"""Generate per-module API reference pages under docs/api/.

The reference ships a mkdocs+mkdocstrings site (mkdocs.yml, 14 docs/*.md);
this environment has no mkdocs, so the equivalent is generated directly
from the package's docstrings into plain markdown: one page per public
module, every public function/class with its signature and docstring.

Run from the repo root:  python scripts/gen_api_docs.py
"""
from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MODULES = [
    "fastbox_tpu",
    "fastbox_tpu.grid",
    "fastbox_tpu.box",
    "fastbox_tpu.pipeline",
    "fastbox_tpu.utils",
    "fastbox_tpu.io",
    "fastbox_tpu.timing",
    "fastbox_tpu.compile_cache",
    "fastbox_tpu.plot",
    "fastbox_tpu.cosmology.params",
    "fastbox_tpu.cosmology.background",
    "fastbox_tpu.cosmology.eisenstein_hu",
    "fastbox_tpu.cosmology.halofit",
    "fastbox_tpu.cosmology.tables",
    "fastbox_tpu.cosmology.massfunction",
    "fastbox_tpu.fields.gaussian",
    "fastbox_tpu.fields.transforms",
    "fastbox_tpu.fields.lpt",
    "fastbox_tpu.fields.cola",
    "fastbox_tpu.fields.lattice_cic",
    "fastbox_tpu.ops.fft_safe",
    "fastbox_tpu.ops.spectra",
    "fastbox_tpu.ops.rsd",
    "fastbox_tpu.ops.painting",
    "fastbox_tpu.ops.reduce",
    "fastbox_tpu.ops.nbodykit_compat",
    "fastbox_tpu.filters.pca",
    "fastbox_tpu.filters.ica",
    "fastbox_tpu.filters.kpca",
    "fastbox_tpu.filters.nmf",
    "fastbox_tpu.filters.gpr",
    "fastbox_tpu.filters.bandpass",
    "fastbox_tpu.filters.lsq",
    "fastbox_tpu.models.foregrounds",
    "fastbox_tpu.models.beams",
    "fastbox_tpu.models.noise",
    "fastbox_tpu.models.tracers",
    "fastbox_tpu.models.halos",
    "fastbox_tpu.analysis.voids",
    "fastbox_tpu.analysis.inpaint",
    "fastbox_tpu.analysis.forecast",
    "fastbox_tpu.analysis.datacube",
    "fastbox_tpu.parallel.mesh",
    "fastbox_tpu.parallel.fft",
    "fastbox_tpu.parallel.sharded",
    "fastbox_tpu.parallel.rng",
    "fastbox_tpu.parallel.lattice",
    "fastbox_tpu.parallel.cola",
    "fastbox_tpu.parallel.spectra",
    "fastbox_tpu.parallel.halos",
    "fastbox_tpu.parallel.filters",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(no docstring)*"


def _unwrap(obj):
    """Reach through jax.jit / functools wrappers to the traced function."""
    seen = 0
    while hasattr(obj, "__wrapped__") and seen < 8:
        obj = obj.__wrapped__
        seen += 1
    return obj


def document_module(name: str) -> str:
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", "", _doc(mod), ""]

    public = getattr(mod, "__all__", None)
    if public is None:
        public = [n for n in sorted(vars(mod))
                  if not n.startswith("_")
                  and getattr(getattr(mod, n), "__module__", None) == name]

    for attr in public:
        obj = getattr(mod, attr, None)
        if obj is None:
            continue
        if inspect.isclass(obj):
            lines += [f"## class `{attr}{_sig(obj)}`", "", _doc(obj), ""]
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_"):
                    continue
                target = meth
                if isinstance(meth, (staticmethod, classmethod)):
                    target = meth.__func__
                if callable(target):
                    target = _unwrap(target)
                    lines += [f"### `{attr}.{mname}{_sig(target)}`", "",
                              _doc(target), ""]
                elif isinstance(meth, property):
                    lines += [f"### property `{attr}.{mname}`", "",
                              _doc(meth), ""]
        elif callable(obj):
            fn = _unwrap(obj)
            lines += [f"## `{attr}{_sig(fn)}`", "", _doc(fn), ""]
        else:
            lines += [f"## `{attr}`", "", f"Constant: `{obj!r}`", ""]
    return "\n".join(lines) + "\n"


def main():
    outdir = REPO / "docs" / "api"
    outdir.mkdir(parents=True, exist_ok=True)
    index = ["# fastbox_tpu API reference", "",
             "Generated from docstrings by `scripts/gen_api_docs.py`.", ""]
    for name in MODULES:
        page = name.replace(".", "_") + ".md"
        try:
            text = document_module(name)
        except Exception as exc:  # pragma: no cover
            print(f"SKIP {name}: {exc}")
            continue
        (outdir / page).write_text(text)
        index.append(f"- [`{name}`]({page})")
        print(f"wrote {page}")
    (outdir / "index.md").write_text("\n".join(index) + "\n")
    print(f"{len(MODULES)} modules documented")


if __name__ == "__main__":
    main()
