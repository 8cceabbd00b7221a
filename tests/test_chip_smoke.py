"""chip_smoke.py's phases and output contract, at 16^3 on the CPU.

The script refuses to run without a GPU; here the device check is
injected so that every phase runs at a small size through the same code
the card runs at full size.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _no_check(jax_mod):
    return None


@pytest.fixture()
def no_cache(monkeypatch):
    """Keep main() from pointing this test process's compilation cache
    at the checkout."""
    import fastbox_tpu.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: None)


@pytest.fixture(scope="module")
def sizes(tmp_path_factory):
    """Small sizes plus a 16^3 truth file made the way truth_gate.py
    makes one (f64 oracle and f32 run on the same stream)."""
    from scripts.truth_gate import _build, _gate_config, _run

    grid, cosmo = _build(16, 1e3, 0.8)
    keys = [1000, 1001]
    k, tc, td, ts = _run(jax, grid, cosmo, _gate_config("float64"), keys)
    _, fc, fd, fs = _run(jax, grid, cosmo, _gate_config("float32"), keys)
    path = tmp_path_factory.mktemp("truth") / "truth16.npz"
    np.savez(path, k=k, pk_cleaned=tc, pk_density=td, sigma=ts,
             f32_pk_cleaned=fc, f32_pk_density=fd, f32_sigma=fs,
             keys=np.asarray(keys), meta=np.asarray([16, 1e3, 0.8]),
             draw_method=np.asarray("erfinv"))
    return dict(chip_smoke.FULL, n=16, box=1e3, big_n=32, cola_n=16,
                cola_box=1e3, truth=str(path), four_n=16, four_box=1e3,
                four_truth=str(path), four_cola_n=16)


PHASES = chip_smoke.ONE_CARD + chip_smoke.FOUR_CARDS[1:]


@pytest.mark.parametrize("name,fn", PHASES, ids=[p[0] for p in PHASES])
def test_phase_passes_at_small_size(sizes, name, fn):
    msg = fn(jax, sizes)
    assert isinstance(msg, str) and msg


def test_truth_phase_fails_on_a_wrong_result(sizes, tmp_path):
    d = dict(np.load(sizes["truth"]))
    d["pk_density"] = d["pk_density"] * 1.01
    bad = tmp_path / "bad.npz"
    np.savez(bad, **d)
    with pytest.raises(chip_smoke.PhaseFailed, match="pk_density"):
        chip_smoke.phase_truth(jax, dict(sizes, truth=str(bad)))


def test_last_line_is_the_result_json(sizes, capsys, monkeypatch, no_cache):
    monkeypatch.setattr(chip_smoke, "ONE_CARD",
                        [("a.card", chip_smoke.phase_card)])
    assert chip_smoke.main([], device_check=_no_check, sizes=sizes) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("a.card") and " ok " in lines[0]
    assert "card [" in lines[0] and "memory_analysis" in lines[0]
    doc = json.loads(lines[-1])
    dev = jax.devices()[0]
    assert doc == {"ok": True, "device": {"platform": dev.platform,
                                          "kind": dev.device_kind,
                                          "count": len(jax.devices())}}


def test_failed_phase_prints_no_result(sizes, capsys, monkeypatch, no_cache):
    def broken(jax_mod, s):
        raise chip_smoke.PhaseFailed("spectra not finite")

    monkeypatch.setattr(chip_smoke, "ONE_CARD", [("b.pipeline", broken)])
    assert chip_smoke.main([], device_check=_no_check, sizes=sizes) == 1
    out = capsys.readouterr().out
    assert "FAILED" in out and '"ok"' not in out


def test_refuses_to_run_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_card_facts_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert chip_smoke.card_facts().startswith("nvidia-smi unavailable")


def test_compile_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    import fastbox_tpu.compile_cache as cc

    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cc.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cc.enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
