"""No path of the pipeline or COLA picks a kernel by backend any more.

With JAX's backend faked to "gpu", tracing every pipeline entry point and
running COLA must reach neither a Pallas kernel nor a matmul DFT of
``ops/mmfft.py``: every transform is ``jnp.fft`` and every reduction plain
XLA, whatever the device.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.fields.cola import realise_density_cola
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.ops import mmfft
from fastbox_tpu.pipeline import (PipelineConfig, make_chained_pipeline,
                                  make_ensemble_pipeline, make_pipeline)

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)


@pytest.fixture()
def fake_gpu(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a matmul DFT or Pallas kernel was reached")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for name in ("fft", "ifft", "rfft", "irfft", "fftn", "ifftn",
                 "rfftn_any", "irfftn_any", "rfftn3", "irfftn3",
                 "irfftn_pair", "_dft_last"):
        monkeypatch.setattr(mmfft, name, forbidden)
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", forbidden)


def _grid(n=16, z=0.8):
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=n, redshift=z)
    return grid, build_cosmology(COSMO, redshift=z)


@pytest.mark.parametrize("entry", ["single", "rows", "chained", "ensemble"])
def test_pipeline_paths_use_native_xla(fake_gpu, entry):
    grid, cosmo = _grid()
    key = jax.random.PRNGKey(0)
    if entry == "single":
        fn, arg = make_pipeline(grid, cosmo, PipelineConfig(), jit=False), key
    elif entry == "rows":
        fn = make_pipeline(grid, cosmo, PipelineConfig(noise_scheme="rows"),
                           jit=False)
        arg = key
    elif entry == "chained":
        fn = make_chained_pipeline(grid, cosmo, PipelineConfig())
        arg = jax.random.split(key, 2)
    else:
        fn = make_ensemble_pipeline(grid, cosmo, PipelineConfig())
        arg = jax.random.split(key, 2)
    out = jax.eval_shape(fn, arg)
    assert out["pk_cleaned"].shape[-1] == 19


@pytest.mark.parametrize("lattice_B", [3, None])
def test_cola_paths_use_native_xla(fake_gpu, lattice_B):
    grid, cosmo = _grid(n=8, z=0.0)
    d, _ = realise_density_cola(jax.random.PRNGKey(1), grid, cosmo,
                                redshift_init=3.0, n_steps=2,
                                keep_velocities=False, lattice_B=lattice_B)
    assert np.isfinite(np.asarray(d)).all()


def test_no_pallas_module_is_imported():
    assert importlib.util.find_spec("fastbox_tpu.ops.pallas") is None
    code = (
        "import sys, jax\n"
        "from fastbox_tpu.cosmology import build_cosmology\n"
        "from fastbox_tpu.grid import GridSpec\n"
        "from fastbox_tpu.pipeline import make_pipeline\n"
        "g = GridSpec.create(box_scale=(1e3,)*3, nsamp=8, redshift=0.8)\n"
        f"c = build_cosmology({COSMO!r}, redshift=0.8)\n"
        "jax.eval_shape(make_pipeline(g, c, jit=False),"
        " jax.random.PRNGKey(0))\n"
        "print(sorted(m for m in sys.modules if 'pallas' in m))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
