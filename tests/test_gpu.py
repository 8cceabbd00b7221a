"""Checks that need the GPU itself; they skip on the CPU.

Run on the card with ``FASTBOX_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.ops import fft_safe
from fastbox_tpu.pipeline import PipelineConfig, make_ensemble_pipeline

pytestmark = pytest.mark.gpu


def test_batched_fft_under_vmap_matches_numpy(gpu):
    """Batched cube transforms (the ensemble path) run on cuFFT."""
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 32))
    got = jax.vmap(fft_safe.rfftn)(jnp.asarray(x, jnp.float32))
    ref = np.fft.rfftn(x, axes=(1, 2, 3))
    assert np.abs(np.asarray(got) - ref).max() < 1e-4 * np.abs(ref).max()


def test_ensemble_pipeline_runs_on_gpu(gpu):
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=32, redshift=0.8)
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.8)
    fn = make_ensemble_pipeline(grid, cosmo, PipelineConfig())
    out = fn(jax.random.split(jax.random.PRNGKey(0), 2))
    pk = np.asarray(out["pk_density"])
    assert pk.shape[0] == 2 and np.isfinite(pk).sum(axis=1).min() >= 8
    assert next(iter(out["pk_density"].devices())).platform == "gpu"
