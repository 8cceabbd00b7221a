"""Chained-pipeline eigh hoist (PipelineConfig.eigh_hoist).

The hoisted chain (scan -> batched eigh -> scan) must be the SAME
estimator as the plain chain: identical covariance, identical projection
clean, eigh merely batched.  In f64 the two paths must agree to
solver-roundoff; in f32 the reordering scatter must stay in the
conditioning-floor class (the cleaned low bins amplify any rounding by
the foreground-subtraction ratio, so bit-equality is not expected —
CLAUDE.md).
"""
import jax
import numpy as np
import pytest

from fastbox_tpu.grid import GridSpec
from fastbox_tpu.pipeline import PipelineConfig, make_chained_pipeline


@pytest.fixture(scope="module")
def grid32():
    return GridSpec.create(box_scale=(1e3,) * 3, nsamp=32, redshift=0.8)


def _chain(grid32, cosmo, dtype, hoist, nkeys=3):
    keys = jax.random.split(jax.random.PRNGKey(7), nkeys)
    cfg = PipelineConfig(dtype=dtype, eigh_hoist=hoist)
    return make_chained_pipeline(grid32, cosmo, cfg)(keys)


def test_hoist_matches_plain_f64(grid32, cosmo_z08):
    a = _chain(grid32, cosmo_z08, "float64", "off")
    b = _chain(grid32, cosmo_z08, "float64", "on")
    for name in ("pk_cleaned", "pk_density", "pk_cleaned_err",
                 "sigma_data"):
        x, y = np.asarray(a[name]), np.asarray(b[name])
        m = np.isfinite(x)
        assert np.allclose(x[m], y[m], rtol=1e-10, atol=1e-12), name


def test_hoist_f32_within_conditioning_class(grid32, cosmo_z08):
    a = _chain(grid32, cosmo_z08, "float32", "off")
    b = _chain(grid32, cosmo_z08, "float32", "on")
    x, y = np.asarray(a["pk_cleaned"]), np.asarray(b["pk_cleaned"])
    m = np.isfinite(x)
    rel = np.max(np.abs(x[m] - y[m]) / np.maximum(np.abs(x[m]), 1e-30))
    # Reordering scatter only: well under the measured f32 conditioning
    # floor class (2.9e-3 at 128^3, TRUTH_GATE.json), nowhere near a
    # wrong-estimator O(1) deviation.
    assert rel < 5e-3
    # The density spectrum takes no PCA path and must be exact.
    xd, yd = np.asarray(a["pk_density"]), np.asarray(b["pk_density"])
    md = np.isfinite(xd)
    assert np.array_equal(xd[md], yd[md])


def test_hoist_auto_off_on_cpu(grid32, cosmo_z08):
    """'auto' must resolve to the plain path (bitwise identical
    outputs to eigh_hoist='off')."""
    a = _chain(grid32, cosmo_z08, "float32", "auto")
    b = _chain(grid32, cosmo_z08, "float32", "off")
    x, y = np.asarray(a["pk_cleaned"]), np.asarray(b["pk_cleaned"])
    m = np.isfinite(x)
    assert np.array_equal(x[m], y[m])


def test_hoist_rejects_unknown(grid32, cosmo_z08):
    with pytest.raises(ValueError):
        make_chained_pipeline(grid32, cosmo_z08,
                              PipelineConfig(eigh_hoist="maybe"))
