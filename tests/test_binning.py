"""Exact integer-lattice P(k) bin classification (round 4).

The floating-|k| digitize puts edge-sitting modes in different bins in
f32 vs f64 (np.logspace places the first edge one f64 ulp above the
fundamental frequency — 5 flipped modes at every N, a ~3e-1 artifact in
the first retained 512^3 bin).  ``ops.spectra.kbin_thresholds`` decides
membership on the exact integer lattice instead; these tests pin that
contract.
"""
import jax.numpy as jnp
import numpy as np

from fastbox_tpu.grid import GridSpec
from fastbox_tpu.ops import spectra


def _counts(grid, delta_x, dtype):
    """Per-bin weighted mode counts through the public estimator path."""
    from fastbox_tpu.ops.reduce import binned_weighted_sum_sumsq_count

    bins = spectra.default_kbins(grid, 20)
    thr = spectra.kbin_thresholds(grid, bins)
    vals, stddev = spectra._binned_pk_half_core(
        grid, jnp.asarray(delta_x, dtype), jnp.asarray(bins),
        None if thr is None else jnp.asarray(thr))
    return np.asarray(vals)


def test_f32_f64_bin_identical():
    """The same realisation bins to IDENTICAL per-bin means in f32 and
    f64 (classification is dtype-free; only arithmetic rounding remains)."""
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=32, redshift=0.0)
    rng = np.random.default_rng(7)
    dx = rng.standard_normal(grid.shape)
    v64 = _counts(grid, dx, jnp.float64)
    v32 = _counts(grid, dx.astype(np.float32), jnp.float32)
    good = np.isfinite(v64)
    assert np.array_equal(good, np.isfinite(v32))  # same bin occupancy
    assert np.allclose(v32[good], v64[good], rtol=2e-4)


def test_fundamentals_in_first_retained_bin():
    """The five fundamental half-spectrum modes are classified INTO the
    first bin (the reference's ulp-above-kmin logspace edge would discard
    them — documented divergence, docs/conventions.md item 4)."""
    grid = GridSpec.create(box_scale=(2e3,) * 3, nsamp=64, redshift=0.0)
    bins = spectra.default_kbins(grid, 20)
    thr = spectra.kbin_thresholds(grid, bins)
    assert thr is not None
    # m = 1 (the fundamentals) must land in searchsorted bin 1 (the
    # first retained bin after the discarded sub-kmin bin 0)
    assert np.searchsorted(thr, 1, side="right") == 1
    # m = 0 (the zero mode) stays in the discarded bin
    assert np.searchsorted(thr, 0, side="right") == 0


def test_anisotropic_falls_back():
    grid = GridSpec.create(box_scale=(1e2, 2e2, 3e2), nsamp=16)
    assert spectra.kbin_thresholds(grid, spectra.default_kbins(grid)) is None
