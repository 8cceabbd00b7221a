"""End-to-end pipeline module: single, ensemble, and config variants."""
import jax
import numpy as np

from fastbox_tpu.grid import GridSpec
from fastbox_tpu.pipeline import (
    PipelineConfig,
    make_ensemble_pipeline,
    make_pipeline,
)

GRID = GridSpec.create(box_scale=(1e3,) * 3, nsamp=16, redshift=0.8)


def test_single_pipeline(cosmo_z08):
    fn = make_pipeline(GRID, cosmo_z08, PipelineConfig(dtype="float64", nbins=8))
    out = fn(jax.random.PRNGKey(0))
    pk = np.asarray(out["pk_cleaned"])
    assert pk.shape == (7,)
    assert np.isfinite(pk).sum() >= 3
    assert float(out["sigma_data"]) > 0

    # Deterministic per key
    out2 = fn(jax.random.PRNGKey(0))
    assert np.allclose(pk, np.asarray(out2["pk_cleaned"]), equal_nan=True)


def test_pipeline_halfspectrum_matches_fullgrid(cosmo_z08):
    """The rfft half-spectrum path must reproduce the full-grid binned
    spectrum exactly (multiplicity weighting)."""
    import jax.numpy as jnp

    from fastbox_tpu.fields import gaussian
    from fastbox_tpu.ops import spectra

    config = PipelineConfig(dtype="float64", nbins=10)
    fn = make_pipeline(GRID, cosmo_z08, config)
    key = jax.random.PRNGKey(5)
    out = fn(key)

    # Recreate the same half-spectrum draw, go to real space, and compute
    # the *full-grid* spectrum through the standard estimator
    k_dens = jax.random.split(key, 5)[0]
    white_h = gaussian.hermitian_half_noise(k_dens, GRID, jnp.float64)
    H = GRID.N // 2 + 1
    amp_half = jnp.sqrt(
        jnp.nan_to_num(cosmo_z08.pk_nl(GRID.kmag(jnp.float64)))[..., :H]
        * GRID.boxfactor)
    delta_x = jnp.fft.irfftn(white_h * amp_half, s=GRID.shape)
    kc, pk_full, _ = spectra.binned_power_spectrum(GRID, delta_x=delta_x,
                                                   nbins=10)
    assert np.allclose(np.asarray(out["k"]), np.asarray(kc))
    assert np.allclose(np.asarray(out["pk_density"]), np.asarray(pk_full),
                       rtol=1e-9, equal_nan=True)


def test_pipeline_no_fg_no_noise(cosmo_z08):
    config = PipelineConfig(dtype="float64", nbins=8,
                            include_foregrounds=False, include_noise=False)
    out = make_pipeline(GRID, cosmo_z08, config)(jax.random.PRNGKey(1))
    # Without foregrounds the data std is the signal's (mK-scale)
    assert 0.01 < float(out["sigma_data"]) < 1.0


def test_pipeline_instrument_response(cosmo_z08):
    """Beam + k_par filter options (config 3) run and act in the right
    direction: both suppress total data variance."""
    base = PipelineConfig(dtype="float64", nbins=8, include_foregrounds=False,
                          include_noise=False)
    out0 = make_pipeline(GRID, cosmo_z08, base)(jax.random.PRNGKey(9))
    cfg_b = PipelineConfig(dtype="float64", nbins=8,
                           include_foregrounds=False, include_noise=False,
                           beam_dish_m=13.5, kpar_min=0.05)
    out1 = make_pipeline(GRID, cosmo_z08, cfg_b)(jax.random.PRNGKey(9))
    assert float(out1["sigma_data"]) < float(out0["sigma_data"])
    assert np.isfinite(np.asarray(out1["pk_cleaned"])).sum() >= 3


def test_ensemble_pipeline(cosmo_z08):
    fn = make_ensemble_pipeline(GRID, cosmo_z08,
                                PipelineConfig(dtype="float64", nbins=8))
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    out = fn(keys)
    pk = np.asarray(out["pk_cleaned"])
    assert pk.shape == (4, 7)
    # Different keys -> different realisations
    assert not np.allclose(np.nan_to_num(pk[0]), np.nan_to_num(pk[1]))


def test_pipeline_density_spectrum_matches_theory(cosmo_z08):
    """pk_density from the pipeline tracks the input nonlinear P(k)."""
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=32, redshift=0.8)
    fn = make_pipeline(grid, cosmo_z08,
                       PipelineConfig(dtype="float64", sigma_nl=0.0))
    pks = []
    for seed in range(5):
        out = fn(jax.random.PRNGKey(seed))
        pks.append(np.asarray(out["pk_density"]))
    k = np.asarray(out["k"])
    mean = np.nanmean(pks, axis=0)
    th = np.asarray(cosmo_z08.pk_nl(k))
    sel = np.isfinite(mean) & (k > 2 * grid.kmin) & (k < 0.3 * grid.kmax)
    ratio = mean[sel] / th[sel]
    assert np.all(ratio > 0.6) and np.all(ratio < 1.6), ratio


def test_sharded_config_variants(cosmo_z08):
    from fastbox_tpu.parallel import make_mesh, make_sharded_ensemble_step

    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=16, redshift=0.8)
    mesh = make_mesh(8, space=4, grid_n=16)
    cfg = PipelineConfig(dtype="float64", nbins=8, include_foregrounds=False,
                         include_noise=False, sigma_nl=150.0)
    step = make_sharded_ensemble_step(mesh, grid, cosmo_z08, cfg)
    out = step(jax.random.split(jax.random.PRNGKey(7), 2))
    pk = np.asarray(out["pk_cleaned"])
    assert pk.shape[0] == 2
    assert np.isfinite(pk).sum() >= 6


def test_ensemble_pipeline_sharded(cosmo_z08):
    from fastbox_tpu.parallel import make_mesh

    mesh = make_mesh(8, space=1)
    fn = make_ensemble_pipeline(GRID, cosmo_z08,
                                PipelineConfig(dtype="float64", nbins=8),
                                mesh=mesh)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    out = fn(keys)
    assert np.asarray(out["pk_cleaned"]).shape == (8, 7)


def test_chained_pipeline_matches_single(cosmo_z08):
    """make_chained_pipeline stacks exactly the single-shot outputs."""
    from fastbox_tpu.pipeline import make_chained_pipeline

    config = PipelineConfig(dtype="float64", nbins=8)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    single = make_pipeline(GRID, cosmo_z08, config)
    chained = make_chained_pipeline(GRID, cosmo_z08, config)
    outs = chained(keys)
    for i, k in enumerate(keys):
        ref = single(k)
        np.testing.assert_allclose(np.asarray(outs["pk_cleaned"])[i],
                                   np.asarray(ref["pk_cleaned"]),
                                   rtol=1e-12, equal_nan=True)


def test_fft_pair_matches_default(cosmo_z08):
    """fft_pair=True (one complex MXU inverse for delta_x + vel_z) must
    reproduce the two-dispatch default to FFT roundoff."""
    keys = jax.random.PRNGKey(5)
    base = make_pipeline(GRID, cosmo_z08,
                         PipelineConfig(dtype="float64", nbins=8))
    pair = make_pipeline(GRID, cosmo_z08,
                         PipelineConfig(dtype="float64", nbins=8,
                                        fft_pair=True))
    a = base(keys)
    b = pair(keys)
    np.testing.assert_allclose(np.asarray(a["pk_cleaned"]),
                               np.asarray(b["pk_cleaned"]),
                               rtol=1e-9, equal_nan=True)
    np.testing.assert_allclose(float(a["sigma_data"]),
                               float(b["sigma_data"]), rtol=1e-10)
