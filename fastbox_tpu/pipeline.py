"""The end-to-end 21cm mock pipeline as a single jitted function.

This is the single-program expression of the reference's
``examples/example_endtoend.py`` workload (SURVEY.md §3.2), the
"realize -> RSD -> filter -> P(k)" pipeline named in BASELINE.json:

  1. Gaussian density realisation with the tabulated nonlinear P(k)
  2. HI bias scaling and log-normal transform
  3. linear velocity field from the Gaussian delta_k
  4. redshift-space remap (vmapped per-LOS, sigma_nl dispersion)
  5. brightness-temperature scaling Tb (1 + delta_s)
  6. diffuse foreground cube (2D GRF amplitude x spectral-index power law)
  7. radiometer noise
  8. PCA foreground clean
  9. binned P(k) of the cleaned cube (and of intermediate fields)

Everything after the host-side setup (cosmology tables, instrument scalars)
is one XLA program: ``make_pipeline`` returns a jitted ``fn(key) -> dict``,
and ``make_ensemble_pipeline`` vmaps it over a batch of keys for Monte-Carlo
throughput, optionally sharded over a device mesh.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .cosmology import Cosmology
from .fields import gaussian, transforms
from .filters import pca_filter
from .grid import GridSpec
from .models import noise as noise_mod
from .models.foregrounds import ForegroundModel, gaussian_smooth_wrap
from .ops import fft_safe
from .ops import rsd as rsd_ops
from .ops import spectra as spectra_ops
from .ops.reduce import binned_weighted_dual

__all__ = ["PipelineConfig", "make_pipeline", "make_chained_pipeline",
           "make_ensemble_pipeline"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the end-to-end mock pipeline.

    Defaults mirror example_endtoend.py's parameter choices.
    """

    # Signal
    linear_pk: bool = False
    bias: float | None = None        # None -> HI bias fit at box redshift
    sigma_nl: float = 120.0          # km/s (example_endtoend.py:44)
    rsd_method: str = "linear"
    # Foregrounds (example_endtoend.py:59-68)
    fg_amp: float = 57.0
    fg_beta: float = 1.1
    fg_monopole: float = 10.0
    fg_smoothing_deg: float = 4.0
    spec_idx_mean: float = 2.07
    spec_idx_std: float = 2e-4
    spec_idx_smoothing_deg: float = 15.0
    freq_ref: float = 130.0
    # Noise (example_endtoend.py:82-84)
    Tinst: float = 18.0              # K
    tp_hours: float = 2.0
    fov_deg2: float = 1.0
    Ndish: int = 64
    # Instrument response (config 3: anisotropic filter + beam)
    beam_dish_m: float | None = None   # Gaussian beam FWHM = 1.22 lambda/D
    kpar_min: float | None = None      # foreground-avoidance high-pass (1/Mpc)
    # Cleaning + estimation
    pca_nmodes: int = 4
    pca_exact: bool = True    # exact eigh (default) vs subspace iteration
                              # (approximate when trailing modes are
                              # degenerate — opt in knowingly)
    nbins: int = 20
    include_foregrounds: bool = True
    include_noise: bool = True
    dtype: str = "float32"
    # Noise-draw scheme: 'half' (default) draws density noise directly on
    # the rfft half-spectrum — fastest, single-chip only.  'rows' draws
    # every noise field per leading-axis row (parallel/rng.py), giving
    # realisations that are IDENTICAL between the single-chip pipeline and
    # the sharded ensemble step (any mesh shape) for the same key.
    noise_scheme: str = "half"
    # Fuse the (delta_x, vel_z) inverse transforms into ONE complex
    # matmul-DFT inverse (ops/mmfft.irfftn_pair: irfft(a + i b) ->
    # (Re, Im)) instead of two native C2R transforms.  Opt-in: f64 agrees
    # with the default to 1e-9 (tested), but in f32 the matmul DFT adds
    # rounding the native FFT does not.
    fft_pair: bool = False
    # Einsum precision of the fft_pair matmul DFT (None inherits the
    # mmfft module default, HIGHEST).  Every other transform is the
    # native FFT and takes no precision.
    mm3d_precision: str | None = "HIGH"
    # Einsum precision for the PCA covariance/projection GEMMs
    # (filters/pca.py).  The cleaned low bins amplify PCA-side rounding
    # ~1000x, so these GEMMs run at full float32.  On the H100 "HIGH" and
    # "DEFAULT" both lower to TF32 cuBLAS GEMMs (3.2e-4 relative error on
    # a 2048^2 product, vs 2.3e-6 at HIGHEST), and at 256^3 "HIGH" doubles
    # the cleaned-P(k) error of bins 1-2 against the f64 oracle (PERF.md).
    # None also means HIGHEST.
    pca_precision: str | None = "HIGHEST"
    # Truth-anchoring knobs (scripts/truth_gate.py).  jax.random draws are
    # dtype-dependent: the same key yields different values in f32 vs
    # f64, so an f64 run is normally a different REALISATION and can only
    # be compared statistically.  Setting ``draw_dtype='float32'`` on an
    # f64 pipeline makes every PRNG draw happen in f32 before casting to
    # the compute dtype, so the f64 run consumes the exact f32 random
    # stream and becomes a per-bin truth oracle for the f32 run.
    draw_dtype: str | None = None
    # Draw the sigma_nl and radiometer-noise fields inline in draw_dtype
    # (instead of in the compute dtype inside the RSD / noise helpers), so
    # the f64 oracle of the truth gate sees the same noise as the f32 run.
    threefry_noise: bool = False
    # Foreground spectral-cube evaluation: 'poly' (default) splits
    # alpha = spec_idx_mean + dalpha and evaluates the pixel-varying
    # factor exp(dalpha*log(nu/ref)) by a cubic Taylor polynomial with
    # the pixel-common factors precomputed in f64 — see
    # ForegroundModel.construct_cube_smallalpha_fn for the truth-gate
    # finding that motivates it (the generic f32 pow's voxel-decorrelated
    # rounding is THE dominant cleaned-P(k) error at 256^3).  Falls back
    # to 'pow' automatically when the small-|dalpha*logf| bound does not
    # hold.  'pow' forces the reference-style generic power law.
    fg_spectral: str = "poly"
    # Diagnostic: also return the intermediate cubes (delta_x, vel_z,
    # delta_s, fg_cube, data, cleaned) so per-stage divergence can be
    # measured.  Gate / probe use only —
    # the extra outputs force materialisation of every cube.
    debug_stages: bool = False
    # Chained-pipeline eigh hoist: run the chain as
    # scan(realise..covariance) -> ONE batched eigh over the K stacked
    # covariances -> scan(project-clean..P(k)).  The same exact
    # estimator (jnp.linalg.eigh, merely batched: f64 chains agree to
    # 5e-13, tests/test_pipeline_hoist.py), at the price of K extra cube
    # materialisations (data + |delta_k|^2 stacks) at the scan boundary.
    # Default 'off'; 'on' forces it; 'auto' resolves to 'off'.
    eigh_hoist: str = "off"
    # Bits->normal transform for the threefry density half-spectrum draw
    # (step 1, 'half' scheme only): 'erfinv' (jax.random.normal, the
    # stream every committed oracle expectation uses) or 'box_muller'
    # (one log+sqrt+cos+sin pair per COMPLEX mode instead of two erf_inv
    # polynomial evaluations, still fused with the colour multiply).  A
    # different, equally valid realisation stream; composes with
    # draw_dtype (the uniforms are drawn in draw_dtype), so the truth
    # gate can oracle it per-bin.
    draw_method: str = "erfinv"
    # Additive per-bin debias vector subtracted from the RETAINED
    # pk_cleaned bins (length nbins-1, same order as the returned "k").
    # ``calibrate_pk_debias`` measures mean(pk_fast - pk_ref) on held-out
    # keys for a lower-precision configuration; this knob subtracts it in
    # the estimator.  None = no subtraction (default).
    pk_debias: tuple | None = None

    def __post_init__(self):
        # Validate knobs that are otherwise consumed far from construction,
        # so invalid values fail fast for every pipeline constructor.
        # NOTE: eigh_hoist only has an effect in make_chained_pipeline —
        # make_pipeline/make_ensemble_pipeline have no chain to hoist over
        # ('on' is accepted there but is a no-op by construction).
        if self.eigh_hoist not in ("auto", "on", "off"):
            raise ValueError(f"Unknown eigh_hoist '{self.eigh_hoist}'")
        if self.fg_spectral not in ("poly", "pow"):
            raise ValueError(f"Unknown fg_spectral '{self.fg_spectral}'")


def _hi_bias(z):
    """Bull et al. (2015) b_HI(z) fit (reference tracers.py:129-144)."""
    return 6.6655e-01 + 1.7765e-01 * z + 5.0223e-02 * z**2


def _hi_tb(z):
    """Tb(z) power-law fit in mK (reference tracers.py:115-117)."""
    return 5.5919e-02 + 2.3242e-01 * z - 2.4136e-02 * z**2


def _build_pipeline(grid: GridSpec, cosmology: Cosmology,
                    config: PipelineConfig):
    """Construct the pipeline body: ``(fn_inner, (amp_half, bin_idx))``.

    ``fn_inner(key, amp_half, bin_idx) -> dict`` is the pure body; the
    two device consts are returned separately so callers pass them as
    ARGUMENTS to their jit (closed-over cubes would be embedded in the
    program as constants, which blows up compile memory at 512^3+).
    """
    dtype = jnp.dtype(config.dtype)
    z = grid.redshift
    bias = float(config.bias if config.bias is not None else _hi_bias(z))
    Tb = float(_hi_tb(z))
    Hz = 100.0 * cosmology.h * cosmology.Ea

    # Host-side instrument constants
    freqs = grid.freq_array(cosmology)
    ang_x, _ = grid.pixel_array(cosmology)
    dang = ang_x[1] - ang_x[0]
    fg_sigma_pix = config.fg_smoothing_deg / dang
    alpha_sigma_pix = config.spec_idx_smoothing_deg / dang
    sigma_rms = noise_mod.radiometer_sigma(
        freqs, ang_x, config.Tinst, config.tp_hours, config.fov_deg2,
        config.Ndish,
    )
    freqs_j = jnp.asarray(freqs.copy(), dtype=dtype)
    sigma_j = jnp.asarray(sigma_rms, dtype=dtype)

    # Foreground spectral factors, precomputed in f64 on host (see
    # PipelineConfig.fg_spectral / construct_cube_smallalpha_fn).  The
    # poly path needs |dalpha * logf| << 1; with dalpha ~ N(0, std^2)
    # smoothed, an 8-sigma bound at 0.01 keeps the cubic's truncation
    # error below 4e-10 with astronomically safe margin.
    if config.fg_spectral not in ("poly", "pow"):
        raise ValueError(f"Unknown fg_spectral '{config.fg_spectral}'")
    _logf = np.log(np.asarray(freqs, np.float64) / config.freq_ref)
    use_fg_poly = (config.fg_spectral == "poly"
                   and 8.0 * config.spec_idx_std * np.abs(_logf).max() < 1e-2)
    ffac_mean_j = jnp.asarray(
        np.power(np.asarray(freqs, np.float64) / config.freq_ref,
                 config.spec_idx_mean), dtype)
    logf_j = jnp.asarray(_logf, dtype)

    pk_fn = cosmology.pk_lin if config.linear_pk else cosmology.pk_nl

    # The pipeline works on the rfft half-spectrum (the field is real):
    # half the FFT cost and half the reduction traffic, exactly equivalent
    # to the full grid.  Large per-grid arrays (the sqrt(P) amplitude) are
    # passed as *arguments* to the jitted function rather than closed-over
    # constants — embedded constants are shipped with the program to the
    # compiler and blow up at 512^3+.
    H = grid.N // 2 + 1
    vel_fac = float(100.0 * cosmology.h * cosmology.Ea
                    * cosmology.growth_rate * cosmology.scale_factor)

    kxv, kyv, kzv = grid.kvec(dtype)
    kz_half = kzv[:H]
    nyq_z = grid.nyquist_mask(2)[:H]

    # sqrt(P(k) boxfactor) on the half grid, tabulated once at build time
    # (the table interpolation over N^3/2 values is not worth repeating).
    kmag_half_build = jnp.sqrt(kxv[:, None, None] ** 2 + kyv[None, :, None] ** 2
                               + kz_half[None, None, :] ** 2)
    amp_half = jnp.sqrt(jnp.nan_to_num(pk_fn(kmag_half_build))
                        * jnp.asarray(grid.boxfactor, dtype)).astype(dtype)
    del kmag_half_build

    # Half-spectrum mode multiplicity along kz
    kz_weight = np.full(H, 2.0, dtype=np.float64)
    kz_weight[0] = 1.0
    if grid.N % 2 == 0:
        kz_weight[-1] = 1.0
    kzw_j = jnp.asarray(kz_weight, dtype)

    kbins_edges = np.asarray(spectra_ops.default_kbins(grid, config.nbins))
    _e = np.concatenate([[0.0], kbins_edges])
    kcent = 0.5 * (_e[1:] + _e[:-1])
    nb = kbins_edges.size
    if config.pk_debias is not None and len(config.pk_debias) != nb - 1:
        raise ValueError(
            f"pk_debias must have length {nb - 1} (the retained bins); "
            f"got {len(config.pk_debias)}")
    # Bin classification plan (round 4): squared-space digitize, with
    # EXACT integer-lattice operands on cubic grids — identical bin
    # membership in every dtype/platform/kernel (the floating |k| path
    # put 5 edge-sitting fundamental modes in different bins between
    # f32 and f64, a ~3e-1 artifact in the first retained 512^3 bin;
    # see ops/spectra.kbin_thresholds).
    _thr = spectra_ops.kbin_thresholds(grid, kbins_edges)
    if _thr is not None:
        _fi2 = spectra_ops._index_sq(grid)          # int32 (N,), exact

    # Bin indices precomputed once on device, passed as a runtime
    # argument (recomputing the searchsorted per call costs a full pass
    # over the cube).  Cubic grids classify the exact integer lattice.
    if _thr is not None:
        _fi2_j = jnp.asarray(_fi2)
        _m = (_fi2_j[:, None, None] + _fi2_j[None, :, None]
              + _fi2_j[:H][None, None, :])
        bin_idx_arg = jnp.searchsorted(jnp.asarray(_thr), _m.ravel(),
                                       side="right").astype(jnp.int32)
        del _m
    else:
        _kmag_b = jnp.sqrt(kxv[:, None, None] ** 2
                           + kyv[None, :, None] ** 2
                           + kz_half[None, None, :] ** 2)
        bin_idx_arg = jnp.searchsorted(jnp.asarray(kbins_edges, dtype),
                                       _kmag_b.ravel(),
                                       side="right").astype(jnp.int32)
        del _kmag_b

    if config.noise_scheme not in ("half", "rows"):
        raise ValueError(f"Unknown noise_scheme '{config.noise_scheme}'")
    rows_mode = config.noise_scheme == "rows"

    ddt = jnp.dtype(config.draw_dtype) if config.draw_dtype else dtype
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    _pca_prec = (jax.lax.Precision.HIGHEST if config.pca_precision is None
                 else getattr(jax.lax.Precision, config.pca_precision))

    def fn_pre(key, amp_half, want_cov=False):
        """Stages (1)-(7b): realise through the instrument response.

        Returns a dict with the data cube, the density power half-cube
        and summary scalars; with ``want_cov`` also the frequency-
        frequency covariance (the eigh-hoist path computes the batched
        eigendecomposition OUTSIDE the chain scan — see
        PipelineConfig.eigh_hoist).
        """
        from .parallel.rng import (TAGS, default_row_method,
                                   row_complex_normal, row_normal)
        _rm = default_row_method(grid.N)

        (k_dens, k_rsd, k_fg, k_alpha, k_noise) = jax.random.split(key, 5)

        # (1) Gaussian density field (conventions of box.py:130-194): noise
        # drawn directly on the Hermitian half-spectrum (statistics identical
        # to the reference's full draw + .real projection), or per-row in
        # x-space (mesh-independent 'rows' scheme; costs one extra rfftn).
        if rows_mode:
            white = row_normal(key, TAGS["density"], 0, grid.N,
                               (grid.N, grid.N), dtype, _rm)
            white_h = fft_safe.rfftn(white) * dtype.type(grid.N ** -1.5)
            delta_k = white_h * amp_half
        else:
            white_h = gaussian.hermitian_half_noise(
                k_dens, grid, ddt, method=config.draw_method)
            if ddt != dtype:
                white_h = white_h.astype(cdtype)
            delta_k = white_h * amp_half

        # (3, hoisted) LOS velocity spectrum from the Gaussian field
        # (z component only); k-weights built on the fly (XLA fuses the
        # broadcasts).
        k2 = (kxv[:, None, None] ** 2 + kyv[None, :, None] ** 2
              + kz_half[None, None, :] ** 2)
        inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
        vz_k = (1j * delta_k) * (dtype.type(vel_fac)
                                 * kz_half[None, None, :] * inv_k2)
        vz_k = jnp.where(nyq_z[None, None, :], 0.0, vz_k)

        if config.fft_pair:
            from .ops import mmfft

            delta_x, vel_z = mmfft.irfftn_pair(
                delta_k, vz_k, s=grid.shape,
                precision=config.mm3d_precision)
            delta_x = delta_x.astype(dtype)
            vel_z = vel_z.astype(dtype)
        else:
            delta_x = fft_safe.irfftn(delta_k, s=grid.shape).astype(dtype)
            vel_z = fft_safe.irfftn(vz_k, s=grid.shape).astype(dtype)

        # (2) bias + log-normal
        delta_ln = transforms.lognormal(delta_x * bias)

        # (4) RSD remap
        if rows_mode and config.sigma_nl > 0.0:
            vel_z = vel_z + dtype.type(config.sigma_nl) * row_normal(
                key, TAGS["sigma_nl"], 0, grid.N, (grid.N, grid.N),
                dtype, _rm)
            delta_s = rsd_ops.redshift_space_density(
                delta_ln, vel_z, grid, Hz, sigma_nl=0.0,
                method=config.rsd_method,
            )
        elif config.threefry_noise and config.sigma_nl > 0.0:
            # Gate path: platform-deterministic threefry draw in ddt,
            # mirroring add_scaled_normal's fallback stream shape
            vel_z = vel_z + dtype.type(config.sigma_nl) * jax.random.normal(
                k_rsd, grid.shape, ddt).astype(dtype)
            delta_s = rsd_ops.redshift_space_density(
                delta_ln, vel_z, grid, Hz, sigma_nl=0.0,
                method=config.rsd_method,
            )
        else:
            delta_s = rsd_ops.redshift_space_density(
                delta_ln, vel_z, grid, Hz, sigma_nl=config.sigma_nl,
                key=k_rsd, method=config.rsd_method,
            )

        # (5) signal cube in mK
        data = Tb * (1.0 + delta_s)

        # (6) foregrounds
        if config.include_foregrounds:
            if rows_mode:
                white2d = row_complex_normal(
                    key, TAGS["fg_re"], TAGS["fg_im"], 0, grid.N,
                    (grid.N,), dtype, _rm)
                alpha_w = row_normal(key, TAGS["alpha"], 0, grid.N,
                                     (grid.N,), dtype, _rm)
            else:
                kf1, kf2 = jax.random.split(k_fg)
                white2d = (
                    jax.random.normal(kf1, (grid.N, grid.N), ddt).astype(dtype)
                    + 1j * jax.random.normal(kf2, (grid.N, grid.N),
                                             ddt).astype(dtype))
                alpha_w = jax.random.normal(
                    k_alpha, (grid.N, grid.N), ddt).astype(dtype)
            fg_map = ForegroundModel.foreground_amp_from_whitenoise(
                white2d, grid, cosmology.chi, config.fg_amp, config.fg_beta,
                config.fg_monopole, fg_sigma_pix,
            )
            if use_fg_poly:
                # Smooth only the tiny pixel-varying part (linear op:
                # algebraically identical to smoothing mean + std*w) and
                # keep every large spectral factor pixel-common.
                dalpha = config.spec_idx_std * gaussian_smooth_wrap(
                    alpha_w, alpha_sigma_pix)
                alpha_map = config.spec_idx_mean + dalpha
                fg_cube = ForegroundModel.construct_cube_smallalpha_fn(
                    fg_map, dalpha, ffac_mean_j, logf_j)
            else:
                alpha_map = (config.spec_idx_mean
                             + config.spec_idx_std * alpha_w)
                alpha_map = gaussian_smooth_wrap(alpha_map, alpha_sigma_pix)
                fg_cube = ForegroundModel.construct_cube_fn(
                    fg_map, alpha_map, freqs_j, config.freq_ref
                )
            data = data + fg_cube

        # (7) radiometer noise
        if config.include_noise:
            if rows_mode:
                data = data + row_normal(key, TAGS["noise"], 0, grid.N,
                                         (grid.N, grid.N), dtype, _rm) \
                    * sigma_j[None, None, :]
            elif config.threefry_noise:
                data = data + jax.random.normal(
                    k_noise, grid.shape, ddt).astype(dtype) \
                    * sigma_j[None, None, :]
            else:
                data = rsd_ops.add_scaled_normal(data, sigma_j, k_noise)

        # (7b) instrument response (config 3): per-channel Gaussian beam in
        # k_perp, and a k_par foreground-avoidance high-pass
        if config.beam_dish_m is not None:
            from .constants import C_MS

            lam = C_MS / (freqs * 1e6)
            fwhm = 1.22 * lam / config.beam_dish_m           # rad
            sigma_r = (fwhm / np.sqrt(8.0 * np.log(2.0))) * cosmology.chi
            sig_j = jnp.asarray(sigma_r, dtype)              # (Nfreq,) Mpc
            kperp2 = (kxv[:, None] ** 2
                      + kyv[: grid.N // 2 + 1][None, :] ** 2)
            dk2 = fft_safe.rfftn(data, axes=(0, 1))
            B = jnp.exp(-0.5 * kperp2[:, :, None] * (sig_j**2)[None, None, :])
            data = fft_safe.irfftn(dk2 * B, s=(grid.N, grid.N),
                                   axes=(0, 1)).astype(dtype)
        if config.kpar_min is not None:
            dkz = fft_safe.rfft(data, axis=2)
            T = 1.0 - jnp.exp(-0.5 * (kz_half / dtype.type(config.kpar_min)) ** 2)
            data = fft_safe.irfft(dkz * T[None, None, :], n=grid.N,
                                  axis=2).astype(dtype)

        boxf = jnp.asarray(grid.boxfactor, dtype)
        pre = {
            "data": data,
            "p_dens": (delta_k * jnp.conj(delta_k)).real / boxf,
            "sigma_data": jnp.std(data),
        }
        if want_cov:
            # np.cov with ddof=1 — exactly pca_filter's covariance
            # (filters/pca.py, same pca_precision resolution): the
            # hoisted path must feed the batched eigh the same matrix
            # the in-line path builds.
            d2 = data.reshape((-1, data.shape[-1])).T
            x = d2 - jnp.mean(d2, axis=-1, keepdims=True)
            pre["cov"] = jnp.matmul(x, x.T, precision=_pca_prec) \
                / (d2.shape[1] - 1)
        if config.debug_stages:
            pre.update(delta_x=delta_x, vel_z=vel_z, delta_s=delta_s)
            if config.include_foregrounds:
                pre.update(fg_cube=fg_cube, fg_map=fg_map,
                           alpha_map=alpha_map)
        return pre

    def fn_post(pre, U, bin_idx):
        """Stages (8)-(9): PCA clean and binned spectra.

        ``U = None`` computes the eigendecomposition inline (the plain
        single-shot path, via filters.pca); a precomputed ``U`` (the
        top-modes eigenvector block from the hoisted batched eigh)
        applies the identical projection clean without it.
        """
        data = pre["data"]

        # (8) PCA clean: exact eigh by default; block-power subspace
        # iteration is the opt-in perf knob (pca_exact=False — approximate
        # when trailing modes are degenerate, see PipelineConfig)
        if U is not None:
            # Projection clean with the hoisted eigenvectors — the same
            # arithmetic (and GEMM precision) as filters.pca.pca_filter.
            prec = _pca_prec
            shape = data.shape
            d2 = data.reshape((-1, shape[-1])).T
            d_mean = jnp.mean(d2, axis=-1, keepdims=True)
            x = d2 - d_mean
            fg_amps = jnp.matmul(U.T, x, precision=prec)
            fg_field = (jnp.matmul(U, fg_amps, precision=prec)
                        + d_mean).T.reshape(shape)
            cleaned = data - fg_field
        elif config.pca_exact:
            cleaned = pca_filter(data, config.pca_nmodes,
                                 precision=config.pca_precision)
        else:
            from .filters.pca import pca_filter_subspace

            cleaned = pca_filter_subspace(data, config.pca_nmodes)

        # (9) binned P(k) of the cleaned cube and the underlying density
        # (half-spectrum reductions, multiplicity-weighted: exactly the
        # full-grid convention of box.py:696-768; both cubes share one
        # histogram pass)
        boxf = jnp.asarray(grid.boxfactor, dtype)
        ck = fft_safe.rfftn(cleaned)
        p_clean = (ck * jnp.conj(ck)).real / boxf
        p_dens = pre["p_dens"]
        w = jnp.broadcast_to(kzw_j[None, None, :], p_clean.shape)
        s1, q1, s2, _, cnt = binned_weighted_dual(
            p_clean.ravel(), p_dens.ravel(), w.ravel(), bin_idx, nb)
        pk_clean = (s1 / cnt)[1:]
        if config.pk_debias is not None:
            pk_clean = pk_clean - jnp.asarray(config.pk_debias, dtype)
        var = jnp.maximum(q1 / cnt - (s1 / cnt) ** 2, 0.0)
        var = jnp.where(cnt > 1, var, 0.0)
        pk_err = (jnp.sqrt(var) / jnp.sqrt(cnt))[1:]
        pk_dens = (s2 / cnt)[1:]

        out = {
            "k": jnp.asarray(kcent[1:], dtype),
            "pk_cleaned": pk_clean,
            "pk_cleaned_err": pk_err,
            "pk_density": pk_dens,
            "sigma_data": pre["sigma_data"],
        }
        if config.debug_stages:
            out.update(
                {n: pre[n] for n in ("delta_x", "vel_z", "delta_s")},
                data=data, cleaned=cleaned,
                ck_power=p_clean,
            )
            if config.include_foregrounds:
                out["fg_cube"] = pre["fg_cube"]
                out["fg_map"] = pre["fg_map"]
                out["alpha_map"] = pre["alpha_map"]
        return out

    def fn_inner(key, amp_half, bin_idx):
        return fn_post(fn_pre(key, amp_half), None, bin_idx)

    fn_inner.pre = fn_pre
    fn_inner.post = fn_post
    return fn_inner, (amp_half, bin_idx_arg)


def make_pipeline(grid: GridSpec, cosmology: Cosmology,
                  config: PipelineConfig = PipelineConfig(), jit: bool = True):
    """Build the end-to-end mock pipeline as a pure function of a PRNG key.

    Returns ``fn(key) -> dict`` with the cleaned data cube's binned P(k)
    (k centroids are static and returned alongside), plus summary fields.
    With ``jit`` the function also has ``fn.lower(key)``, the lowered
    program (for ``.compile().memory_analysis()`` and the like).
    """
    fn_inner, consts = _build_pipeline(grid, cosmology, config)
    if not jit:
        return lambda key: fn_inner(key, *consts)
    inner = jax.jit(fn_inner)

    def fn(key):
        return inner(key, *consts)

    fn.lower = lambda key: inner.lower(key, *consts)
    return fn


def make_chained_pipeline(grid: GridSpec, cosmology: Cosmology,
                          config: PipelineConfig = PipelineConfig()):
    """``fn(keys[K]) -> dict`` running K pipelines SEQUENTIALLY in one
    program via ``lax.scan`` (outputs stacked on a leading axis).

    One dispatch per K realisations amortises the per-launch host
    overhead.  Unlike ``vmap`` ensembles the body keeps unbatched cube
    shapes, so it lowers exactly as the single-shot pipeline does.
    """
    fn_inner, consts = _build_pipeline(grid, cosmology, config)

    if config.eigh_hoist not in ("auto", "on", "off"):
        raise ValueError(f"Unknown eigh_hoist '{config.eigh_hoist}'")
    # 'auto' resolves to OFF (see PipelineConfig.eigh_hoist).
    use_hoist = (config.pca_exact and not config.debug_stages
                 and config.eigh_hoist == "on")

    if use_hoist:
        # Two scans around ONE batched eigh (PipelineConfig.eigh_hoist):
        # the per-realisation (Nfreq, Nfreq) eigh is latency-bound inside
        # the scan body (the device idles while it iterates on a tiny
        # matrix); hoisting turns K sequential eighs into one batched
        # decomposition.  Same estimator, same HIGHEST GEMMs — phase B
        # applies the identical projection clean.
        nmodes = config.pca_nmodes

        @jax.jit
        def chained(keys, amp_half, bin_idx):
            def body_a(carry, key):
                return carry, fn_inner.pre(key, amp_half, want_cov=True)

            _, pre = jax.lax.scan(body_a, None, keys)
            cov = pre.pop("cov")
            _, vecs = jnp.linalg.eigh(cov)          # (K, C, C), ascending
            pre["U"] = vecs[:, :, ::-1][:, :, :nmodes]

            def body_b(carry, xs):
                U = xs["U"]
                rest = {k: v for k, v in xs.items() if k != "U"}
                return carry, fn_inner.post(rest, U, bin_idx)

            _, outs = jax.lax.scan(body_b, None, pre)
            return outs

        return lambda keys: chained(keys, *consts)

    @jax.jit
    def chained(keys, amp_half, bin_idx):
        def body(carry, key):
            return carry, fn_inner(key, amp_half, bin_idx)

        _, outs = jax.lax.scan(body, None, keys)
        return outs

    return lambda keys: chained(keys, *consts)


def calibrate_pk_debias(grid: GridSpec, cosmology: Cosmology,
                        config_fast: PipelineConfig,
                        config_ref: PipelineConfig | None = None,
                        keys=(5000, 5001, 5002, 5003, 5004, 5005, 5006, 5007)):
    """Measure the additive per-bin bias of a fast (lower-precision)
    pipeline configuration against a reference configuration.

    Runs both configurations on the same held-out ``keys`` (use keys
    DISJOINT from any science/gate keys) and returns
    ``mean(pk_fast - pk_ref, axis=keys)`` as a tuple suitable for
    ``dataclasses.replace(config_fast, pk_debias=...)``.

    Motivation: low-precision DFT rounding is additive noise power — a
    systematic positive bias on the cleaned low bins — which is the one
    error class an estimator can subtract after calibration.
    ``config_ref`` defaults to ``config_fast`` with the precision knobs
    at full float32 and the native-FFT inverse pair.
    """
    import dataclasses as _dc

    if config_ref is None:
        config_ref = _dc.replace(config_fast, pca_precision="HIGHEST",
                                 fft_pair=False, pk_debias=None)
    config_fast = _dc.replace(config_fast, pk_debias=None)
    fn_fast = make_pipeline(grid, cosmology, config_fast)
    fn_ref = make_pipeline(grid, cosmology, config_ref)
    diffs = []
    for seed in keys:
        k = jax.random.PRNGKey(seed)
        pf = np.asarray(fn_fast(k)["pk_cleaned"], np.float64)
        pr = np.asarray(fn_ref(k)["pk_cleaned"], np.float64)
        diffs.append(pf - pr)
    return tuple(float(v) for v in np.mean(diffs, axis=0))


def make_ensemble_pipeline(grid: GridSpec, cosmology: Cosmology,
                           config: PipelineConfig = PipelineConfig(),
                           mesh=None, axis: str = "ens"):
    """Vmapped Monte-Carlo ensemble: ``fn(keys[B]) -> dict`` of stacked outputs.

    With ``mesh`` given, the key batch (and all derived cubes) is sharded
    over ``axis`` — pure data parallelism over realisations, the BASELINE
    throughput configuration.
    """
    single = make_pipeline(grid, cosmology, config, jit=False)

    batched = jax.vmap(single)

    if mesh is None:
        return jax.jit(batched)

    from jax.sharding import NamedSharding, PartitionSpec as P

    keys_sharding = NamedSharding(mesh, P(axis))
    return jax.jit(batched, in_shardings=(keys_sharding,))
