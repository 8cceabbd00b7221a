"""Fully-SPMD multi-chip ensemble pipeline (shard_map over an ('ens','space') mesh).

This is the scaling path for boxes that do not fit one chip (>= 1024^3) and
for Monte-Carlo ensemble throughput: the whole
realize -> bias/lognormal -> velocity -> RSD -> foregrounds -> noise ->
beam/kpar response -> PCA clean -> binned P(k) step runs inside a single
``shard_map`` program:

  * 'ens'   — data parallelism over realisations (no communication)
  * 'space' — slab decomposition of the leading spatial axis; 3D/2D FFTs use
              all-to-all transposes (parallel/fft.py); global
              reductions (lognormal mean, PCA covariance, P(k) bins,
              sigma_data) psum over 'space'; per-LOS ops (RSD, k_par
              filters) stay local because the z axis is never sharded.

Every noise field is drawn with the mesh-independent row-keyed scheme
(parallel/rng.py), so a realisation is a function of its key alone: the
single-chip pipeline in ``noise_scheme='rows'`` mode produces bit-comparable
fields for the same key (asserted by tests/test_parallel.py), and results
do not change with the device count.

Full ``PipelineConfig`` support: ``rsd_method``, ``beam_dish_m``,
``kpar_min`` and ``pca_exact`` are honored identically to the single-chip
pipeline (pipeline.py:229-256); nothing is silently dropped.

The replaced reference machinery: nbodykit's MPI slab FFTs and every
Python-loop stage (SURVEY.md §2.3, §5.7-5.8).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..ops import fft_safe
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..cosmology import Cosmology
from ..grid import GridSpec
from ..models import noise as noise_mod
from ..models.foregrounds import _scipy_gaussian_kernel1d
from ..ops.reduce import binned_weighted_sum_sumsq_count
from ..ops.rsd import remap_los_batched
from ..ops.spectra import _index_sq, default_kbins, kbin_thresholds
from ..pipeline import PipelineConfig, _hi_bias, _hi_tb
from .fft import pfft2_local, pifft2_local, pirfft3_local, prfft3_local
from .rng import TAGS, default_row_method, row_normal

__all__ = ["make_sharded_ensemble_step"]


def _subspace_from_cov(cov, nmodes: int):
    """Top-``nmodes`` eigenvectors of the psum-reduced covariance — the
    same oversampled subspace + Rayleigh-Ritz algorithm (and defaults) as
    filters.pca.pca_filter_subspace, so the sharded ``pca_exact=False``
    path matches the single-chip one exactly."""
    from ..filters.pca import topk_eigvecs_subspace

    return topk_eigvecs_subspace(cov, nmodes)


def make_sharded_ensemble_step(mesh: Mesh, grid: GridSpec, cosmology: Cosmology,
                               config: PipelineConfig = PipelineConfig()):
    """Build the jitted multi-chip ensemble step.

    Returns ``fn(keys) -> dict`` where ``keys`` has shape (B,) with B a
    multiple of the 'ens' mesh axis, sharded over 'ens'; each realisation's
    cube is slab-sharded over 'space'.
    """
    dtype = jnp.dtype(config.dtype)
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    N = grid.N
    space = mesh.shape["space"]
    assert N % space == 0, f"N={N} must be divisible by space axis {space}"
    Np = N // space

    z = grid.redshift
    bias = float(config.bias if config.bias is not None else _hi_bias(z))
    Tb = float(_hi_tb(z))
    Hz = 100.0 * cosmology.h * cosmology.Ea
    vel_fac = (100.0 * cosmology.h * cosmology.Ea * cosmology.growth_rate
               * cosmology.scale_factor)
    pk_fn = cosmology.pk_lin if config.linear_pk else cosmology.pk_nl

    # Host-side constants (replicated into the SPMD program).  All spectral
    # work runs on the rfft half-spectrum over the (unsharded) z axis: half
    # the FFT flops and half the all-to-all bytes of the full grid.
    H = N // 2 + 1
    kx_full = np.asarray(2.0 * np.pi * grid.fft_index / grid.Lx)
    ky_full = np.asarray(2.0 * np.pi * grid.fft_index / grid.Ly)
    # fft_index[:H] ends with the -N/2 Nyquist entry for even N — the same
    # signed convention the single-chip path gets from grid.kvec()[:H]
    # (the plane is zeroed below anyway, box.py:268-274).
    kz_half = np.asarray(2.0 * np.pi * grid.fft_index / grid.Lz)[:H].copy()
    nyq_z = np.zeros(H, dtype=bool)
    if N % 2 == 0:
        nyq_z[-1] = True
    # Mode multiplicity along the half axis (interior modes count twice)
    kz_weight = np.full(H, 2.0)
    kz_weight[0] = 1.0
    if N % 2 == 0:
        kz_weight[-1] = 1.0
    zgrid = np.asarray(grid.z)

    freqs = grid.freq_array(cosmology)
    ang_x, _ = grid.pixel_array(cosmology)
    dang = ang_x[1] - ang_x[0]
    sigma_rms = noise_mod.radiometer_sigma(
        freqs, ang_x, config.Tinst, config.tp_hours, config.fov_deg2,
        config.Ndish)
    freqs_c = jnp.asarray(freqs.copy(), dtype)
    sigma_c = jnp.asarray(sigma_rms, dtype)

    # Instrument response constants (config 3), mirroring pipeline.py
    beam_sig_r = None
    if config.beam_dish_m is not None:
        from ..constants import C_MS

        lam = C_MS / (freqs * 1e6)
        fwhm = 1.22 * lam / config.beam_dish_m               # rad
        beam_sig_r = (fwhm / np.sqrt(8.0 * np.log(2.0))) * cosmology.chi

    # Smoothing kernels (FFT of scipy's truncated wrap-mode kernel)
    fg_kern = np.fft.fft(_scipy_gaussian_kernel1d(config.fg_smoothing_deg / dang, N))
    al_kern = np.fft.fft(
        _scipy_gaussian_kernel1d(config.spec_idx_smoothing_deg / dang, N))

    # Foreground spectral factors (config parity with pipeline.py's
    # fg_spectral='poly' path): the generic f32 (nu/ref)**alpha carries
    # pixel-decorrelated exp/log rounding that dominates the cleaned
    # low bins (truth gate at 256^3: 1.77e-2 -> 1.26e-3).  Keep
    # the large pixel-common factors in host f64 and evaluate only the
    # tiny pixel-varying exp(dalpha*logf) by a cubic Taylor polynomial.
    if config.fg_spectral not in ("poly", "pow"):
        raise ValueError(f"Unknown fg_spectral '{config.fg_spectral}'")
    _logf = np.log(np.asarray(freqs, np.float64) / config.freq_ref)
    use_fg_poly = (config.fg_spectral == "poly"
                   and 8.0 * config.spec_idx_std * np.abs(_logf).max() < 1e-2)
    ffac_mean_c = jnp.asarray(
        np.power(np.asarray(freqs, np.float64) / config.freq_ref,
                 config.spec_idx_mean), dtype)
    logf_c = jnp.asarray(_logf, dtype)

    kbins = default_kbins(grid, config.nbins)
    # Exact integer-lattice bin classification on cubic grids — the same
    # plan the single-chip pipeline uses (ops/spectra.kbin_thresholds),
    # so sharded and single-chip runs bin identically in every dtype.
    bin_thr = kbin_thresholds(grid, kbins)
    fi2_int = None if bin_thr is None else _index_sq(grid)
    nb = kbins.size
    _edges = np.concatenate([[0.0], kbins])
    kcent = 0.5 * (_edges[1:] + _edges[:-1])

    boxfactor = grid.boxfactor
    npix_total = N * N

    def step(keys_local):
        s = lax.axis_index("space")
        row0 = s * Np
        B_loc = keys_local.shape[0]

        _method = default_row_method(N)

        def draw(tag, row_shape):
            return jax.vmap(
                lambda k: row_normal(k, tag, row0, Np, row_shape, dtype,
                                     _method)
            )(keys_local)

        kx_loc = lax.dynamic_slice_in_dim(jnp.asarray(kx_full, dtype), row0, Np)
        ky = jnp.asarray(ky_full, dtype)
        kzh = jnp.asarray(kz_half, dtype)
        k2_loc = (kx_loc[:, None, None] ** 2 + ky[None, :, None] ** 2
                  + kzh[None, None, :] ** 2)          # (Np, N, H)
        kmag_loc = jnp.sqrt(k2_loc)

        # --- (1) Gaussian realisation --------------------------------
        # Row-keyed real white noise rfft'd to a Hermitian half-spectrum:
        # one half-FFT replaces the full ifft+fft round trip, with identical
        # statistics to the reference's complex draw + .real projection
        # (box.py:174-193).
        white = draw(TAGS["density"], (N, N))         # (B, Np, N, N) real
        white_h = prfft3_local(white, "space") \
            * dtype.type(N ** -1.5)                    # unit-variance Hermitian
        amp = jnp.sqrt(jnp.nan_to_num(pk_fn(kmag_loc)) * dtype.type(boxfactor))
        delta_k = white_h * amp[None]                  # (B, Np, N, H)
        delta_x = pirfft3_local(delta_k, N, "space").astype(dtype)

        # --- (2) bias + lognormal (global mean over the cube) --------
        e = jnp.exp(delta_x * dtype.type(bias))
        mean_e = lax.psum(jnp.sum(e, axis=(1, 2, 3)), "space") / N**3
        delta_ln = e / mean_e[:, None, None, None] - 1.0

        # --- (3) LOS velocity ----------------------------------------
        inv_k2 = jnp.where(k2_loc > 0, 1.0 / jnp.where(k2_loc > 0, k2_loc, 1.0), 0.0)
        vz_k = (1j * dtype.type(vel_fac)) * delta_k * (kzh[None, None, :] * inv_k2)
        vz_k = jnp.where(jnp.asarray(nyq_z)[None, None, None, :], 0.0, vz_k)
        vel_z = pirfft3_local(vz_k, N, "space").astype(dtype)

        # --- (4) RSD remap (fully local: LOS axis unsharded) ---------
        vel = vel_z
        if config.sigma_nl > 0.0:
            vel = vel + dtype.type(config.sigma_nl) * draw(TAGS["sigma_nl"],
                                                           (N, N))
        svals = jnp.asarray(zgrid, dtype)[None, None, None, :] - vel / dtype.type(Hz)
        L_z = zgrid[-1] - zgrid[0]
        svals = (svals - dtype.type(zgrid[0])) % dtype.type(L_z) + dtype.type(zgrid[0])
        fill = 0.5 * (delta_ln[..., 0] + delta_ln[..., -1])
        delta_s = remap_los_batched(
            delta_ln.reshape(-1, N), svals.reshape(-1, N),
            jnp.asarray(zgrid, dtype), fill.reshape(-1),
            method=config.rsd_method, ztarget_np=zgrid,
        ).reshape(delta_ln.shape)

        data = dtype.type(Tb) * (1.0 + delta_s)

        # --- (5) foregrounds (distributed 2D FFT) --------------------
        if config.include_foregrounds:
            white2d = (draw(TAGS["fg_re"], (N,))
                       + 1j * draw(TAGS["fg_im"], (N,)))  # (B, Np, N)
            alpha_w = draw(TAGS["alpha"], (N,))
            k_perp = jnp.sqrt(kx_loc[:, None] ** 2 + ky[None, :] ** 2)
            ell = 0.5 * k_perp * dtype.type(cosmology.chi) / 1000.0
            C_ell = jnp.where(
                ell > 0,
                dtype.type(config.fg_amp)
                * jnp.where(ell > 0, ell, 1.0) ** dtype.type(config.fg_beta),
                0.0,
            ) * dtype.type(N**4 / (grid.Lx * grid.Ly))
            fgk_loc = lax.dynamic_slice_in_dim(jnp.asarray(fg_kern), row0, Np)
            alk_loc = lax.dynamic_slice_in_dim(jnp.asarray(al_kern), row0, Np)
            fg_k = (white2d * jnp.sqrt(C_ell)[None]
                    * fgk_loc[None, :, None] * jnp.asarray(fg_kern)[None, None, :])
            fg_x = pifft2_local(fg_k, "space").real.astype(dtype) \
                + dtype.type(config.fg_monopole)
            alpha_k = pfft2_local(
                (dtype.type(config.spec_idx_std) * alpha_w).astype(cdtype), "space")
            dalpha = pifft2_local(
                alpha_k * alk_loc[None, :, None] * jnp.asarray(al_kern)[None, None, :],
                "space").real.astype(dtype)
            if use_fg_poly:
                u = dalpha[..., None] * logf_c[None, None, None, :]
                one_sixth = jnp.asarray(1.0 / 6.0, dtype)
                expu = 1.0 + u * (1.0 + u * (0.5 + u * one_sixth))
                ffac = ffac_mean_c[None, None, None, :] * expu
            else:
                alpha = dalpha + dtype.type(config.spec_idx_mean)
                ffac = (freqs_c[None, None, None, :]
                        / dtype.type(config.freq_ref)) ** alpha[..., None]
            data = data + fg_x[..., None] * ffac

        # --- (6) radiometer noise ------------------------------------
        if config.include_noise:
            data = data + draw(TAGS["noise"], (N, N)) * sigma_c[None, None, None, :]

        # --- (6b) instrument response (config 3): per-channel Gaussian
        # beam in k_perp (distributed 2D FFT over the sharded pixel
        # plane), and a k_par foreground-avoidance high-pass (local z)
        if beam_sig_r is not None:
            sig2 = jnp.asarray(beam_sig_r, dtype) ** 2          # (Nfreq,)
            kperp2 = (kx_loc[:, None] ** 2 + ky[None, :] ** 2)  # (Np, N)
            Bfac = jnp.exp(-0.5 * kperp2[None, :, :, None] * sig2[None, None, None, :])
            dk2 = pfft2_local(data.astype(cdtype), "space")
            data = pifft2_local(dk2 * Bfac, "space").real.astype(dtype)
        if config.kpar_min is not None:
            dkz = fft_safe.rfft(data, axis=3)
            T = 1.0 - jnp.exp(-0.5 * (kzh / dtype.type(config.kpar_min)) ** 2)
            data = fft_safe.irfft(dkz * T[None, None, None, :], n=N,
                                 axis=3).astype(dtype)

        # --- (7) PCA clean (covariance psum'd over pixels) -----------
        d2 = data.reshape(B_loc, Np * N, N)  # (B, pix_loc, Nfreq)
        mean_spec = lax.psum(jnp.sum(d2, axis=1), "space") / npix_total
        x = d2 - mean_spec[:, None, :]
        # Same pca_precision resolution as the single-chip pipeline
        # (filters/pca.py: a reduced-precision GEMM here moves the
        # cleaned P(k) low bins far above the f32 floor)
        _prec = (jax.lax.Precision.HIGHEST
                 if config.pca_precision is None
                 else getattr(jax.lax.Precision, config.pca_precision))
        cov = lax.psum(jnp.einsum("bpf,bpg->bfg", x, x, precision=_prec),
                       "space") / (npix_total - 1)
        if config.pca_exact:
            _, vecs = jax.vmap(jnp.linalg.eigh)(cov)
            U = vecs[:, :, ::-1][:, :, : config.pca_nmodes]  # (B, Nf, nmodes)
        else:
            U = jax.vmap(lambda c: _subspace_from_cov(c, config.pca_nmodes))(cov)
        proj = jnp.einsum("bpf,bfm->bpm", x, U, precision=_prec)
        fg_fit = jnp.einsum("bpm,bfm->bpf", proj, U, precision=_prec) \
            + mean_spec[:, None, :]
        cleaned = (d2 - fg_fit).reshape(B_loc, Np, N, N)

        # --- (8) binned P(k): cleaned cube + underlying density ------
        # Half-spectrum reduction with kz multiplicity weights: exactly the
        # full-grid mean/stddev convention of box.py:696-768.
        ck = prfft3_local(cleaned, "space")
        p_clean = (ck * jnp.conj(ck)).real / dtype.type(boxfactor)
        p_dens = (delta_k * jnp.conj(delta_k)).real / dtype.type(boxfactor)
        if bin_thr is not None:
            fi2_j = jnp.asarray(fi2_int)
            fx2_loc = lax.dynamic_slice_in_dim(fi2_j, row0, Np)
            m_loc = (fx2_loc[:, None, None] + fi2_j[None, :, None]
                     + fi2_j[:H][None, None, :])
            idx = jnp.searchsorted(jnp.asarray(bin_thr), m_loc.ravel(),
                                   side="right")
        else:
            idx = jnp.searchsorted(jnp.asarray(kbins, dtype),
                                   kmag_loc.ravel(), side="right")
        wgt = jnp.broadcast_to(jnp.asarray(kz_weight, dtype)[None, None, :],
                               p_clean.shape[1:]).ravel()

        def bin_one(p):
            return binned_weighted_sum_sumsq_count(p.ravel(), wgt, idx, nb)

        sums, sumsqs, counts = jax.vmap(bin_one)(p_clean)
        sums = lax.psum(sums, "space")
        sumsqs = lax.psum(sumsqs, "space")
        counts = lax.psum(counts, "space")
        pk_mean = sums / counts
        var = jnp.maximum(sumsqs / counts - pk_mean**2, 0.0)
        var = jnp.where(counts > 1, var, 0.0)
        pk_err = jnp.sqrt(var) / jnp.sqrt(counts)

        dsums, _, _ = jax.vmap(bin_one)(p_dens)
        dsums = lax.psum(dsums, "space")
        pk_dens = dsums / counts

        # Global sigma of the data cube (matches the single-chip
        # jnp.std(data): ddof=0 over all N^3 voxels)
        dsum = lax.psum(jnp.sum(data, axis=(1, 2, 3)), "space")
        dsq = lax.psum(jnp.sum(data**2, axis=(1, 2, 3)), "space")
        dmean = dsum / N**3
        sigma_data = jnp.sqrt(jnp.maximum(dsq / N**3 - dmean**2, 0.0))

        return {
            "k": jnp.asarray(kcent[1:], dtype),
            "pk_cleaned": pk_mean[:, 1:],
            "pk_cleaned_err": pk_err[:, 1:],
            "pk_density": pk_dens[:, 1:],
            "sigma_data": sigma_data,
        }

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=P("ens"),
        out_specs={
            "k": P(),
            "pk_cleaned": P("ens"),
            "pk_cleaned_err": P("ens"),
            "pk_density": P("ens"),
            "sigma_data": P("ens"),
        },
        check_vma=False,
    )

    keys_sharding = NamedSharding(mesh, P("ens"))
    return jax.jit(sharded, in_shardings=(keys_sharding,))
