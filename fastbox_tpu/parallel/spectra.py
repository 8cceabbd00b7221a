"""Distributed spectrum estimators for slab-sharded cubes.

The reference runs its estimators through nbodykit's MPI-parallel FFTPower
and FFTCorr (SURVEY.md §2.3; examples/example_halos.py, example_corr_fn.py)
— the one genuinely distributed component it has.  These factories are the
SPMD counterparts for cubes that live sharded over a ``'space'`` mesh
axis (e.g. the output of ``parallel.make_sharded_cola`` at >= 1024^3, where
gathering the cube to one chip or the host is not an option):

  * one distributed rfft half-spectrum (all-to-all slab transposes,
    parallel/fft.py), never the full C2C grid;
  * kz-multiplicity weights make the half-grid reductions EXACTLY equal to
    the full-grid sums of the single-device estimators (ops/spectra.py),
    including odd Legendre multipoles via the even-part pairing rule
    ``L(mu) + (w - 1) L(-mu)`` (an interior half-grid mode stands for the
    +-k pair, whose mu's are opposite);
  * per-bin sums ``psum`` over 'space'; outputs are replicated scalars/
    vectors.

Each factory returns a jitted function — build once, call per realisation
(the single-device estimators are ``@jit`` module functions; here the mesh
and binning are baked into the closure).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..grid import GridSpec
from ..ops.reduce import binned_sums
from ..ops.spectra import _legendre, _linear_kbins, _norm_los
from .fft import pirfft3_local, prfft3_local

__all__ = [
    "make_sharded_power_spectrum",
    "make_sharded_power_multipoles",
    "make_sharded_correlation",
]


def _slab_geometry(mesh: Mesh, grid: GridSpec):
    nshards = mesh.shape["space"]
    N = grid.N
    assert N % nshards == 0, f"N={N} must divide over space={nshards}"
    return nshards, N, N // nshards, N // 2 + 1


def _k_consts(grid: GridSpec):
    """1-D spectral constants (host numpy): k vectors, kz multiplicity, and
    the PARTNER-mode vectors.

    A half-grid mode with interior kz (multiplicity 2) stands for the +-k
    pair.  The partner's frequency vector negates every component — except
    on the x/y Nyquist planes, where index N/2 is its own negation (the
    fftfreq convention keeps it at -N/2), so the partner's kx/ky stay put.
    mu-dependent statistics must evaluate the partner at these
    fixed-point-aware vectors, not at -k.
    """
    N = grid.N
    H = N // 2 + 1
    kx = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lx
    ky = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Ly
    kz = (2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lz)[:H].copy()
    nyq = np.zeros(N, bool)
    if N % 2 == 0:
        nyq[N // 2] = True
    kxp = np.where(nyq, kx, -kx)
    kyp = np.where(nyq, ky, -ky)
    w = np.full(H, 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    return kx, ky, kz, w, kxp, kyp


def _local_kgrid(kx_np, ky_np, kz_np, dtype, row0, Np):
    kx = lax.dynamic_slice_in_dim(jnp.asarray(kx_np, dtype), row0, Np)
    ky = jnp.asarray(ky_np, dtype)
    kz = jnp.asarray(kz_np, dtype)
    kmag = jnp.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                    + kz[None, None, :] ** 2)
    return kx, ky, kz, kmag


def _half_power(x, second, axis_name, boxfactor, dtype):
    """Re(d1_k conj d2_k)/boxfactor on the local half-spectrum slab."""
    if second is None:
        d1 = prfft3_local(x[None], axis_name)[0]
        d2 = d1
    else:
        both = prfft3_local(jnp.stack([x, second]), axis_name)
        d1, d2 = both[0], both[1]
    return (d1 * jnp.conj(d2)).real / dtype.type(boxfactor)


def make_sharded_power_spectrum(mesh: Mesh, grid: GridSpec,
                                dk: float | None = None, kmin: float = 0.0,
                                kmax: float | None = None, nmu: int = 1,
                                exclude_zero: bool = True,
                                los: tuple = (0, 0, 1),
                                cross: bool = False, dtype=jnp.float64):
    """Distributed P(k) / P(k, mu) (the nbodykit-FFTPower-over-MPI analog).

    Returns ``fn(delta_x[, second]) -> dict`` with the same keys and values
    as ``ops.spectra.power_spectrum`` (exactly equal on matched inputs —
    tested), where ``delta_x`` is (N, N, N) sharded over ``mesh['space']``.
    """
    nshards, N, Np, H = _slab_geometry(mesh, grid)
    dtype = jnp.dtype(dtype)
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kx_np, ky_np, kz_np, w_np, kxp_np, kyp_np = _k_consts(grid)
    lx, ly, lz = _norm_los(los)
    boxfactor = grid.boxfactor

    def step(*fields):
        row0 = lax.axis_index("space") * Np
        kx, ky, kz, kmag = _local_kgrid(kx_np, ky_np, kz_np, dtype, row0, Np)
        w = jnp.broadcast_to(jnp.asarray(w_np, dtype)[None, None, :],
                             kmag.shape).ravel()

        p = _half_power(fields[0], fields[1] if cross else None, "space",
                        boxfactor, dtype).ravel()
        km = kmag.ravel()
        kidx = jnp.searchsorted(jnp.asarray(edges, dtype), km,
                                side="right") - 1
        kidx = jnp.where((kidx < 0) | (kidx >= nk), nk, kidx)
        if exclude_zero:
            kidx = jnp.where(km == 0.0, nk, kidx)

        def mu_bins(kxv, kyv, kzsign):
            kdotl = (kxv[:, None, None] * dtype.type(lx)
                     + kyv[None, :, None] * dtype.type(ly)
                     + kzsign * kz[None, None, :] * dtype.type(lz)).ravel()
            mu = jnp.abs(jnp.where(km > 0.0,
                                   kdotl / jnp.where(km > 0, km, 1.0), 0.0))
            muidx = jnp.clip((mu * nmu).astype(jnp.int32), 0, nmu - 1)
            return mu, jnp.where(kidx >= nk, nk * nmu, kidx * nmu + muidx)

        if nmu > 1:
            # Two scatters: each half-grid mode at its own mu, and its
            # pair partner (weight w-1) at the partner's mu — which is
            # NOT -mu on the x/y Nyquist planes (see _k_consts).
            kxp = lax.dynamic_slice_in_dim(jnp.asarray(kxp_np, dtype),
                                           row0, Np)
            kyp = jnp.asarray(kyp_np, dtype)
            mu1, flat1 = mu_bins(kx, ky, dtype.type(1.0))
            mu2, flat2 = mu_bins(kxp, kyp, dtype.type(-1.0))
            ntot = nk * nmu

            def both(v1, v2):
                s = binned_sums(v1, flat1, ntot) \
                    + binned_sums(v2 * (w - 1.0), flat2, ntot)
                return lax.psum(s, "space")

            psum_ = both(p, p)
            ksum = both(km, km)
            count = both(jnp.ones_like(p), jnp.ones_like(p))
            musum = both(mu1, mu2)
            return {
                "k_edges": jnp.asarray(edges, dtype),
                "power": (psum_ / count).reshape(nk, nmu),
                "k": (ksum / count).reshape(nk, nmu),
                "mu": (musum / count).reshape(nk, nmu),
                "modes": count.reshape(nk, nmu),
            }

        psum_ = lax.psum(binned_sums(p * w, kidx, nk), "space")
        ksum = lax.psum(binned_sums(km * w, kidx, nk), "space")
        count = lax.psum(binned_sums(w, kidx, nk), "space")
        return {
            "k_edges": jnp.asarray(edges, dtype),
            "power": psum_ / count,
            "k": ksum / count,
            "modes": count,
        }

    nin = 2 if cross else 1
    outspec = {"k_edges": P(), "power": P(), "k": P(), "modes": P()}
    if nmu > 1:
        outspec["mu"] = P()
    sharded = shard_map(step, mesh=mesh, in_specs=(P("space"),) * nin,
                        out_specs=outspec, check_vma=False)
    return jax.jit(sharded)


def make_sharded_power_multipoles(mesh: Mesh, grid: GridSpec,
                                  poles=(0, 2, 4), dk: float | None = None,
                                  kmin: float = 0.0,
                                  kmax: float | None = None,
                                  los: tuple = (0, 0, 1),
                                  cross: bool = False, dtype=jnp.float64):
    """Distributed P_l(k) multipoles, equal to ``ops.spectra.power_multipoles``.

    Odd multipoles: an interior half-grid mode carries the +-k pair whose
    mu's are opposite, so its Legendre weight is ``L(mu) + L(-mu)`` (zero
    for odd l) while the self-conjugate kz planes (multiplicity 1) keep
    ``L(mu)`` — the pairing rule ``L(mu) + (w - 1) L(-mu)``.
    """
    nshards, N, Np, H = _slab_geometry(mesh, grid)
    dtype = jnp.dtype(dtype)
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1
    kx_np, ky_np, kz_np, w_np, kxp_np, kyp_np = _k_consts(grid)
    lx, ly, lz = _norm_los(los)
    boxfactor = grid.boxfactor

    def step(*fields):
        row0 = lax.axis_index("space") * Np
        kx, ky, kz, kmag = _local_kgrid(kx_np, ky_np, kz_np, dtype, row0, Np)
        w = jnp.broadcast_to(jnp.asarray(w_np, dtype)[None, None, :],
                             kmag.shape).ravel()

        p = _half_power(fields[0], fields[1] if cross else None, "space",
                        boxfactor, dtype).ravel()
        km = kmag.ravel()

        def mu_of(kxv, kyv, kzsign):
            kdotl = (kxv[:, None, None] * dtype.type(lx)
                     + kyv[None, :, None] * dtype.type(ly)
                     + kzsign * kz[None, None, :] * dtype.type(lz)).ravel()
            return jnp.where(km > 0.0, kdotl / jnp.where(km > 0, km, 1.0),
                             0.0)

        mu1 = mu_of(kx, ky, dtype.type(1.0))
        kxp = lax.dynamic_slice_in_dim(jnp.asarray(kxp_np, dtype), row0, Np)
        kyp = jnp.asarray(kyp_np, dtype)
        mu2 = mu_of(kxp, kyp, dtype.type(-1.0))

        kidx = jnp.searchsorted(jnp.asarray(edges, dtype), km,
                                side="right") - 1
        kidx = jnp.where((kidx < 0) | (kidx >= nk) | (km == 0.0), nk, kidx)

        count = lax.psum(binned_sums(w, kidx, nk), "space")
        ksum = lax.psum(binned_sums(km * w, kidx, nk), "space")
        out = {"k_edges": jnp.asarray(edges, dtype), "k": ksum / count,
               "modes": count}
        for ell in poles:
            # Each half-grid mode contributes L(mu) for itself and
            # (w-1) L(mu_partner) for its +-k pair partner (mu_partner is
            # -mu only away from the x/y Nyquist planes — see _k_consts).
            lw = _legendre(ell, mu1) + (w - 1.0) * _legendre(ell, mu2)
            wp = lax.psum(binned_sums(p * lw, kidx, nk), "space")
            out[f"power_{ell}"] = (2 * ell + 1) * wp / count
        return out

    nin = 2 if cross else 1
    outspec = {"k_edges": P(), "k": P(), "modes": P()}
    for ell in poles:
        outspec[f"power_{ell}"] = P()
    sharded = shard_map(step, mesh=mesh, in_specs=(P("space"),) * nin,
                        out_specs=outspec, check_vma=False)
    return jax.jit(sharded)


def make_sharded_correlation(mesh: Mesh, grid: GridSpec, dr: float = 2.0,
                             rmin: float = 0.0, rmax: float | None = None,
                             poles=None, los: tuple = (0, 0, 1),
                             cross: bool = False, dtype=jnp.float64):
    """Distributed xi(r) (and optional xi_l(r) with ``poles``), equal to
    ``ops.spectra.correlation_function`` / ``correlation_multipoles``.

    xi3d = irfft(d1_k conj d2_k)/N^3 on the slab (the product of Hermitian
    spectra is Hermitian, so the half-spectrum inverse is exact), binned by
    minimum-image |r| with the x coordinate sliced per slab.
    """
    nshards, N, Np, H = _slab_geometry(mesh, grid)
    dtype = jnp.dtype(dtype)
    if rmax is None:
        rmax = 0.5 * min(grid.Lx, grid.Ly, grid.Lz)
    edges = np.arange(rmin, rmax + dr, dr, dtype=np.float64)
    nr = edges.size - 1
    nidx = np.fft.fftfreq(N, 1.0) * N
    rx_np = nidx * (grid.Lx / N)
    ry_np = nidx * (grid.Ly / N)
    rz_np = nidx * (grid.Lz / N)
    lx, ly, lz = _norm_los(los)

    def step(*fields):
        row0 = lax.axis_index("space") * Np
        if cross:
            both = prfft3_local(jnp.stack([fields[0], fields[1]]), "space")
            ph = both[0] * jnp.conj(both[1])
        else:
            d1 = prfft3_local(fields[0][None], "space")[0]
            ph = d1 * jnp.conj(d1)
        xi3d = pirfft3_local(ph[None], N, "space")[0].real / dtype.type(N**3)

        rx = lax.dynamic_slice_in_dim(jnp.asarray(rx_np, dtype), row0, Np)
        ry = jnp.asarray(ry_np, dtype)
        rz = jnp.asarray(rz_np, dtype)
        rmag = jnp.sqrt(rx[:, None, None] ** 2 + ry[None, :, None] ** 2
                        + rz[None, None, :] ** 2).ravel()
        ridx = jnp.searchsorted(jnp.asarray(edges, dtype), rmag,
                                side="right") - 1
        ridx = jnp.where((ridx < 0) | (ridx >= nr), nr, ridx)

        x = xi3d.ravel()
        count = lax.psum(binned_sums(jnp.ones_like(x), ridx, nr), "space")
        rsum = lax.psum(binned_sums(rmag, ridx, nr), "space")
        out = {"r_edges": jnp.asarray(edges, dtype), "r": rsum / count,
               "modes": count}
        if poles is None:
            out["corr"] = lax.psum(binned_sums(x, ridx, nr), "space") / count
        else:
            rdotl = (rx[:, None, None] * dtype.type(lx)
                     + ry[None, :, None] * dtype.type(ly)
                     + rz[None, None, :] * dtype.type(lz)).ravel()
            mu = jnp.where(rmag > 0.0, rdotl / jnp.where(rmag > 0, rmag, 1.0),
                           0.0)
            for ell in poles:
                xw = x * _legendre(ell, mu)
                out[f"corr_{ell}"] = ((2 * ell + 1)
                                      * lax.psum(binned_sums(xw, ridx, nr),
                                                 "space") / count)
        return out

    nin = 2 if cross else 1
    outspec = {"r_edges": P(), "r": P(), "modes": P()}
    if poles is None:
        outspec["corr"] = P()
    else:
        for ell in poles:
            outspec[f"corr_{ell}"] = P()
    sharded = shard_map(step, mesh=mesh, in_specs=(P("space"),) * nin,
                        out_specs=outspec, check_vma=False)
    return jax.jit(sharded)
