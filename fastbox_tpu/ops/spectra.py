"""On-device power-spectrum and correlation-function estimators (L5).

Two families live here:

1. ``binned_power_spectrum`` — exact convention-match of the reference's
   in-repo estimator (box.py:696-768), with the O(nbins * N^3) digitize loop
   replaced by a single-pass one-hot-matmul histogram (ops/reduce.py).

2. ``power_spectrum`` / ``power_multipoles`` / ``correlation_function`` /
   ``correlation_multipoles`` — the native replacement for the external
   nbodykit ``FFTPower``/``FFTCorr`` estimators that every reference example
   leans on (examples/example_box.py:48-52, example_halos.py:46-53,
   example_corr_fn.py:12-47, example_endtoend.py:122-151; README.md:42-43).
   These compute auto- and cross-spectra, P(k, mu), multipoles P_l(k) via
   Legendre weights, and xi(r) multipoles by inverse-FFT of the 3D power —
   all on device, so Monte Carlo ensembles never leave HBM.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from . import fft_safe
import numpy as np

from ..grid import GridSpec
from .reduce import binned_sum_sumsq_count, binned_sums

__all__ = [
    "binned_power_spectrum",
    "kbin_thresholds",
    "power_spectrum",
    "power_multipoles",
    "correlation_function",
    "correlation_multipoles",
]


# ----------------------------------------------------------------------
# Reference-convention 1D estimator
# ----------------------------------------------------------------------
def default_kbins(grid: GridSpec, nbins: int = 20) -> np.ndarray:
    """Log-spaced bin edges on [kmin, kmax] (box.py:749)."""
    return np.logspace(np.log10(grid.kmin), np.log10(grid.kmax), nbins)


def kbin_thresholds(grid: GridSpec, bins) -> np.ndarray | None:
    """Integer-lattice bin-classification thresholds for cubic grids.

    On a cubic grid every mode's |k| is ``kappa*sqrt(m)`` with
    ``kappa = 2 pi / L`` and ``m = i^2 + j^2 + l^2`` an exact integer, so
    the digitize test ``bins[b] <= |k|`` (searchsorted side='right') is
    exactly ``T_b <= m`` with ``T_b = ceil((bins[b]/kappa)^2)`` computed
    once in f64 on host (a 1e-12 relative inclusion tolerance classifies
    an edge *within f64 rounding of a lattice value* into the bin it
    bounds).  Classifying the integer ``m`` instead of a floating |k|
    makes the binning EXACT and identical across dtypes, platforms and
    kernels for every N <= 4096 (m < 2^24, so even f32 holds it).

    Why this exists (round 4): ``np.logspace(log10(kmin), ...)`` puts
    the first edge one f64 ulp ABOVE kmin = the fundamental frequency,
    so f64 digitize (the reference convention, box.py:749-758) silently
    DISCARDS the five fundamental half-spectrum modes at every N while
    any f32 |k| path keeps them.  At 512^3 the first retained bin holds
    8 modes, 5 of them edge-sitters — a ~3e-1 f32-vs-f64 discrepancy
    that masqueraded as a conditioning floor (truth_gate_512.npz).  The
    integer convention keeps the fundamentals (documented divergence
    from the reference's ulp-sensitive behaviour, docs/conventions.md).

    Returns None for anisotropic boxes (no common integer lattice);
    callers fall back to floating-|k| classification there.
    """
    if not (grid.Lx == grid.Ly == grid.Lz):
        return None
    kappa = 2.0 * np.pi / grid.Lx
    E = (np.asarray(bins, np.float64) / kappa) ** 2
    return np.ceil(E * (1.0 - 1e-12)).astype(np.int32)


def _index_sq(grid: GridSpec) -> np.ndarray:
    """Squared integer FFT indices (host, exact)."""
    fi = np.asarray(grid.fft_index, np.int64)
    return (fi * fi).astype(np.int32)


@partial(jax.jit, static_argnames=("grid",))
def _binned_pk_half_core(grid: GridSpec, delta_x, bins, thr=None):
    """Half-spectrum lowering of the reference binning: one rank-3 R2C
    plus a kz-multiplicity-weighted histogram reproduces the full-grid
    sums exactly (interior kz planes appear twice in the full grid with
    identical |delta_k|^2; the kz=0 and Nyquist planes once).

    ``thr``: optional int32 :func:`kbin_thresholds` — exact integer-
    lattice classification (cubic grids); None falls back to floating
    |k| searchsorted."""
    from .reduce import binned_weighted_sum_sumsq_count

    rdtype = delta_x.dtype
    N = grid.N
    H = N // 2 + 1
    half = fft_safe.rfftn(delta_x)
    pk = (half * jnp.conj(half)).real / jnp.asarray(grid.boxfactor, rdtype)
    if thr is not None:
        fi2 = jnp.asarray(_index_sq(grid))
        m = (fi2[:, None, None] + fi2[None, :, None]
             + fi2[:H][None, None, :])
        idx = jnp.searchsorted(thr, m.ravel(), side="right")
    else:
        kx, ky, kz = grid.kvec(rdtype)
        kmag = jnp.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                        + kz[:H][None, None, :] ** 2)
        idx = jnp.searchsorted(bins.astype(rdtype), kmag.ravel(),
                               side="right")
    w = np.full(H, 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    wf = jnp.broadcast_to(jnp.asarray(w, rdtype)[None, None, :], pk.shape)
    nb = bins.shape[0]
    sums, sumsqs, counts = binned_weighted_sum_sumsq_count(
        pk.ravel(), wf.ravel(), idx.astype(jnp.int32), nb)
    vals = sums / counts
    var = jnp.maximum(sumsqs / counts - vals**2, 0.0)
    var = jnp.where(counts > 1, var, 0.0)
    stddev = jnp.sqrt(var) / jnp.sqrt(counts)
    return vals, stddev


@partial(jax.jit, static_argnames=("grid",))
def _binned_pk_core(grid: GridSpec, delta_k, bins, thr=None):
    rdtype = jnp.real(delta_k).dtype
    pk = (delta_k * jnp.conj(delta_k)).real / jnp.asarray(grid.boxfactor, rdtype)
    nb = bins.shape[0]
    if thr is not None:
        fi2 = jnp.asarray(_index_sq(grid))
        m = (fi2[:, None, None] + fi2[None, :, None]
             + fi2[None, None, :])
        idx = jnp.searchsorted(thr, m.ravel(), side="right")
    else:
        kmag = grid.kmag(rdtype)
        # np.digitize(k, bins) == searchsorted(bins, k, side='right')
        idx = jnp.searchsorted(bins.astype(rdtype), kmag.ravel(),
                               side="right")
    sums, sumsqs, counts = binned_sum_sumsq_count(pk.ravel(), idx, nb)
    vals = sums / counts  # count==0 -> NaN, matching mean-of-empty
    var = jnp.maximum(sumsqs / counts - vals**2, 0.0)
    # A single-element bin has exactly zero std; clamp the cancellation
    # residue of the E[x^2]-E[x]^2 form
    var = jnp.where(counts > 1, var, 0.0)
    stddev = jnp.sqrt(var) / jnp.sqrt(counts)
    return vals, stddev


def binned_power_spectrum(
    grid: GridSpec,
    delta_k=None,
    delta_x=None,
    nbins: int = 20,
    kbins: np.ndarray | None = None,
):
    """Binned 1D P(k) with the reference's exact binning semantics.

    Matches box.py:696-768: ``|delta_k|^2 / boxfactor``, ``digitize`` binning
    against ``nbins`` log-spaced edges, arithmetic-midpoint bin centroids,
    per-bin mean and ``std/sqrt(N)``, first (sub-kmin) bin discarded.  Bins
    with no modes return NaN, as numpy's mean-of-empty does.

    Returns:
        (kc, pk, sigma_pk) with length ``len(kbins) - 1``.
    """
    if delta_x is not None and delta_k is not None:
        raise ValueError("delta_x and delta_k specified; can only specify one")
    bins = np.asarray(kbins if kbins is not None else default_kbins(grid, nbins),
                      dtype=np.float64)
    _bins = np.concatenate([[0.0], bins])
    cent = 0.5 * (_bins[1:] + _bins[:-1])

    thr = kbin_thresholds(grid, bins)
    thr_j = None if thr is None else jnp.asarray(thr)
    if delta_k is None:
        rdtype = jnp.asarray(delta_x).dtype
        vals, stddev = _binned_pk_half_core(grid, delta_x, jnp.asarray(bins),
                                            thr_j)
    else:
        rdtype = jnp.real(delta_k).dtype
        vals, stddev = _binned_pk_core(grid, delta_k, jnp.asarray(bins),
                                       thr_j)

    # First value is garbage (k < kmin modes incl. k=0); throw it away
    return jnp.asarray(cent[1:], rdtype), vals[1:], stddev[1:]


# ----------------------------------------------------------------------
# nbodykit-replacement estimators
# ----------------------------------------------------------------------
def _power_3d(grid: GridSpec, delta_x, second=None):
    """Raw 3D (cross-)power |d1_k conj(d2_k)| / boxfactor on the full grid."""
    d1k = fft_safe.fftn(delta_x)
    d2k = d1k if second is None else fft_safe.fftn(second)
    rdtype = jnp.real(delta_x).dtype
    return (d1k * jnp.conj(d2k)).real / jnp.asarray(grid.boxfactor, rdtype), rdtype


def _linear_kbins(grid: GridSpec, dk=None, kmin=0.0, kmax=None):
    """nbodykit-style linear k bins: default dk = 2 pi / max(L) (fundamental)."""
    kf = 2.0 * np.pi / max(grid.Lx, grid.Ly, grid.Lz)
    if dk is None:
        dk = 2.0 * kf
    if kmax is None:
        kmax = np.pi * grid.N / min(grid.Lx, grid.Ly, grid.Lz) + dk / 2  # ~ Nyquist
    edges = np.arange(kmin, kmax + dk, dk, dtype=np.float64)
    return edges


def _norm_los(los) -> tuple[float, float, float]:
    """Normalize a static 3-vector line of sight (nbodykit accepts any)."""
    lx, ly, lz = (float(v) for v in los)
    n = (lx * lx + ly * ly + lz * lz) ** 0.5
    if n == 0.0:
        raise ValueError("los must be a nonzero 3-vector")
    return (lx / n, ly / n, lz / n)


def _mu_k(grid: GridSpec, rdtype, los) -> jnp.ndarray:
    """mu = (k . los)/|k| on the flattened full k grid (0 at k=0)."""
    lx, ly, lz = _norm_los(los)
    kx, ky, kz = grid.kvec(rdtype)
    kdotl = (kx[:, None, None] * rdtype.type(lx)
             + ky[None, :, None] * rdtype.type(ly)
             + kz[None, None, :] * rdtype.type(lz)).ravel()
    kmag = grid.kmag(rdtype).ravel()
    return jnp.where(kmag > 0.0, kdotl / jnp.where(kmag > 0, kmag, 1.0), 0.0)


@partial(jax.jit, static_argnames=("grid", "dk", "kmin", "kmax", "nmu",
                                   "exclude_zero", "los"))
def power_spectrum(
    grid: GridSpec,
    delta_x,
    second=None,
    dk: float | None = None,
    kmin: float = 0.0,
    kmax: float | None = None,
    nmu: int = 1,
    exclude_zero: bool = True,
    los: tuple = (0, 0, 1),
):
    """Mode-averaged P(k) or P(k, mu) on linear k bins (FFTPower 1d/2d analog).

    Parameters:
        delta_x: real-space overdensity cube.
        second: optional second field for a cross-spectrum.
        dk, kmin, kmax: linear k-bin edges (defaults: twice the fundamental
            frequency up to the Nyquist scale, like nbodykit).
        nmu: number of |mu| bins on [0, 1] (mu = (k . los)/|k|).
        exclude_zero: drop the k=0 mode from the average.
        los: static line-of-sight 3-vector (any direction; nbodykit's
            ``los`` argument — the reference examples only ever use
            [0, 0, 1], which remains the default).

    Returns:
        dict with 'k' (mean k per bin), 'mu' (mean |mu|), 'power', 'modes';
        arrays have shape (nk,) if nmu == 1 else (nk, nmu).
    """
    p3d, rdtype = _power_3d(grid, delta_x, second)
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1

    kmag = grid.kmag(rdtype).ravel()
    kidx = jnp.searchsorted(jnp.asarray(edges, rdtype), kmag, side="right") - 1
    kidx = jnp.where((kidx < 0) | (kidx >= nk), nk, kidx)
    if exclude_zero:
        kidx = jnp.where(kmag == 0.0, nk, kidx)

    if nmu > 1:
        mu = jnp.abs(_mu_k(grid, jnp.dtype(rdtype), los))
        muidx = jnp.clip((mu * nmu).astype(jnp.int32), 0, nmu - 1)
        flat_idx = jnp.where(kidx >= nk, nk * nmu, kidx * nmu + muidx)
        ntot = nk * nmu
    else:
        mu = None
        flat_idx = kidx
        ntot = nk

    p = p3d.ravel()
    psum = binned_sums(p, flat_idx, ntot)
    ksum = binned_sums(kmag, flat_idx, ntot)
    count = binned_sums(jnp.ones_like(p), flat_idx, ntot)

    out = {
        "k_edges": jnp.asarray(edges, rdtype),
        "power": (psum / count),
        "k": ksum / count,
        "modes": count,
    }
    if nmu > 1:
        musum = binned_sums(mu, flat_idx, ntot)
        out["mu"] = (musum / count).reshape(nk, nmu)
        out["power"] = out["power"].reshape(nk, nmu)
        out["k"] = out["k"].reshape(nk, nmu)
        out["modes"] = count.reshape(nk, nmu)
    return out


def _legendre(ell: int, mu):
    if ell == 0:
        return jnp.ones_like(mu)
    if ell == 1:
        return mu
    if ell == 2:
        return 1.5 * mu**2 - 0.5
    if ell == 3:
        return 2.5 * mu**3 - 1.5 * mu
    if ell == 4:
        return (35.0 * mu**4 - 30.0 * mu**2 + 3.0) / 8.0
    raise NotImplementedError(f"Legendre ell={ell} not implemented")


@partial(jax.jit, static_argnames=("grid", "poles", "dk", "kmin", "kmax",
                                   "los"))
def power_multipoles(
    grid: GridSpec,
    delta_x,
    second=None,
    poles=(0, 2, 4),
    dk: float | None = None,
    kmin: float = 0.0,
    kmax: float | None = None,
    los: tuple = (0, 0, 1),
):
    """Power-spectrum multipoles P_l(k) = (2l+1) <P(k) L_l(mu)> per k bin.

    ``los`` is any static 3-vector (default the z axis, [0, 0, 1] — the
    only direction the reference examples ever use).
    """
    p3d, rdtype = _power_3d(grid, delta_x, second)
    edges = _linear_kbins(grid, dk, kmin, kmax)
    nk = edges.size - 1

    kmag = grid.kmag(rdtype).ravel()
    mu = _mu_k(grid, jnp.dtype(rdtype), los)

    kidx = jnp.searchsorted(jnp.asarray(edges, rdtype), kmag, side="right") - 1
    kidx = jnp.where((kidx < 0) | (kidx >= nk) | (kmag == 0.0), nk, kidx)

    p = p3d.ravel()
    count = binned_sums(jnp.ones_like(p), kidx, nk)
    ksum = binned_sums(kmag, kidx, nk)
    out = {"k_edges": jnp.asarray(edges, rdtype), "k": ksum / count, "modes": count}
    for ell in poles:
        wp = p * _legendre(ell, mu)
        out[f"power_{ell}"] = (2 * ell + 1) * binned_sums(wp, kidx, nk) / count
    return out


def _rgrid(grid: GridSpec, rdtype):
    """Minimum-image separation coordinates for the FFT-based xi estimator."""
    nx = np.fft.fftfreq(grid.N, 1.0) * grid.N
    rx = jnp.asarray(nx * (grid.Lx / grid.N), rdtype)
    ry = jnp.asarray(nx * (grid.Ly / grid.N), rdtype)
    rz = jnp.asarray(nx * (grid.Lz / grid.N), rdtype)
    rmag = jnp.sqrt(
        rx[:, None, None] ** 2 + ry[None, :, None] ** 2 + rz[None, None, :] ** 2
    )
    return rmag, rz


@partial(jax.jit, static_argnames=("grid", "dr", "rmin", "rmax"))
def correlation_function(
    grid: GridSpec,
    delta_x,
    second=None,
    dr: float = 2.0,
    rmin: float = 0.0,
    rmax: float | None = None,
):
    """Two-point correlation xi(r) via inverse FFT of the 3D power (FFTCorr).

    xi(r) = ifftn(|delta_k|^2).real / N^3, binned in minimum-image |r|.
    Matches the nbodykit FFTCorr path used at example_endtoend.py:122-151.
    """
    d1k = fft_safe.fftn(delta_x)
    d2k = d1k if second is None else fft_safe.fftn(second)
    rdtype = jnp.real(delta_x).dtype
    xi3d = fft_safe.ifftn(d1k * jnp.conj(d2k)).real / grid.N**3

    if rmax is None:
        rmax = 0.5 * min(grid.Lx, grid.Ly, grid.Lz)
    edges = np.arange(rmin, rmax + dr, dr, dtype=np.float64)
    nr = edges.size - 1

    rmag, _ = _rgrid(grid, rdtype)
    ridx = jnp.searchsorted(jnp.asarray(edges, rdtype), rmag.ravel(), side="right") - 1
    ridx = jnp.where((ridx < 0) | (ridx >= nr), nr, ridx)

    x = xi3d.ravel()
    count = binned_sums(jnp.ones_like(x), ridx, nr)
    rsum = binned_sums(rmag.ravel(), ridx, nr)
    xsum = binned_sums(x, ridx, nr)
    return {
        "r_edges": jnp.asarray(edges, rdtype),
        "r": rsum / count,
        "corr": xsum / count,
        "modes": count,
    }


@partial(jax.jit, static_argnames=("grid", "poles", "dr", "rmin", "rmax",
                                   "los"))
def correlation_multipoles(
    grid: GridSpec,
    delta_x,
    second=None,
    poles=(0, 2, 4),
    dr: float = 2.0,
    rmin: float = 0.0,
    rmax: float | None = None,
    los: tuple = (0, 0, 1),
):
    """Correlation-function multipoles xi_l(r) along a static ``los`` vector
    (default z axis, matching every reference example)."""
    d1k = fft_safe.fftn(delta_x)
    d2k = d1k if second is None else fft_safe.fftn(second)
    rdtype = jnp.real(delta_x).dtype
    xi3d = fft_safe.ifftn(d1k * jnp.conj(d2k)).real / grid.N**3

    if rmax is None:
        rmax = 0.5 * min(grid.Lx, grid.Ly, grid.Lz)
    edges = np.arange(rmin, rmax + dr, dr, dtype=np.float64)
    nr = edges.size - 1

    lx, ly, lz = _norm_los(los)
    nx = np.fft.fftfreq(grid.N, 1.0) * grid.N
    rx = jnp.asarray(nx * (grid.Lx / grid.N), rdtype)
    ry = jnp.asarray(nx * (grid.Ly / grid.N), rdtype)
    rz1 = jnp.asarray(nx * (grid.Lz / grid.N), rdtype)
    rmag, _ = _rgrid(grid, rdtype)
    rflat = rmag.ravel()
    rdotl = (rx[:, None, None] * rdtype.type(lx)
             + ry[None, :, None] * rdtype.type(ly)
             + rz1[None, None, :] * rdtype.type(lz)).ravel()
    mu = jnp.where(rflat > 0.0, rdotl / jnp.where(rflat > 0, rflat, 1.0), 0.0)
    ridx = jnp.searchsorted(jnp.asarray(edges, rdtype), rflat, side="right") - 1
    ridx = jnp.where((ridx < 0) | (ridx >= nr), nr, ridx)

    x = xi3d.ravel()
    count = binned_sums(jnp.ones_like(x), ridx, nr)
    rsum = binned_sums(rflat, ridx, nr)
    out = {"r_edges": jnp.asarray(edges, rdtype), "r": rsum / count, "modes": count}
    for ell in poles:
        wx = x * _legendre(ell, mu)
        out[f"corr_{ell}"] = (2 * ell + 1) * binned_sums(wx, ridx, nr) / count
    return out
