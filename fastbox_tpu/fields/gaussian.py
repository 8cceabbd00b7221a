"""Gaussian random field realisation engine (L2 of SURVEY.md layer map).

Functional, key-based replacements for the reference's in-place methods
``CosmoBox.realise_density`` (box.py:130-194), ``realise_velocity``
(box.py:197-290) and ``realise_potential`` (box.py:293-353).

Statistical conventions matched exactly (SURVEY.md §2.2):
  * P(k) is multiplied by ``boxfactor = N^6/V`` before the draw (box.py:171).
  * The draw is *complex* white noise ``(re + i im) sqrt(P)`` — twice the
    target variance — and only ``ifftn(.).real`` is kept, which restores the
    statistics (box.py:174-187).
  * ``delta_k`` is then recomputed as ``fftn(delta_x)`` so it satisfies
    Hermitian symmetry (box.py:191-193).
  * k=0 (and any other non-finite P) contributes zero power (box.py:167).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..ops import fft_safe
import numpy as np

from ..grid import GridSpec

__all__ = [
    "white_noise",
    "gaussian_field_from_whitenoise",
    "realise_density",
    "realise_velocity",
    "realise_potential",
]


def _complex_dtype(real_dtype):
    return jnp.complex128 if jnp.dtype(real_dtype) == jnp.float64 else jnp.complex64


def _complex_normal(key, shape, dtype, method: str = "erfinv"):
    """``re + i im`` with independent unit-normal parts.

    ``method="erfinv"`` is two ``jax.random.normal`` draws (the stream
    every committed oracle/test expectation uses).  ``method="box_muller"``
    draws one uniform pair and emits BOTH Box-Muller outputs as (re, im)
    — one log+sqrt+cos+sin for the pair instead of two ~20-term erf_inv
    polynomials, and no full-shape coefficient-broadcast HLO temps
    (parallel/rng.py).  A DIFFERENT, equally valid
    realisation stream: gate any default flip on statistics + the truth
    gate, never on per-voxel comparisons.
    """
    k1, k2 = jax.random.split(key)
    if method == "box_muller":
        # Lazy import: parallel/__init__ imports modules that import this
        # file, so a top-level import would be circular.  bm_pair is the
        # single stream-defining Box-Muller (shared with the rows draws).
        from ..parallel.rng import bm_pair

        return jax.lax.complex(*bm_pair(k1, k2, shape, dtype))
    if method != "erfinv":
        raise ValueError(f"Unknown draw method '{method}'")
    return jax.lax.complex(jax.random.normal(k1, shape, dtype),
                           jax.random.normal(k2, shape, dtype))


def hermitian_half_noise(key, grid: GridSpec, dtype=jnp.float32,
                         method: str = "erfinv"):
    """Complex white noise drawn directly on the rfft half-spectrum, with
    the exact statistics of ``hermitian_symmetrize(white_noise(...))``.

    Interior kz modes (0 < l < N/2) get independent CN parts of variance
    1/2 (each represents a +-k pair of the full draw); the kz=0 and (even
    N) kz=N/2 planes are internally conjugate-paired, so they are realised
    as 2D Hermitian projections of unit-variance plane noise.  Memory and
    RNG cost are half the full-grid draw.

    ``method`` selects the bits->normal transform (see
    :func:`_complex_normal`); both are pure functions of ``key``.
    """
    N = grid.N
    H = N // 2 + 1
    k_int, k_p0, k_pn = jax.random.split(key, 3)

    dtype = jnp.dtype(dtype)
    half = _complex_normal(k_int, (N, N, H), dtype, method) \
        * jnp.asarray(np.sqrt(0.5), dtype)

    half = half.at[:, :, 0].set(_herm_plane(k_p0, N, dtype, method))
    if N % 2 == 0:
        half = half.at[:, :, H - 1].set(_herm_plane(k_pn, N, dtype, method))
    return half


def _herm_plane(key, N, dtype, method: str = "erfinv"):
    """(N, N) complex plane with internal 2D Hermitian pairing — the kz=0
    / kz=N/2 structure of a real cube's half-spectrum (see
    hermitian_half_noise)."""
    w = _complex_normal(key, (N, N), jnp.dtype(dtype), method)
    rev = w
    for axis in (0, 1):
        rev = jnp.roll(jnp.flip(rev, axis), 1, axis)
    return 0.5 * (w + jnp.conj(rev))


def hermitian_symmetrize(A):
    """Project a Fourier cube onto Hermitian symmetry: (A + conj(A_-k))/2.

    Identity: fftn(Re(ifftn(A))) == hermitian_symmetrize(A).  The reference
    realises its field as ifftn(noise).real followed by a second fftn
    (box.py:187-193); using this projection instead saves one full 3D FFT
    per realisation while producing the same delta_k to roundoff.
    """
    rev = A
    for axis in range(A.ndim):
        rev = jnp.roll(jnp.flip(rev, axis), 1, axis)
    return 0.5 * (A + jnp.conj(rev))


@partial(jax.jit, static_argnames=("grid", "dtype"))
def white_noise(key, grid: GridSpec, dtype=jnp.float32):
    """Complex unit white noise (re + i im), each part ~ N(0,1) (box.py:174-176).

    Jitted, and combined via ``lax.complex`` (no complex128 promotion
    of a Python ``1j`` scalar).
    """
    kre, kim = jax.random.split(key)
    re = jax.random.normal(kre, grid.shape, dtype=dtype)
    im = jax.random.normal(kim, grid.shape, dtype=dtype)
    return jax.lax.complex(re, im)


@partial(jax.jit, static_argnames=("grid",))
def gaussian_field_from_whitenoise(white, grid: GridSpec, pk_fn):
    """Colour complex white noise by a power spectrum.

    Parameters:
        white: complex (N,N,N) unit white noise.
        grid: static geometry.
        pk_fn: callable k -> P(k) in Mpc^3 (e.g. a PowerSpectrumTable).

    Returns:
        (delta_x, delta_k): real-space field and its Hermitian FFT.
    """
    rdtype = jnp.real(white).dtype
    kmag = grid.kmag(rdtype)
    pk = pk_fn(kmag) * jnp.asarray(grid.boxfactor, rdtype)
    pk = jnp.nan_to_num(pk)
    amp = jnp.sqrt(pk).astype(rdtype)
    # delta_k = fftn(Re(ifftn(white*amp))) == Hermitian projection of
    # white*amp: one FFT instead of the reference's two (box.py:187-193).
    delta_k = hermitian_symmetrize(white * amp).astype(_complex_dtype(rdtype))
    delta_x = fft_safe.ifftn(delta_k).real.astype(rdtype)
    return delta_x, delta_k


@partial(jax.jit, static_argnames=("grid", "linear", "dtype"))
def realise_density(key, grid: GridSpec, cosmology, linear: bool = False,
                    dtype=jnp.float32):
    """Draw a Gaussian density field with the cosmology's P(k) (box.py:130-194)."""
    pk_fn = cosmology.pk_lin if linear else cosmology.pk_nl
    white = white_noise(key, grid, dtype)
    return gaussian_field_from_whitenoise(white, grid, pk_fn)


@partial(jax.jit, static_argnames=("grid",))
def realise_velocity(delta_k, grid: GridSpec, cosmology):
    """Linear velocity field v(k) = i [f H a] delta_k k / k^2 (box.py:197-290).

    Returns a (3, N, N, N) complex array of the x,y,z Fourier-space velocity
    components; ``ifftn`` of a component gives the real-space velocity in
    km/s.  For even N the most-negative-frequency plane of each component is
    zeroed (box.py:268-274).
    """
    cdtype = delta_k.dtype
    rdtype = jnp.real(delta_k).dtype
    kx, ky, kz = grid.kvec(rdtype)
    k2 = grid.k2(rdtype)
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)

    nyq = grid.nyquist_mask(0)  # same 1-D pattern on each axis

    # Prefactor 100 h E(a) f(a) a, in km/s/Mpc (box.py:280-281)
    a = cosmology.scale_factor
    fac = 100.0 * cosmology.h * cosmology.Ea * cosmology.growth_rate * a

    # Keep the complex scalar in the field's dtype: a bare Python complex
    # would otherwise promote to complex128
    ifac = jnp.asarray(1j * fac, dtype=cdtype)
    base = ifac * delta_k * inv_k2
    vx = base * kx[:, None, None]
    vy = base * ky[None, :, None]
    vz = base * kz[None, None, :]
    vx = jnp.where(nyq[:, None, None], 0.0, vx)
    vy = jnp.where(nyq[None, :, None], 0.0, vy)
    vz = jnp.where(nyq[None, None, :], 0.0, vz)
    return jnp.stack([vx, vy, vz]).astype(cdtype)


@partial(jax.jit, static_argnames=("grid", "apply_prefactor"))
def realise_potential(delta_k, grid: GridSpec, cosmology, apply_prefactor=False):
    """Potential field phi_k = delta_k / k^2, monopole zeroed (box.py:293-353).

    Note: the reference computes the physical prefactor
    ``(3/2) Omega_m H0^2 D(a)/a`` but never applies it (box.py:343-347 —
    documented latent bug, SURVEY.md §2.1 #5).  Default behaviour matches the
    reference output; pass ``apply_prefactor=True`` for the intended physics.
    """
    rdtype = jnp.real(delta_k).dtype
    k2 = grid.k2(rdtype)
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)
    phi_k = delta_k * inv_k2
    if apply_prefactor:
        params = cosmology.params
        fac = (
            1.5 * params.Omega_m * (100.0 * params.h) ** 2
            * cosmology.growth / cosmology.scale_factor
        )
        phi_k = phi_k * fac
    return phi_k
