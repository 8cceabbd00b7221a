"""Lagrangian perturbation theory displacement fields (1LPT + 2LPT).

Setup for the COLA realisation engine (fields/cola.py), replacing the
reference's external pycola3 Cython dependency (box.py:463-589).  All
operators are k-space multiplies + FFTs, jit-compatible.

Conventions: the displacement potentials solve
    lap(phi1) = -delta          psi1 = grad(phi1)  (Zel'dovich)
    lap(phi2) = -S2,  S2 = sum_{i<j} [phi1_ii phi1_jj - phi1_ij^2]
    psi2 = grad(phi2)
so positions are x = q + D1 psi1 + D2 psi2 with D2(a) ~ -3/7 D1^2
Omega_m(a)^(-1/143) (Bouchet et al. 1995).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..ops import fft_safe

from ..grid import GridSpec

__all__ = ["lpt_displacements", "second_order_growth"]


@partial(jax.jit, static_argnames=("grid",))
def lpt_displacements(delta_k, grid: GridSpec):
    """1LPT and 2LPT displacement fields from a linear density field.

    Works on the rfft HALF spectrum internally: the density is real, so
    the full-spectrum formulation carried 2x the complex bytes for
    nothing (at 512^3 its program needed 17.0 GB, 13.0 GB of them
    temps, compiled.memory_analysis()).

    Parameters:
        delta_k: Fourier-space linear overdensity — full (N, N, N)
            Hermitian spectrum or its (N, N, N//2+1) rfft half (the full
            form is sliced; for a real field the half determines it).

    Returns:
        (psi1, psi2): two (3, N, N, N) real displacement fields on the
        Lagrangian grid.
    """
    rdtype = jnp.real(delta_k).dtype
    N = grid.N
    H = N // 2 + 1
    kx, ky, kz = grid.kvec(rdtype)
    kzh = kz[:H]
    nyq = grid.nyquist_mask(0)
    nyq_h = nyq[:H]
    k2h = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
           + kzh[None, None, :] ** 2)
    inv_k2 = jnp.where(k2h > 0.0, 1.0 / jnp.where(k2h > 0.0, k2h, 1.0), 0.0)
    delta_h = delta_k if delta_k.shape[-1] == H else delta_k[:, :, :H]

    def grad_half(phi_h):
        # irfftn(i k_i phi_h) per axis; the Nyquist plane of the
        # derivative axis is zeroed for even N — the ik multiply cannot
        # represent a real derivative there (box.py:268-274 convention).
        gxk = jnp.where(nyq[:, None, None], 0.0,
                        1j * kx[:, None, None] * phi_h)
        gyk = jnp.where(nyq[None, :, None], 0.0,
                        1j * ky[None, :, None] * phi_h)
        gzk = jnp.where(nyq_h[None, None, :], 0.0,
                        1j * kzh[None, None, :] * phi_h)
        gx = fft_safe.irfftn(gxk, s=grid.shape)
        gy = fft_safe.irfftn(gyk, s=grid.shape)
        gz = fft_safe.irfftn(gzk, s=grid.shape)
        return jnp.stack([gx, gy, gz])

    phi1_h = delta_h * inv_k2  # lap phi1 = -delta  =>  phi1_k = delta_k / k^2
    psi1 = grad_half(phi1_h)

    # Second derivatives phi1_ij = irfftn(-k_i k_j phi1_h), consumed
    # pairwise into S2 so at most three tidal cubes are live at once.
    kxc = kx[:, None, None]
    kyc = ky[None, :, None]
    kzc = kzh[None, None, :]

    def dd(a, b):
        return fft_safe.irfftn(-(a * b) * phi1_h, s=grid.shape)

    dxx = dd(kxc, kxc)
    dyy = dd(kyc, kyc)
    dzz = dd(kzc, kzc)
    S2 = dxx * dyy + dxx * dzz + dyy * dzz
    del dxx, dyy, dzz
    S2 = S2 - dd(kxc, kyc) ** 2
    S2 = S2 - dd(kxc, kzc) ** 2
    S2 = S2 - dd(kyc, kzc) ** 2
    phi2_h = fft_safe.rfftn(S2) * inv_k2
    psi2 = grad_half(phi2_h)
    return psi1, psi2


def second_order_growth(D1, omega_m_a):
    """D2(a) ~ -3/7 D1^2 Omega_m(a)^(-1/143) (Bouchet et al. 1995)."""
    return -3.0 / 7.0 * D1**2 * omega_m_a ** (-1.0 / 143.0)
