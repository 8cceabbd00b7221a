"""Stateless field transforms (L3 of SURVEY.md layer map).

JAX versions of the reference's Fourier-space transfer functions,
top-hat smoothing, and log-normal transform (box.py:356-381, 441-460,
595-655).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..ops import fft_safe

from ..grid import GridSpec

__all__ = [
    "lognormal",
    "apply_transfer_fn",
    "window",
    "window1",
    "smooth_field",
]


@jax.jit
def lognormal(delta_x):
    """Log-normal transform exp(d)/<exp(d)> - 1 (box.py:441-460).

    nbodykit-style normalisation; see Eq. 3.1 of arXiv:1706.09195.
    """
    d = jnp.exp(delta_x)
    return d / jnp.mean(d) - 1.0


@partial(jax.jit, static_argnames=("grid", "transfer_fn"))
def apply_transfer_fn(field_k, grid: GridSpec, transfer_fn):
    """Apply an anisotropic (k_perp, k_par) transfer function (box.py:356-381).

    ``transfer_fn(k_perp, k_par)`` modulates the Fourier-space field; the
    result is inverse-FFTed.  Like the reference, the returned field is
    complex (the caller may take ``.real``).
    """
    rdtype = jnp.real(field_k).dtype
    k_perp, k_par = grid.kperp_kpar(rdtype)
    dk = field_k * transfer_fn(k_perp, k_par)
    dk = jnp.nan_to_num(dk)
    return fft_safe.ifftn(dk)


def window(k, R):
    """Squared FT of the top-hat window (box.py:595-613)."""
    x = k * R
    safe = jnp.where(x != 0.0, x, 1.0)
    f = (3.0 / safe**3) * (jnp.sin(safe) - safe * jnp.cos(safe))
    return f**2


def window1(k, R):
    """FT of the top-hat window (box.py:615-633)."""
    x = k * R
    safe = jnp.where(x != 0.0, x, 1.0)
    return (3.0 / safe**3) * (jnp.sin(safe) - safe * jnp.cos(safe))


@partial(jax.jit, static_argnames=("grid",))
def smooth_field(field_k, grid: GridSpec, R, h):
    """Top-hat smooth a Fourier-space field; R in Mpc/h (box.py:635-655).

    Returns the complex real-space smoothed field (reference returns the raw
    ``ifftn`` output).
    """
    rdtype = jnp.real(field_k).dtype
    kmag = grid.kmag(rdtype)
    dk = field_k * window1(kmag, R / h)
    dk = jnp.nan_to_num(dk)
    return fft_safe.ifftn(dk)
