"""FFT facade: the call patterns this package uses, on ``jnp.fft``.

Every function is the native XLA transform on every backend (cuFFT on
the GPU, pocketfft on the CPU), batched or not.  The facade keeps one
place where the package's transforms are named, and adds the one
convenience ``numpy.fft`` spells differently: ``rfft2`` zero-pads to
``s`` before transforming (``irfft2`` takes ``s`` as the output shape).

Only the call patterns used in this package are supported (see each
function's docstring), not the full numpy.fft surface.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["rfftn", "irfftn", "fftn", "ifftn", "fft", "ifft",
           "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2"]


def rfftn(x, axes=None):
    """``jnp.fft.rfftn(x, axes=axes)``."""
    return jnp.fft.rfftn(x, axes=axes)


def irfftn(a, s, axes=None):
    """``jnp.fft.irfftn(a, s=s, axes=axes)`` (``s`` is required here)."""
    return jnp.fft.irfftn(a, s=tuple(int(v) for v in s), axes=axes)


def fftn(x, axes=None):
    return jnp.fft.fftn(x, axes=axes)


def ifftn(x, axes=None):
    return jnp.fft.ifftn(x, axes=axes)


def fft(x, axis=-1):
    return jnp.fft.fft(x, axis=axis)


def ifft(x, axis=-1):
    return jnp.fft.ifft(x, axis=axis)


def fft2(x, axes=(-2, -1)):
    return jnp.fft.fftn(x, axes=tuple(axes))


def ifft2(x, axes=(-2, -1)):
    return jnp.fft.ifftn(x, axes=tuple(axes))


def rfft(x, axis=-1):
    return jnp.fft.rfft(x, axis=axis)


def irfft(a, n, axis=-1):
    return jnp.fft.irfft(a, n=int(n), axis=axis)


def _pad_to(x, s, axes):
    pads = [(0, 0)] * x.ndim
    need = False
    for n, ax in zip(s, axes):
        cur = x.shape[ax]
        if n != cur:
            if n < cur:
                raise ValueError("fft_safe: s smaller than input not supported")
            pads[ax] = (0, n - cur)
            need = True
    return jnp.pad(x, pads) if need else x


def rfft2(x, s=None, axes=(-2, -1)):
    """``jnp.fft.rfft2`` with optional zero-padding to ``s``."""
    axes = tuple(ax % x.ndim for ax in axes)
    if s is not None:
        x = _pad_to(x, s, axes)
    return jnp.fft.rfft2(x, axes=axes)


def irfft2(a, s, axes=(-2, -1)):
    axes = tuple(ax % a.ndim for ax in axes)
    return jnp.fft.irfft2(a, s=s, axes=axes)
