"""Distributed 3D FFTs by slab decomposition (the nbodykit/pfft replacement).

The reference scales its mesh FFTs through nbodykit's MPI slab-decomposed
pfft (SURVEY.md §2.3, §5.8).  Here the same decomposition is expressed
with ``jax.lax.all_to_all`` over a named mesh axis: transform the two
unsharded axes locally, all-to-all transpose the slab axis against one of
them, transform the remaining axis, transpose back.

These helpers are written for use *inside* ``shard_map`` with arrays of
shape (B, N/P, N, N): a local batch of row-slabs.  The z (LOS) axis is
always kept unsharded, so per-LOS operations (RSD, frequency filters) stay
communication-free.
"""
from __future__ import annotations

from jax import lax

from ..ops import fft_safe

__all__ = [
    "pfft3_local", "pifft3_local", "pfft2_local", "pifft2_local",
    "prfft3_local", "pirfft3_local",
]


def pfft3_local(x, axis_name: str):
    """Forward 3D FFT of a batched row-slab (B, N/P, N, N) -> same sharding."""
    x = fft_safe.fftn(x, axes=(2, 3))
    # (B, N/P, N, N) -> (B, N, N/P, N): send column blocks, gather full rows
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.fft(x, axis=1)
    return lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def pifft3_local(x, axis_name: str):
    """Inverse 3D FFT of a batched row-slab (B, N/P, N, N)."""
    x = fft_safe.ifftn(x, axes=(2, 3))
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.ifft(x, axis=1)
    return lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def prfft3_local(x, axis_name: str):
    """Real-input forward 3D FFT of a batched row-slab.

    (B, N/P, N, N) real -> (B, N/P, N, N//2+1) complex half-spectrum over
    the *local* z (LOS) axis.  Because the half axis is never sharded, both
    all-to-all transposes move half the bytes of the full-spectrum
    ``pfft3_local`` — the rfft treatment the single-chip pipeline already
    uses, extended to the slab decomposition.
    """
    x = fft_safe.rfft(x, axis=3)
    x = fft_safe.fft(x, axis=2)
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.fft(x, axis=1)
    return lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def pirfft3_local(x, n: int, axis_name: str):
    """Inverse of :func:`prfft3_local`.

    (B, N/P, N, N//2+1) complex -> (B, N/P, N, n) real, with ``n`` the full
    z-axis length (required because N//2+1 is ambiguous in parity).
    """
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.ifft(x, axis=1)
    x = lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)
    x = fft_safe.ifft(x, axis=2)
    return fft_safe.irfft(x, n=n, axis=3)


def pfft2_local(x, axis_name: str):
    """Forward 2D FFT of a batched sharded map (B, N/P, N)."""
    x = fft_safe.fft(x, axis=2)
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.fft(x, axis=1)
    return lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)


def pifft2_local(x, axis_name: str):
    """Inverse 2D FFT of a batched sharded map (B, N/P, N)."""
    x = fft_safe.ifft(x, axis=2)
    x = lax.all_to_all(x, axis_name, split_axis=2, concat_axis=1, tiled=True)
    x = fft_safe.ifft(x, axis=1)
    return lax.all_to_all(x, axis_name, split_axis=1, concat_axis=2, tiled=True)
