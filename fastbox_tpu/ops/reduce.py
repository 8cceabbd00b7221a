"""Binned reductions (histograms) in one pass over the data.

The reference bins its power spectrum with ``np.digitize`` plus a Python loop
doing one full-array masked mean per bin (box.py:758-765) — O(nbins * N^3)
traffic and the dominant cost of its estimation stage (~25 s at 128^3,
BASELINE.md).  Here the (sum, sum of squares, count) of every bin are
accumulated in a *single pass* over the data: the flat array is processed in
fixed-size chunks and each chunk's contribution is a small one-hot matmul,
scanned so XLA pipelines the reads with compute.

The one-hot contractions run at ``precision=HIGHEST``: a float32 dot at a
lower precision may run on reduced-precision tensor cores (TF32 keeps ~3
digits), and these sums carry the data, so they must be float32-exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["binned_sum_sumsq_count", "binned_sums"]

_CHUNK = 65536
_HIGHEST = jax.lax.Precision.HIGHEST


def _chunked(values, bin_idx, nbins: int, stats: int):
    """Core scan: values (M,) f32/f64, bin_idx (M,) int32 -> (stats, nbins).

    stats==1: sums only.  stats==3: (sum, sumsq, count).
    """
    dtype = values.dtype
    n = values.shape[0]
    chunk = min(_CHUNK, n)
    pad = (-n) % chunk
    if pad:
        values = jnp.concatenate([values, jnp.zeros(pad, dtype)])
        # Padding goes to an extra garbage bin so counts stay exact.
        bin_idx = jnp.concatenate(
            [bin_idx, jnp.full(pad, nbins, dtype=bin_idx.dtype)]
        )
    m = values.shape[0] // chunk
    values = values.reshape(m, chunk)
    bin_idx = bin_idx.reshape(m, chunk)

    def body(acc, xs):
        v, b = xs
        onehot = jax.nn.one_hot(b, nbins + 1, dtype=dtype)  # (chunk, nbins+1)
        if stats == 3:
            stacked = jnp.stack([v, v * v, jnp.ones_like(v)])  # (3, chunk)
        else:
            stacked = v[None, :]
        return acc + jnp.dot(stacked, onehot, precision=_HIGHEST,
                             preferred_element_type=dtype), None

    init = jnp.zeros((stats, nbins + 1), dtype)
    acc, _ = jax.lax.scan(body, init, (values, bin_idx))
    return acc[:, :nbins]


def binned_sum_sumsq_count(values, bin_idx, nbins: int):
    """Per-bin (sum, sum of squares, count) in one pass.

    Parameters:
        values: flat real array.
        bin_idx: int bin index per element; entries >= nbins are ignored.
        nbins: number of bins.

    Returns:
        (sums, sumsqs, counts), each shape (nbins,).
    """
    acc = _chunked(values.ravel(), bin_idx.ravel().astype(jnp.int32), nbins, 3)
    return acc[0], acc[1], acc[2]


def binned_sums(values, bin_idx, nbins: int):
    """Per-bin sums only (single-stat variant)."""
    acc = _chunked(values.ravel(), bin_idx.ravel().astype(jnp.int32), nbins, 1)
    return acc[0]


def binned_weighted_dual(values1, values2, weights, bin_idx, nbins: int):
    """Two fields, one histogram pass: (sum w*v1, sum w*v1^2, sum w*v2,
    sum w*v2^2, sum w) per bin.

    The pipeline bins the cleaned cube AND the density cube against the
    same k-bin indices; sharing the one-hot matmul halves the reduction
    cost versus two `binned_weighted_sum_sumsq_count` calls.
    """
    v1 = values1.ravel()
    v2 = values2.ravel().astype(v1.dtype)
    w = weights.ravel().astype(v1.dtype)
    b = bin_idx.ravel().astype(jnp.int32)
    n = v1.shape[0]
    chunk = min(_CHUNK, n)
    pad = (-n) % chunk
    if pad:
        v1 = jnp.concatenate([v1, jnp.zeros(pad, v1.dtype)])
        v2 = jnp.concatenate([v2, jnp.zeros(pad, v1.dtype)])
        w = jnp.concatenate([w, jnp.zeros(pad, v1.dtype)])
        b = jnp.concatenate([b, jnp.full(pad, nbins, dtype=b.dtype)])
    m = v1.shape[0] // chunk
    v1 = v1.reshape(m, chunk)
    v2 = v2.reshape(m, chunk)
    w = w.reshape(m, chunk)
    b = b.reshape(m, chunk)

    def body(acc, xs):
        x1, x2, ww, bb = xs
        onehot = jax.nn.one_hot(bb, nbins + 1, dtype=x1.dtype)
        stacked = jnp.stack([ww * x1, ww * x1 * x1, ww * x2, ww * x2 * x2, ww])
        return acc + jnp.dot(stacked, onehot, precision=_HIGHEST,
                             preferred_element_type=x1.dtype), None

    init = jnp.zeros((5, nbins + 1), v1.dtype)
    acc, _ = jax.lax.scan(body, init, (v1, v2, w, b))
    return tuple(acc[i, :nbins] for i in range(5))


def binned_weighted_sum_sumsq_count(values, weights, bin_idx, nbins: int):
    """Weighted per-bin (sum w*v, sum w*v^2, sum w) in one pass.

    Used for half-spectrum (rfft) mode counting, where interior modes carry
    multiplicity 2 and the self-conjugate planes multiplicity 1 — making the
    reduction exactly equal to the full-grid version.
    """
    v = values.ravel()
    w = weights.ravel().astype(v.dtype)
    b = bin_idx.ravel().astype(jnp.int32)
    n = v.shape[0]
    chunk = min(_CHUNK, n)
    pad = (-n) % chunk
    if pad:
        v = jnp.concatenate([v, jnp.zeros(pad, v.dtype)])
        w = jnp.concatenate([w, jnp.zeros(pad, v.dtype)])
        b = jnp.concatenate([b, jnp.full(pad, nbins, dtype=b.dtype)])
    m = v.shape[0] // chunk
    v = v.reshape(m, chunk)
    w = w.reshape(m, chunk)
    b = b.reshape(m, chunk)

    def body(acc, xs):
        vv, ww, bb = xs
        onehot = jax.nn.one_hot(bb, nbins + 1, dtype=vv.dtype)
        stacked = jnp.stack([ww * vv, ww * vv * vv, ww])
        return acc + jnp.dot(stacked, onehot, precision=_HIGHEST,
                             preferred_element_type=vv.dtype), None

    init = jnp.zeros((3, nbins + 1), v.dtype)
    acc, _ = jax.lax.scan(body, init, (v, w, b))
    return acc[0, :nbins], acc[1, :nbins], acc[2, :nbins]
