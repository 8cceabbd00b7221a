"""Matmul FFTs: Cooley-Tukey DFTs expressed as small einsums.

The package's transforms run on the native FFT (``ops/fft_safe.py``).
This module remains as the dense-linear-algebra formulation used by
``PipelineConfig.fft_pair`` (two real inverse transforms as one complex
matmul DFT) and as a reference to time the native FFT against.

A length-``N = n1*n2`` DFT along one axis is two (n1,n1)/(n2,n2) matmuls
with a twiddle multiply in between (decimation in time):

    j = j1*n2 + j2,  k = k2*n1 + k1
    A[k1, j2] = sum_j1 x[j1, j2] W_n1^(j1 k1)
    B[k1, j2] = A[k1, j2] * W_N^(k1 j2)
    X[k2, k1] = sum_j2 B[k1, j2] W_n2^(j2 k2)

Everything is dense linear algebra: batch dimensions are free and any rank
works.  Matmuls run at ``precision=HIGHEST`` by default so f32 inputs keep
~f32 accuracy; the factor matrices are built in float64 on the host.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft", "ifft", "fftn", "ifftn", "fft2", "ifft2",
           "rfft", "irfft", "rfftn_via_cfft", "irfftn_pair",
           "rfftn3", "irfftn3"]

# Matmul accumulation precision (HIGHEST keeps ~f32 accuracy).  Settable
# via the environment (FASTBOX_MM_PRECISION=HIGH) or set_precision(); read
# at trace time, so call jax.clear_caches() after changing it mid-process.
import os as _os

_PREC = getattr(jax.lax.Precision,
                _os.environ.get("FASTBOX_MM_PRECISION", "HIGHEST"))


class _Split:
    """Sentinel precision: compensated split-f32 DFT weights.

    The DFT/twiddle matrices are Dekker-split into an (hi, lo) f32 pair
    of their float64 values (hi = f32(W), lo = f32(W - hi), exact), and
    every weight contraction runs as TWO einsums at HIGHEST summed in
    f32.  This removes the f32 *representation* error of the weights
    (the hi+lo pair carries ~48 mantissa bits); what remains is the f32
    accumulation error of the matmul itself.  ~2x the HIGHEST matmul
    cost.
    """

    def __repr__(self):  # pragma: no cover - debug nicety
        return "Precision.SPLIT"


SPLIT = _Split()


def set_precision(name: str):
    """Set the einsum precision for all matmul DFT stages.

    ``name`` is one of "DEFAULT", "HIGH", "HIGHEST", "SPLIT".  Affects
    traces made after the call; jitted programs already compiled keep
    their old precision (use ``jax.clear_caches()`` to force a
    re-trace).
    """
    global _PREC
    _PREC = SPLIT if name.upper() == "SPLIT" \
        else getattr(jax.lax.Precision, name)


def _prec(precision):
    """Resolve a per-call precision: None -> the module default."""
    if precision is None:
        return _PREC
    if isinstance(precision, str):
        if precision.upper() == "SPLIT":
            return SPLIT
        return getattr(jax.lax.Precision, precision)
    return precision


def _split_pair(W64):
    """Dekker-split a float64/complex128 host matrix into f32 (hi, lo).

    hi = round-to-f32(W); lo = round-to-f32(W - hi).  The subtraction is
    exact in f64, so hi + lo reproduces W to ~2^-48 relative.
    """
    if np.iscomplexobj(W64):
        cdt = np.complex64
        hi = W64.astype(cdt)
        lo = (W64 - hi.astype(np.complex128)).astype(cdt)
    else:
        hi = W64.astype(np.float32)
        lo = (W64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


_HIGHEST = jax.lax.Precision.HIGHEST


def _w_einsum(eq, x, W64, prec, as_complex=False):
    """Weight contraction honouring the SPLIT sentinel.

    ``W64`` is the HOST f64/c128 master matrix; non-split paths contract
    against its f32/c64 rounding at ``prec``, the split path runs two
    HIGHEST einsums against the Dekker pair and sums in f32.
    """
    conv = _as_complex if as_complex else jnp.asarray
    if prec is SPLIT:
        hi, lo = _split_pair(W64)
        return (jnp.einsum(eq, x, conv(hi), precision=_HIGHEST)
                + jnp.einsum(eq, x, conv(lo), precision=_HIGHEST))
    dt = np.complex64 if np.iscomplexobj(W64) else np.float32
    return jnp.einsum(eq, x, conv(W64.astype(dt)), precision=prec)


# Per-length stage-split overrides for empirical tuning, e.g.
# FACTOR_OVERRIDES[256] = (16, 16) runs the length-256 DFT as two
# radix-16 matmul stages instead of one dense (256,256) stage.
# Read at trace time.
FACTOR_OVERRIDES: dict[int, tuple[int, ...]] = {}

def _factor(n: int) -> tuple[int, ...]:
    """Split n into DFT stage sizes.

    One large dense stage: a factored split halves the matmul flops but
    pays for it with the inter-stage reshape/swapaxes relayout (several
    full-cube memory passes).  So one dense stage up to 1024 (a
    1024-point DFT matrix is a 4 MB f32 pair — fine as a device
    constant), peeling small prefactors only beyond that.
    """
    ov = FACTOR_OVERRIDES.get(n)
    if ov is not None:
        assert int(np.prod(ov)) == n, (ov, n)
        return tuple(int(s) for s in ov)
    if n <= 1024:
        return (n,)
    out = []
    while n > 1024:
        for p in (2, 3, 5, 7):
            if n % p == 0:
                out.append(p)
                n //= p
                break
        else:  # large prime factor: accept one big dense stage
            break
    out.append(n)
    return tuple(out)


@lru_cache(maxsize=64)
def _stage_mats(n: int, sign: int, dtype_name: str,
                stages: tuple[int, ...]):
    """Host-precomputed (W_stage, twiddle) ladder for a length-n DFT.

    Returns a list of (n1, n2, W1[n1,n1], T[n1,n2]) where n2 is the
    remaining length after this stage (product of later stages); the last
    stage has n2 == 1 and T == None.  ``stages`` is part of the cache key
    so FACTOR_OVERRIDES changes take effect on the next trace.
    """
    dtype = np.dtype(dtype_name)
    mats = []
    rem = n
    for s in stages:
        n1, n2 = s, rem // s
        j1 = np.arange(n1)
        W1 = np.exp(sign * 2j * np.pi * np.outer(j1, j1) / n1)
        if n2 > 1:
            T = np.exp(sign * 2j * np.pi
                       * np.outer(j1, np.arange(n2)) / rem)
        else:
            T = None
        # Cache NUMPY constants: creating jnp arrays here would return
        # tracers when first called inside a jit trace, and the lru_cache
        # would leak them into later traces.
        mats.append((n1, n2, W1.astype(dtype),
                     None if T is None else T.astype(dtype)))
        rem = n2
    return mats


def _as_complex(W):
    """Bring a host complex constant on device as a real pair combined
    with ``lax.complex`` (same result eagerly and under jit)."""
    return jax.lax.complex(jnp.asarray(np.ascontiguousarray(W.real)),
                           jnp.asarray(np.ascontiguousarray(W.imag)))


def _dft_last(x, n: int, sign: int, precision=None):
    """DFT along the last axis via the matmul ladder (recursive radix)."""
    is64 = x.dtype == jnp.complex128
    prec = _prec(precision)
    if prec is SPLIT and is64:
        prec = _HIGHEST        # f64 inputs already carry full weights
    split = prec is SPLIT
    # SPLIT contracts against Dekker pairs of the f64 masters, so fetch
    # the complex128 ladder (the DATA stays complex64 on device).
    cdtype = "complex128" if (is64 or split) else "complex64"
    mats = _stage_mats(n, sign, cdtype, _factor(n))

    def wmul(eq, x, W):
        if split:
            hi, lo = _split_pair(W)
            return (jnp.einsum(eq, x, _as_complex(hi), precision=_HIGHEST)
                    + jnp.einsum(eq, x, _as_complex(lo), precision=_HIGHEST))
        return jnp.einsum(eq, x, _as_complex(W), precision=prec)

    def rec(x, level):
        n1, n2, W1, T = mats[level]
        if n2 == 1:
            return wmul("...a,ab->...b", x, W1)
        xs = x.reshape(x.shape[:-1] + (n1, n2))
        A = wmul("...ab,ac->...cb", xs, W1)
        # Twiddles are elementwise (one rounding each, not amplified by
        # a length-n accumulation) — a single c64 multiply suffices even
        # under SPLIT.
        B = A * _as_complex(T.astype(np.complex64) if split else T)
        X = rec(B, level + 1)           # shape (..., k1, k2)
        X = jnp.swapaxes(X, -1, -2)     # k = k2*n1 + k1
        return X.reshape(x.shape[:-1] + (n1 * n2,))

    return rec(x.astype("complex128" if is64 else "complex64"), 0)


def fft(x, axis: int = -1, precision=None):
    """C2C forward DFT along ``axis`` (any rank, any batch dims)."""
    x = jnp.moveaxis(x, axis, -1)
    y = _dft_last(x, x.shape[-1], -1, precision)
    return jnp.moveaxis(y, -1, axis)


def ifft(x, axis: int = -1, precision=None):
    """C2C inverse DFT along ``axis`` (normalised by 1/n)."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    y = _dft_last(x, n, +1, precision) * (1.0 / n)
    return jnp.moveaxis(y, -1, axis)


def fft2(x, axes=(-2, -1)):
    for ax in axes:
        x = fft(x, ax)
    return x


def ifft2(x, axes=(-2, -1)):
    for ax in axes:
        x = ifft(x, ax)
    return x


def fftn(x, axes=None):
    axes = tuple(range(x.ndim)) if axes is None else axes
    for ax in axes:
        x = fft(x, ax)
    return x


def ifftn(x, axes=None):
    axes = tuple(range(x.ndim)) if axes is None else axes
    for ax in axes:
        x = ifft(x, ax)
    return x


def rfft(x, axis: int = -1, precision=None):
    """R2C forward along ``axis``: full C2C, sliced to n//2+1 modes."""
    n = x.shape[axis]
    y = fft(x.astype(jnp.result_type(x.dtype, jnp.complex64)), axis,
            precision=precision)
    sl = [slice(None)] * y.ndim
    sl[axis] = slice(0, n // 2 + 1)
    return y[tuple(sl)]


def irfft(x, n: int, axis: int = -1, precision=None):
    """C2R inverse along ``axis`` from the half spectrum (length n//2+1)."""
    x = jnp.moveaxis(x, axis, -1)
    h = x.shape[-1]
    assert h == n // 2 + 1, (h, n)
    # Hermitian mirror: X[n-k] = conj(X[k]) for k = 1..n-h
    tail = jnp.conj(x[..., 1:n - h + 1][..., ::-1])
    full = jnp.concatenate([x, tail], axis=-1)
    y = _dft_last(full, n, +1, precision) * (1.0 / n)
    return jnp.moveaxis(jnp.real(y), -1, axis)


def rfftn_via_cfft(x, axes=None):
    """rfftn equivalent: C2C over all axes, last axis sliced to half.

    For a real input this does 2x the minimal work along the first axis;
    every stage is one batched matmul.
    """
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    n_last = x.shape[axes[-1]]
    y = x.astype(jnp.complex64) if not jnp.iscomplexobj(x) else x
    y = fft(y, axes[-1])
    sl = [slice(None)] * y.ndim
    sl[axes[-1]] = slice(0, n_last // 2 + 1)
    y = y[tuple(sl)]
    for ax in axes[:-1]:
        y = fft(y, ax)
    return y


@lru_cache(maxsize=32)
def _c2r_mats(n: int, dtype_name: str):
    """Real matrices (Er, Ei) of shape (H, n) for the last-axis C2R stage:
    y[x] = Er.T @ Re(c) - Ei.T @ Im(c), folding the Hermitian tail's
    contribution into mode multiplicities m = [1, 2, ..., 2, (1|2)]."""
    H = n // 2 + 1
    m = np.full(H, 2.0)
    m[0] = 1.0
    if n % 2 == 0:
        m[-1] = 1.0
    ph = 2.0 * np.pi * np.outer(np.arange(H), np.arange(n)) / n
    Er = (m[:, None] * np.cos(ph)) / n
    Ei = (m[:, None] * np.sin(ph)) / n
    dt = np.dtype(dtype_name)
    return Er.astype(dt), Ei.astype(dt)


@lru_cache(maxsize=32)
def _r2c_mats(n: int, dtype_name: str):
    """Real matrices (Cr, Ci) of shape (n, H) for the last-axis R2C stage:
    c[k] = x @ Cr + i * (x @ Ci)."""
    H = n // 2 + 1
    ph = 2.0 * np.pi * np.outer(np.arange(n), np.arange(H)) / n
    dt = np.dtype(dtype_name)
    return np.cos(ph).astype(dt), (-np.sin(ph)).astype(dt)


def rfftn_any(x, axes, precision=None):
    """R2C over ``axes`` (half spectrum along ``axes[-1]``), any rank.

    The half axis runs as two real-matrix contractions, then C2C matmul
    DFTs over the remaining axes on half-width data — the matmul form of
    ``jnp.fft.rfftn(x, axes=axes)``.
    """
    axes = tuple(ax % x.ndim for ax in axes)
    al = axes[-1]
    n = x.shape[al]
    rdt = "float64" if x.dtype == jnp.float64 else "float32"
    xm = jnp.moveaxis(x, al, -1)
    prec = _prec(precision)
    if prec is SPLIT and rdt == "float32":
        Cr64, Ci64 = _r2c_mats(n, "float64")
        cr = _w_einsum("...x,xk->...k", xm, Cr64, SPLIT)
        ci = _w_einsum("...x,xk->...k", xm, Ci64, SPLIT)
    else:
        p = _HIGHEST if prec is SPLIT else prec
        Cr, Ci = _r2c_mats(n, rdt)
        cr = jnp.einsum("...x,xk->...k", xm, Cr, precision=p)
        ci = jnp.einsum("...x,xk->...k", xm, Ci, precision=p)
    c = jnp.moveaxis(jax.lax.complex(cr, ci), -1, al)
    for ax in axes[:-1]:
        c = fft(c, ax, precision=precision)
    return c


def irfftn_any(a_half, n_last: int, axes, precision=None):
    """C2R over ``axes`` from the half spectrum along ``axes[-1]``.

    C2C matmul DFT inverses over the leading axes on half-width data,
    then one real-matrix contraction applies the final inverse and the
    Hermitian fold — the matmul form of
    ``jnp.fft.irfftn(a, s=..., axes=axes)``.
    """
    axes = tuple(ax % a_half.ndim for ax in axes)
    al = axes[-1]
    rdt = "float64" if a_half.dtype == jnp.complex128 else "float32"
    assert a_half.shape[al] == n_last // 2 + 1, (a_half.shape, n_last)
    prec = _prec(precision)
    split = prec is SPLIT and rdt == "float32"
    if prec is SPLIT and not split:
        prec = _HIGHEST
    Er, Ei = _c2r_mats(n_last, "float64" if split else rdt)
    for ax in axes[:-1]:
        a_half = ifft(a_half, ax, precision=precision)
    am = jnp.moveaxis(a_half, al, -1)
    if split:
        y = (_w_einsum("...k,kx->...x", jnp.real(am), Er, SPLIT)
             - _w_einsum("...k,kx->...x", jnp.imag(am), Ei, SPLIT))
    else:
        y = (jnp.einsum("...k,kx->...x", jnp.real(am), Er, precision=prec)
             - jnp.einsum("...k,kx->...x", jnp.imag(am), Ei, precision=prec))
    return jnp.moveaxis(y, -1, al)


def irfftn3(a_half, s, precision=None):
    """``jnp.fft.irfftn(a, s=s)`` replacement for a 3D half spectrum."""
    assert a_half.ndim == 3
    return irfftn_any(a_half, s[-1], (0, 1, 2), precision=precision)


def rfftn3(x, precision=None):
    """``jnp.fft.rfftn(x)`` replacement for a real 3D cube."""
    assert x.ndim == 3
    return rfftn_any(x, (0, 1, 2), precision=precision)


def _hermitian_full(h, n_last: int):
    """Expand an rfftn-layout half spectrum (..., N, N, H) of a REAL cube
    to the full (..., N, N, n_last) spectrum.

    3D Hermitian symmetry: X[-i, -j, -k] = conj(X[i, j, k]) (indices mod
    N), so the missing k >= H planes mirror with ALL axes reversed.
    """
    H = h.shape[-1]
    mid = h[..., 1:n_last - H + 1]      # k = 1 .. n_last-H
    m = jnp.conj(mid[..., ::-1])        # now ordered k' = H .. n_last-1
    # i -> (-i) mod N on each leading spatial axis: flip then roll by one
    m = jnp.roll(jnp.flip(m, axis=-3), 1, axis=-3)
    m = jnp.roll(jnp.flip(m, axis=-2), 1, axis=-2)
    return jnp.concatenate([h, m], axis=-1)


def irfftn_pair(a_half, b_half, s, precision=None):
    """Two C2R inverse 3D transforms for the price of one C2C transform.

    ``a_half``/``b_half`` are Hermitian half-spectra (shape
    (..., N, N, N//2+1), the layout of ``jnp.fft.rfftn`` output); returns
    the two real cubes ``(irfftn(a), irfftn(b))``, computed as the
    real/imag parts of one complex inverse transform of ``a + i b``.

    ``precision`` overrides the einsum precision for THIS pair (None
    inherits the module default), matching rfftn3/irfftn3 semantics so
    PipelineConfig.mm3d_precision governs the fused path too.
    """
    N0, N1, N2 = s
    assert a_half.shape[-1] == N2 // 2 + 1
    assert b_half.shape[-1] == N2 // 2 + 1
    c = _hermitian_full(a_half, N2) + 1j * _hermitian_full(b_half, N2)
    c = ifft(c, -3, precision=precision)
    c = ifft(c, -2, precision=precision)
    c = ifft(c, -1, precision=precision)
    return jnp.real(c), jnp.imag(c)
