"""Mesh-independent row-keyed noise draws.

The sharded pipeline cannot draw ``normal(key, (N, N, N))`` like the
single-chip path — each slab owns only ``N/P`` leading rows, and JAX has no
API for generating an offset sub-range of a larger draw.  Instead every
noise field is drawn **per leading-axis row**, with the row's PRNG key
derived as ``fold_in(fold_in(key, tag), global_row_index)``:

  * a slab draws exactly its own rows by offsetting the row index, so the
    realisation is INDEPENDENT of the mesh shape (1 chip, 8 chips and the
    single-device pipeline in ``noise_scheme='rows'`` mode all produce the
    same field for the same key);
  * tags separate the independent noise streams of one realisation.

The single-chip pipeline's default ``noise_scheme='half'`` keeps the faster
direct half-spectrum draw (one fewer FFT); 'rows' exists for exact
single-vs-sharded parity testing and for runs that must be reproducible
across device counts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["TAGS", "bm_pair", "row_normal", "row_complex_normal"]

# Stream tags (arbitrary distinct constants, stable across versions)
TAGS = {
    "density": 1,
    "sigma_nl": 17,
    "fg_re": 101,
    "fg_im": 102,
    "alpha": 103,
    "noise": 202,
    "halos": 301,
}


def bm_pair(k1, k2, shape, dtype):
    """One Box-Muller transform: TWO independent N(0,1) fields of ``shape``.

    The canonical threefry-uniform Box-Muller used everywhere
    (``_bm_normal`` rows here, ``fields.gaussian._complex_normal``
    re/im pairs); keeping it in one place pins the stream — the
    tiny-floored ``u1`` endpoint convention and the (cos, sin) output
    order DEFINE which realisation a key maps to.
    """
    dtype = jnp.dtype(dtype)
    tiny = jnp.finfo(dtype).tiny
    u1 = jax.random.uniform(k1, shape, dtype, minval=tiny, maxval=1.0)
    u2 = jax.random.uniform(k2, shape, dtype)
    r = jnp.sqrt(dtype.type(-2.0) * jnp.log(u1))
    th = dtype.type(2.0 * jnp.pi) * u2
    return r * jnp.cos(th), r * jnp.sin(th)


def _bm_normal(key, shape, dtype):
    """Standard normals via Box-Muller on threefry uniforms.

    Same determinism contract as ``jax.random.normal`` (pure function of
    the key, platform-independent) but a DIFFERENT stream, and a much
    lighter lowering: ``erf_inv`` evaluates a ~20-coefficient polynomial
    whose constant broadcasts XLA can materialise as full-shape HLO
    temps — at 1024^3 slab shapes a 16 GB device ran out of memory on
    them (31 GiB of ``erf_inv.*.remat2 = broadcast(constant)`` temps).
    Box-Muller is two transcendentals with no coefficient tables.

    Both halves of each (cos, sin) pair are used when the trailing axis
    is even (it always is for grid rows); the odd case draws twice.
    """
    dtype = jnp.dtype(dtype)
    k1, k2 = jax.random.split(key)
    if shape and shape[-1] % 2 == 0:
        half = shape[:-1] + (shape[-1] // 2,)
        a, b = bm_pair(k1, k2, half, dtype)
        return jnp.concatenate([a, b], axis=-1)
    return bm_pair(k1, k2, shape, dtype)[0]


def row_normal(key, tag: int, row0, nrows: int, row_shape, dtype,
               method: str = "erfinv"):
    """Draw ``nrows`` standard-normal rows starting at global row ``row0``.

    Returns shape ``(nrows, *row_shape)``.  ``row0`` may be a traced value
    (e.g. ``axis_index * rows_per_shard`` inside shard_map).

    ``method`` selects the bits->normal transform: ``"erfinv"`` (the
    ``jax.random.normal`` stream, default) or ``"box_muller"`` (the
    memory-lean stream — see :func:`_bm_normal`; used from 1024^3 up).  Both are deterministic per (key, tag, row), so
    mesh-shape independence holds for either; they are different
    realisation streams.
    """
    base = jax.random.fold_in(key, tag)
    if method == "box_muller":
        draw = lambda k: _bm_normal(k, row_shape, dtype)  # noqa: E731
    elif method == "erfinv":
        draw = lambda k: jax.random.normal(k, row_shape, dtype)  # noqa: E731
    else:
        raise ValueError(f"Unknown row_normal method '{method}'")

    def one(i):
        return draw(jax.random.fold_in(base, i))

    return jax.vmap(one)(row0 + jnp.arange(nrows))


def row_complex_normal(key, re_tag: int, im_tag: int, row0, nrows: int,
                       row_shape, dtype, method: str = "erfinv"):
    """Complex rows ``re + i im`` with independent unit-normal parts."""
    re = row_normal(key, re_tag, row0, nrows, row_shape, dtype, method)
    im = row_normal(key, im_tag, row0, nrows, row_shape, dtype, method)
    return re + 1j * im


def default_row_method(N: int) -> str:
    """The rows-draw transform the pipeline ships at grid size ``N``.

    erfinv (the jax.random.normal stream) up to 512^3 — unchanged
    streams for every committed test/bench expectation — and Box-Muller
    from 1024^3 up, where the erf_inv lowering's full-shape coefficient
    broadcasts exceed per-chip HBM.  Realisations are N-dependent
    anyway, so switching stream BY SIZE preserves the contract that a
    (key, N) pair fully determines the field.
    """
    return "box_muller" if N >= 1024 else "erfinv"
