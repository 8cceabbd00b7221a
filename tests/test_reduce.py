"""ops/reduce.py's one-pass binned reductions against np.bincount."""
import jax.numpy as jnp
import numpy as np
import pytest

from fastbox_tpu.ops import reduce


def _bincount(idx, w, nbins):
    keep = idx < nbins
    return np.bincount(idx[keep], weights=w[keep], minlength=nbins)[:nbins]


# n below one chunk, a whole number of chunks, and a remainder chunk
# (the chunk is shrunk to 64 elements for the last two)
@pytest.mark.parametrize("n,chunk", [(50, None), (256, 64), (300, 64)])
def test_binned_weighted_dual_matches_bincount(rng, monkeypatch, n, chunk):
    if chunk is not None:
        monkeypatch.setattr(reduce, "_CHUNK", chunk)
    nbins = 7
    # bins 2 and 5 stay empty; indices >= nbins are ignored
    idx = rng.choice([0, 1, 3, 4, 6, 7, 9], size=n)
    v1 = rng.standard_normal(n)
    v2 = rng.uniform(0.5, 2.0, n)
    w = rng.choice([1.0, 2.0], size=n)
    got = reduce.binned_weighted_dual(jnp.asarray(v1), jnp.asarray(v2),
                                      jnp.asarray(w), jnp.asarray(idx), nbins)
    want = (_bincount(idx, w * v1, nbins), _bincount(idx, w * v1 ** 2, nbins),
            _bincount(idx, w * v2, nbins), _bincount(idx, w * v2 ** 2, nbins),
            _bincount(idx, w, nbins))
    for g, t in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), t, rtol=1e-12, atol=1e-12)
    assert np.asarray(got[4])[[2, 5]].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("n,chunk", [(40, None), (200, 64)])
def test_binned_sum_sumsq_count_and_sums(rng, monkeypatch, n, chunk):
    if chunk is not None:
        monkeypatch.setattr(reduce, "_CHUNK", chunk)
    nbins = 5
    idx = rng.integers(0, nbins + 2, n)
    v = rng.standard_normal(n)
    s, q, c = reduce.binned_sum_sumsq_count(jnp.asarray(v), jnp.asarray(idx),
                                            nbins)
    ones = np.ones(n)
    np.testing.assert_allclose(np.asarray(s), _bincount(idx, v, nbins),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(q), _bincount(idx, v * v, nbins),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(c), _bincount(idx, ones, nbins))
    np.testing.assert_allclose(
        np.asarray(reduce.binned_sums(jnp.asarray(v), jnp.asarray(idx),
                                      nbins)),
        _bincount(idx, v, nbins), rtol=1e-12, atol=1e-12)


def test_binned_weighted_sum_sumsq_count(rng, monkeypatch):
    monkeypatch.setattr(reduce, "_CHUNK", 32)
    n, nbins = 100, 4
    idx = rng.integers(0, nbins, n)
    v = rng.standard_normal(n)
    w = rng.uniform(0.0, 2.0, n)
    s, q, c = reduce.binned_weighted_sum_sumsq_count(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(idx), nbins)
    np.testing.assert_allclose(np.asarray(s), _bincount(idx, w * v, nbins),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(q), _bincount(idx, w * v * v, nbins),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(c), _bincount(idx, w, nbins),
                               rtol=1e-12, atol=1e-12)


def test_float32_sums_are_exact_to_float32(rng):
    """The one-hot contractions run at HIGHEST: float32 sums of float32
    data agree with f64 bincount to float32 accumulation error, not to
    the ~1e-3 of a reduced-precision matmul path."""
    n, nbins = 5000, 6
    idx = rng.integers(0, nbins, n)
    v = rng.uniform(1.0, 2.0, n).astype(np.float32)
    s, _, c = reduce.binned_sum_sumsq_count(jnp.asarray(v), jnp.asarray(idx),
                                            nbins)
    ref = _bincount(idx, v.astype(np.float64), nbins)
    assert np.abs(np.asarray(s, np.float64) - ref).max() / ref.max() < 1e-5
    np.testing.assert_array_equal(np.asarray(c),
                                  _bincount(idx, np.ones(n), nbins))
