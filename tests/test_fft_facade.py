"""ops/fft_safe.py against numpy.fft, for every function the package uses
and each of its axes / ``s`` / zero-padding patterns."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastbox_tpu.ops import fft_safe


def _real(rng, shape):
    return rng.standard_normal(shape)


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# (name, input builder, facade call, numpy reference)
CASES = [
    ("rfftn_cube", lambda r: _real(r, (12, 10, 8)),
     lambda x: fft_safe.rfftn(x), lambda x: np.fft.rfftn(x)),
    ("rfftn_axes01", lambda r: _real(r, (6, 10, 12)),
     lambda x: fft_safe.rfftn(x, axes=(0, 1)),
     lambda x: np.fft.rfftn(x, axes=(0, 1))),
    ("rfftn_batched", lambda r: _real(r, (3, 8, 8, 6)),
     lambda x: fft_safe.rfftn(x, axes=(1, 2, 3)),
     lambda x: np.fft.rfftn(x, axes=(1, 2, 3))),
    ("irfftn_cube_even", lambda r: np.fft.rfftn(_real(r, (8, 6, 10))),
     lambda a: fft_safe.irfftn(a, s=(8, 6, 10)),
     lambda a: np.fft.irfftn(a, s=(8, 6, 10))),
    ("irfftn_cube_odd", lambda r: np.fft.rfftn(_real(r, (8, 6, 9))),
     lambda a: fft_safe.irfftn(a, s=(8, 6, 9)),
     lambda a: np.fft.irfftn(a, s=(8, 6, 9))),
    ("irfftn_axes01", lambda r: np.fft.rfftn(_real(r, (6, 10, 5)),
                                             axes=(0, 1)),
     lambda a: fft_safe.irfftn(a, s=(6, 10), axes=(0, 1)),
     lambda a: np.fft.irfftn(a, s=(6, 10), axes=(0, 1))),
    ("fftn_all", lambda r: _cplx(r, (6, 8, 4)),
     lambda x: fft_safe.fftn(x), lambda x: np.fft.fftn(x)),
    ("fftn_axes12", lambda r: _cplx(r, (3, 6, 8)),
     lambda x: fft_safe.fftn(x, axes=(1, 2)),
     lambda x: np.fft.fftn(x, axes=(1, 2))),
    ("ifftn_all", lambda r: _cplx(r, (6, 8, 4)),
     lambda x: fft_safe.ifftn(x), lambda x: np.fft.ifftn(x)),
    ("fft_axis0", lambda r: _cplx(r, (7, 5)),
     lambda x: fft_safe.fft(x, axis=0), lambda x: np.fft.fft(x, axis=0)),
    ("ifft_axis1", lambda r: _cplx(r, (4, 9, 3)),
     lambda x: fft_safe.ifft(x, axis=1), lambda x: np.fft.ifft(x, axis=1)),
    ("fft2_default", lambda r: _cplx(r, (2, 6, 10)),
     lambda x: fft_safe.fft2(x), lambda x: np.fft.fft2(x)),
    ("ifft2_axes01", lambda r: _cplx(r, (6, 10, 2)),
     lambda x: fft_safe.ifft2(x, axes=(0, 1)),
     lambda x: np.fft.ifft2(x, axes=(0, 1))),
    ("rfft_last", lambda r: _real(r, (4, 5, 16)),
     lambda x: fft_safe.rfft(x, axis=2), lambda x: np.fft.rfft(x, axis=2)),
    ("irfft_odd_axis0", lambda r: np.fft.rfft(_real(r, (11, 4)), axis=0),
     lambda a: fft_safe.irfft(a, n=11, axis=0),
     lambda a: np.fft.irfft(a, n=11, axis=0)),
    ("rfft2_padded", lambda r: _real(r, (6, 7)),
     lambda x: fft_safe.rfft2(x, s=(12, 14), axes=(0, 1)),
     lambda x: np.fft.rfft2(x, s=(12, 14), axes=(0, 1))),
    ("rfft2_padded_negative_axes", lambda r: _real(r, (2, 5, 6)),
     lambda x: fft_safe.rfft2(x, s=(8, 6), axes=(-2, -1)),
     lambda x: np.fft.rfft2(x, s=(8, 6), axes=(-2, -1))),
    ("rfft2_unpadded", lambda r: _real(r, (8, 6, 3)),
     lambda x: fft_safe.rfft2(x, axes=(0, 1)),
     lambda x: np.fft.rfft2(x, axes=(0, 1))),
    ("irfft2_s", lambda r: np.fft.rfft2(_real(r, (12, 14))),
     lambda a: fft_safe.irfft2(a, s=(12, 14)),
     lambda a: np.fft.irfft2(a, s=(12, 14))),
]


@pytest.mark.parametrize("name,build,call,ref", CASES,
                         ids=[c[0] for c in CASES])
def test_facade_matches_numpy(rng, name, build, call, ref):
    x = build(rng)
    got = np.asarray(call(jnp.asarray(x)))
    want = ref(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_rfft2_rejects_s_smaller_than_input():
    with pytest.raises(ValueError):
        fft_safe.rfft2(jnp.zeros((8, 8)), s=(4, 8), axes=(0, 1))


def test_batched_under_vmap_equals_axes_call(rng):
    """The ensemble pipeline vmaps the cube transforms: the batched
    transform must equal one call over the trailing axes."""
    x = jnp.asarray(_real(rng, (3, 8, 6, 4)))
    a = jax.vmap(fft_safe.rfftn)(x)
    np.testing.assert_allclose(np.asarray(a),
                               np.asarray(fft_safe.rfftn(x, axes=(1, 2, 3))),
                               rtol=1e-12, atol=1e-12)
    back = jax.vmap(lambda v: fft_safe.irfftn(v, s=(8, 6, 4)))(a)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-12)
