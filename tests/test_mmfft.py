"""Oracle tests for the matmul FFTs (ops/mmfft.py), the formulation
behind ``PipelineConfig.fft_pair``, against numpy.fft on every code path
the package uses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastbox_tpu.ops import fft_safe, mmfft


@pytest.fixture()
def cube(rng):
    return rng.standard_normal((24, 24, 24)).astype(np.float32)


def test_fft_ifft_1d_all_axes(rng):
    c = (rng.standard_normal((12, 14, 16))
         + 1j * rng.standard_normal((12, 14, 16))).astype(np.complex64)
    for ax in range(3):
        got = np.asarray(mmfft.fft(jnp.asarray(c), ax))
        np.testing.assert_allclose(got, np.fft.fft(c, axis=ax),
                                   rtol=2e-5, atol=2e-5)
        got = np.asarray(mmfft.ifft(jnp.asarray(c), ax))
        np.testing.assert_allclose(got, np.fft.ifft(c, axis=ax),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [8, 15, 17, 31, 48, 100, 256, 512])
def test_fft_sizes_incl_primes_and_radix_splits(rng, n):
    y = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    got = np.asarray(mmfft.fft(jnp.asarray(y)))
    ref = np.fft.fft(y)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_rfftn3_irfftn3_roundtrip_and_oracle(cube):
    ah = np.fft.rfftn(cube)
    got = np.asarray(mmfft.rfftn3(jnp.asarray(cube)))
    np.testing.assert_allclose(got, ah, rtol=1e-4,
                               atol=1e-4 * np.abs(ah).max())
    back = np.asarray(mmfft.irfftn3(jnp.asarray(ah.astype(np.complex64)),
                                    cube.shape))
    np.testing.assert_allclose(back, cube, atol=5e-6)


def test_rfftn_any_partial_axes(rng):
    x = rng.standard_normal((6, 10, 12)).astype(np.float32)
    # half axis is the last of axes; batch over the remaining one
    got = np.asarray(mmfft.rfftn_any(jnp.asarray(x), (0, 1)))
    ref = np.fft.rfftn(x, axes=(0, 1))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    back = np.asarray(mmfft.irfftn_any(
        jnp.asarray(ref.astype(np.complex64)), x.shape[1], (0, 1)))
    np.testing.assert_allclose(back, x, atol=5e-6)


def test_irfft_1d_hermitian(rng):
    x = rng.standard_normal((5, 9, 16)).astype(np.float32)
    h = np.fft.rfft(x, axis=2).astype(np.complex64)
    got = np.asarray(mmfft.irfft(jnp.asarray(h), 16, 2))
    np.testing.assert_allclose(got, x, atol=5e-6)


def test_irfftn_pair_two_for_one(rng):
    a = rng.standard_normal((16, 16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16, 16)).astype(np.float32)
    ah = jnp.asarray(np.fft.rfftn(a).astype(np.complex64))
    bh = jnp.asarray(np.fft.rfftn(b).astype(np.complex64))
    ga, gb = mmfft.irfftn_pair(ah, bh, (16, 16, 16))
    np.testing.assert_allclose(np.asarray(ga), a, atol=5e-6)
    np.testing.assert_allclose(np.asarray(gb), b, atol=5e-6)


def test_batched_transforms(rng):
    xb = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    got = np.asarray(mmfft.fftn(jnp.asarray(xb, jnp.complex64),
                                axes=(1, 2, 3)))
    ref = np.fft.fftn(xb, axes=(1, 2, 3))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_f64_precision(rng):
    x = rng.standard_normal((12, 12, 12))
    ah = np.fft.rfftn(x)
    got = np.asarray(mmfft.rfftn3(jnp.asarray(x)))
    assert np.abs(got - ah).max() / np.abs(ah).max() < 1e-12
    back = np.asarray(mmfft.irfftn3(jnp.asarray(ah), x.shape))
    assert np.abs(back - x).max() < 1e-13


# ---------------------------------------------------------------------
# fft_safe facade
# ---------------------------------------------------------------------
def test_fft_safe_matches_native_on_cpu(cube):
    """Every fft_safe call is exactly the native transform."""
    x = jnp.asarray(cube)
    np.testing.assert_array_equal(np.asarray(fft_safe.rfftn(x)),
                                  np.asarray(jnp.fft.rfftn(x)))
    ah = jnp.fft.rfftn(x)
    np.testing.assert_array_equal(
        np.asarray(fft_safe.irfftn(ah, s=cube.shape)),
        np.asarray(jnp.fft.irfftn(ah, s=cube.shape)))
    np.testing.assert_array_equal(
        np.asarray(fft_safe.fftn(x.astype(jnp.complex64))),
        np.asarray(jnp.fft.fftn(x.astype(jnp.complex64))))


def test_fft_safe_rfft2_padding(rng):
    """The beam convolution path: zero-padded rfft2/irfft2."""
    x = rng.standard_normal((6, 7)).astype(np.float32)
    got = np.asarray(fft_safe.rfft2(jnp.asarray(x), s=(12, 14),
                                    axes=(0, 1)))
    ref = np.fft.rfft2(x, s=(12, 14), axes=(0, 1))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_factor_override_roundtrip(rng):
    """FACTOR_OVERRIDES reroutes the stage split without changing results.

    A (4, 8)-split length-32 DFT must agree with numpy exactly like the
    default dense stage; the override is keyed into the stage-matrix cache
    so flipping it mid-process takes effect on the next trace.
    """
    x = (rng.standard_normal((8, 32))
         + 1j * rng.standard_normal((8, 32))).astype(np.complex128)
    ref = np.fft.fft(x, axis=-1)
    try:
        mmfft.FACTOR_OVERRIDES[32] = (4, 8)
        got = np.asarray(mmfft.fft(jnp.asarray(x), axis=-1))
    finally:
        mmfft.FACTOR_OVERRIDES.pop(32, None)
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    # back on the default split: still exact
    got2 = np.asarray(mmfft.fft(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(got2, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_set_precision_roundtrips():
    prev = mmfft._PREC
    try:
        mmfft.set_precision("HIGH")
        assert mmfft._PREC == jax.lax.Precision.HIGH
        mmfft.set_precision("SPLIT")
        assert mmfft._PREC is mmfft.SPLIT
    finally:
        mmfft._PREC = prev


def test_split_precision_oracle(rng):
    """SPLIT (Dekker-split weights, two-einsum HIGHEST contractions) must
    match numpy at least as tightly as the plain f32 path on every route:
    rfftn3/irfftn3, C2C fft/ifft, and the precision-string plumbing."""
    cube = rng.standard_normal((24, 20, 16)).astype(np.float32)
    ah = np.fft.rfftn(cube.astype(np.float64))
    got = np.asarray(mmfft.rfftn_any(jnp.asarray(cube), (0, 1, 2),
                                     precision="SPLIT"))
    assert got.dtype == np.complex64
    assert np.abs(got - ah).max() / np.abs(ah).max() < 1e-5

    back = np.asarray(mmfft.irfftn_any(jnp.asarray(ah.astype(np.complex64)),
                                       16, (0, 1, 2), precision="SPLIT"))
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, cube, atol=5e-6)

    c = (rng.standard_normal(48) + 1j * rng.standard_normal(48)
         ).astype(np.complex64)
    got1 = np.asarray(mmfft.fft(jnp.asarray(c), precision="SPLIT"))
    ref1 = np.fft.fft(c)
    assert np.abs(got1 - ref1).max() / np.abs(ref1).max() < 1e-5

    # f64 inputs degrade SPLIT to HIGHEST (weights already full precision)
    c64 = c.astype(np.complex128)
    got2 = np.asarray(mmfft.fft(jnp.asarray(c64), precision="SPLIT"))
    np.testing.assert_allclose(got2, np.fft.fft(c64), rtol=1e-12,
                               atol=1e-12 * np.abs(ref1).max())


def test_split_pair_exact():
    """hi + lo reconstructs the f64 master to ~2^-48 relative."""
    W = np.exp(-2j * np.pi * np.outer(np.arange(64), np.arange(64)) / 64)
    hi, lo = mmfft._split_pair(W)
    err = np.abs((hi.astype(np.complex128) + lo.astype(np.complex128)) - W)
    assert err.max() < 1e-13
    hr, lr = mmfft._split_pair(W.real)
    errr = np.abs((hr.astype(np.float64) + lr.astype(np.float64)) - W.real)
    assert errr.max() < 1e-13
