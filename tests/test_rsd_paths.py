"""The XLA RSD remap paths against the scipy-griddata oracle.

``remap_los_batched`` sorts each line of sight, then chooses on device
(``lax.cond``) between the banded telescoping interpolation (every sorted
node within ``band`` cells of its rank) and the exact chunked sum.  These
tests pin both branches, and the nearest-neighbour path, on power-of-two
and other grid sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import oracle
from fastbox_tpu.fields import gaussian
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.ops import rsd
from fastbox_tpu.ops.rsd import redshift_space_density, remap_los_batched


def _fields(cosmo, n):
    grid = GridSpec.create(box_scale=(1e2,) * 3, nsamp=n, redshift=0.0)
    dx, dk = gaussian.realise_density(jax.random.PRNGKey(n), grid, cosmo,
                                      dtype=jnp.float64)
    v = gaussian.realise_velocity(dk, grid, cosmo)
    vz = jnp.fft.ifftn(v[2]).real
    return grid, np.asarray(dx), np.asarray(vz), 100.0 * cosmo.h * cosmo.Ea


def _max_sorted_disp(grid, vz, Hz):
    """The quantity the lax.cond tests: max |sorted wrapped s - z|."""
    z = np.asarray(grid.z)
    L = z[-1] - z[0]
    s = (z[None, None, :] - vz / Hz - z[0]) % L + z[0]
    ss = np.sort(s.reshape(-1, grid.N), axis=1)
    return np.abs(ss - z[None, :]).max(), z[1] - z[0]


@pytest.mark.parametrize("n", [12, 16, 20])
@pytest.mark.parametrize("scale,branch", [(0.2, "banded"), (40.0, "exact")])
def test_linear_paths_match_griddata(cosmo_z0, n, scale, branch):
    grid, dx, vz, Hz = _fields(cosmo_z0, n)
    vz = vz * scale
    maxd, dz = _max_sorted_disp(grid, vz, Hz)
    assert (maxd <= 4 * dz) == (branch == "banded"), (maxd, dz)
    got = redshift_space_density(jnp.asarray(dx), jnp.asarray(vz), grid, Hz)
    want = oracle.redshift_space_density(dx, vz, np.asarray(grid.z), Hz)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("n", [12, 16])
def test_nearest_matches_griddata(cosmo_z0, n):
    grid, dx, vz, Hz = _fields(cosmo_z0, n)
    got = redshift_space_density(jnp.asarray(dx), jnp.asarray(vz), grid, Hz,
                                 method="nearest")
    want = oracle.redshift_space_density(dx, vz, np.asarray(grid.z), Hz,
                                         method="nearest")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-10)


def test_chunked_exact_interp_independent_of_block_rows(rng, monkeypatch):
    """_interp_full_chunked pads M to whole row blocks; the result must
    not depend on the block size (forced small here, with a remainder)."""
    M, C = 37, 16
    zt = np.linspace(0.0, 15.0, C)
    s = rng.uniform(-2.0, 17.0, (M, C))
    v = rng.standard_normal((M, C))
    ss, vv = lax.sort_key_val(jnp.asarray(s), jnp.asarray(v))
    whole = np.asarray(rsd._interp_full_chunked(ss, vv, jnp.asarray(zt)))
    # Blocks of 5 rows: 37 = 7*5 + 2 pads the last block
    monkeypatch.setattr(rsd, "_CHUNK_ELEMS", 5 * C * C)
    blocked = np.asarray(rsd._interp_full_chunked(ss, vv, jnp.asarray(zt)))
    np.testing.assert_allclose(blocked, whole, rtol=1e-12, atol=1e-12)
    dv = np.diff(np.asarray(vv), axis=1)
    ds = np.diff(np.asarray(ss), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        fr = (zt[None, None, :] - np.asarray(ss)[:, :-1, None]) / ds[..., None]
    fr = np.where(ds[..., None] > 0, fr,
                  (zt[None, None, :] >= np.asarray(ss)[:, :-1, None]))
    want = np.asarray(vv)[:, :1] + np.sum(dv[..., None]
                                          * np.clip(fr, 0.0, 1.0), axis=1)
    np.testing.assert_allclose(whole, want, rtol=1e-12, atol=1e-12)


def test_remap_cond_picks_exact_branch_beyond_band(rng):
    """Nodes displaced beyond the band: remap_los_batched must still equal
    the exact telescoping interpolation with the hull fill."""
    M, C, band = 8, 32, 2
    zt = np.arange(C, dtype=np.float64)
    s = zt[None, :] + rng.uniform(-6.0, 6.0, (M, C))   # up to 6 cells
    v = rng.standard_normal((M, C))
    fill = rng.standard_normal(M)
    got = np.asarray(remap_los_batched(jnp.asarray(v), jnp.asarray(s),
                                       jnp.asarray(zt), jnp.asarray(fill),
                                       band=band, ztarget_np=zt))
    ss, vv = lax.sort_key_val(jnp.asarray(s), jnp.asarray(v))
    exact = np.asarray(rsd._interp_full_chunked(ss, vv, jnp.asarray(zt)))
    ss = np.asarray(ss)
    inside = (zt[None, :] >= ss[:, :1]) & (zt[None, :] <= ss[:, -1:])
    np.testing.assert_allclose(got, np.where(inside, exact, fill[:, None]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 6, 16), (2, 128)])
def test_add_scaled_normal_moments(shape):
    """x + scale * N(0, 1): mean x, per-column std = scale."""
    C = shape[-1]
    scale = np.linspace(0.5, 2.0, C)
    x = jnp.full((64,) + shape, 3.0)
    y = np.asarray(rsd.add_scaled_normal(x, jnp.asarray(scale),
                                         jax.random.PRNGKey(0)))
    z = ((y - 3.0) / scale).reshape(-1)
    n = z.size
    assert abs(z.mean()) < 5.0 / np.sqrt(n)
    assert abs(z.std() - 1.0) < 5.0 / np.sqrt(2 * n)
    assert abs(np.mean(z ** 3)) < 0.1
    assert abs(np.mean(z ** 4) - 3.0) < 0.2


def test_add_scaled_normal_return_max():
    x = jnp.linspace(-1.0, 1.0, 48).reshape(3, 16)
    key = jax.random.PRNGKey(3)
    y, m = rsd.add_scaled_normal(x, jnp.full(16, 0.5), key, return_max=True)
    y0 = rsd.add_scaled_normal(x, jnp.full(16, 0.5), key)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y0))
    assert float(m) == float(np.abs(np.asarray(y)).max())


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_vmapped_remap_folds_batch_and_keeps_one_cond(rng, scale):
    """Under vmap (the ensemble pipeline) the remap equals the per-row
    remap, and the program keeps its cond instead of a select of both
    branches."""
    B, M, C = 3, 8, 32
    zt = np.arange(C, dtype=np.float64)
    s = zt[None, None, :] + scale * rng.uniform(-1.0, 1.0, (B, M, C))
    v = rng.standard_normal((B, M, C))
    fill = rng.standard_normal((B, M))

    def one(v_, s_, f_):
        return remap_los_batched(v_, s_, jnp.asarray(zt), f_, band=2,
                                 ztarget_np=zt)

    got = np.asarray(jax.vmap(one)(jnp.asarray(v), jnp.asarray(s),
                                   jnp.asarray(fill)))
    want = np.stack([np.asarray(one(jnp.asarray(v[b]), jnp.asarray(s[b]),
                                    jnp.asarray(fill[b])))
                     for b in range(B)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    jaxpr = str(jax.make_jaxpr(jax.vmap(one))(jnp.asarray(v), jnp.asarray(s),
                                               jnp.asarray(fill)))
    assert "cond[" in jaxpr
