"""Roll-based lattice CIC (fields/lattice_cic.py) vs the scatter/gather path.

The lattice formulation must be *exactly* the same operator as the
scatter-based CIC whenever displacements respect the band bound — these
tests pin that down in f64, plus the COLA integration (equivalence of the
full evolution, and the runtime fallback when the bound is violated).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.fields.cola import (
    cic_gather,
    cic_paint_particles,
    realise_density_cola,
)
from fastbox_tpu.fields.lattice_cic import (
    cic_gather_lattice,
    cic_paint_lattice,
    wrapped_displacement,
)
from fastbox_tpu.grid import GridSpec


def _lattice_setup(rng, N, B):
    disp = rng.uniform(-B, B, size=(N, N, N, 3))
    idx = np.stack(np.meshgrid(*(np.arange(N),) * 3, indexing="ij"), axis=-1)
    u = (idx + disp) % N  # box-wrapped positions in cell units
    return disp, u


def test_wrapped_displacement_recovers_raw_offsets(rng):
    N, B = 16, 3
    disp, u = _lattice_setup(rng, N, B)
    d = np.asarray(wrapped_displacement(jnp.asarray(u), N))
    assert np.abs(d - disp).max() < 1e-12


def test_paint_matches_scatter(rng):
    N, B = 16, 2
    disp, u = _lattice_setup(rng, N, B)
    w = rng.uniform(0.5, 2.0, size=(N, N, N))

    ref = cic_paint_particles(jnp.asarray(u.reshape(-1, 3)), N,
                              weights=jnp.asarray(w.ravel()))
    d = wrapped_displacement(jnp.asarray(u), N)
    got = cic_paint_lattice(d, B=B, weights=jnp.asarray(w))
    assert np.abs(np.asarray(ref) - np.asarray(got)).max() < 1e-11

    # unweighted too (mass conservation: sums to N^3)
    got1 = cic_paint_lattice(d, B=B)
    ref1 = cic_paint_particles(jnp.asarray(u.reshape(-1, 3)), N)
    assert np.abs(np.asarray(ref1) - np.asarray(got1)).max() < 1e-11
    assert abs(float(got1.sum()) - N**3) < 1e-8


def test_gather_matches_scatter_gather(rng):
    N, B = 16, 2
    disp, u = _lattice_setup(rng, N, B)
    mesh = jnp.asarray(rng.standard_normal((N, N, N)))
    ref = cic_gather(mesh, jnp.asarray(u.reshape(-1, 3))).reshape(N, N, N)
    d = wrapped_displacement(jnp.asarray(u), N)
    got = cic_gather_lattice(mesh, d, B=B)
    assert np.abs(np.asarray(ref) - np.asarray(got)).max() < 1e-12


def test_paint_gather_are_adjoint(rng):
    """<paint(w), m> == <w, gather(m)> — the pair is used as scatter and its
    transpose in the PM force, so adjointness is load-bearing."""
    N, B = 8, 2
    disp, u = _lattice_setup(rng, N, B)
    d = wrapped_displacement(jnp.asarray(u), N)
    w = jnp.asarray(rng.standard_normal((N, N, N)))
    m = jnp.asarray(rng.standard_normal((N, N, N)))
    lhs = float(jnp.vdot(cic_paint_lattice(d, B=B, weights=w), m))
    rhs = float(jnp.vdot(w, cic_gather_lattice(m, d, B=B)))
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))


def test_cola_lattice_matches_scatter_path():
    """Full COLA evolution: lattice CIC and scatter CIC give the same field
    (identical operators, different summation order only)."""
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.0)
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=16, redshift=0.0)
    kw = dict(redshift_init=9.0, n_steps=4, dtype=jnp.float64)
    d_lat, v_lat = realise_density_cola(jax.random.PRNGKey(5), grid, cosmo,
                                        lattice_B=2, **kw)
    d_sc, v_sc = realise_density_cola(jax.random.PRNGKey(5), grid, cosmo,
                                      lattice_B=None, **kw)
    assert np.abs(np.asarray(d_lat) - np.asarray(d_sc)).max() < 1e-8
    assert np.abs(np.asarray(v_lat) - np.asarray(v_sc)).max() < 1e-6


def test_cola_bound_violation_falls_back():
    """lattice_B=0 cannot hold (displacements exceed 0 cells), so every step
    must take the exact scatter fallback — results identical to the
    all-scatter path."""
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.0)
    grid = GridSpec.create(box_scale=(1e3,) * 3, nsamp=16, redshift=0.0)
    kw = dict(redshift_init=9.0, n_steps=3, dtype=jnp.float64)
    d0, _ = realise_density_cola(jax.random.PRNGKey(6), grid, cosmo,
                                 lattice_B=0, **kw)
    d1, _ = realise_density_cola(jax.random.PRNGKey(6), grid, cosmo,
                                 lattice_B=None, **kw)
    assert np.abs(np.asarray(d0) - np.asarray(d1)).max() < 1e-8


@pytest.mark.parametrize("B", [1, 2, 3])
def test_xla_lattice_matches_scatter_each_band(rng, B):
    """The roll lattice (the XLA path COLA takes within its band) equals
    the scatter-add paint and the gather at every ladder band."""
    N = 2 * B + 4
    disp, u = _lattice_setup(rng, N, B)
    w = rng.uniform(0.5, 2.0, size=(N, N, N))
    mesh = jnp.asarray(rng.standard_normal((N, N, N)))
    d = wrapped_displacement(jnp.asarray(u), N)
    p_ref = cic_paint_particles(jnp.asarray(u.reshape(-1, 3)), N,
                                weights=jnp.asarray(w.ravel()))
    p_lat = cic_paint_lattice(d, B=B, weights=jnp.asarray(w))
    assert np.abs(np.asarray(p_ref) - np.asarray(p_lat)).max() < 1e-11
    g_ref = cic_gather(mesh, jnp.asarray(u.reshape(-1, 3))).reshape(N, N, N)
    g_lat = cic_gather_lattice(mesh, d, B=B)
    assert np.abs(np.asarray(g_ref) - np.asarray(g_lat)).max() < 1e-12


@pytest.mark.parametrize("M", [64 * 3 + 17, 64 + 1, 64 * 2])
def test_scatter_remainder_block(rng, monkeypatch, M):
    """Particle counts that are not a multiple of the scatter chunk take a
    final remainder block: paint and gather equal the one-block path."""
    from fastbox_tpu.fields import cola as cola_mod

    N = 8
    u = jnp.asarray(rng.uniform(-1.0, N + 1.0, (M, 3)))
    w = jnp.asarray(rng.uniform(0.5, 1.5, M))
    mesh = jnp.asarray(rng.standard_normal((N, N, N)))
    p_ref = cola_mod.cic_paint_particles(u, N, weights=w)
    g_ref = cola_mod.cic_gather(mesh, u)
    monkeypatch.setattr(cola_mod, "_SCATTER_CHUNK", 64)
    p_chunk = cola_mod.cic_paint_particles(u, N, weights=w)
    g_chunk = cola_mod.cic_gather(mesh, u)
    assert g_chunk.shape == (M,)
    assert np.abs(np.asarray(p_ref) - np.asarray(p_chunk)).max() < 1e-12
    assert np.abs(np.asarray(g_ref) - np.asarray(g_chunk)).max() < 1e-12
    assert abs(float(p_chunk.sum()) - float(w.sum())) < 1e-9
