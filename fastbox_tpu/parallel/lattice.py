"""Slab-sharded lattice CIC paint/gather with halo exchange.

The single-device lattice CIC (fields/lattice_cic.py) turns the COLA
engine's scatter/gather into data-independent periodic rolls.  This module
extends the same formulation to a slab decomposition of the leading (x)
axis inside ``shard_map``: rolls along the two *unsharded* axes stay local,
while cross-slab flow along the sharded axis is a pair of ``lax.ppermute``
strip exchanges per call — exactly the halo exchange a domain-decomposed PM
code performs over MPI, expressed as an XLA collective.

Geometry: a particle with wrapped displacement ``|d| <= B`` cells touches
cells offset by ``o in [-B, B+1]`` from its own lattice site, so a slab's
particles spill at most ``H = B + 1`` rows into each neighbouring slab
(requires slab height ``S >= H``).  Paint accumulates into an
``(S + 2H)``-row buffer and ships the two ``H``-row halo strips to the
neighbours; gather first builds an ``(S + 2H)``-row halo-extended mesh from
the neighbours and then reads static slices of it — no data-dependent
indexing anywhere, so both lower to dense, data-independent code.

Replaces: the reference's pycola3 evolution is single-process
(/root/reference/fastbox/box.py:499-537); its only distributed mesh path is
nbodykit's MPI pfft.  Here the *N-body engine itself* is SPMD.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..fields.lattice_cic import _axis_weights

__all__ = ["halo_paint", "halo_gather", "halo_extend",
           "halo_paint_many", "halo_gather_many"]


def _perm_pairs(nshards: int, shift: int):
    """ppermute pairs sending each shard's value to ``src + shift``."""
    return [(i, (i + shift) % nshards) for i in range(nshards)]


def halo_extend(mesh, H: int, axis_name: str, nshards: int):
    """Extend a slab ``(S, ...)`` with ``H`` ghost rows from each periodic
    neighbour along the sharded leading axis -> ``(S + 2H, ...)``."""
    prev_tail = lax.ppermute(mesh[-H:], axis_name, _perm_pairs(nshards, +1))
    next_head = lax.ppermute(mesh[:H], axis_name, _perm_pairs(nshards, -1))
    return jnp.concatenate([prev_tail, mesh, next_head], axis=0)


def halo_paint(disp, B: int, axis_name: str, nshards: int, weights=None):
    """Periodic CIC paint of a lattice-ordered particle slab.

    Parameters:
        disp: (S, N, N, 3) wrapped displacement of each particle from its
            own lattice site in cell units, ``|disp| <= B`` (the leading
            axis is the sharded one; S = N / nshards >= B + 1).
        B: static displacement bound in cells.
        axis_name: shard_map mesh axis of the slab decomposition.
        nshards: number of shards on that axis (static).
        weights: optional (S, N, N) per-particle weights.

    Returns:
        (S, N, N) slab of summed CIC weights (the caller's rows only; halo
        contributions have been exchanged and accumulated).
    """
    S = disp.shape[0]
    H = B + 1
    assert S >= H, f"slab height {S} must be >= B+1 = {H}"
    wx = _axis_weights(disp[..., 0], B)
    wy = _axis_weights(disp[..., 1], B)
    wz = _axis_weights(disp[..., 2], B)

    buf = None
    for ox in range(-B, B + 2):
        px = wx[ox] if weights is None else wx[ox] * weights
        sx = None
        for oy in range(-B, B + 2):
            pxy = px * wy[oy]
            sy = None
            for oz in range(-B, B + 2):
                t = jnp.roll(pxy * wz[oz], oz, axis=2)
                sy = t if sy is None else sy + t
            sy = jnp.roll(sy, oy, axis=1)
            sx = sy if sx is None else sx + sy
        if buf is None:
            buf = jnp.zeros((S + 2 * H,) + sx.shape[1:], sx.dtype)
        buf = buf.at[H + ox: H + ox + S].add(sx)

    # Halo strips: buf[:H] lands on the previous slab's tail rows,
    # buf[H+S:] on the next slab's head rows.
    recv_tail = lax.ppermute(buf[:H], axis_name, _perm_pairs(nshards, -1))
    recv_head = lax.ppermute(buf[H + S:], axis_name, _perm_pairs(nshards, +1))
    core = buf[H: H + S]
    return core.at[:H].add(recv_head).at[S - H:].add(recv_tail)


def halo_paint_many(disp, B: int, axis_name: str, nshards: int, weights):
    """``halo_paint`` for a channel stack of weights in ONE halo exchange.

    Parameters as :func:`halo_paint`, but ``weights`` is (C, S, N, N); the
    C paints share the axis-weight products and the two ppermute strip
    exchanges (the per-step collectives drop from 2C to 2).

    Returns (C, S, N, N).
    """
    S = disp.shape[0]
    H = B + 1
    assert S >= H, f"slab height {S} must be >= B+1 = {H}"
    wx = _axis_weights(disp[..., 0], B)
    wy = _axis_weights(disp[..., 1], B)
    wz = _axis_weights(disp[..., 2], B)

    buf = None
    for ox in range(-B, B + 2):
        px = wx[ox][None] * weights               # (C, S, N, N)
        sx = None
        for oy in range(-B, B + 2):
            pxy = px * wy[oy][None]
            sy = None
            for oz in range(-B, B + 2):
                t = jnp.roll(pxy * wz[oz][None], oz, axis=3)
                sy = t if sy is None else sy + t
            sy = jnp.roll(sy, oy, axis=2)
            sx = sy if sx is None else sx + sy
        if buf is None:
            buf = jnp.zeros(
                (sx.shape[0], S + 2 * H) + sx.shape[2:], sx.dtype)
        buf = buf.at[:, H + ox: H + ox + S].add(sx)

    recv_tail = lax.ppermute(buf[:, :H], axis_name, _perm_pairs(nshards, -1))
    recv_head = lax.ppermute(buf[:, H + S:], axis_name,
                             _perm_pairs(nshards, +1))
    core = buf[:, H: H + S]
    return core.at[:, :H].add(recv_head).at[:, S - H:].add(recv_tail)


def halo_gather_many(meshes, disp, B: int, axis_name: str, nshards: int):
    """``halo_gather`` for a channel stack of meshes in ONE halo exchange.

    ``meshes`` is (C, S, N, N); returns (C, S, N, N).  The C gathers share
    the axis weights and the single stacked halo extension.
    """
    S = meshes.shape[1]
    H = B + 1
    assert S >= H, f"slab height {S} must be >= B+1 = {H}"
    wx = _axis_weights(disp[..., 0], B)
    wy = _axis_weights(disp[..., 1], B)
    wz = _axis_weights(disp[..., 2], B)

    prev_tail = lax.ppermute(meshes[:, -H:], axis_name,
                             _perm_pairs(nshards, +1))
    next_head = lax.ppermute(meshes[:, :H], axis_name,
                             _perm_pairs(nshards, -1))
    ext = jnp.concatenate([prev_tail, meshes, next_head], axis=1)

    out = None
    for oz in range(-B, B + 2):
        rz = jnp.roll(ext, -oz, axis=3)
        for oy in range(-B, B + 2):
            ryz = jnp.roll(rz, -oy, axis=2)
            sx = None
            for ox in range(-B, B + 2):
                t = wx[ox][None] * ryz[:, H + ox: H + ox + S]
                sx = t if sx is None else sx + t
            term = (wy[oy] * wz[oz])[None] * sx
            out = term if out is None else out + term
    return out


def halo_gather(mesh, disp, B: int, axis_name: str, nshards: int):
    """Trilinear (CIC) interpolation of a slab-sharded periodic mesh at
    lattice-ordered particle positions (adjoint of :func:`halo_paint`).

    Parameters:
        mesh: (S, N, N) slab of the periodic field (leading axis sharded).
        disp: (S, N, N, 3) wrapped displacements in cell units, |disp| <= B.

    Returns:
        (S, N, N) interpolated values, one per particle.
    """
    S = mesh.shape[0]
    H = B + 1
    assert S >= H, f"slab height {S} must be >= B+1 = {H}"
    wx = _axis_weights(disp[..., 0], B)
    wy = _axis_weights(disp[..., 1], B)
    wz = _axis_weights(disp[..., 2], B)

    ext = halo_extend(mesh, H, axis_name, nshards)  # (S+2H, N, N)
    out = None
    for oz in range(-B, B + 2):
        rz = jnp.roll(ext, -oz, axis=2)
        for oy in range(-B, B + 2):
            ryz = jnp.roll(rz, -oy, axis=1)
            sx = None
            for ox in range(-B, B + 2):
                t = wx[ox] * ryz[H + ox: H + ox + S]
                sx = t if sx is None else sx + t
            term = wy[oy] * wz[oz] * sx
            out = term if out is None else out + term
    return out
