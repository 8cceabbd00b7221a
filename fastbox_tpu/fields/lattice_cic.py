"""Lattice-ordered CIC paint/gather as data-independent periodic rolls.

The COLA engine's per-step CIC paint + force gather (fields/cola.py,
replacing the reference's pycola3 path at box.py:463-589) is a scatter-add
and a gather with data-dependent indices.  This module is the alternative
that needs neither: it exploits the structure a PM lattice gives us: particles are
never reordered, so the particle array IS a (N, N, N) grid in Lagrangian
order, and each particle's displacement from its own lattice site is
physically bounded (a few cells for any cosmological box).  When every
wrapped displacement satisfies ``|disp| <= B`` cells, the CIC cloud of the
particle at lattice site ``l`` only touches cells ``l + o`` with per-axis
offset ``o`` in ``[-B, B+1]`` — so the scatter-add becomes a sum of
``(2B+2)^3`` *data-independent* periodic rolls of elementwise weight
products, and the gather becomes the same sum with the mesh rolled the
other way.  Rolls are dense, data-independent memory traffic: no atomics,
no random access.

The periodic roll topology makes box wrapping exact: a particle that
crossed the box edge has a wrapped displacement near +-N/2 only if it
actually travelled that far — callers map displacements to [-N/2, N/2)
and the bound check covers the rest.

Exactness: identical to the scatter/gather CIC (fields/cola.py
``cic_paint_particles`` / ``cic_gather``) up to f.p. summation order,
whenever the bound holds.  Callers verify ``max |disp| <= B`` (one scalar
reduction) and ``lax.cond`` to the scatter path otherwise.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["cic_paint_lattice", "cic_gather_lattice", "wrapped_displacement",
           "wrapped_displacement_axes"]


def wrapped_displacement(u, N: int):
    """Map positions ``u`` (cell units) to the periodic displacement of each
    particle from its own lattice site, in [-N/2, N/2)."""
    shape = u.shape[:-1]
    idx = jnp.stack(
        jnp.meshgrid(*(jnp.arange(s, dtype=u.dtype) for s in shape),
                     indexing="ij"), axis=-1)
    d = u - idx
    return (d + N / 2.0) % N - N / 2.0


def wrapped_displacement_axes(u3, N: int):
    """Per-axis wrapped displacements for SoA positions ``u3`` (3, N, N, N).

    Returns a (dx, dy, dz) tuple of (N, N, N) arrays — the tuple form
    every lattice kernel accepts directly.  Each lattice coordinate is a
    broadcast 1-D iota, so nothing rank-4 is materialised."""
    dt = u3.dtype
    ax = jnp.arange(N, dtype=dt)
    out = []
    for i, idx in enumerate((ax[:, None, None], ax[None, :, None],
                             ax[None, None, :])):
        d = u3[i] - idx
        out.append((d + N / 2.0) % N - N / 2.0)
    return tuple(out)


def _disp_axes(disp):
    """Normalise displacement input: (N,N,N,3) array or (dx,dy,dz) tuple."""
    if isinstance(disp, tuple):
        return disp
    return disp[..., 0], disp[..., 1], disp[..., 2]


def _axis_weights(d, B: int):
    """Per-offset CIC weights along one axis.

    ``d`` is the (wrapped) displacement along the axis; the particle's
    cloud covers cells ``floor(d)`` (weight 1-frac) and ``floor(d)+1``
    (weight frac).  Returns a dict {o: weight field} for o in [-B, B+1].
    """
    fl = jnp.floor(d)
    fr = d - fl
    w = {}
    for o in range(-B, B + 2):
        w[o] = (1.0 - fr) * (fl == o) + fr * (fl == o - 1)
    return w


def cic_paint_lattice(disp, B: int = 2, weights=None):
    """Periodic CIC paint of lattice-ordered particles via rolls.

    Parameters:
        disp: (N, N, N, 3) displacement of each particle from its lattice
            site, in CELL units, wrapped to [-N/2, N/2) (use
            ``wrapped_displacement``).  Must satisfy ``|disp| <= B`` for
            exact results — the caller checks.
        B: static displacement bound in cells.
        weights: optional (N, N, N) per-particle weights (default 1).

    Returns:
        (N, N, N) mesh of summed CIC weights.
    """
    dx, dy, dz = _disp_axes(disp)
    wx = _axis_weights(dx, B)
    wy = _axis_weights(dy, B)
    wz = _axis_weights(dz, B)

    mesh = None
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
        sx = jnp.roll(sx, ox, axis=0)
        mesh = sx if mesh is None else mesh + sx
    return mesh


def cic_gather_lattice(mesh, disp, B: int = 2):
    """Trilinear (CIC) interpolation of a periodic mesh at lattice-ordered
    particle positions, via rolls (the adjoint of ``cic_paint_lattice``).

    Parameters:
        mesh: (N, N, N) periodic field.
        disp: (N, N, N, 3) wrapped displacements in cell units, |disp| <= B.
        B: static displacement bound in cells.

    Returns:
        (N, N, N) interpolated values, one per particle.
    """
    dx, dy, dz = _disp_axes(disp)
    wx = _axis_weights(dx, B)
    wy = _axis_weights(dy, B)
    wz = _axis_weights(dz, B)

    out = None
    for oz in range(-B, B + 2):
        rz = jnp.roll(mesh, -oz, axis=2)
        for oy in range(-B, B + 2):
            ryz = jnp.roll(rz, -oy, axis=1)
            sx = None
            for ox in range(-B, B + 2):
                t = wx[ox] * jnp.roll(ryz, -ox, axis=0)
                sx = t if sx is None else sx + t
            term = wy[oy] * wz[oz] * sx
            out = term if out is None else out + term
    return out
