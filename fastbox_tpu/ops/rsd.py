"""Redshift-space distortion remapping.

The reference remaps each line of sight with a Python double loop over the
(x, y) pixel plane calling ``scipy.interpolate.griddata`` per LOS
(box.py:384-438) — its dominant cost at large N (SURVEY.md §6).  Here the
remap is a fixed-shape batched computation over all N^2 lines of sight at
once: one ``lax.sort_key_val`` along the LOS axis, then a gather-free
telescoping interpolation — banded (O(band) work per target) when every
sorted node lies within ``band`` cells of its rank, the exact chunked
O(N) sum otherwise, chosen on device by ``lax.cond``.

Semantics matched to the reference:
  * ``s = z - (v_z + v_nl) / H(a)`` (box.py:422)
  * periodic wrap ``s -> (s - z0) mod Lz + z0`` (box.py:425-426)
  * 1-D ``griddata`` linear: targets outside [min(s), max(s)] get the fill
    value ``0.5 (delta[...,0] + delta[...,-1])`` (box.py:429-437)
  * ``method='nearest'``: scipy dispatches to
    interp1d(kind='nearest', fill_value='extrapolate') — nearest endpoint
    out of range, midpoint bisection inside.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..grid import GridSpec

__all__ = ["redshift_space_density", "remap_los_batched", "add_scaled_normal"]

# Element budget of one (rows, C, T) block of the exact interpolation.
_CHUNK_ELEMS = 2 ** 27


def add_scaled_normal(x, scale_row, key, return_max: bool = False):
    """x + scale_row[..broadcast..] * N(0,1) along the last axis.

    The draw is ``jax.random.normal(key, x.shape, x.dtype)``, which XLA
    fuses with the scale and the add into one elementwise pass.
    ``scale_row`` is a (C,) per-last-axis scale.  With ``return_max``
    also returns ``max|result|`` (one extra reduction).
    """
    y = x + jax.random.normal(key, x.shape, x.dtype) \
        * jnp.asarray(scale_row, x.dtype)
    if return_max:
        return y, jnp.max(jnp.abs(y))
    return y


def _interp_sorted_banded(ss, vv, ztarget, w: int):
    """Banded telescoping interpolation for nearly-sorted nodes.

    Valid when every sorted node satisfies |ss[:, i] - ztarget[i]| <=
    w * dz (checked by the caller): then segment c is fully crossed for
    c < t - w and untouched for c >= t + w, so

        out(t) = vv[:, max(t-w, 0)]
                 + sum_{c = max(t-w,0)}^{min(t+w-1, C-2)} dv_c clamp_c(t)

    — O(w) work per target instead of O(C), with only static shifts
    (no gathers).  Physically w*dz bounds the RSD displacement
    |v|/H(a): at the default 256^3 / 4 Gpc configuration w=4 admits
    ~6700 km/s, far beyond any peculiar velocity in the box.
    """
    M, C = ss.shape
    dtype = vv.dtype
    dv = vv[:, 1:] - vv[:, :-1]
    ds = ss[:, 1:] - ss[:, :-1]
    # Pad segment arrays to length C so roll() windows stay in range
    dv = jnp.concatenate([dv, jnp.zeros((M, 1), dtype)], axis=1)
    ds = jnp.concatenate([ds, jnp.ones((M, 1), dtype)], axis=1)

    # base(t) = vv[:, max(t - w, 0)]
    base = jnp.concatenate(
        [jnp.broadcast_to(vv[:, :1], (M, w)), vv[:, : C - w]], axis=1)

    t_idx = jnp.arange(C)
    out = base
    for o in range(-w, w):
        c_idx = t_idx + o                        # segment index per target
        valid = (c_idx >= 0) & (c_idx <= C - 2)
        dv_o = jnp.roll(dv, -o, axis=1)
        ds_o = jnp.roll(ds, -o, axis=1)
        ss_o = jnp.roll(ss, -o, axis=1)
        safe_ds = jnp.where(ds_o > 0.0, ds_o, 1.0)
        frac = (ztarget[None, :] - ss_o) / safe_ds
        frac = jnp.where(ds_o > 0.0, frac,
                         (ztarget[None, :] >= ss_o).astype(dtype))
        wgt = jnp.clip(frac, 0.0, 1.0)
        out = out + jnp.where(valid[None, :], dv_o * wgt, 0.0)
    return out


def _interp_full_chunked(ss, vv, ztarget):
    """Exact telescoping interpolation over all segments, chunked over LOS.

    The naive broadcast materialises (M, C-1, T); at 512^3 in f64 that is
    ~550 GiB, which OOMed the CPU truth run (lax.cond allocates the max
    over branches, so even never-executed fallbacks must be bounded).
    ``lax.map`` over row blocks caps the temp at ~1 GiB while computing
    the identical result.
    """
    M, C = ss.shape
    T = int(ztarget.shape[0])
    rows = int(max(1, min(M, _CHUNK_ELEMS // max(C * T, 1))))
    pad = (-M) % rows
    ssp = jnp.pad(ss, ((0, pad), (0, 0)))
    vvp = jnp.pad(vv, ((0, pad), (0, 0)))

    def blk(args):
        s_, v_ = args
        dv_ = v_[:, 1:] - v_[:, :-1]
        ds_ = s_[:, 1:] - s_[:, :-1]
        safe = jnp.where(ds_ > 0.0, ds_, 1.0)
        fr = (ztarget[None, None, :] - s_[:, :-1, None]) / safe[:, :, None]
        fr = jnp.where(ds_[:, :, None] > 0.0, fr,
                       (ztarget[None, None, :]
                        >= s_[:, :-1, None]).astype(v_.dtype))
        return v_[:, :1] + jnp.sum(dv_[:, :, None]
                                   * jnp.clip(fr, 0.0, 1.0), axis=1)

    out = lax.map(blk, (ssp.reshape(-1, rows, C), vvp.reshape(-1, rows, C)))
    return out.reshape(-1, T)[:M]


def _banded_or_exact(ss, vv, ztarget, fill, band: int, dz: float):
    """Linear interpolation of sorted lines of sight: the banded path when
    every node is within ``band`` cells of its rank, the exact chunked sum
    otherwise (one ``lax.cond`` on the device-side bound), then the hull
    fill.

    Lines of sight are independent, so a vmapped call (the ensemble
    pipeline) folds its batch into the LOS axis and keeps ONE cond.  A
    plain vmap would turn the cond into a select that computes both
    branches, and the GPU compile of the fusion XLA builds from them does
    not finish in reasonable time.
    """
    @jax.custom_batching.custom_vmap
    def run(ss, vv, ztarget, fill):
        maxdisp = jnp.max(jnp.abs(ss - ztarget[None, :]))
        out = lax.cond(maxdisp <= band * dz,
                       lambda a: _interp_sorted_banded(*a, ztarget, band),
                       lambda a: _interp_full_chunked(*a, ztarget),
                       (ss, vv))
        inside = ((ztarget[None, :] >= ss[:, :1])
                  & (ztarget[None, :] <= ss[:, -1:]))
        return jnp.where(inside, out, fill[:, None])

    @run.def_vmap
    def _fold_batch_into_rows(axis_size, in_batched, ss, vv, ztarget, fill):
        if in_batched[2]:
            raise NotImplementedError("RSD targets must not be batched")
        ss, vv, fill = (
            x if b else jnp.broadcast_to(x, (axis_size,) + x.shape)
            for x, b in zip((ss, vv, fill), in_batched[:2] + in_batched[3:]))
        M, C = ss.shape[1:]
        out = run(ss.reshape(-1, C), vv.reshape(-1, C), ztarget,
                  fill.reshape(-1))
        return out.reshape((axis_size, M) + out.shape[1:]), True

    return run(ss, vv, ztarget, fill)


def remap_los_batched(vals, s, ztarget, fill, method: str = "linear",
                      band: int = 4, ztarget_np=None):
    """Scattered 1-D interpolation of many lines of sight at once.

    Uses the *telescoping* form of piecewise-linear interpolation on the
    sorted nodes: with dv_c = v_{c+1}-v_c and ds_c = s_{c+1}-s_c,

        out(t) = v_0 + sum_c dv_c * clamp((z_t - s_c)/ds_c, 0, 1)

    which needs no index computation and no gathers at all — just one fused
    broadcast-reduce over (LOS, segment, target).  Targets left of s_0 get
    v_0, right of s_last get v_last, exactly like sorted linear
    interpolation; the hull fill is applied afterwards.

    Parameters:
        vals: (M, C) sample values per LOS.
        s: (M, C) sample coordinates per LOS (unsorted).
        ztarget: (T,) target grid (shared by all LOS).
        fill: (M,) fill value per LOS (used by 'linear' outside the hull).
        method: 'linear' or 'nearest'.

    Returns:
        (M, T) interpolated values.
    """
    # Banded fast paths: the targets are the (uniform) grid the nodes were
    # displaced from, so when every sorted node lands within `band` cells
    # of its rank the O(C) telescoping sum collapses to O(band).  The bound
    # is checked on device; rare violating realisations (enormous
    # velocities / heavy wrapping) fall back to the exact full kernel via
    # lax.cond.  Concrete, uniform targets of matching length are required
    # to know the rank <-> coordinate correspondence.
    zt_np = None
    if method == "linear" and band > 0:
        import numpy as _np

        if ztarget_np is not None:
            zt_np = _np.asarray(ztarget_np)
        else:
            try:
                # Concrete only outside jit; jitted callers must pass
                # ztarget_np (a dtype cast turns constants into tracers).
                zt_np = _np.asarray(ztarget)
            except Exception:
                zt_np = None
        if zt_np is not None:
            d = _np.diff(zt_np.astype(_np.float64))
            # f32 coordinates carry ~1e-4 jitter in their diffs at Gpc
            # offsets; uniform-enough is all the band bound needs.
            if (zt_np.size != s.shape[1] or d.size == 0
                    or d.min() <= 0
                    or (d.max() - d.min()) > 1e-2 * abs(d.mean())):
                zt_np = None

    ss, vv = lax.sort_key_val(s, vals)

    if method == "linear" and zt_np is not None:
        return _banded_or_exact(ss, vv, ztarget, fill, band,
                                float(zt_np[1] - zt_np[0]))

    dv = vv[:, 1:] - vv[:, :-1]          # (M, C-1)

    if method == "linear":
        out = _interp_full_chunked(ss, vv, ztarget)
        inside = ((ztarget[None, :] >= ss[:, :1])
                  & (ztarget[None, :] <= ss[:, -1:]))
        return jnp.where(inside, out, fill[:, None])

    if method == "nearest":
        # interp1d 'nearest' (fill_value='extrapolate'): value switches at
        # segment midpoints, searchsorted(mids, z, side='left') semantics
        mids = 0.5 * (ss[:, 1:] + ss[:, :-1])
        step = (mids[:, :, None] < ztarget[None, None, :]).astype(vv.dtype)
        return vv[:, :1] + jnp.sum(dv[:, :, None] * step, axis=1)

    raise ValueError(f"Unsupported RSD interpolation method '{method}'")


@partial(jax.jit, static_argnames=("grid", "sigma_nl", "method"))
def redshift_space_density(
    delta_x,
    velocity_z,
    grid: GridSpec,
    Hz: float,
    sigma_nl: float = 0.0,
    key=None,
    method: str = "linear",
):
    """Remap a real-space density cube to redshift space (box.py:384-438).

    Parameters:
        delta_x: (N,N,N) real-space density field.
        velocity_z: (N,N,N) LOS (z-axis) velocity in km/s.
        grid: static geometry.
        Hz: H(a) in km/s/Mpc (the reference computes ``100 h E(a)`` at
            box.py:406).
        sigma_nl: RMS of incoherent small-scale velocities (km/s).  When > 0
            a ``key`` must be supplied for the random draw (box.py:416-418).
        key: jax PRNG key for the sigma_nl draw.
        method: 'linear' or 'nearest'.

    Returns:
        delta_s: (N,N,N) redshift-space density field.
    """
    rdtype = delta_x.dtype
    N = grid.N
    z = jnp.asarray(grid.z, dtype=rdtype)
    z0 = z[0]
    length_z = z[-1] - z[0]

    vel = velocity_z
    if sigma_nl > 0.0:
        if key is None:
            raise ValueError("sigma_nl > 0 requires a PRNG `key`.")
        vel = add_scaled_normal(vel, jnp.full(N, sigma_nl, rdtype), key)

    fill = 0.5 * (delta_x[..., 0] + delta_x[..., -1])

    # Redshift-space coordinate per voxel, periodically wrapped (box.py:422-426)
    u = z[None, None, :] - vel / jnp.asarray(Hz, rdtype)
    s = (u - z0) % length_z + z0

    out = remap_los_batched(
        delta_x.reshape(N * N, N), s.reshape(N * N, N), z,
        fill.reshape(N * N), method=method, ztarget_np=grid.z,
    )
    return out.reshape(N, N, N)
