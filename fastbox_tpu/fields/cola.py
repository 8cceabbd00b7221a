"""COLA (COmoving Lagrangian Acceleration) approximate N-body engine.

Native replacement for the reference's optional pycola3 dependency
(box.py:463-589): 2LPT initial conditions plus a particle-mesh leapfrog in
which particles evolve *relative to* their 2LPT trajectories (Tassev,
Zaldarriaga & Eisenstein 2013), so ~10 steps give accurate quasi-linear
structure.  The whole evolution is one ``lax.scan`` inside jit: CIC paint
(scatter-add), k-space Poisson solve, CIC force gather, kick/drift with
host-precomputed step integrals.

Units: comoving Mpc, velocities in km/s (momentum p = a^2 dx/dt), H in
km/s/Mpc.  Force: lap(phi) = (3/2) Omega_m H0^2 delta / a.  The COLA
compensation subtracts the LPT acceleration
d(p_lpt)/dt = (3/2) Omega_m H0^2 / a [D1 psi1 + (D2 - D1^2) psi2],
which follows from the first- and second-order growth equations.
"""
from __future__ import annotations

from functools import lru_cache, partial

import os
import jax
import jax.numpy as jnp
from ..ops import fft_safe
import numpy as np
from jax import lax
from scipy.integrate import quad

from ..cosmology import background as bg
from ..grid import GridSpec
from .gaussian import white_noise, gaussian_field_from_whitenoise
from .lpt import lpt_displacements, second_order_growth

__all__ = ["realise_density_cola", "cic_paint_particles", "cic_gather"]


# ----------------------------------------------------------------------
# CIC scatter / gather on the periodic grid (cell units)
# ----------------------------------------------------------------------
# Particle chunk for the scatter/gather paths.  The flat (M, 3)
# index/weight temporaries of a monolithic scatter cost ~8.5 GB of HLO
# temps inside the cond at 512^3 (134M particles; XLA allocates a
# cond's branches at their max).  Chunking bounds the branch at
# ~chunk*3 ints + a mesh carry; 4M rows keeps it under ~0.2 GB.
_SCATTER_CHUNK = 4 * 1024 * 1024

# Grid size at and above which the COLA evolution dispatches step-by-step
# (donated state) instead of as one scan program — see _build_evolve_cached.
# Module-level so tests can shrink it to exercise the lowmem path.
_LOWMEM_MIN_N = 512


def _u_axes(u):
    """Normalise positions: (M, 3) array or a (ux, uy, uz) tuple of flat
    (M,) components (the SoA engine layout)."""
    if isinstance(u, tuple):
        return u
    return u[:, 0], u[:, 1], u[:, 2]


def _paint_block(mesh, ub, wb, N: int):
    uxb, uyb, uzb = ub
    fl = [jnp.floor(a) for a in (uxb, uyb, uzb)]
    fr = [a - f for a, f in zip((uxb, uyb, uzb), fl)]
    i0 = [f.astype(jnp.int32) for f in fl]
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - fr[0], fr[0])
        ix = jnp.mod(i0[0] + dx, N)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - fr[1], fr[1])
            iy = jnp.mod(i0[1] + dy, N)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - fr[2], fr[2])
                iz = jnp.mod(i0[2] + dz, N)
                mesh = mesh.at[ix, iy, iz].add(wb * wx * wy * wz)
    return mesh


def cic_paint_particles(u, N: int, weights=None):
    """Scatter particles at positions ``u`` (cell units, any real) onto an
    (N,N,N) periodic mesh with CIC weights.  ``u`` is (M, 3) or an SoA
    (ux, uy, uz) tuple of (M,) components.

    Large particle counts scatter in ``_SCATTER_CHUNK`` row blocks via
    ``lax.fori_loop`` with the mesh as carry, then one remainder block
    for the last ``M % _SCATTER_CHUNK`` rows — identical sums up to the
    order of float additions into a cell, bounded temporaries."""
    ux, uy, uz = _u_axes(u)
    M = ux.shape[0]
    w = jnp.ones(M, ux.dtype) if weights is None else weights
    mesh = jnp.zeros((N, N, N), ux.dtype)
    if M <= _SCATTER_CHUNK:
        return _paint_block(mesh, (ux, uy, uz), w, N)

    chunk = _SCATTER_CHUNK
    nfull = M // chunk

    def body(i, mesh):
        ub = tuple(jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
                   for a in (ux, uy, uz))
        wb = jax.lax.dynamic_slice_in_dim(w, i * chunk, chunk)
        return _paint_block(mesh, ub, wb, N)

    mesh = jax.lax.fori_loop(0, nfull, body, mesh)
    if M % chunk:
        tail = slice(nfull * chunk, M)
        mesh = _paint_block(mesh, (ux[tail], uy[tail], uz[tail]), w[tail], N)
    return mesh


def _gather_block(mesh, ub, N: int):
    uxb, uyb, uzb = ub
    fl = [jnp.floor(a) for a in (uxb, uyb, uzb)]
    fr = [a - f for a, f in zip((uxb, uyb, uzb), fl)]
    i0 = [f.astype(jnp.int32) for f in fl]
    out = jnp.zeros(uxb.shape[0], mesh.dtype)
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - fr[0], fr[0])
        ix = jnp.mod(i0[0] + dx, N)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - fr[1], fr[1])
            iy = jnp.mod(i0[1] + dy, N)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - fr[2], fr[2])
                iz = jnp.mod(i0[2] + dz, N)
                out = out + mesh[ix, iy, iz] * wx * wy * wz
    return out


def cic_gather(mesh, u):
    """Trilinear (CIC) interpolation of a periodic mesh at positions ``u``
    (cell units; (M, 3) or an SoA component tuple).  Chunked like
    :func:`cic_paint_particles` (the flat index temporaries of a
    monolithic gather are the same ~GB class at 512^3)."""
    ux, uy, uz = _u_axes(u)
    N = mesh.shape[0]
    M = ux.shape[0]
    if M <= _SCATTER_CHUNK:
        return _gather_block(mesh, (ux, uy, uz), N)

    chunk = _SCATTER_CHUNK
    nfull = M // chunk

    def blk(ub):
        return _gather_block(mesh, tuple(ub), N)

    head = slice(0, nfull * chunk)
    out = jax.lax.map(blk, tuple(a[head].reshape(nfull, chunk)
                                 for a in (ux, uy, uz))).reshape(-1)
    if M % chunk:
        tail = slice(nfull * chunk, M)
        out = jnp.concatenate(
            [out, _gather_block(mesh, (ux[tail], uy[tail], uz[tail]), N)])
    return out


# ----------------------------------------------------------------------
# Host-side step schedule
# ----------------------------------------------------------------------
def _growth_scalars(params, a):
    a_tab, D_tab, f_tab = bg.growth_tables(params)
    D1 = np.interp(np.log(a), np.log(a_tab), D_tab)
    f1 = np.interp(np.log(a), np.log(a_tab), f_tab)
    om = bg.omega_m_of_a(params, a)
    D2 = second_order_growth(D1, om)
    # f2 = dlnD2/dlna from D2(a) = -3/7 D1^2 om^(-1/143), numerically
    eps = 1e-4
    f2 = (np.log(np.abs(second_order_growth(
        np.interp(np.log(a * (1 + eps)), np.log(a_tab), D_tab),
        bg.omega_m_of_a(params, a * (1 + eps)))))
        - np.log(np.abs(D2))) / np.log(1 + eps)
    return float(D1), float(f1), float(D2), float(f2)


def _kick_drift_integrals(params, a1, a2):
    """Kick dt = int da/(a H) (dp/da = F/(aH)) and drift
    int da/(a^3 H) (dx/da = p/(a^3 H)), with p = a^2 dx/dt."""
    H0 = 100.0 * params.h
    K = quad(lambda a: 1.0 / (a * bg.e_of_a(params, a)), a1, a2)[0] / H0
    D = quad(lambda a: 1.0 / (a**3 * bg.e_of_a(params, a)), a1, a2)[0] / H0
    return K, D


# ----------------------------------------------------------------------
# Main engine
# ----------------------------------------------------------------------
def realise_density_cola(key, grid: GridSpec, cosmology, redshift=None,
                         redshift_init: float = 15.0, n_steps: int | None = None,
                         dtype=jnp.float32, keep_velocities: bool = True,
                         force_factor: int = 1, lattice_B: int | None = None,
                         gradient: str = "spectral",
                         diagnostics: bool = False):
    """Evolve a 2LPT+COLA realisation to the target redshift.

    Parameters mirror the reference's ``realise_density_cola``
    (box.py:463-534): ``redshift_init`` is the starting redshift,
    ``n_steps`` defaults to ``int(1 + z_init)`` as in the pycola3 driver.
    ``force_factor`` (the pycola3 ``gridscale`` analog) computes PM forces
    on a mesh of ``force_factor * N`` cells per side: 2-3x sharpens
    small-scale growth near the particle Nyquist at 8-27x the force-mesh
    memory; 1 (default) matches the particle grid.

    ``lattice_B`` (force_factor == 1 only) enables the lattice CIC
    paint/gather with an ADAPTIVE band ladder: each force evaluation
    measures max|displacement| and ``lax.switch``es to the smallest band
    B' <= lattice_B that covers it (kernel cost grows ~(2B+2)^3, and
    early steps need only B'=1), falling back to the exact scatter path
    beyond ``lattice_B``.  ``None`` (default) disables it: every step
    runs the scatter-add paint and the gather.  The lattice is the
    periodic-roll formulation of fields/lattice_cic.py; on an H100 at
    256^3 the scatter path is ~50x faster per realisation and compiles in
    seconds instead of minutes (PERF.md), so the lattice stays an option.

    ``gradient`` selects how the PM force is differentiated from the
    k-space Poisson solve: ``"spectral"`` (default) inverse-transforms the
    three ``i k_i phi_k`` components (3 big C2R transforms per step);
    ``"fd4"``/``"fd6"`` inverse-transform the potential ONCE and take
    4th/6th-order centred finite differences in real space (12/18
    periodic rolls — bandwidth-bound elementwise traffic that XLA fuses,
    ~1/3 the transform cost per step).  The FD kernels under-pull the
    force approaching the mesh Nyquist (keff/k at kh=pi/2: fd4 0.849,
    fd6 0.934), which measurably suppresses small-scale growth: at 32^3
    the field std lands 15% (fd4) / 10% (fd6) below spectral while
    large-scale P(k) matches to <1.5% (tests/test_cola.py).  Standard
    PM-code practice (FastPM-style FD kernels) but NOT the validated
    default here — spectral differentiation is; use FD only where the
    transform wall dominates and near-Nyquist power is discarded anyway.

    With ``diagnostics=True`` a third return value carries per-step probe
    arrays: ``maxdisp`` (max wrapped Lagrangian displacement in cells at
    each force evaluation), ``frac_out`` (fraction of displacement
    components beyond ``lattice_B``) and ``used_lattice`` (ladder branch
    index per step: 0.. selects band 1..lattice_B, len(bands) means the
    scatter fallback ran, -1 means lattice disabled).

    Returns:
        (delta_x, vel[, diag]) where delta_x is the CIC density contrast on
        the grid and vel is a (3, N, N, N) grid of CIC-averaged peculiar
        velocities in km/s (zeros where empty) if ``keep_velocities``,
        else None.
    """
    assert grid.Lx == grid.Ly == grid.Lz, "COLA requires a cubic box"
    dtype = jnp.dtype(dtype)
    params = cosmology.params
    z_final = grid.redshift if redshift is None else redshift
    a_init = 1.0 / (1.0 + redshift_init)
    a_final = 1.0 / (1.0 + z_final)
    assert redshift_init > z_final, "Must have redshift_init > redshift"
    if n_steps is None:
        n_steps = int(1 + redshift_init)

    N = grid.N
    cell = grid.Lx / N
    H0 = 100.0 * params.h
    fac_pm = 1.5 * params.Omega_m * H0**2

    # --- step schedule (host) -------------------------------------
    a_steps = np.linspace(a_init, a_final, n_steps + 1)
    a_half = 0.5 * (a_steps[:-1] + a_steps[1:])
    kicks1, kicks2, drifts = [], [], []
    D1s, D2s, dD1, dD2, a_force = [], [], [], [], []
    for i in range(n_steps):
        K1, _ = _kick_drift_integrals(params, a_steps[i], a_half[i])
        K2, _ = _kick_drift_integrals(params, a_half[i], a_steps[i + 1])
        _, Dr = _kick_drift_integrals(params, a_steps[i], a_steps[i + 1])
        kicks1.append(K1)
        kicks2.append(K2)
        drifts.append(Dr)
        d1a, _, d2a, _ = _growth_scalars(params, a_steps[i])
        d1b, _, d2b, _ = _growth_scalars(params, a_steps[i + 1])
        D1s.append(d1a)
        D2s.append(d2a)
        dD1.append(d1b - d1a)
        dD2.append(d2b - d2a)
        a_force.append(a_steps[i])
    D1_f, f1_f, D2_f, f2_f = _growth_scalars(params, a_final)

    step_consts = tuple(
        jnp.asarray(np.asarray(v), dtype)
        for v in (kicks1, kicks2, drifts, D1s, D2s, dD1, dD2, a_force)
    )

    # --- initial conditions ---------------------------------------
    white = white_noise(key, grid, dtype)
    delta_x0, delta_k0 = gaussian_field_from_whitenoise(white, grid,
                                                        cosmology.pk_lin_z0)
    psi1, psi2 = lpt_displacements(delta_k0, grid)  # (3,N,N,N) each, Mpc
    # Free the IC intermediates NOW: they would otherwise stay live on
    # device through the whole evolution (~1.5 GB at 512^3 — white +
    # delta_x0 + the complex half-spectrum).
    del white, delta_x0, delta_k0
    if N >= _LOWMEM_MIN_N:
        # Async dispatch would overlap the 2LPT program's multi-GB temps
        # with the evolution's first programs; at the lowmem sizes that
        # transient union can exceed device memory.  Wait for the ICs so
        # their temporaries are freed before the evolution enqueues.
        jax.block_until_ready((psi1, psi2))

    # SoA particle state (3, N, N, N): the cubes feed the lattice CIC's
    # tuple API with zero transposes.  The lattice coordinates themselves
    # are built IN-TRACE from iota inside the engine's init program (a
    # host-side q cube would be a 1.5 GB transfer at 512^3).
    p1 = psi1  # (3, N, N, N), Mpc
    p2 = psi2

    d1_init, _, d2_init, _ = _growth_scalars(params, a_init)

    # Scalars the compiled program takes as runtime arguments, so one
    # compiled ``evolve`` serves every cosmology/redshift at a given
    # (grid, force_factor, lattice_B, dtype, keep_velocities).
    a2H = a_final**2 * H0 * float(bg.e_of_a(params, a_final))
    scal = jnp.asarray(
        [d1_init, d2_init, fac_pm, a2H * f1_f * D1_f, a2H * f2_f * D2_f,
         1.0 / a_final], dtype)

    if gradient not in ("spectral", "fd4", "fd6"):
        raise ValueError(f"Unknown gradient '{gradient}'")
    evolve = _build_evolve_cached(grid, int(force_factor),
                                  None if lattice_B is None else int(lattice_B),
                                  dtype.name, bool(keep_velocities),
                                  bool(diagnostics), gradient)
    return evolve(p1, p2, step_consts, scal)


@lru_cache(maxsize=8)
def _build_evolve_cached(grid: GridSpec, force_factor: int,
                         lattice_B: int | None,
                         dtype_name: str, keep_velocities: bool,
                         diagnostics: bool = False,
                         gradient: str = "spectral"):
    """Compile-once COLA evolution program for a static configuration.

    Cached on the static knobs only: the cosmology enters via the runtime
    ``scal`` vector and ``step_consts`` arrays, and n_steps via the scan
    length, so re-realising (new seeds, new cosmologies) never re-traces.
    """
    dtype = jnp.dtype(dtype_name)
    N = grid.N
    cell = grid.Lx / N

    # Lattice-ordered roll-based CIC (fields/lattice_cic.py) replaces the
    # scatter/gather path whenever the force mesh matches the particle grid
    # and every wrapped displacement fits the static bound — checked per
    # call, with a lax.cond fallback to the exact scatter path.
    use_lattice = (force_factor == 1 and lattice_B is not None)
    # Adaptive band ladder: the kernel cost grows ~(2B+2)^3, while max|d|
    # grows smoothly over the evolution (0.2 -> 2.4 cells at 256^3/4Gpc),
    # so each force evaluation picks the smallest band covering the
    # CURRENT displacements via lax.switch; beyond the widest band the
    # exact scatter path runs.
    bands = () if not use_lattice else tuple(
        b for b in range(1, int(lattice_B) + 1) if 2 * b + 2 <= N)
    if use_lattice or diagnostics:
        from .lattice_cic import (cic_gather_lattice, cic_paint_lattice,
                                  wrapped_displacement_axes)

    Nf = N * force_factor
    cell_f = grid.Lx / Nf
    Hf = Nf // 2 + 1
    kf = 2.0 * np.pi * np.fft.fftfreq(Nf, d=1.0 / Nf) / grid.Lx
    # Zero the derivative axis's Nyquist plane: in the full-FFT form the
    # ``.real`` projection drops exactly that (anti-Hermitian) plane, so
    # this keeps the rfft-based solve equivalent to fftn + .real.
    nyq_full = np.zeros(Nf, bool)
    nyq_half = np.zeros(Hf, bool)
    if Nf % 2 == 0:
        nyq_full[Nf // 2] = True
        nyq_half[-1] = True
    kx_d_np = np.where(nyq_full, 0.0, kf)
    kz_d_np = np.where(nyq_half, 0.0, kf[:Hf])
    # 1-D constants only — the 3-D k^2 grid and the particle-Nyquist cut
    # are broadcast on the fly inside jit (embedded N^3 constants would
    # be compiled into the program and blow up at large N).
    m1_np = np.abs(kf) <= np.pi * N / grid.Lx * (1 + 1e-12)

    # lowmem (N >= _LOWMEM_MIN_N): dispatch the evolution step-by-step
    # with donated (x, v) state instead of one scan program.  At 512^3
    # the monolithic program's temps (15 GB) plus the 4.8 GB state
    # arguments and outputs total ~20.6 GB (compiled.memory_analysis());
    # per-step programs hold only one force evaluation's temps, and
    # donation aliases the state through each call.  The host-
    # orchestrated phase programs implement the spectral gradient on
    # the particle-resolution mesh only (force_factor 1); other
    # configurations keep the scan program (they are opt-in research
    # knobs, not the shipping path).
    lowmem = (N >= _LOWMEM_MIN_N and gradient == "spectral"
              and force_factor == 1)

    def band_index(maxd):
        """Smallest ladder band covering maxd STRICTLY (maxd < b);
        len(bands) -> scatter.  A displacement exactly equal to b
        (measure-zero) escalates to the next band / the exact scatter
        fallback."""
        idx = jnp.int32(0)
        for b in bands:
            idx = idx + (maxd >= dtype.type(b)).astype(jnp.int32)
        return idx

    def _flat(u3):
        return tuple(u3[i].reshape(-1) for i in range(3))

    def _maxabs(d):
        return jnp.maximum(jnp.maximum(jnp.max(jnp.abs(d[0])),
                                       jnp.max(jnp.abs(d[1]))),
                           jnp.max(jnp.abs(d[2])))

    def _kconsts():
        # Rebuilt inside every trace: 1-D hosts broadcast on the fly
        # (no embedded N^3 constants).
        kxf = jnp.asarray(kf, dtype)
        kzf_h = jnp.asarray(kf[:Hf].copy(), dtype)
        k2f = (kxf[:, None, None] ** 2 + kxf[None, :, None] ** 2
               + kzf_h[None, None, :] ** 2)
        if force_factor > 1:
            # Keep only modes that exist on the particle grid: beyond the
            # particle Nyquist the painted density is pure discreteness
            # (lattice harmonics) whose forces random-walk the particles.
            # With the cut, the finer mesh's whole benefit is its narrower
            # CIC window — sharper small-scale growth (validated against
            # the analytic 2LPT force: residual halves at force_factor=2).
            m1 = jnp.asarray(m1_np)
            m1h = jnp.asarray(m1_np[:Hf])
            kcut = (m1[:, None, None] & m1[None, :, None]
                    & m1h[None, None, :])
        else:
            kcut = None
        return k2f, kcut

    mean_per_cell = dtype.type(N**3 / Nf**3)

    def pm_force(x, a, fac_pm):
        kx_d = jnp.asarray(kx_d_np, dtype)
        kz_d = jnp.asarray(kz_d_np, dtype)
        k2f, kcut = _kconsts()
        u = x / cell_f                       # (3, N, N, N)
        diag = None
        if use_lattice:
            d = wrapped_displacement_axes(u, N)
            maxd = _maxabs(d)
            idx = band_index(maxd)
            if diagnostics:
                frac = sum(
                    jnp.mean((jnp.abs(c) > dtype.type(lattice_B))
                             .astype(dtype)) for c in d) / 3.0
                diag = (maxd, frac, idx)
            rho = lax.switch(
                idx,
                [partial(cic_paint_lattice, d, B=b) for b in bands]
                + [partial(cic_paint_particles, _flat(u), Nf)])
        else:
            if diagnostics:
                d_p = wrapped_displacement_axes(x / cell, N)
                bref = dtype.type(lattice_B if lattice_B is not None
                                  else 2)
                diag = (_maxabs(d_p),
                        sum(jnp.mean((jnp.abs(c) > bref).astype(dtype))
                            for c in d_p) / 3.0,
                        jnp.int32(-1))
            rho = cic_paint_particles(_flat(u), Nf)
        delta = rho / mean_per_cell - 1.0
        dk = fft_safe.rfftn(delta)
        if kcut is not None:
            dk = dk * kcut
        inv_k2 = jnp.where(k2f > 0.0, 1.0 / jnp.where(k2f > 0.0, k2f, 1.0), 0.0)
        c = fac_pm / a
        # Note: no window deconvolution in the force — W^-2 diverges at
        # the mesh corners and pumps aliasing noise into the particles.
        # Growth is therefore mildly suppressed approaching the particle
        # Nyquist; pass force_factor >= 2 when that regime matters.
        if gradient in ("fd4", "fd6"):
            # One inverse transform of the potential, then centred
            # finite differences.  Periodic rolls are bandwidth-bound
            # elementwise traffic that XLA fuses — ~1/3 the per-step
            # transform cost of the spectral path.  Stencils
            # (coefficients over [f_{j+1}-f_{j-1}, f_{j+2}-f_{j-2},
            # f_{j+3}-f_{j-3}] / denom*h):
            #   fd4: (8, -1) / 12        keff/k at kh=pi/2: 0.849
            #   fd6: (45, -9, 1) / 60    keff/k at kh=pi/2: 0.934
            phi = fft_safe.irfftn(c * dk * inv_k2, s=(Nf, Nf, Nf))
            if gradient == "fd4":
                coeffs, denom = (8.0, -1.0), 12.0
            else:
                coeffs, denom = (45.0, -9.0, 1.0), 60.0
            invh = dtype.type(1.0 / (denom * cell_f))

            def fd(ax):
                acc = None
                for j, cj in enumerate(coeffs, start=1):
                    t = dtype.type(cj) * (jnp.roll(phi, -j, ax)
                                          - jnp.roll(phi, j, ax))
                    acc = t if acc is None else acc + t
                return acc * invh

            comps = (lambda: fd(0), lambda: fd(1), lambda: fd(2))
        else:
            base = (1j * c) * dk * inv_k2
            comps = tuple(
                (lambda kvec=kvec: fft_safe.irfftn(
                    base * kvec, s=(Nf, Nf, Nf)))
                for kvec in (kx_d[:, None, None], kx_d[None, :, None],
                             kz_d[None, None, :]))

        def gather_one(F):
            if not use_lattice:
                return cic_gather(F, _flat(u)).reshape(u.shape[1:])

            def g_lat(b):
                return cic_gather_lattice(F, d, B=b)

            def g_sc():
                return cic_gather(F, _flat(u)).reshape(N, N, N)

            return lax.switch(
                idx, [partial(g_lat, b) for b in bands] + [g_sc])

        # Sequential per-component transform + gather: each force mesh
        # is consumed by its own gather before the next is produced, so
        # only ONE (N,N,N) mesh is live at a time.
        return jnp.stack([gather_one(f()) for f in comps], axis=0), diag

    def step_body(x, v, p1, p2, consts, fac_pm):
        K1, K2, Dr, D1, D2, dD1_, dD2_, a_f = consts
        F, diag = pm_force(x, a_f, fac_pm)
        # COLA compensation: subtract the LPT acceleration
        comp = (fac_pm / a_f) * (D1 * p1 + (D2 - D1**2) * p2)
        Fres = F - comp
        v = v + Fres * (K1 + K2)
        x = x + v * Dr + dD1_ * p1 + dD2_ * p2
        x = jnp.mod(x, dtype.type(grid.Lx))
        return x, v, diag

    def finish_body(x, v, p1, p2, scal):
        _, _, _, pfac1, pfac2, inv_a_final = scal
        u = x / cell
        if use_lattice:
            d_fin = wrapped_displacement_axes(u, N)
            idx_fin = band_index(_maxabs(d_fin))

            def paint_fin(w):
                def lat(b):
                    return cic_paint_lattice(d_fin, B=b, weights=w)

                return lax.switch(
                    idx_fin,
                    [partial(lat, b) for b in bands]
                    + [partial(cic_paint_particles, _flat(u), N,
                               weights=None if w is None
                               else w.reshape(-1))])
        else:
            def paint_fin(w):
                return cic_paint_particles(
                    _flat(u), N,
                    weights=None if w is None else w.reshape(-1))

        rho = paint_fin(None)
        # Deconvolve the CIC assignment window (standard PM practice), so
        # the output spectrum is unbiased up to the particle Nyquist scale.
        from ..ops.painting import compensation

        comp_k = compensation(grid, "cic", dtype)[..., : N // 2 + 1]
        delta_x = fft_safe.irfftn(fft_safe.rfftn(rho - 1.0) * comp_k,
                                  s=(N, N, N)).astype(dtype)

        final_maxdisp = (_maxabs(wrapped_displacement_axes(u, N))
                         if diagnostics else None)
        if not keep_velocities:
            return delta_x, None, final_maxdisp
        # Total momentum = LPT part at a_final + residual; v_pec = p/a (km/s)
        p_tot = v + pfac1 * p1 + pfac2 * p2
        vel_grids = []
        for comp in range(3):
            m = paint_fin(p_tot[comp])
            vel_grids.append(jnp.where(rho > 0, m / jnp.maximum(rho, 1e-10),
                                       0.0) * inv_a_final)
        return delta_x, jnp.stack(vel_grids), final_maxdisp

    def _diag_out(diags, final_maxdisp):
        maxds, fracs, used = diags
        return {"maxdisp": maxds, "frac_out": fracs, "used_lattice": used,
                "final_maxdisp": final_maxdisp}

    def _q_init(p1, p2, scal):
        # Lattice coordinates from broadcast iota — never materialised
        # as a host-side argument (see realise_density_cola).
        qs = [jax.lax.broadcasted_iota(dtype, (N, N, N), i)
              * dtype.type(cell) for i in range(3)]
        x = jnp.stack(qs, axis=0) + scal[0] * p1 + scal[1] * p2
        return x, jnp.zeros_like(x)  # residual momentum

    if not lowmem:
        # Single scan program.
        @jax.jit
        def evolve(p1, p2, step_consts, scal):
            x, v = _q_init(p1, p2, scal)

            def step(carry, consts):
                x, v = carry
                x, v, diag = step_body(x, v, p1, p2, consts, scal[2])
                return (x, v), diag

            (x, v), diags = jax.lax.scan(step, (x, v), step_consts)
            delta_x, vel, final_maxdisp = finish_body(x, v, p1, p2, scal)
            if diagnostics:
                return delta_x, vel, _diag_out(diags, final_maxdisp)
            return delta_x, vel

        return evolve

    # lowmem: host-orchestrated per-phase programs with no lax.switch or
    # cond, so only the branch a step takes holds device memory.  The
    # band is picked ON HOST from the downloaded maxd scalar, and each
    # phase is its own jit with (x, v) donated through the update; the
    # host waits for each step so no two steps' temporaries overlap.
    @jax.jit
    def init_j(p1, p2, scal):
        return _q_init(p1, p2, scal)

    @jax.jit
    def prep_j(x):
        u = x / cell_f
        d = wrapped_displacement_axes(u, N)
        if diagnostics and lattice_B is not None:
            frac = sum(jnp.mean((jnp.abs(c) > dtype.type(lattice_B))
                                .astype(dtype)) for c in d) / 3.0
        else:
            frac = jnp.zeros((), dtype)
        return d, _maxabs(d), frac

    @partial(jax.jit, static_argnames=("b",))
    def paint_lat_j(d, b):
        return cic_paint_lattice(d, B=b)

    @jax.jit
    def paint_sc_j(x):
        return cic_paint_particles(_flat(x / cell_f), Nf)

    @jax.jit
    def solve_j(rho, a_f, scal):
        delta = rho / mean_per_cell - 1.0
        dk = fft_safe.rfftn(delta)
        k2f, kcut = _kconsts()
        if kcut is not None:
            dk = dk * kcut
        inv_k2 = jnp.where(k2f > 0.0, 1.0 / jnp.where(k2f > 0.0, k2f, 1.0),
                           0.0)
        c = scal[2] / a_f
        return (1j * c) * dk * inv_k2

    @partial(jax.jit, static_argnames=("axis",))
    def grad_j(base, axis):
        kx_d = jnp.asarray(kx_d_np, dtype)
        kz_d = jnp.asarray(kz_d_np, dtype)
        kvec = (kx_d[:, None, None], kx_d[None, :, None],
                kz_d[None, None, :])[axis]
        return fft_safe.irfftn(base * kvec, s=(Nf, Nf, Nf))

    @partial(jax.jit, static_argnames=("b",))
    def gather_lat_j(F, d, b):
        return cic_gather_lattice(F, d, B=b)

    @jax.jit
    def gather_sc_j(F, x):
        return cic_gather(F, _flat(x / cell_f)).reshape(N, N, N)

    @partial(jax.jit, donate_argnums=(0, 1))
    def upd_j(x, v, g0, g1, g2, p1, p2, consts, scal):
        K1, K2, Dr, D1, D2, dD1_, dD2_, a_f = consts
        F = jnp.stack([g0, g1, g2], axis=0)
        comp = (scal[2] / a_f) * (D1 * p1 + (D2 - D1**2) * p2)
        v = v + (F - comp) * (K1 + K2)
        x = x + v * Dr + dD1_ * p1 + dD2_ * p2
        x = jnp.mod(x, dtype.type(grid.Lx))
        return x, v

    @partial(jax.jit, static_argnames=("b",))
    def paint_w_lat_j(d, w, b):
        return cic_paint_lattice(d, B=b, weights=w)

    @jax.jit
    def paint_w_sc_j(x, w):
        return cic_paint_particles(_flat(x / cell_f), N,
                                   weights=w.reshape(-1))

    @jax.jit
    def delta_fin_j(rho):
        from ..ops.painting import compensation

        comp_k = compensation(grid, "cic", dtype)[..., : N // 2 + 1]
        return fft_safe.irfftn(fft_safe.rfftn(rho - 1.0) * comp_k,
                               s=(N, N, N)).astype(dtype)

    @jax.jit
    def ptot_j(v, p1, p2, scal):
        return v + scal[3] * p1 + scal[4] * p2

    @jax.jit
    def veldiv_j(m, rho, scal):
        return jnp.where(rho > 0, m / jnp.maximum(rho, 1e-10), 0.0) * scal[5]

    def _host_band(m):
        """Smallest ladder band with the STRICT bound m < b; None -> the
        exact-scatter program (same criterion as band_index)."""
        for b in bands:
            if m < float(b):
                return b
        return None

    def _paint(x, d, m, w=None):
        b = _host_band(m)
        if b is not None:
            return (paint_lat_j(d, b) if w is None
                    else paint_w_lat_j(d, w, b)), b
        return (paint_sc_j(x) if w is None else paint_w_sc_j(x, w)), None

    def evolve(p1, p2, step_consts, scal):
        x, v = init_j(p1, p2, scal)
        jax.block_until_ready(x)  # don't overlap init with step 0
        n_steps = int(step_consts[0].shape[0])
        # Host-side schedule rows: one transfer instead of one eager
        # device index per scalar.
        sc_np = [np.asarray(c) for c in step_consts]
        diags = []
        _verbose = bool(os.environ.get("FASTBOX_COLA_VERBOSE"))
        for i in range(n_steps):
            row = tuple(c[i] for c in sc_np)
            d, maxd, frac = prep_j(x)
            m = float(maxd)
            rho, b = _paint(x, d, m)
            base = solve_j(rho, row[7], scal)
            del rho
            gs = []
            for ax in range(3):
                F = grad_j(base, ax)
                gs.append(gather_lat_j(F, d, b) if b is not None
                          else gather_sc_j(F, x))
                del F
            del d, base
            x, v = upd_j(x, v, gs[0], gs[1], gs[2], p1, p2, row, scal)
            del gs
            jax.block_until_ready(x)
            if _verbose:
                print(f"[cola] step {i + 1}/{n_steps} done "
                      f"(maxd={m:.2f}, band={b})", flush=True)
            if diagnostics:
                idx = bands.index(b) if b is not None else len(bands)
                diags.append((m, float(frac), idx))
        # --- final paint + outputs (host-orchestrated like the steps) --
        d, maxd, _ = prep_j(x)
        m = float(maxd)
        rho, _b = _paint(x, d, m)
        delta_x = delta_fin_j(rho)
        vel = None
        if keep_velocities:
            p_tot = ptot_j(v, p1, p2, scal)
            vel_grids = []
            for comp in range(3):
                mw, _ = _paint(x, d, m, w=p_tot[comp])
                vel_grids.append(veldiv_j(mw, rho, scal))
            vel = jnp.stack(vel_grids)
        if diagnostics:
            stacked = tuple(jnp.asarray([dg[k] for dg in diags])
                            for k in range(3))
            return delta_x, vel, _diag_out(stacked, jnp.asarray(m, dtype))
        return delta_x, vel

    return evolve
