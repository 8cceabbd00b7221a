"""Slab-sharded (SPMD) COLA engine: the multi-chip approximate N-body path.

The single-device engine (fields/cola.py, replacing the reference's
pycola3 path at /root/reference/fastbox/box.py:463-589) evolves a
lattice-ordered particle set whose wrapped displacements stay within a few
cells.  That structure shards cleanly: decompose the leading (x) axis into
row slabs over a ``'space'`` mesh axis and the whole evolution becomes

  * row-keyed white noise (parallel/rng.py) — each slab draws exactly its
    own rows, so realisations are independent of the device count;
  * 2LPT initial conditions from distributed rfft half-spectrum solves
    (parallel/fft.py all-to-all slab FFTs, 13 transforms batched into 5);
  * per step: halo-exchange lattice CIC paint (parallel/lattice.py, two
    ppermute strip exchanges), distributed Poisson solve (one forward +
    one batched 3-component inverse FFT), halo-exchange force gather, and
    purely local kick/drift/COLA-compensation arithmetic;
  * a final halo paint + distributed CIC window deconvolution (and CIC
    momentum averages for the velocity grids).

Everything is one ``shard_map`` program under ``jit``: XLA schedules the
ppermutes and all-to-alls between devices.  The reference has no distributed
N-body at all (pycola3 is single-process Cython); this is the ``>= 1024^3
single box'' scaling path (BASELINE.md) applied to the N-body feature.

Displacement bound: the lattice formulation is exact while every wrapped
displacement stays within ``lattice_B`` cells.  Unlike the single-chip
engine there is no scatter fallback (data-dependent scatter cannot cross
slabs); instead the returned ``max_disp`` diagnostic lets callers verify
the bound post hoc (cosmological displacements are ~2.5 cells at 15 Mpc
resolution).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..cosmology import Cosmology
from ..grid import GridSpec
from ..fields.cola import _growth_scalars, _kick_drift_integrals
from ..cosmology import background as bg
from .fft import pirfft3_local, prfft3_local
from .lattice import halo_gather_many, halo_paint, halo_paint_many
from .rng import TAGS, default_row_method, row_normal

__all__ = ["make_sharded_cola"]


def make_sharded_cola(mesh: Mesh, grid: GridSpec, cosmology: Cosmology,
                      redshift=None, redshift_init: float = 15.0,
                      n_steps: int | None = None, dtype=jnp.float32,
                      lattice_B: int = 3, keep_velocities: bool = True,
                      pk_nbins: int | None = None, fields: bool = True,
                      ensemble: bool = False):
    """Build the jitted slab-sharded COLA realisation.

    Returns ``fn(key) -> dict`` with ``delta_x`` (N,N,N) global array
    sharded over ``mesh['space']``, ``vel`` (3,N,N,N) CIC-averaged peculiar
    velocities in km/s (or None), and ``max_disp`` — the global maximum
    wrapped displacement in cells over the whole evolution, which callers
    should check stays ``<= lattice_B``.

    With ``pk_nbins`` the binned power spectrum of the evolved field is
    reduced IN-PROGRAM (psum over slabs, the box.py:696-768 convention)
    and returned as ``k``/``pk``/``pk_err`` — at >= 1024^3 the cube never
    needs to leave the devices (host transfers are the scaling
    killer).

    Parameters mirror ``fields.cola.realise_density_cola`` minus
    ``force_factor`` (the force mesh always matches the particle grid) and
    the scatter fallback (see module docstring).

    Monte-Carlo mode: with ``ensemble=True`` the mesh is 2-D
    ``('ens', 'space')`` and the returned ``fn(keys)`` takes a (B,) key
    array sharded over 'ens' (B a multiple of the ens axis); each ens row
    evolves its realisations SEQUENTIALLY (``lax.map`` — one compiled
    program, B/ens dispatch-free repeats) while 'space' slab-shards every
    cube.  Combine with ``fields=False`` (requires ``pk_nbins``) so only
    the (B, nbins) spectra and (B,) max_disp diagnostics are retained —
    the point of in-program reduction at >= 1024^3.
    """
    if not fields:
        assert pk_nbins is not None, "fields=False requires pk_nbins"
        keep_velocities = False
    assert grid.Lx == grid.Ly == grid.Lz, "COLA requires a cubic box"
    dtype = jnp.dtype(dtype)
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    params = cosmology.params
    z_final = grid.redshift if redshift is None else redshift
    a_init = 1.0 / (1.0 + redshift_init)
    a_final = 1.0 / (1.0 + z_final)
    assert redshift_init > z_final, "Must have redshift_init > redshift"
    if n_steps is None:
        n_steps = int(1 + redshift_init)

    N = grid.N
    nshards = mesh.shape["space"]
    assert N % nshards == 0, f"N={N} must divide over space={nshards}"
    Np = N // nshards
    B = int(lattice_B)
    assert Np >= B + 1, (
        f"slab height {Np} < lattice_B+1 = {B + 1}: use fewer shards or a "
        f"smaller band")
    cell = grid.Lx / N
    H0 = 100.0 * params.h
    fac_pm = 1.5 * params.Omega_m * H0**2

    # --- host-side step schedule (identical to the single-chip engine) --
    a_steps = np.linspace(a_init, a_final, n_steps + 1)
    a_half = 0.5 * (a_steps[:-1] + a_steps[1:])
    rows = []
    for i in range(n_steps):
        K1, _ = _kick_drift_integrals(params, a_steps[i], a_half[i])
        K2, _ = _kick_drift_integrals(params, a_half[i], a_steps[i + 1])
        _, Dr = _kick_drift_integrals(params, a_steps[i], a_steps[i + 1])
        d1a, _, d2a, _ = _growth_scalars(params, a_steps[i])
        d1b, _, d2b, _ = _growth_scalars(params, a_steps[i + 1])
        rows.append((K1, K2, Dr, d1a, d2a, d1b - d1a, d2b - d2a, a_steps[i]))
    step_consts = jnp.asarray(np.asarray(rows), dtype)  # (n_steps, 8)
    d1_init, _, d2_init, _ = _growth_scalars(params, a_init)
    D1_f, f1_f, D2_f, f2_f = _growth_scalars(params, a_final)
    a2H = a_final**2 * H0 * float(bg.e_of_a(params, a_final))
    scal = jnp.asarray(
        [d1_init, d2_init, fac_pm, a2H * f1_f * D1_f, a2H * f2_f * D2_f,
         1.0 / a_final], dtype)

    # --- host-side spectral constants -----------------------------------
    Hh = N // 2 + 1
    kf = 2.0 * np.pi * np.fft.fftfreq(N, d=1.0 / N) / grid.Lx
    nyq_full = np.zeros(N, bool)
    nyq_half = np.zeros(Hh, bool)
    if N % 2 == 0:
        nyq_full[N // 2] = True
        nyq_half[-1] = True
    k_d_np = np.where(nyq_full, 0.0, kf)        # Nyquist-zeroed derivative
    kz_np = kf[:Hh].copy()
    kz_d_np = np.where(nyq_half, 0.0, kz_np)
    # CIC compensation 1/W, separable (ops/painting.py:93-113)
    with np.errstate(invalid="ignore"):
        s = np.sinc(kf * cell / (2.0 * np.pi))  # sinc(k dx/2) with np.sinc(pi x)
    w1 = np.where(kf == 0.0, 1.0, s) ** 2
    w1z = w1[:Hh].copy()
    boxfactor = grid.boxfactor

    if pk_nbins is not None:
        from ..ops.spectra import _index_sq, default_kbins, kbin_thresholds

        kbins = default_kbins(grid, pk_nbins)
        _edges = np.concatenate([[0.0], kbins])
        kcent = 0.5 * (_edges[1:] + _edges[:-1])
        # Exact integer-lattice classification on cubic grids (same plan
        # as ops.spectra.binned_power_spectrum — dtype-independent bins)
        bin_thr = kbin_thresholds(grid, kbins)
        fi2_int = None if bin_thr is None else _index_sq(grid)
        # kz-multiplicity weights for the half-spectrum reduction
        kz_weight = np.full(Hh, 2.0)
        kz_weight[0] = 1.0
        if N % 2 == 0:
            kz_weight[-1] = 1.0

    def step_fn(key):
        s_idx = lax.axis_index("space")
        row0 = s_idx * Np

        kx = lax.dynamic_slice_in_dim(jnp.asarray(kf, dtype), row0, Np)
        ky = jnp.asarray(kf, dtype)
        kz = jnp.asarray(kz_np, dtype)
        kx_d = lax.dynamic_slice_in_dim(jnp.asarray(k_d_np, dtype), row0, Np)
        ky_d = jnp.asarray(k_d_np, dtype)
        kz_d = jnp.asarray(kz_d_np, dtype)
        k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
              + kz[None, None, :] ** 2)
        inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.where(k2 > 0.0, k2, 1.0), 0.0)

        # --- initial conditions: rows-keyed linear field + 2LPT ---------
        # default_row_method: Box-Muller from 1024^3 up (the erf_inv
        # lowering's coefficient-broadcast temps, parallel/rng.py),
        # matching pipeline.py / sharded.py.
        white = row_normal(key, TAGS["density"], row0, Np, (N, N), dtype,
                           method=default_row_method(N))
        white_h = prfft3_local(white[None], "space")[0] * dtype.type(N**-1.5)
        kmag = jnp.sqrt(k2)
        amp = jnp.sqrt(jnp.nan_to_num(cosmology.pk_lin_z0(kmag))
                       * dtype.type(boxfactor))
        delta_k0 = (white_h * amp).astype(cdtype)

        def gradient(phik):
            g = jnp.stack([
                (1j * kx_d[:, None, None]) * phik,
                (1j * ky_d[None, :, None]) * phik,
                (1j * kz_d[None, None, :]) * phik,
            ])
            return pirfft3_local(g, N, "space").astype(dtype)  # (3,Np,N,N)

        phi1_k = delta_k0 * inv_k2
        psi1 = gradient(phi1_k)
        # Second derivatives phi1_ij = irfft(-k_i k_j phi1_k), batched.
        # Diagonal terms use the raw k vectors (k_i^2 is even under index
        # negation everywhere, Nyquist included).  Cross terms use the
        # NYQUIST-ZEROED vectors: with one factor at the self-negating
        # Nyquist frequency, k_i k_j is ODD under index negation, i.e.
        # anti-Hermitian content that the single-chip ifftn(...).real
        # projection drops (fields/lpt.py:80) but a Hermitian-completion
        # inverse would keep with a half-dependent sign.
        ones = jnp.ones_like(k2)
        kk = jnp.stack([
            kx[:, None, None] * kx[:, None, None] * ones,
            ky[None, :, None] * ky[None, :, None] * ones,
            kz[None, None, :] * kz[None, None, :] * ones,
            kx_d[:, None, None] * ky_d[None, :, None] * ones,
            kx_d[:, None, None] * kz_d[None, None, :] * ones,
            ky_d[None, :, None] * kz_d[None, None, :] * ones,
        ])
        d = pirfft3_local(-kk * phi1_k[None], N, "space").astype(dtype)
        S2 = (d[0] * d[1] - d[3] ** 2 + d[0] * d[2] - d[4] ** 2
              + d[1] * d[2] - d[5] ** 2)
        phi2_k = prfft3_local(S2[None], "space")[0] * inv_k2
        psi2 = gradient(phi2_k)

        p1 = jnp.moveaxis(psi1, 0, -1)  # (Np, N, N, 3), Mpc
        p2 = jnp.moveaxis(psi2, 0, -1)

        d1i, d2i, fac, pfac1, pfac2, inv_af = scal
        half = dtype.type(N / 2.0)
        Nf_ = dtype.type(N)

        def wrap(x):
            return (x + half) % Nf_ - half

        disp = wrap((d1i * p1 + d2i * p2) / dtype.type(cell))
        v = jnp.zeros_like(disp)

        def pm_force(disp, a):
            rho = halo_paint(disp, B, "space", nshards)
            dk = prfft3_local((rho - 1.0)[None], "space")[0]
            base = (1j * (fac / a)) * dk * inv_k2
            Fk = jnp.stack([
                base * kx_d[:, None, None],
                base * ky_d[None, :, None],
                base * kz_d[None, None, :],
            ])
            F3 = pirfft3_local(Fk, N, "space").astype(dtype)
            return jnp.moveaxis(
                halo_gather_many(F3, disp, B, "space", nshards), 0, -1)

        def step(carry, consts):
            disp, v, maxd = carry
            K1, K2, Dr, D1, D2, dD1, dD2, a_f = consts
            maxd = jnp.maximum(maxd, jnp.max(jnp.abs(disp)))
            F = pm_force(disp, a_f)
            comp = (fac / a_f) * (D1 * p1 + (D2 - D1**2) * p2)
            v = v + (F - comp) * (K1 + K2)
            disp = wrap(disp + (v * Dr + dD1 * p1 + dD2 * p2)
                        / dtype.type(cell))
            return (disp, v, maxd), None

        (disp, v, maxd), _ = lax.scan(step, (disp, v, jnp.zeros((), dtype)),
                                      step_consts)
        maxd = jnp.maximum(maxd, jnp.max(jnp.abs(disp)))
        maxd = lax.pmax(maxd, "space")

        rho = halo_paint(disp, B, "space", nshards)
        compk = (lax.dynamic_slice_in_dim(jnp.asarray(w1, dtype), row0, Np)
                 [:, None, None]
                 * jnp.asarray(w1, dtype)[None, :, None]
                 * jnp.asarray(w1z, dtype)[None, None, :])
        rk = prfft3_local((rho - 1.0)[None], "space")[0] / compk

        out = {"max_disp": maxd}
        if fields:
            out["delta_x"] = pirfft3_local(rk[None], N,
                                           "space")[0].astype(dtype)
        if pk_nbins is not None:
            from ..ops.reduce import binned_weighted_sum_sumsq_count

            p = (rk * jnp.conj(rk)).real / dtype.type(boxfactor)
            if bin_thr is not None:
                fi2_j = jnp.asarray(fi2_int)
                m_loc = (lax.dynamic_slice_in_dim(fi2_j, row0, Np)
                         [:, None, None]
                         + fi2_j[None, :, None] + fi2_j[:Hh][None, None, :])
                idx = jnp.searchsorted(jnp.asarray(bin_thr), m_loc.ravel(),
                                       side="right")
            else:
                idx = jnp.searchsorted(jnp.asarray(kbins, dtype),
                                       jnp.sqrt(k2).ravel(), side="right")
            wgt = jnp.broadcast_to(
                jnp.asarray(kz_weight, dtype)[None, None, :], p.shape).ravel()
            sums, sumsqs, counts = binned_weighted_sum_sumsq_count(
                p.ravel(), wgt, idx.astype(jnp.int32), pk_nbins)
            sums = lax.psum(sums, "space")
            sumsqs = lax.psum(sumsqs, "space")
            counts = lax.psum(counts, "space")
            pk_mean = sums / counts
            var = jnp.maximum(sumsqs / counts - pk_mean**2, 0.0)
            var = jnp.where(counts > 1, var, 0.0)
            out["k"] = jnp.asarray(kcent[1:], dtype)
            out["pk"] = pk_mean[1:]
            out["pk_err"] = (jnp.sqrt(var) / jnp.sqrt(counts))[1:]
        if keep_velocities:
            p_tot = v + pfac1 * p1 + pfac2 * p2
            mom = halo_paint_many(disp, B, "space", nshards,
                                  weights=jnp.moveaxis(p_tot, -1, 0))
            out["vel"] = jnp.where(
                rho[None] > 0,
                mom / jnp.maximum(rho, dtype.type(1e-10))[None],
                0.0) * inv_af
        return out

    out_specs = {"max_disp": P()}
    if fields:
        out_specs["delta_x"] = P("space")
    if keep_velocities:
        out_specs["vel"] = P(None, "space")
    if pk_nbins is not None:
        out_specs["k"] = P()
        out_specs["pk"] = P()
        out_specs["pk_err"] = P()

    if not ensemble:
        sharded = shard_map(step_fn, mesh=mesh, in_specs=P(),
                            out_specs=out_specs, check_vma=False)
        return jax.jit(sharded)

    # Monte-Carlo mode: keys sharded over 'ens', realisations evolved
    # sequentially per ens row (one compiled program; the lattice/FFT code
    # keeps unbatched cube shapes).  Stacked outputs gain a leading B axis.
    assert "ens" in mesh.shape, "ensemble=True needs an ('ens','space') mesh"
    ens_specs = {k: P(*(("ens",) + tuple(v))) for k, v in out_specs.items()}
    if pk_nbins is not None:
        ens_specs["k"] = P()  # bin centroids are realisation-independent

    def many(keys):
        outs = lax.map(step_fn, keys)
        if pk_nbins is not None:
            outs["k"] = outs["k"][0]
        return outs

    sharded = shard_map(many, mesh=mesh, in_specs=P("ens"),
                        out_specs=ens_specs, check_vma=False)
    return jax.jit(sharded)
