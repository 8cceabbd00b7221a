#!/usr/bin/env python
"""Smoke run of the main paths on the GPU, at the sizes users run.

    python chip_smoke.py          # phases a-g on one GPU
    python chip_smoke.py --four   # only the sharded paths, on four GPUs

Phases (one card):
  a. card facts: nvidia-smi name and power limit, jax.devices(), and
     compiled.memory_analysis() of the 256^3 pipeline step;
  b. the 256^3 / 4 Gpc / z=0.8 make_pipeline and make_chained_pipeline
     (chain 4): finite spectra, compile and steady time per realisation;
  c. the truth gate: the gate configuration on the keys of
     truth_gate_256.npz (an f64 CPU oracle of the same random stream),
     failing above 3x the file's CPU-f32 floor for pk_cleaned or above
     1e-4 for pk_density;
  d. make_ensemble_pipeline at 256^3 with a batch of 4 (batched FFTs
     under vmap);
  e. one 512^3 make_pipeline realisation;
  f. the README's CosmoBox flow at 256^3;
  g. realise_density_cola at 256^3 / 4 Gpc with its default steps:
     std(delta) and P(k)/P_lin over the linear bins.

``--four`` runs only the multi-card paths: the sharded ensemble step at
512^3 on an (ens=1, space=4) mesh against the one-card
``make_pipeline(noise_scheme="rows")`` on the same key, and the sharded
COLA at 256^3 on four cards against the one-card COLA statistics.

Each phase prints one line: its name, its seconds and its check.  The
last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed.  The script exits non-zero, printing no result, when JAX
finds no GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)

# Sizes of the run on the card.  Tests pass smaller ones.
FULL = dict(n=256, box=4e3, redshift=0.8, chain=4, batch=4, big_n=512,
            cosmobox_box=1e3, cola_n=256, cola_box=4e3,
            truth=os.path.join(REPO, "truth_gate_256.npz"),
            four_n=512, four_box=4e3,
            four_truth=os.path.join(REPO, "truth_gate_512.npz"),
            four_cola_n=256)

FLOOR_FACTOR = 3.0       # pk_cleaned vs the f64 oracle, in CPU-f32 floors
DENSITY_TOL = 1e-4       # pk_density vs the f64 oracle, relative
# tests/test_cola.py's health ranges for a COLA field
COLA_RATIO = (0.45, 2.0)
COLA_VEL_RMS = (30.0, 1500.0)


class PhaseFailed(Exception):
    pass


def expect(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def require_gpu(jax):
    """Stop (exit 2, nothing on stdout) unless JAX's backend is the GPU."""
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is '{jax.default_backend()}', "
              "not 'gpu' — refusing to run", file=sys.stderr)
        raise SystemExit(2)


def card_facts() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def _setup(n, box, redshift):
    from fastbox_tpu.cosmology import build_cosmology
    from fastbox_tpu.grid import GridSpec

    grid = GridSpec.create(box_scale=(box,) * 3, nsamp=n, redshift=redshift)
    return grid, build_cosmology(COSMO, redshift=redshift)


def _timed(jax, fn, args):
    """(first-call seconds, steady seconds per call, last output).

    The first call compiles; the steady time is the mean over the rest.
    """
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(args[0]))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for a in args[1:]:
        out = fn(a)
    jax.block_until_ready(out)
    steady = (time.perf_counter() - t0) / max(1, len(args) - 1)
    return first, steady, out


def _spectra_ok(out, lead=()):
    """Finite spectra of the expected shape; returns the finite-bin count.

    Empty log-k bins are NaN by convention, so the cleaned and density
    spectra must agree on which bins are finite and most must be.
    """
    pc = np.asarray(out["pk_cleaned"], np.float64)
    pd = np.asarray(out["pk_density"], np.float64)
    nb = np.asarray(out["k"]).shape[-1]
    expect(pc.shape == lead + (nb,) and pd.shape == pc.shape,
           f"spectra shape {pc.shape}, expected {lead + (nb,)}")
    fin = np.isfinite(pc)
    expect(np.array_equal(fin, np.isfinite(pd)),
           "cleaned and density spectra disagree on the empty bins")
    nfin = int(fin.reshape(-1, nb).sum(axis=1).min())
    expect(nfin >= nb // 2, f"only {nfin}/{nb} finite bins")
    expect(np.all(pd[fin] > 0), "non-positive density power")
    expect(np.isfinite(np.asarray(out["sigma_data"])).all(),
           "sigma_data not finite")
    return f"{nfin}/{nb}"


def phase_card_facts(jax, s):
    """The cards' names and power limits, and the devices JAX sees."""
    devs = ", ".join(f"{d.platform}:{d.device_kind}" for d in jax.devices())
    return f"card [{card_facts()}] devices [{devs}]"


def phase_card(jax, s):
    """a. Card facts and the memory analysis of the pipeline step."""
    from fastbox_tpu.pipeline import PipelineConfig, make_pipeline

    grid, cosmo = _setup(s["n"], s["box"], s["redshift"])
    fn = make_pipeline(grid, cosmo, PipelineConfig())
    mem = fn.lower(jax.random.PRNGKey(0)).compile().memory_analysis()
    if mem is None:
        mtxt = "memory_analysis: not available"
    else:
        mtxt = ("memory_analysis: args={:.1f} MiB out={:.1f} MiB "
                "temps={:.1f} MiB".format(
                    mem.argument_size_in_bytes / 2**20,
                    mem.output_size_in_bytes / 2**20,
                    mem.temp_size_in_bytes / 2**20))
    return f"{phase_card_facts(jax, s)} {s['n']}^3 step {mtxt}"


def phase_pipeline(jax, s):
    """b. make_pipeline and make_chained_pipeline at the headline size."""
    from fastbox_tpu.pipeline import (PipelineConfig, make_chained_pipeline,
                                      make_pipeline)

    grid, cosmo = _setup(s["n"], s["box"], s["redshift"])
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    first, steady, out = _timed(
        jax, make_pipeline(grid, cosmo, PipelineConfig()), list(keys))
    bins = _spectra_ok(out)
    K = s["chain"]
    chains = [jax.random.split(k, K) for k in keys[:3]]
    cfirst, csteady, cout = _timed(
        jax, make_chained_pipeline(grid, cosmo, PipelineConfig()), chains)
    _spectra_ok(cout, lead=(K,))
    return (f"single: compile+first {first:.2f} s, steady {steady:.4f} "
            f"s/realisation; chain {K}: compile+first {cfirst:.2f} s, "
            f"steady {csteady / K:.4f} s/realisation; finite bins {bins}")


def phase_truth(jax, s):
    """c. The gate configuration against the committed f64 oracle."""
    from scripts.truth_gate import _build, _gate_config, _rel, _run

    d = np.load(s["truth"])
    nsamp, box, redshift = d["meta"]
    keys = [int(k) for k in d["keys"]]
    grid, cosmo = _build(int(nsamp), float(box), float(redshift))
    _, c, dd, _ = _run(jax, grid, cosmo, _gate_config("float32"), keys)
    rel_c = np.max(_rel(c, d["pk_cleaned"]), axis=0)
    rel_d = np.max(_rel(dd, d["pk_density"]), axis=0)
    floor_bins = np.max(_rel(d["f32_pk_cleaned"], d["pk_cleaned"]), axis=0)
    floor = float(floor_bins.max())

    def fmt(v):
        return "[" + " ".join(f"{x:.2e}" for x in v) + "]"

    msg = (f"{int(nsamp)}^3 keys {keys}: pk_cleaned max rel {rel_c.max():.3e}"
           f" vs CPU-f32 floor {floor:.3e} (limit {FLOOR_FACTOR:g}x); "
           f"pk_density max rel {rel_d.max():.3e} (limit {DENSITY_TOL:g}); "
           f"per-bin cleaned {fmt(rel_c)} floor {fmt(floor_bins)} "
           f"density {fmt(rel_d)}")
    expect(rel_c.max() <= FLOOR_FACTOR * floor, "pk_cleaned above limit: "
           + msg)
    expect(rel_d.max() <= DENSITY_TOL, "pk_density above limit: " + msg)
    return msg


def phase_ensemble(jax, s):
    """d. make_ensemble_pipeline: the whole mock vmapped over a batch."""
    from fastbox_tpu.pipeline import PipelineConfig, make_ensemble_pipeline

    grid, cosmo = _setup(s["n"], s["box"], s["redshift"])
    B = s["batch"]
    batches = [jax.random.split(jax.random.PRNGKey(10 + i), B)
               for i in range(3)]
    first, steady, out = _timed(
        jax, make_ensemble_pipeline(grid, cosmo, PipelineConfig()), batches)
    bins = _spectra_ok(out, lead=(B,))
    return (f"batch {B}: compile+first {first:.2f} s, steady "
            f"{steady / B:.4f} s/realisation; finite bins {bins}")


def phase_big(jax, s):
    """e. One make_pipeline realisation at 512^3."""
    from fastbox_tpu.pipeline import PipelineConfig, make_pipeline

    grid, cosmo = _setup(s["big_n"], s["box"], s["redshift"])
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    first, steady, out = _timed(
        jax, make_pipeline(grid, cosmo, PipelineConfig()), list(keys))
    bins = _spectra_ok(out)
    return (f"{s['big_n']}^3: compile+first {first:.2f} s, second "
            f"{steady:.4f} s; finite bins {bins}")


def phase_cosmobox(jax, s):
    """f. The README's CosmoBox flow, eagerly, through the object API."""
    import jax.numpy as jnp

    import fastbox_tpu.filters as filters
    from fastbox_tpu import CosmoBox, default_cosmo
    from fastbox_tpu.models import ForegroundModel, HITracer, NoiseModel

    t0 = time.perf_counter()
    box = CosmoBox(cosmo=default_cosmo, box_scale=(s["cosmobox_box"],) * 3,
                   nsamp=s["n"], redshift=0.8, realise_now=False, seed=10)
    box.realise_density()
    tracer = HITracer(box)
    delta_ln = box.lognormal(box.delta_x * tracer.bias_HI())
    vel_k = box.realise_velocity(delta_x=box.delta_x)
    delta_s = box.redshift_space_density(
        delta_x=delta_ln, velocity_z=jnp.fft.ifftn(vel_k[2]).real,
        sigma_nl=120.)
    data = tracer.signal_amplitude() * (1. + delta_s)
    fg = ForegroundModel(box)
    data = data + fg.construct_cube(
        fg.realise_foreground_amp(57., 1.1, 10., smoothing_scale=4.),
        fg.realise_spectral_index(2.07, 2e-4, 15.))
    data = data + NoiseModel(box).realise_radiometer_noise(18., 2., 1., 64)
    cleaned = filters.pca_filter(data, nmodes=4)
    k, pk, err = box.binned_power_spectrum(delta_x=cleaned)
    pk = np.asarray(pk)
    first = time.perf_counter() - t0
    expect(np.asarray(cleaned).shape == (s["n"],) * 3, "cleaned cube shape")
    expect(np.isfinite(np.asarray(cleaned)).all(), "cleaned cube not finite")
    fin = np.isfinite(pk)
    expect(fin.sum() >= pk.size // 2 and np.all(pk[fin] > 0),
           f"cleaned P(k) bad: {pk}")
    return (f"{s['n']}^3 eager flow {first:.2f} s (compiles included); "
            f"finite bins {int(fin.sum())}/{pk.size}")


def _cola_stats(grid, cosmo, delta, vel=None):
    """std(delta) and mean P(k)/P_lin over the linear bins, checked
    against tests/test_cola.py's ranges."""
    from fastbox_tpu.ops.spectra import binned_power_spectrum

    d = np.asarray(delta, np.float64)
    expect(d.shape == (grid.N,) * 3 and np.isfinite(d).all(),
           "COLA field not finite / wrong shape")
    kc, pk, _ = binned_power_spectrum(grid, delta_x=delta)
    kc, pk = np.asarray(kc), np.asarray(pk)
    plin = np.asarray(cosmo.pk_lin(kc))
    # Linear bins: above the fundamental mode's bin, below both the
    # nonlinear scale and half the particle Nyquist (where a 1x PM force
    # mesh under-grows)
    k_f = 2.0 * np.pi / grid.Lx
    k_ny = np.pi * grid.N / grid.Lx
    sel = (np.isfinite(pk) & (plin > 0) & (kc > 1.5 * k_f)
           & (kc < min(0.05, 0.5 * k_ny)))
    expect(sel.sum() >= 3, f"only {int(sel.sum())} linear bins")
    ratio = float(np.mean(pk[sel] / plin[sel]))
    expect(COLA_RATIO[0] < ratio < COLA_RATIO[1],
           f"mean P/P_lin {ratio:.3f} outside {COLA_RATIO}")
    msg = f"std(delta) {d.std():.4f}, mean P/P_lin {ratio:.3f} " \
          f"over {int(sel.sum())} linear bins"
    if vel is not None:
        rms = float(np.asarray(vel).std())
        expect(COLA_VEL_RMS[0] < rms < COLA_VEL_RMS[1],
               f"velocity rms {rms:.1f} km/s outside {COLA_VEL_RMS}")
        msg += f", vel rms {rms:.1f} km/s"
    return d.std(), ratio, msg


def phase_cola(jax, s):
    """g. realise_density_cola with its default steps and lattice."""
    from fastbox_tpu.fields.cola import realise_density_cola

    grid, cosmo = _setup(s["cola_n"], s["cola_box"], 0.0)

    def one(key):
        return realise_density_cola(key, grid, cosmo)

    first, steady, (delta, vel) = _timed(
        jax, one, [jax.random.PRNGKey(1), jax.random.PRNGKey(2)])
    _, _, msg = _cola_stats(grid, cosmo, delta, vel)
    return (f"{s['cola_n']}^3: compile+first {first:.2f} s, second "
            f"{steady:.3f} s; {msg}")


def phase_four_sharded(jax, s):
    """The sharded ensemble step on (ens=1, space=4) vs the one-card
    rows-scheme pipeline on the same key."""
    from scripts.truth_gate import _rel

    from fastbox_tpu.parallel import make_mesh, make_sharded_ensemble_step
    from fastbox_tpu.pipeline import PipelineConfig, make_pipeline

    grid, cosmo = _setup(s["four_n"], s["four_box"], s["redshift"])
    cfg = PipelineConfig(noise_scheme="rows")
    key = jax.random.PRNGKey(5)
    t0 = time.perf_counter()
    ref = make_pipeline(grid, cosmo, cfg)(key)
    ref = {k: np.asarray(ref[k], np.float64)
           for k in ("pk_cleaned", "pk_density")}
    t_one = time.perf_counter() - t0
    mesh = make_mesh(4, space=4, grid_n=grid.N)
    step = make_sharded_ensemble_step(mesh, grid, cosmo, cfg)
    keys = key[None]
    first, steady, out = _timed(jax, step, [keys, keys])
    got = {k: np.asarray(out[k], np.float64)[0]
           for k in ("pk_cleaned", "pk_density")}
    d = np.load(s["four_truth"])
    floor = float(np.max(_rel(d["f32_pk_cleaned"], d["pk_cleaned"])))
    rel_c = float(np.max(_rel(got["pk_cleaned"], ref["pk_cleaned"])))
    rel_d = float(np.max(_rel(got["pk_density"], ref["pk_density"])))
    msg = (f"{grid.N}^3 mesh {dict(mesh.shape)}: one card {t_one:.2f} s "
           f"(compile incl.); sharded compile+first {first:.2f} s, steady "
           f"{steady:.4f} s; pk_cleaned rel {rel_c:.3e} (limit "
           f"{FLOOR_FACTOR:g}x floor {floor:.3e}), pk_density rel "
           f"{rel_d:.3e} (limit {DENSITY_TOL:g})")
    expect(rel_c <= FLOOR_FACTOR * floor, msg)
    expect(rel_d <= DENSITY_TOL, msg)
    return msg


def phase_four_cola(jax, s):
    """Sharded COLA on four cards vs the one-card COLA statistics."""
    from jax.sharding import Mesh

    from fastbox_tpu.fields.cola import realise_density_cola
    from fastbox_tpu.parallel import make_sharded_cola

    grid, cosmo = _setup(s["four_cola_n"], s["cola_box"], 0.0)
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    d1, _ = realise_density_cola(key, grid, cosmo, keep_velocities=False)
    std1, r1, _ = _cola_stats(grid, cosmo, d1)
    t_one = time.perf_counter() - t0
    del d1
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    fn = make_sharded_cola(mesh, grid, cosmo, keep_velocities=False)
    first, steady, out = _timed(jax, fn, [key, jax.random.PRNGKey(2)])
    maxd = float(out["max_disp"])
    expect(maxd <= 3.0, f"max displacement {maxd:.2f} cells > lattice_B 3")
    std4, r4, msg4 = _cola_stats(grid, cosmo, out["delta_x"])
    expect(abs(std4 / std1 - 1.0) < 0.05,
           f"sharded std {std4:.4f} vs one-card {std1:.4f}")
    return (f"{grid.N}^3: one card {t_one:.2f} s (compile incl.), std "
            f"{std1:.4f}, P/P_lin {r1:.3f}; sharded compile+first "
            f"{first:.2f} s, steady {steady:.3f} s, max_disp {maxd:.2f}, "
            f"{msg4}")


ONE_CARD = [("a.card", phase_card), ("b.pipeline", phase_pipeline),
            ("c.truth", phase_truth), ("d.ensemble", phase_ensemble),
            ("e.big", phase_big), ("f.cosmobox", phase_cosmobox),
            ("g.cola", phase_cola)]
FOUR_CARDS = [("four.card", phase_card_facts),
              ("four.sharded", phase_four_sharded),
              ("four.cola", phase_four_cola)]


def run_phases(jax, phases, sizes):
    """Run each phase, print its line; return the names that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            msg = fn(jax, sizes)
            status = "ok"
        except Exception as e:  # report every phase, fail at the end
            msg = f"{type(e).__name__}: {e}"
            status = "FAILED"
            failed.append(name)
        print(f"{name:<13s} {time.perf_counter() - t0:9.2f} s  {status}  "
              f"{msg}", flush=True)
    return failed


def main(argv=None, device_check=require_gpu, sizes=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    device_check(jax)
    from fastbox_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    sizes = dict(FULL if sizes is None else sizes)
    if args.four:
        if len(jax.devices()) < 4:
            print("chip_smoke: --four needs four devices, JAX sees "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 2
        phases = FOUR_CARDS
    else:
        phases = ONE_CARD
    failed = run_phases(jax, phases, sizes)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
