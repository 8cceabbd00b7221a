#!/usr/bin/env python
"""Measure the three choices the GPU build of the pipeline rests on.

    python scripts/probe_gpu_choices.py [--only fft,precision,cola]

1. ``fft``: the native FFT (cuFFT) against the matmul DFTs of
   ``ops/mmfft.py`` at HIGHEST, for the pipeline's three cube transforms
   at 256^3 (two C2R inverses and one R2C forward): time per transform
   and max relative error against an f64 numpy transform.
2. ``precision``: what an f32 ``dot`` at each ``lax.Precision`` lowers to
   on this device (the GEMM lines of the compiled HLO) and its relative
   error against f64.
3. ``cola``: one 256^3 / 4 Gpc COLA realisation with the roll lattice
   (``lattice_B=3``) against one with the scatter-add paint and gather
   (``lattice_B=None``): compile+first and steady seconds, and the
   health statistics.
4. ``trace``: a profiler trace of five steady 256^3 pipeline steps:
   device time per realisation, the RSD remap's share of it, and the
   twelve costliest HLO ops with the source op each came from.

Times are host-clock seconds around work that ends in
``block_until_ready``, after a warm-up call.  Prints one line per
measurement and, last, one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(jax, fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def probe_fft(jax, n=256):
    import jax.numpy as jnp

    from fastbox_tpu.ops import mmfft

    rng = np.random.default_rng(0)
    x64 = rng.standard_normal((n, n, n))
    a64 = np.fft.rfftn(x64)
    x = jnp.asarray(x64, jnp.float32)
    a = jnp.asarray(a64.astype(np.complex64))
    hi = jax.lax.Precision.HIGHEST
    cases = {
        "rfftn": (jax.jit(jnp.fft.rfftn),
                  jax.jit(lambda v: mmfft.rfftn3(v, precision=hi)), x, a64),
        "irfftn": (jax.jit(lambda v: jnp.fft.irfftn(v, s=(n, n, n))),
                   jax.jit(lambda v: mmfft.irfftn3(v, (n, n, n),
                                                   precision=hi)), a, x64),
    }
    res = {}
    for name, (nat, mm, arg, ref) in cases.items():
        for impl, fn in (("cufft", nat), ("mmfft_highest", mm)):
            t = _time(jax, fn, arg)
            got = np.asarray(fn(arg), np.complex128 if name == "rfftn"
                             else np.float64)
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            res[f"{name}_{impl}"] = {"seconds": t, "max_rel_err": err}
            print(f"fft {n}^3 {name:7s} {impl:14s} {t * 1e3:9.3f} ms  "
                  f"max rel err {err:.2e}", flush=True)
    # The pipeline runs two inverses (delta_x, vel_z) and one forward.
    for impl in ("cufft", "mmfft_highest"):
        tot = (2 * res[f"irfftn_{impl}"]["seconds"]
               + res[f"rfftn_{impl}"]["seconds"])
        res[f"three_transforms_{impl}"] = tot
        print(f"fft {n}^3 three pipeline transforms {impl:14s} "
              f"{tot * 1e3:9.3f} ms", flush=True)
    return res


def probe_precision(jax, m=2048):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a64 = rng.standard_normal((m, m))
    b64 = rng.standard_normal((m, m))
    ref = a64 @ b64
    a = jnp.asarray(a64, jnp.float32)
    b = jnp.asarray(b64, jnp.float32)
    res = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        fn = jax.jit(lambda u, v, p=prec: jnp.dot(u, v, precision=p))
        text = fn.lower(a, b).compile().as_text()
        # The GEMM's custom call and the precision / algorithm fields of
        # its backend config say which tensor-core path cuBLAS may take.
        gemm = [ln.strip()[:160] for ln in text.splitlines()
                if re.search(r"gemm|cublas|dot\(", ln)]
        gemm += sorted(set(re.findall(
            r'"(?:precision_config|algorithm|compute_precision)"'
            r'\s*:\s*(?:\{[^}]*\}|"[^"]*"|[0-9]+)', text)))
        got = np.asarray(fn(a, b), np.float64)
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        t = _time(jax, fn, a, b, reps=10)
        res[name] = {"max_rel_err": err, "seconds": t, "hlo": gemm[:8]}
        print(f"precision {name:8s} {m}x{m} f32 dot: max rel err "
              f"{err:.2e}, {t * 1e3:.3f} ms", flush=True)
        for ln in gemm[:8]:
            print(f"  hlo: {ln}", flush=True)
    return res


def probe_cola(jax, n=256, box=4e3):
    from fastbox_tpu.cosmology import build_cosmology
    from fastbox_tpu.fields.cola import realise_density_cola
    from fastbox_tpu.grid import GridSpec
    from fastbox_tpu.ops.spectra import binned_power_spectrum

    grid = GridSpec.create(box_scale=(box,) * 3, nsamp=n, redshift=0.0)
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.0)
    res = {}
    for label, B in (("lattice_B3", 3), ("scatter", None)):
        def one(seed, B=B):
            d, _ = realise_density_cola(jax.random.PRNGKey(seed), grid,
                                        cosmo, keep_velocities=False,
                                        lattice_B=B)
            return jax.block_until_ready(d)

        t0 = time.perf_counter()
        d = one(1)
        first = time.perf_counter() - t0
        steady = []
        for seed in (2, 3):
            t0 = time.perf_counter()
            one(seed)
            steady.append(time.perf_counter() - t0)
        kc, pk, _ = binned_power_spectrum(grid, delta_x=d)
        kc, pk = np.asarray(kc), np.asarray(pk)
        plin = np.asarray(cosmo.pk_lin(kc))
        sel = np.isfinite(pk) & (kc > 3e-3) & (kc < 2e-2) & (plin > 0)
        ratio = float(np.mean(pk[sel] / plin[sel]))
        std = float(np.std(np.asarray(d)))
        res[label] = {"compile_plus_first_s": first, "steady_s": steady,
                      "std_delta": std, "mean_pk_over_plin": ratio}
        print(f"cola {n}^3 {label:10s} compile+first {first:.2f} s, steady "
              f"{' '.join(f'{v:.3f}' for v in steady)} s, std(delta) "
              f"{std:.4f}, mean P/P_lin {ratio:.3f}", flush=True)
    return res


def _device_op_times(trace_dir, module_substr):
    """{hlo_op: summed device microseconds} for one jitted module, read
    from the perfetto trace JAX's profiler writes."""
    import glob
    import gzip

    path = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                     recursive=True)[0]
    with gzip.open(path) as f:
        events = json.load(f)["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    gpu = {p for p, name in procs.items() if "GPU" in name}
    times = {}
    for e in events:
        a = e.get("args", {})
        if (e.get("ph") == "X" and "hlo_op" in a
                and module_substr in a.get("hlo_module", "")
                and (not gpu or e["pid"] in gpu)):
            times[a["hlo_op"]] = times.get(a["hlo_op"], 0.0) + e["dur"]
    return times


def probe_trace(jax, n=256, reps=5):
    """Device time of the 256^3 pipeline step by HLO op, and the share of
    the ops that come from the RSD remap (``redshift_space_density``)."""
    import tempfile

    from fastbox_tpu.cosmology import build_cosmology
    from fastbox_tpu.grid import GridSpec
    from fastbox_tpu.pipeline import PipelineConfig, make_pipeline

    grid = GridSpec.create(box_scale=(4e3,) * 3, nsamp=n, redshift=0.8)
    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.8)
    fn = make_pipeline(grid, cosmo, PipelineConfig())
    keys = jax.random.split(jax.random.PRNGKey(0), reps + 1)
    text = fn.lower(keys[0]).compile().as_text()
    op_name = dict(re.findall(
        r'^\s*(?:ROOT )?%(\S+) = .*?metadata=\{op_name="([^"]+)"', text,
        re.M))
    jax.block_until_ready(fn(keys[0]))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d, create_perfetto_trace=True):
            for k in keys[1:]:
                out = fn(k)
            jax.block_until_ready(out)
        times = _device_op_times(d, "fn_inner")
    total = sum(times.values())
    rsd = sum(t for op, t in times.items()
              if "redshift_space_density" in op_name.get(op, ""))
    top = sorted(times.items(), key=lambda kv: -kv[1])[:12]
    print(f"trace {n}^3 pipeline: device busy {total / reps / 1e3:.3f} "
          f"ms/realisation, RSD remap {rsd / reps / 1e3:.3f} ms "
          f"({100 * rsd / max(total, 1e-9):.1f}%)", flush=True)
    for op, t in top:
        print(f"  {t / reps / 1e3:8.3f} ms  {op:28s} "
              f"{op_name.get(op, '')[-90:]}", flush=True)
    return {"device_ms_per_realisation": total / reps / 1e3,
            "rsd_ms_per_realisation": rsd / reps / 1e3,
            "top_ops_ms": [(op, t / reps / 1e3, op_name.get(op, ""))
                           for op, t in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="fft,precision,cola,trace")
    args = ap.parse_args()

    import jax

    from fastbox_tpu.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print("probe_gpu_choices.py: no GPU backend", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}; {jax.devices()[0]}",
          flush=True)
    out = {"card": card}
    for name in args.only.split(","):
        out[name] = {"fft": probe_fft, "precision": probe_precision,
                     "cola": probe_cola, "trace": probe_trace}[name](jax)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
