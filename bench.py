#!/usr/bin/env python
"""Benchmark: full 256^3 realize -> RSD -> filter -> P(k) pipelines/sec/chip.

This is the headline metric from BASELINE.json.  The reference FastBox runs
the equivalent 128^3 pipeline in ~35 s on one CPU process (~0.0286
pipelines/sec; BASELINE.md) — dominated by its per-LOS Python RSD loop and
per-bin digitize loop.  Here the whole pipeline is one jitted XLA program.

``vs_baseline`` is measured-rate / 0.0286 — conservative, since the
reference number is for boxes with 8x fewer voxels.

Prints ONE json line:
  {"metric": ..., "value": N, "unit": "pipelines/s", "vs_baseline": N}
"""
import argparse
import dataclasses
import json
import os
import sys
import time

# MODULE-default matmul-DFT einsum precision (ops/mmfft.py), which only
# the opt-in fft_pair inverse uses; the env var must be set before
# fastbox_tpu imports.
_early = argparse.ArgumentParser(add_help=False)
_early.add_argument("--mm-precision", default=None)
_mmp = _early.parse_known_args(sys.argv[1:])[0].mm_precision
if _mmp is not None:
    os.environ["FASTBOX_MM_PRECISION"] = _mmp
else:
    os.environ.setdefault("FASTBOX_MM_PRECISION", "HIGHEST")

import jax
import numpy as np

from fastbox_tpu.compile_cache import enable_compile_cache
from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.pipeline import PipelineConfig, make_pipeline

REFERENCE_RATE = 1.0 / 35.0  # 128^3 pipelines/sec, single CPU (BASELINE.md)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsamp", type=int, default=256)
    ap.add_argument("--box", type=float, default=4e3)
    ap.add_argument("--redshift", type=float, default=0.8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3,
                    help="repeat the timed window this many times and "
                         "report the best")
    ap.add_argument("--batch", type=int, default=1,
                    help="vmap this many pipelines per step (ensemble mode)")
    ap.add_argument("--mm-precision", default=None,
                    help="MODULE-default matmul-DFT einsum precision "
                         "(DEFAULT/HIGH/HIGHEST, default HIGHEST); only "
                         "--fft-pair uses matmul DFTs — parsed before jax "
                         "import, listed here for --help")
    ap.add_argument("--mm3d-precision", default=None,
                    help="einsum precision of the --fft-pair matmul DFT")
    ap.add_argument("--fft-pair", action="store_true",
                    help="fuse the (delta_x, vel_z) inverse pair into one "
                         "complex matmul-DFT inverse")
    ap.add_argument("--pca-precision", default=None,
                    choices=["DEFAULT", "HIGH", "HIGHEST"],
                    help="einsum precision for the PCA covariance/"
                         "projection GEMMs (default HIGHEST; truth-gate "
                         "variants 'pca_high' and 'pca_default')")
    ap.add_argument("--eigh-hoist", default=None,
                    choices=["auto", "on", "off"],
                    help="chained-pipeline batched-eigh hoist "
                         "(PipelineConfig.eigh_hoist; default off, "
                         "'auto' resolves to off)")
    ap.add_argument("--draw-method", default=None,
                    choices=["erfinv", "box_muller"],
                    help="bits->normal transform for the density draw "
                         "(PipelineConfig.draw_method; box_muller is the "
                         "lighter lowering but a different stream)")
    ap.add_argument("--pca", default=None, choices=["exact", "subspace"],
                    help="PCA clean backend: exact eigh (default) or the "
                         "oversampled subspace + Rayleigh-Ritz iteration "
                         "(PipelineConfig.pca_exact=False)")
    ap.add_argument("--chain", type=int, default=None,
                    help="scan this many pipelines per dispatch (1 = one "
                         "program per realisation); default 16 up to "
                         "256^3, 7 above")
    ap.add_argument("--out-json", default=None,
                    help="also write the final JSON line to this file")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        print(f"bench.py: JAX backend is '{jax.default_backend()}', not "
              "'gpu' — refusing to measure", file=sys.stderr)
        return 2
    enable_compile_cache()

    grid = GridSpec.create(box_scale=(args.box,) * 3, nsamp=args.nsamp,
                           redshift=args.redshift)
    cosmology = build_cosmology(
        dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8),
        redshift=args.redshift,
    )
    config = PipelineConfig(dtype="float32")
    if args.mm3d_precision is not None:  # None keeps the config default
        config = dataclasses.replace(config,
                                     mm3d_precision=args.mm3d_precision)
    if args.fft_pair:
        config = dataclasses.replace(config, fft_pair=True)
    if args.pca is not None:
        config = dataclasses.replace(config,
                                     pca_exact=args.pca == "exact")
    if args.draw_method is not None:
        config = dataclasses.replace(config, draw_method=args.draw_method)
    if args.eigh_hoist is not None:
        config = dataclasses.replace(config, eigh_hoist=args.eigh_hoist)
    if args.pca_precision is not None:
        config = dataclasses.replace(config,
                                     pca_precision=args.pca_precision)
    if args.chain is None:
        args.chain = 16 if args.nsamp <= 256 else 7
    if args.batch > 1:
        from fastbox_tpu.pipeline import make_ensemble_pipeline

        args.chain = 1  # ensemble mode: the chain branch never runs
        fn_b = make_ensemble_pipeline(grid, cosmology, config)
        fn = lambda key: fn_b(jax.random.split(key, args.batch))
    elif args.chain > 1:
        from fastbox_tpu.pipeline import make_chained_pipeline

        fn_c = make_chained_pipeline(grid, cosmology, config)
        fn = lambda key: fn_c(jax.random.split(key, args.chain))
    else:
        fn = make_pipeline(grid, cosmology, config)
    per_iter = args.batch * args.chain  # realisations per timed iteration

    keys = jax.random.split(jax.random.PRNGKey(0), args.warmup + args.iters)

    # Warmup / compile
    t0 = time.perf_counter()
    for i in range(args.warmup):
        out = fn(keys[i])
    jax.block_until_ready(out)
    if args.verbose:
        print(f"# compile+warmup: {time.perf_counter() - t0:.1f}s")

    dt = None
    for rep in range(max(1, args.repeats)):
        t0 = time.perf_counter()
        outs = [fn(keys[args.warmup + i]) for i in range(args.iters)]
        jax.block_until_ready(outs)
        dt_rep = time.perf_counter() - t0
        dt = dt_rep if dt is None else min(dt, dt_rep)
        if args.verbose:
            print(f"# window {rep}: {dt_rep:.3f}s")

    rate = args.iters * per_iter / dt
    if args.verbose:
        pk = np.asarray(outs[-1]["pk_cleaned"]).reshape(-1)
        print(f"# {dt:.3f}s for {args.iters * per_iter} pipelines at "
              f"{args.nsamp}^3 on {jax.devices()[0].platform}; "
              f"pk head: {pk[:3]}")

    doc = {
        "metric": f"{args.nsamp}^3 realize->RSD->filter->P(k) pipelines/sec/chip",
        "value": round(rate, 4),
        "unit": "pipelines/s",
        "vs_baseline": round(rate / REFERENCE_RATE, 2),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "chain": args.chain,
        "batch": args.batch,
        "mm_precision": os.environ.get("FASTBOX_MM_PRECISION", "HIGHEST"),
        "mm3d_precision": config.mm3d_precision,
        "pca": "exact" if config.pca_exact else "subspace",
        "eigh_hoist": config.eigh_hoist,
        "pca_precision": config.pca_precision,
        "draw_method": config.draw_method,
    }
    print(json.dumps(doc))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
