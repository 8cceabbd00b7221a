#!/usr/bin/env python
"""COLA benchmark with one JSON line of results.

Measures steady-state seconds/realisation of the full COLA evolution
(2LPT ICs + kicks/drifts + PM force solves + CIC paint/gather) at a given
size on the GPU, with the health statistics (large-scale P/P_lin,
std(delta)) recorded alongside:

    python scripts/bench_cola.py --nsamp 256
    python scripts/bench_cola.py --nsamp 256 --lattice-B none

Replaces the reference's pycola3 path (reference box.py:463-589), which
has no published timing;
``vs_baseline`` is measured against the reference's 35 s end-to-end
Gaussian pipeline at 128^3 (the only recorded reference wall-clock,
BASELINE.md) and is therefore conservative.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

from fastbox_tpu.compile_cache import enable_compile_cache


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nsamp", type=int, default=256)
    p.add_argument("--box", type=float, default=4000.0)
    p.add_argument("--lattice-B", default="3",
                   help="lattice CIC band (int), or 'none' for the "
                        "scatter-add paint and gather")
    p.add_argument("--redshift", type=float, default=0.0)
    p.add_argument("--redshift-init", type=float, default=15.0)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    lattice_B = None if args.lattice_B == "none" else int(args.lattice_B)

    if jax.default_backend() != "gpu":
        print("bench_cola.py: no GPU backend", file=sys.stderr)
        return 2
    enable_compile_cache()
    from fastbox_tpu.cosmology import build_cosmology
    from fastbox_tpu.fields.cola import realise_density_cola
    from fastbox_tpu.grid import GridSpec
    from fastbox_tpu.ops.spectra import binned_power_spectrum

    cosmo = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8),
                            redshift=args.redshift)
    grid = GridSpec.create(box_scale=(args.box,) * 3, nsamp=args.nsamp,
                          redshift=args.redshift)

    def one(seed):
        d, _ = realise_density_cola(
            jax.random.PRNGKey(seed), grid, cosmo,
            redshift_init=args.redshift_init, keep_velocities=False,
            lattice_B=lattice_B)
        return d

    # Warm (compile) + health validation on the first realisation
    t0 = time.time()
    delta = one(1)
    kc, pk, _ = binned_power_spectrum(grid, delta_x=delta)
    kc, pk = np.asarray(kc), np.asarray(pk)
    t_compile = time.time() - t0
    pk_lin = np.asarray(cosmo.pk_lin(kc))
    sel = np.isfinite(pk) & (kc > 3e-3) & (kc < 2e-2) & (pk_lin > 0)
    ratio = pk[sel] / pk_lin[sel]
    std = float(np.std(np.asarray(delta)))

    import gc

    import jax.numpy as jnp

    t0 = time.time()
    for i in range(args.repeat):
        # Free the previous realisation's cube BEFORE the next IC draw
        # (at 512^3 the leftover buffers crowd the IC chain).
        s = float(jnp.std(one(10_001 + i)))
        gc.collect()
    dt = (time.time() - t0) / args.repeat

    doc = {
        "metric": f"{args.nsamp}^3 COLA realisation "
                  f"(2LPT + PM, z {args.redshift_init} -> {args.redshift})",
        "value": round(dt, 3),
        "unit": "s/realisation",
        "vs_baseline": round(35.0 / dt, 2),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "repeat": args.repeat,
        "compile_plus_first_seconds": round(t_compile, 1),
        "lattice_B": lattice_B,
        "health": {
            "std_delta": round(std, 4),
            "pk_over_plin_large_scales": [round(float(v), 3) for v in ratio],
        },
    }
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
