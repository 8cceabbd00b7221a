#!/usr/bin/env python
"""Slab-sharded SPMD COLA: approximate N-body over a device mesh.

The reference's COLA path (box.py:463-589 via pycola3) is single-process;
here the whole 2LPT + PM-leapfrog evolution runs as one shard_map program
over a 'space' mesh axis, with halo-exchange lattice CIC and distributed
Poisson solves (parallel/cola.py).  On a single chip this degenerates to a
1-shard mesh (same program, no communication); on several GPUs the slab
halos travel between devices.

Run on CPU with a virtual mesh to see the multi-device path:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/example_cola_sharded.py --nsamp 64 --space 4
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from fastbox_tpu import default_cosmo
from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.ops.spectra import binned_power_spectrum
from fastbox_tpu.parallel import make_sharded_cola


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsamp", type=int, default=64)
    ap.add_argument("--box", type=float, default=2e3,
                    help="Mpc; default gives ~31 Mpc cells, max|d| ~1.2")
    ap.add_argument("--redshift", type=float, default=0.0)
    ap.add_argument("--space", type=int, default=None,
                    help="shards on the space axis (default: all devices)")
    ap.add_argument("--band", type=int, default=2,
                    help="lattice displacement bound B in cells (graph size "
                         "grows as (2B+2)^3 — keep small for big grids)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    space = args.space or len(jax.devices())
    mesh = Mesh(np.asarray(jax.devices()[:space]), ("space",))
    grid = GridSpec.create(box_scale=(args.box,) * 3, nsamp=args.nsamp,
                           redshift=args.redshift)
    cosmology = build_cosmology(default_cosmo, redshift=args.redshift)

    fn = make_sharded_cola(mesh, grid, cosmology, dtype=jnp.float32,
                           lattice_B=args.band)
    out = fn(jax.random.PRNGKey(args.seed))
    delta = out["delta_x"]
    print(f"mesh={dict(mesh.shape)}  max|displacement| = "
          f"{float(out['max_disp']):.2f} cells (must stay <= lattice_B)")
    print(f"std(delta) = {float(jnp.std(delta)):.3f}")

    k, pk, _ = binned_power_spectrum(grid, delta_x=delta, nbins=12)
    pk_lin = np.asarray(cosmology.pk_lin(jnp.asarray(k)))
    with np.printoptions(precision=3, suppress=False):
        print("k        :", np.asarray(k)[:6])
        print("P(k)/Plin:", (np.asarray(pk) / pk_lin)[:6])


if __name__ == "__main__":
    main()
