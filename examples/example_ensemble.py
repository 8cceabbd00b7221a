#!/usr/bin/env python
"""Monte-Carlo mock ensemble: vmapped end-to-end pipelines, all in HBM.

The throughput configuration from BASELINE.json: a batch of PRNG keys is
vmapped through the full realize -> RSD -> filter -> P(k) pipeline in one
XLA program; on a multi-chip mesh the batch shards over the 'ens' axis
(see fastbox_tpu.parallel for the sharded variant).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax
import numpy as np

from fastbox_tpu.cosmology import build_cosmology
from fastbox_tpu.grid import GridSpec
from fastbox_tpu.pipeline import PipelineConfig, make_ensemble_pipeline

BATCH = 8
grid = GridSpec.create(box_scale=(2e3,) * 3, nsamp=128, redshift=0.8)
cosmology = build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7,
                                 n_s=0.95, sigma8=0.8), redshift=0.8)
config = PipelineConfig()

fn = make_ensemble_pipeline(grid, cosmology, config)
keys = jax.random.split(jax.random.PRNGKey(0), BATCH)

print(f"compiling ensemble of {BATCH} x {grid.N}^3 pipelines...")
out = fn(keys)
jax.block_until_ready(out)

t0 = time.time()
out = fn(jax.random.split(jax.random.PRNGKey(1), BATCH))
jax.block_until_ready(out)
dt = time.time() - t0
print(f"{BATCH} pipelines in {dt:.2f}s -> {BATCH/dt:.1f} pipelines/sec")

pk = np.asarray(out["pk_cleaned"])  # (BATCH, nbins-1)
k = np.asarray(out["k"])[0]         # bin centres (identical across the batch)
mean = np.nanmean(pk, axis=0)
scatter = np.nanstd(pk, axis=0)
print("\n  k [1/Mpc]   <P(k)>        sigma(P)  (over the ensemble)")
for i in range(2, len(k), 3):
    if np.isfinite(mean[i]):
        print(f"  {k[i]:9.4f}  {mean[i]:12.3f}  {scatter[i]:10.3f}")
