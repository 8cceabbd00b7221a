#!/usr/bin/env python
"""Watershed void detection on a redshift-space density field.

Native analog of the reference's examples/example_void_detection.py: the
skimage watershed + RAG merge is replaced by the on-device steepest-descent
label propagation with a host-side region merge.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.analysis import voids
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(1e3,) * 3, nsamp=64,
               realise_now=False, seed=12)

with stage("(1) Realise + RSD") as s:
    delta_x = box.realise_density()
    vel_k = box.realise_velocity(delta_x=delta_x)
    vel_z = jnp.fft.ifftn(vel_k[2]).real
    delta_s = box.redshift_space_density(delta_x=delta_x, velocity_z=vel_z)
    s["sync"] = delta_s

with stage("(2) Watershed void finding") as s:
    labels = voids.apply_watershed(np.asarray(delta_s), mask_threshold=0.0,
                                   merge_threshold=0.2)
    s["sync"] = None

with stage("(3) Void catalogue + measurements") as s:
    cat = voids.trim_by_volume(labels, nmin=30, nmax=100000)
    cat = cat[cat > 0]
    centroids = voids.void_centroid(cat, labels, box, field=np.asarray(delta_s),
                                    kind="uniform")
    radii = voids.void_radii(cat, labels, box)
    s["sync"] = None

print(f"\n{cat.size} voids pass the volume cut")
rs = np.array([radii[l] for l in cat])
print(f"radii: median {np.median(rs):.1f} Mpc, max {rs.max():.1f} Mpc")

with stage("(4) Stacked void profile") as s:
    stack, failures = voids.stack_voids(cat[:40], labels, box,
                                        np.asarray(delta_s), grid_pix=15)
    s["sync"] = None
print(f"stack centre density: {float(stack[7, 7, 7]):.3f} "
      f"(negative = underdense, as expected); {len(failures)} failures")
