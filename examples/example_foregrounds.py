#!/usr/bin/env python
"""Foreground models: diffuse power-law GRF and Battye+2013 point sources.

Native analog of the reference's examples/example_foregrounds.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.models import ForegroundModel, PointSourceModel
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(2e3,) * 3, nsamp=64,
               redshift=0.8, realise_now=False, seed=5)

with stage("(1) Diffuse foreground cube") as s:
    fg = ForegroundModel(box)
    amp = fg.realise_foreground_amp(amp=57.0, beta=1.1, monopole=10.0,
                                    smoothing_scale=4.0)
    alpha = fg.realise_spectral_index(2.07, 2e-4, 15.0)
    cube = fg.construct_cube(amp, alpha, freq_ref=130.0)
    s["sync"] = cube

print(f"    diffuse cube: mean {float(np.asarray(cube).mean()):.2f} mK, "
      f"std {float(np.asarray(cube).std()):.2f} mK")

with stage("(2) Point-source cube (Battye+2013)") as s:
    ps = PointSourceModel(box)
    ps_cube, T_mean = ps.construct_cube(flux_cutoff=0.1, beta=-2.7,
                                        delta_beta=0.1, seed_clustering=1,
                                        seed_poisson=2)
    s["sync"] = ps_cube

print(f"    point-source cube: mean {float(np.asarray(ps_cube).mean()):.2f} mK; "
      f"model mean T at band centre {float(T_mean[len(T_mean)//2, 0]):.2f} mK")

freqs = box.freq_array()
print(f"\nband: {freqs.min():.1f} - {freqs.max():.1f} MHz over {box.N} channels")
