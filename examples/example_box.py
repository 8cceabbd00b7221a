#!/usr/bin/env python
"""Gaussian density field in a box + binned P(k) vs theory.

Native analog of the reference's examples/example_box.py (which uses
nbodykit FFTPower for the estimator); here both the reference-convention
binned spectrum and the native FFTPower-style estimator run on device
(BASELINE.json config 1).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.ops import power_spectrum
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(1e3, 1e3, 1e3), nsamp=128,
               realise_now=False, seed=10)

with stage("(1) Gaussian realisation") as s:
    delta_x = box.realise_density()
    s["sync"] = delta_x

with stage("(2) Binned power spectrum") as s:
    kc, pk, err = box.binned_power_spectrum()
    s["sync"] = pk

with stage("(3) FFTPower-style estimator") as s:
    res = power_spectrum(box.grid, delta_x, dk=2 * np.pi / 500.0)
    s["sync"] = res["power"]

th_k, th_pk = box.theoretical_power_spectrum()

print("\n  k [1/Mpc]   P(k) measured    P(k) theory")
kc = np.asarray(kc)
pk = np.asarray(pk)
for i in range(0, len(kc), 3):
    if np.isfinite(pk[i]):
        th = np.interp(kc[i], th_k, th_pk)
        print(f"  {kc[i]:9.4f}   {pk[i]:13.1f}   {th:12.1f}")

print(f"\nsigma8 of realisation: {box.sigma8():.4f} "
      f"(input linear sigma8 = {box.cosmo.sigma8})")
