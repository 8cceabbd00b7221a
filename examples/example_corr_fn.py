#!/usr/bin/env python
"""Correlation function and multipoles of a log-normal redshift-space field.

Native analog of the reference's examples/example_corr_fn.py (which uses
nbodykit FFTCorr): xi_0/xi_2/xi_4 on device from the inverse FFT of the 3D
power.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.ops import correlation_multipoles
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(1.5e3,) * 3, nsamp=128,
               redshift=0.8, realise_now=False, seed=19)

with stage("(1) Realise + lognormal + RSD") as s:
    delta_x = box.realise_density()
    delta_ln = box.lognormal(delta_x)
    vel_k = box.realise_velocity(delta_x=delta_x)
    vel_z = jnp.fft.ifftn(vel_k[2]).real
    delta_s = box.redshift_space_density(delta_x=delta_ln, velocity_z=vel_z)
    s["sync"] = delta_s

with stage("(2) Correlation multipoles") as s:
    xi = correlation_multipoles(box.grid, delta_s, poles=(0, 2, 4), dr=2.0,
                                rmin=20.0, rmax=200.0)
    s["sync"] = xi["corr_0"]

r = np.asarray(xi["r"])
print("\n  r [Mpc]    xi_0          xi_2          xi_4")
for i in range(0, len(r), 10):
    if np.isfinite(r[i]):
        print(f"  {r[i]:8.1f}  {float(np.asarray(xi['corr_0'])[i]):12.4e} "
              f"{float(np.asarray(xi['corr_2'])[i]):12.4e} "
              f"{float(np.asarray(xi['corr_4'])[i]):12.4e}")
