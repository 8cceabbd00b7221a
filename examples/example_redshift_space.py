#!/usr/bin/env python
"""Log-normal field + linear bias + RSD + power-spectrum multipoles.

Native analog of the reference's examples/example_redshift_space.py
(BASELINE.json config 2).  The quadrupole P_2(k) is non-zero in redshift
space (Kaiser effect); the real-space field's P_2 is consistent with zero.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.models import HITracer
from fastbox_tpu.ops import power_multipoles
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(2e3,) * 3, nsamp=128,
               redshift=0.8, realise_now=False, seed=42)

with stage("(1) Realise + bias + lognormal") as s:
    delta_x = box.realise_density()
    tracer = HITracer(box)
    delta_ln = box.lognormal(delta_x * tracer.bias_HI())
    s["sync"] = delta_ln

with stage("(2) Velocity + RSD remap") as s:
    vel_k = box.realise_velocity(delta_x=delta_x)
    vel_z = jnp.fft.ifftn(vel_k[2]).real
    delta_s = box.redshift_space_density(delta_x=delta_ln, velocity_z=vel_z,
                                         sigma_nl=120.0)
    s["sync"] = delta_s

with stage("(3) Multipoles (real + redshift space)") as s:
    res_r = power_multipoles(box.grid, delta_ln, poles=(0, 2, 4))
    res_s = power_multipoles(box.grid, delta_s, poles=(0, 2, 4))
    s["sync"] = res_s["power_0"]

k = np.asarray(res_s["k"])
print("\n  k [1/Mpc]   P0 real      P0 zspace    P2 zspace    P4 zspace")
for i in range(1, len(k), 2):
    if np.isfinite(k[i]):
        print(f"  {k[i]:9.4f}  {np.asarray(res_r['power_0'])[i]:11.1f} "
              f"{np.asarray(res_s['power_0'])[i]:12.1f} "
              f"{np.asarray(res_s['power_2'])[i]:12.1f} "
              f"{np.asarray(res_s['power_4'])[i]:12.1f}")
