#!/usr/bin/env python
"""21cm intensity map: anisotropic (kperp, kpar) filter + beam + noise.

BASELINE.json config 3: a brightness-temperature cube passed through an
anisotropic foreground-avoidance transfer function, convolved with a
frequency-dependent Gaussian beam, with radiometer noise added.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.models import HITracer, NoiseModel
from fastbox_tpu.models.beams import GaussianBeamModel
from fastbox_tpu.timing import stage

box = CosmoBox(cosmo=default_cosmo, box_scale=(2e3,) * 3, nsamp=128,
               redshift=0.8, realise_now=False, seed=3)

with stage("(1) Realise + Tb scaling") as s:
    delta_x = box.realise_density()
    tracer = HITracer(box)
    Tb = tracer.signal_amplitude()
    cube = Tb * (1.0 + box.lognormal(delta_x * tracer.bias_HI()))
    s["sync"] = cube

with stage("(2) Anisotropic (kperp,kpar) transfer fn") as s:
    # Foreground wedge cut + transverse beam taper (test_box.py:88-90 form)
    transfer_fn = lambda k_perp, k_par: (
        (1.0 - jnp.exp(-0.5 * (k_par / 0.01) ** 2))
        * jnp.exp(-0.5 * (k_perp / 0.5) ** 2)
    )
    cube_f = box.apply_transfer_fn(jnp.fft.fftn(cube), transfer_fn).real
    s["sync"] = cube_f

with stage("(3) Beam convolution (per channel)") as s:
    beam = GaussianBeamModel(box, dish_diameter=13.5)
    cube_b = beam.convolve_fft(cube_f)
    s["sync"] = cube_b

with stage("(4) Radiometer noise") as s:
    noise = NoiseModel(box).realise_radiometer_noise(Tinst=18.0, tp=2.0,
                                                     fov=1.0, Ndish=64)
    obs = cube_b + noise
    s["sync"] = obs

with stage("(5) Binned P(k) of observed cube") as s:
    kc, pk, _ = box.binned_power_spectrum(delta_x=obs)
    s["sync"] = pk

kc, pk = np.asarray(kc), np.asarray(pk)
print("\n  k [1/Mpc]   P_obs(k) [mK^2 Mpc^3]")
for i in range(1, len(kc), 2):
    if np.isfinite(pk[i]):
        print(f"  {kc[i]:9.4f}   {pk[i]:12.4f}")
print(f"\nobs cube std: {float(jnp.std(obs)):.4f} mK")
