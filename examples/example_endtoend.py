#!/usr/bin/env python
"""End-to-end 21cm intensity-mapping mock (BASELINE.json config 5).

Native analog of the reference's examples/example_endtoend.py: log-normal
HI field -> redshift space -> brightness temperature -> diffuse foregrounds
-> radiometer noise -> PCA/ICA cleaning -> correlation functions and binned
spectra.  The nbodykit FFTCorr stage runs natively on device.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

import fastbox_tpu.filters as filters
from fastbox_tpu import CosmoBox, default_cosmo
from fastbox_tpu.models import ForegroundModel, HITracer, NoiseModel
from fastbox_tpu.ops import correlation_function
from fastbox_tpu.timing import Timings, stage

timings = Timings()
box = CosmoBox(cosmo=default_cosmo, box_scale=(4e3, 4e3, 4e3), nsamp=128,
               redshift=0.8, realise_now=False, seed=10)

with stage("(1) Generating box", timings=timings) as s:
    box.realise_density()
    tracer = HITracer(box)
    delta_hi = box.delta_x * tracer.bias_HI()
    delta_ln = box.lognormal(delta_hi)
    vel_k = box.realise_velocity(delta_x=box.delta_x)
    vel_z = jnp.fft.ifftn(vel_k[2]).real
    delta_s = box.redshift_space_density(delta_x=delta_ln, velocity_z=vel_z,
                                         sigma_nl=120.0)
    signal_cube = tracer.signal_amplitude() * (1.0 + delta_s)
    s["sync"] = signal_cube

with stage("(2) Adding foregrounds", timings=timings) as s:
    fg = ForegroundModel(box)
    fg_map = fg.realise_foreground_amp(amp=57.0, beta=1.1, monopole=10.0,
                                       smoothing_scale=4.0)
    alpha = fg.realise_spectral_index(mean_spec_idx=2.07, std_spec_idx=2e-4,
                                      smoothing_scale=15.0)
    fg_cube = fg.construct_cube(fg_map, alpha, freq_ref=130.0)
    data_cube = signal_cube + fg_cube
    s["sync"] = data_cube

with stage("(3) Adding noise", timings=timings) as s:
    noise_cube = NoiseModel(box).realise_radiometer_noise(Tinst=18.0, tp=2.0,
                                                          fov=1.0, Ndish=64)
    data_cube = data_cube + noise_cube
    s["sync"] = data_cube

with stage("(4a) PCA clean", timings=timings) as s:
    cleaned_pca = filters.pca_filter(data_cube, nmodes=4)
    s["sync"] = cleaned_pca

with stage("(4b) ICA clean", timings=timings) as s:
    cleaned_ica = filters.ica_filter(data_cube, nmodes=4)
    s["sync"] = cleaned_ica

with stage("(5) Binned power spectra", timings=timings) as s:
    out = {}
    for name, cube in [("signal", signal_cube), ("data", data_cube),
                       ("pca", cleaned_pca), ("ica", cleaned_ica)]:
        kc, pk, _ = box.binned_power_spectrum(delta_x=cube)
        out[name] = np.asarray(pk)
    s["sync"] = pk

with stage("(6) Correlation functions", timings=timings) as s:
    xi_sig = correlation_function(box.grid, signal_cube, dr=2.0, rmin=20.0,
                                  rmax=200.0)
    xi_pca = correlation_function(box.grid, cleaned_pca, dr=2.0, rmin=20.0,
                                  rmax=200.0)
    s["sync"] = xi_pca["corr"]

print()
print(timings.report())

kc = np.asarray(kc)
print("\n  k [1/Mpc]   P_signal      P_pca         P_ica")
for i in range(2, len(kc), 3):
    if np.isfinite(out["signal"][i]):
        print(f"  {kc[i]:9.4f}  {out['signal'][i]:12.3f} "
              f"{out['pca'][i]:12.3f}  {out['ica'][i]:12.3f}")

r = np.asarray(xi_sig["r"])
print("\n  r [Mpc]    xi_signal     xi_pca")
for i in range(0, len(r), 15):
    if np.isfinite(r[i]):
        print(f"  {r[i]:8.1f}  {float(np.asarray(xi_sig['corr'])[i]):12.3e} "
              f"{float(np.asarray(xi_pca['corr'])[i]):12.3e}")
