#!/usr/bin/env python
"""Fisher forecast for a 21cm x galaxy cross-correlation.

Native analog of the reference's Fisher_forecast_crosscorrelation notebook
(SURVEY.md §3.5): tracers, Limber C_ell, instrument noise, and bandpower
Fisher — all without CCL.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastbox_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from fastbox_tpu.analysis import forecast
from fastbox_tpu.cosmology import CosmoParams

cosmo = CosmoParams()
zmin, zmax = 0.7, 0.9
ells = np.arange(20, 400, 20).astype(float)

t_gal = forecast.tracer_spectro(cosmo, zmin, zmax, "galaxy")
t_im = forecast.tracer_spectro(cosmo, zmin, zmax, "im")

cl_gal = forecast.angular_cl(cosmo, t_gal, t_gal, ells)
cl_im = forecast.angular_cl(cosmo, t_im, t_im, ells)
cl_x = forecast.angular_cl(cosmo, t_gal, t_im, ells)

Nell_im = forecast.noise_im(cosmo, forecast.inst_meerkatuhf, ells, zmin, zmax)
ngal_area = forecast.number_density_to_area_density(cosmo, 1e-3, zmin, zmax)
Nell_gal = 1.0 / ngal_area  # shot noise per steradian

F = forecast.fisher_bandpowers(ells, 20.0, forecast.inst_meerkatuhf["fsky"],
                               cl_gal, cl_im, cl_x, Nell_gal, Nell_im[:, 0])
snr = cl_x * np.sqrt(F)

print("  ell     C_gal         C_im [mK^2]   C_x [mK]      S/N per bin")
for i in range(len(ells)):
    print(f"  {ells[i]:5.0f}  {cl_gal[i]:.4e}  {cl_im[i]:.4e}  "
          f"{cl_x[i]:.4e}  {snr[i]:8.2f}")
print(f"\ntotal cross-spectrum S/N: {np.sqrt(np.sum(snr**2)):.1f}")
