"""fastbox_tpu — a JAX cosmological field simulation framework.

A from-scratch JAX/XLA rebuild of the capabilities of philbull/FastBox
(see SURVEY.md): Gaussian/log-normal density fields coloured by a tabulated
matter power spectrum, velocity/potential fields, tracer biasing,
redshift-space distortions, anisotropic filtering, beams, foregrounds, noise,
foreground cleaning, halo sampling, and on-device P(k)/correlation-function
estimation — designed as jit-compiled pipelines, sharded over device meshes.
"""
__version__ = "0.1.0"


from . import analysis, cosmology, fields, filters, grid, io, models, ops
from . import parallel, timing, utils
from .box import CosmoBox, default_cosmo
from .cosmology import CosmoParams, build_cosmology
from .grid import GridSpec

# Reference-style module aliases (`fastbox.tracers`, `fastbox.filters`, ...)
from .models import foregrounds, noise, tracers

__all__ = [
    "CosmoBox",
    "default_cosmo",
    "CosmoParams",
    "build_cosmology",
    "GridSpec",
    "cosmology",
    "fields",
    "grid",
    "models",
    "ops",
    "foregrounds",
    "noise",
    "tracers",
]
