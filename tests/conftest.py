"""Test configuration.

Correctness tests run on CPU with 8 virtual devices (for multi-device
sharding tests) and float64 enabled, so the JAX pipeline can be validated
against the numpy/scipy oracle at tight tolerances.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere.  Run them on
the card with ``FASTBOX_TEST_GPU=1 python -m pytest -m gpu tests/``: that
variable leaves the platform to JAX instead of forcing the CPU.
"""
import os

_ON_GPU = os.environ.get("FASTBOX_TEST_GPU") == "1"

# Must be set before jax is imported anywhere.
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fastbox_tpu.cosmology import build_cosmology  # noqa: E402


@pytest.fixture(scope="session")
def cosmo_z0():
    """Shared cosmology tables at z=0 (default reference cosmology)."""
    return build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95,
                                sigma8=0.8), redshift=0.0)


@pytest.fixture(scope="session")
def cosmo_z08():
    return build_cosmology(dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95,
                                sigma8=0.8), redshift=0.8)


@pytest.fixture()
def rng():
    return np.random.default_rng(11)


@pytest.fixture()
def gpu():
    """Skip unless JAX's backend is a GPU.  Decided here, at run time,
    never at import: every test worker must collect the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (FASTBOX_TEST_GPU=1 on the card)")
    return jax.devices()[0]
