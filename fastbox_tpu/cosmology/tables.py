"""Setup-time cosmology tabulation -> device-side interpolation.

This is the on-device replacement for the reference's run-time CCL calls
(reference box.py:163-165 evaluates P(k) at all N^3 |k| values through the C
library on every realisation).  Here the host tabulates ln P(ln k) once per
(cosmology, redshift); the jitted pipeline evaluates power spectra with a
pure-JAX log-log interpolation, so realise->...->P(k) compiles to a single
XLA program with no host callbacks.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import background as bg
from .eisenstein_hu import linear_power_z0
from .halofit import halofit_power
from .params import CosmoParams, as_cosmo_params

__all__ = ["PowerSpectrumTable", "Cosmology", "build_cosmology"]

# Mpc^-1; covers any sensible box.  Dense enough that piecewise-linear
# interpolation error through the BAO wiggles is < 1e-5 in ln P (the spectrum
# accuracy budget is 1e-4, BASELINE.md).
_KTAB = np.logspace(-5.0, 3.0, 8192)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["lnk", "lnp"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class PowerSpectrumTable:
    """Log-log P(k) table evaluated on device via linear interpolation."""

    lnk: jax.Array  # (n,) ln k, ascending
    lnp: jax.Array  # (n,) ln P(k)

    def __call__(self, k):
        """Interpolate P(k); returns 0 at k<=0 (reference nan_to_num, box.py:167).

        The table is built log-uniform, so interpolation is a direct index
        computation plus two gathers — no binary search.
        """
        k = jnp.asarray(k)
        safe = jnp.where(k > 0.0, k, 1.0)
        x = jnp.log(safe)
        n = self.lnk.shape[0]
        x0 = self.lnk[0]
        dx = (self.lnk[-1] - x0) / (n - 1)
        f = jnp.clip((x - x0) / dx, 0.0, n - 1.0)
        i = jnp.clip(f.astype(jnp.int32), 0, n - 2)
        w = f - i.astype(f.dtype)
        lnp = self.lnp[i] * (1.0 - w) + self.lnp[i + 1] * w
        return jnp.where(k > 0.0, jnp.exp(lnp), 0.0)

    @classmethod
    def from_arrays(cls, k, pk, dtype=jnp.float64):
        k = np.asarray(k, dtype=np.float64)
        pk = np.asarray(pk, dtype=np.float64)
        good = (k > 0) & (pk > 0)
        lnk = np.log(k[good])
        lnp = np.log(pk[good])
        # __call__ assumes a log-uniform grid; resample if it isn't.
        d = np.diff(lnk)
        if d.size and (np.abs(d - d[0]).max() > 1e-9 * abs(d[0])):
            lnk_u = np.linspace(lnk[0], lnk[-1], max(lnk.size, 4096))
            lnp = np.interp(lnk_u, lnk, lnp)
            lnk = lnk_u
        return cls(
            lnk=jnp.asarray(lnk, dtype=dtype),
            lnp=jnp.asarray(lnp, dtype=dtype),
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["pk_lin", "pk_nl", "pk_lin_z0"],
    meta_fields=["params", "redshift", "scale_factor", "Ea", "growth",
                 "growth_rate", "chi"],
)
@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Immutable bundle: parameters + background scalars + P(k) tables.

    Registered as a pytree (tables are leaves, scalars are hashable
    metadata), so a Cosmology can be passed straight into jitted functions.
    """

    params: CosmoParams
    redshift: float
    scale_factor: float
    # Background scalars at the box redshift
    Ea: float           # E(a) = H(a)/H0
    growth: float       # D(a), normalised to 1 today
    growth_rate: float  # f(a) = dlnD/dlna
    chi: float          # comoving radial distance, Mpc
    # Power spectrum tables at the box redshift
    pk_lin: PowerSpectrumTable
    pk_nl: PowerSpectrumTable
    # z=0 linear table (for re-scaling to other redshifts by D^2)
    pk_lin_z0: PowerSpectrumTable

    @property
    def h(self) -> float:
        return self.params.h

    @property
    def H(self) -> float:
        """H(a) in km/s/Mpc."""
        return 100.0 * self.params.h * self.Ea

    def pk(self, k, linear: bool = False):
        """Matter power spectrum at the bundle's redshift."""
        return self.pk_lin(k) if linear else self.pk_nl(k)


def build_cosmology(
    cosmo,
    redshift: float = 0.0,
    k_table: np.ndarray | None = None,
    dtype=None,
) -> Cosmology:
    """Tabulate all cosmology inputs needed by the device pipeline.

    Parameters:
        cosmo: CosmoParams or a reference-style dict (box.py:18-20).
        redshift: redshift at which fields will be realised.
        k_table: optional custom wavenumber table (Mpc^-1).
        dtype: dtype for the device-side tables (default: float64 if x64 is
            enabled, else float32).
    """
    params = as_cosmo_params(cosmo)
    a = 1.0 / (1.0 + redshift)
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    k = np.asarray(k_table if k_table is not None else _KTAB, dtype=np.float64)

    pk0 = linear_power_z0(params, k)
    D = float(bg.growth_factor(params, a))
    pk_lin_z = pk0 * D**2
    pk_nl_z = halofit_power(params, k, pk_lin_z, a)

    return Cosmology(
        params=params,
        redshift=float(redshift),
        scale_factor=a,
        Ea=float(bg.e_of_a(params, a)),
        growth=D,
        growth_rate=float(bg.growth_rate(params, a)),
        chi=float(bg.comoving_radial_distance(params, a)),
        pk_lin=PowerSpectrumTable.from_arrays(k, pk_lin_z, dtype),
        pk_nl=PowerSpectrumTable.from_arrays(k, pk_nl_z, dtype),
        pk_lin_z0=PowerSpectrumTable.from_arrays(k, pk0, dtype),
    )
