"""Static grid geometry for the simulation box.

The reference stores its geometry on the mutable ``CosmoBox`` object and
materialises four N^3 Fourier-index arrays up front (``Kx, Ky, Kz, k``,
reference box.py:110-127).  Here the geometry is a small frozen
dataclass of Python scalars — hashable, so it can be a static argument to
jitted functions — and the k-grids are generated *inside* jit from three 1-D
index vectors by broadcasting.  XLA fuses the broadcast arithmetic into
consumers, so the N^3 k-magnitude array is never written to HBM on its own.

Conventions matched to the reference:
  * ``x = linspace(-L/2, L/2, N)``; ``Lx = x[-1]-x[0]`` (box.py:76-89)
  * ``boxfactor = N^6/(Lx Ly Lz)`` (box.py:94)
  * integer FFT index grids; ``k = 2 pi sqrt((Kx/Lx)^2 + ...)`` (box.py:116-127)
  * ``kmin = 2 pi / max(L)``, ``kmax = 2 pi sqrt(3) N / min(L)`` (box.py:100-101)
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import jax.numpy as jnp
import numpy as np

from .constants import C_KMS, LINE_FREQ_21CM

__all__ = ["GridSpec"]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of an N^3 comoving box.

    Parameters:
        N: grid points per dimension (reference ``nsamp``).
        Lx, Ly, Lz: box side lengths in Mpc.
        redshift: redshift of the box centre.
        line_freq: emission-line rest frequency in MHz (box.py:26).
    """

    N: int
    Lx: float
    Ly: float
    Lz: float
    redshift: float = 0.0
    line_freq: float = LINE_FREQ_21CM

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, box_scale=1e3, nsamp=32, redshift=0.0, line_freq=LINE_FREQ_21CM):
        """Build from the reference's ``box_scale`` convention (box.py:76-89)."""
        if isinstance(box_scale, tuple):
            assert len(box_scale) == 3, "Must specify scale of x, y, z dimensions"
            Lx, Ly, Lz = (float(s) for s in box_scale)
        else:
            Lx = Ly = Lz = float(box_scale)
        return cls(N=int(nsamp), Lx=Lx, Ly=Ly, Lz=Lz, redshift=float(redshift),
                   line_freq=float(line_freq))

    # ------------------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.N, self.N, self.N)

    @property
    def scale_factor(self) -> float:
        return 1.0 / (1.0 + self.redshift)

    @property
    def boxfactor(self) -> float:
        """DFT/volume normalisation N^6/(Lx Ly Lz) (box.py:94)."""
        return float(self.N) ** 6 / (self.Lx * self.Ly * self.Lz)

    @property
    def volume(self) -> float:
        return self.Lx * self.Ly * self.Lz

    @property
    def voxel_volume(self) -> float:
        return self.volume / self.N**3

    @property
    def kmin(self) -> float:
        return 2.0 * np.pi / max(self.Lx, self.Ly, self.Lz)

    @property
    def kmax(self) -> float:
        return 2.0 * np.pi * np.sqrt(3.0) * self.N / min(self.Lx, self.Ly, self.Lz)

    # ------------------------------------------------------------------
    # Real-space coordinates (host numpy; tiny 1-D arrays)
    # ------------------------------------------------------------------
    @cached_property
    def x(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Lx, 0.5 * self.Lx, self.N)

    @cached_property
    def y(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Ly, 0.5 * self.Ly, self.N)

    @cached_property
    def z(self) -> np.ndarray:
        return np.linspace(-0.5 * self.Lz, 0.5 * self.Lz, self.N)

    # ------------------------------------------------------------------
    # Fourier-space index vectors and broadcast k-grids
    # ------------------------------------------------------------------
    @cached_property
    def fft_index(self) -> np.ndarray:
        """Integer FFT indices [0, 1, ..., N/2-1, -N/2, ..., -1] (box.py:119)."""
        return (self.N * np.fft.fftfreq(self.N, 1.0)).astype(np.int64)

    def kvec(self, dtype=jnp.float32):
        """Physical 1-D wavenumber vectors (2 pi n / L) for each axis."""
        n = self.fft_index.astype(np.float64)
        kx = 2.0 * np.pi * n / self.Lx
        ky = 2.0 * np.pi * n / self.Ly
        kz = 2.0 * np.pi * n / self.Lz
        return (
            jnp.asarray(kx, dtype=dtype),
            jnp.asarray(ky, dtype=dtype),
            jnp.asarray(kz, dtype=dtype),
        )

    def kmag(self, dtype=jnp.float32):
        """|k| on the full grid, built by broadcasting (never a stored constant)."""
        kx, ky, kz = self.kvec(dtype)
        return jnp.sqrt(
            kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
        )

    def k2(self, dtype=jnp.float32):
        """|k|^2 on the full grid by broadcasting."""
        kx, ky, kz = self.kvec(dtype)
        return kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2

    def kperp_kpar(self, dtype=jnp.float32):
        """(k_perp, k_par) grids: transverse magnitude and LOS component.

        Matches apply_transfer_fn's definitions (box.py:374-375): k_par keeps
        its sign (it is 2 pi Kz / Lz, including negative frequencies).
        """
        kx, ky, kz = self.kvec(dtype)
        k_perp = jnp.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2)
        k_par = jnp.broadcast_to(kz[None, None, :], self.shape)
        return k_perp, k_par

    def nyquist_mask(self, axis: int):
        """Boolean 1-D mask selecting the most-negative frequency plane.

        For even N the reference zeroes the velocity component on the plane
        where the integer index equals -N/2 (box.py:268-274).  For odd N no
        plane is masked.
        """
        idx = self.fft_index
        if self.N % 2 == 0:
            return jnp.asarray(idx == idx.min())
        return jnp.zeros(self.N, dtype=bool)

    # ------------------------------------------------------------------
    # Observational coordinates (need background cosmology scalars)
    # ------------------------------------------------------------------
    def freq_array(self, cosmology) -> np.ndarray:
        """Frequency channels (MHz) along the z axis, *descending* (box.py:789-828).

        ``cosmology`` is a ``Cosmology`` bundle evaluated at the desired
        redshift (its ``Ea`` supplies H(a)/H0).
        """
        a = cosmology.scale_factor
        freq_centre = a * self.line_freq
        dx = self.Lz / self.N
        Hz = 100.0 * cosmology.h * cosmology.Ea  # km/s/Mpc
        df = dx * self.line_freq * (a**2 * Hz) / C_KMS
        freqs = freq_centre + df * (np.arange(self.N) - 0.5 * (self.N - 1.0))
        return freqs[::-1]

    def pixel_array(self, cosmology) -> tuple[np.ndarray, np.ndarray]:
        """Angular pixel-centre coordinates in degrees (box.py:831-864)."""
        r = cosmology.chi  # comoving angular distance (flat) at bundle redshift
        x_px = self.x[1] - self.x[0]
        y_px = self.y[1] - self.y[0]
        ang_x = (180.0 / np.pi) * (x_px / r)
        ang_y = (180.0 / np.pi) * (y_px / r)
        grid = np.arange(self.N) - 0.5 * (self.N - 1.0)
        return ang_x * grid, ang_y * grid
