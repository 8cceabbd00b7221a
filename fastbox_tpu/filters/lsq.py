"""Least-squares component fitting, vmapped on device.

Reference: ``fastbox.filters.LSQfitting`` (filters.py:598-747) — per-pixel
synchrotron power-law fits with lmfit, fanned out over 7
``multiprocessing.Process`` workers with a Queue gather (filters.py:702-719).
Here the per-pixel fit is a tiny bounded Gauss-Newton iteration, vmapped
over every pixel at once: the process fan-out disappears entirely
(SURVEY.md §2.4).

Model per pixel (filters.py:612-623): T(nu) = A (nu/nu0)^beta, weighted by
1/noise^2; after the spectral-index fit, synchrotron + free-free amplitudes
are re-solved jointly via the normal equations (filters.py:650-657).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["lsq_synchrotron_fit", "LSQfitting"]


def _fit_one(tval, noval, bgu, freqs, freeind, n_iter: int = 30):
    """Bounded Gauss-Newton fit of (beta, amp) for one pixel.

    Bounds follow the reference's lmfit setup (filters.py:640-641):
    beta in [bgu*1.1, bgu*0.9] (bgu is negative), amp in
    [0.5, 1.5] x tval[0].
    """
    x = freqs / freqs[0]
    w = 1.0 / noval**2

    beta_lo, beta_hi = bgu * 1.1, bgu * 0.9  # bgu < 0 so lo < hi
    amp_lo, amp_hi = tval[0] * 0.5, tval[0] * 1.5

    def body(_, state):
        beta, amp = state
        model = amp * x**beta
        r = w * (model - tval)
        # Jacobian of the weighted residual
        d_beta = w * model * jnp.log(x)
        d_amp = w * x**beta
        JtJ00 = jnp.sum(d_beta * d_beta)
        JtJ01 = jnp.sum(d_beta * d_amp)
        JtJ11 = jnp.sum(d_amp * d_amp)
        g0 = jnp.sum(d_beta * r)
        g1 = jnp.sum(d_amp * r)
        det = JtJ00 * JtJ11 - JtJ01**2
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        db = -(JtJ11 * g0 - JtJ01 * g1) / det
        da = -(-JtJ01 * g0 + JtJ00 * g1) / det
        beta = jnp.clip(beta + db, beta_lo, beta_hi)
        amp = jnp.clip(amp + da, amp_lo, amp_hi)
        return beta, amp

    beta, amp = jax.lax.fori_loop(0, n_iter, body, (bgu, tval[0] * 0.9))

    # Joint amplitude solve with fixed spectral shapes (filters.py:650-657)
    specs = jnp.stack([x**beta, x**freeind], axis=1)  # (Nfreq, 2)
    num = specs.T @ tval
    denom = jnp.linalg.inv(specs.T @ specs)
    amps = num @ denom
    mod = amps @ specs.T
    return beta, amps[0], amps[1], mod


@partial(jax.jit, static_argnames=())
def lsq_synchrotron_fit(data, noise, freqs, freeind):
    """Fit all pixels at once.

    Parameters:
        data: (Npix, Nfreq) observed spectra (mean point-source temp already
            subtracted, as in filters.py:691).
        noise: (Npix, Nfreq) per-pixel noise realisation/level.
        freqs: (Nfreq,) frequencies.
        freeind: free-free spectral index (scalar).

    Returns:
        dict with 'beta', 'sync_amp', 'ff_amp' (Npix,) and 'model'
        (Npix, Nfreq); the residual is ``data - model``.
    """
    # Initial beta guess from channel ratios (filters.py:699)
    bidea = jnp.log(data[:, 3] / data[:, 0]) / jnp.log(freqs[3] / freqs[0])
    beta, syamp, ffamp, mod = jax.vmap(
        lambda t, n, b: _fit_one(t, n, b, freqs, freeind)
    )(data, noise, bidea)
    return {"beta": beta, "sync_amp": syamp, "ff_amp": ffamp, "model": mod}


class LSQfitting:
    """Reference-API shim (filters.py:598-747)."""

    def __init__(self, box):
        self.box = box

    def run_fit(self, maps, freqs, numpix, tpsmean, freeind, noise=None):
        """Fit the data cube; returns (residual, beta map) like the
        reference's ``run_fit`` (filters.py:667-723)."""
        data = jnp.asarray(maps).reshape(numpix, freqs.size) \
            - jnp.asarray(tpsmean).reshape(freqs.size, 1).T
        if noise is None:
            noise = jnp.ones_like(data)
        out = lsq_synchrotron_fit(data, jnp.asarray(noise),
                                  jnp.asarray(freqs), freeind)
        return data - out["model"], out["beta"]

    def give_hest(self, T_obs, freeind, psaveind, flux_cutoff, indspread,
                  redshift=None):
        """Fit the point-source model to a data cube (filters.py:726-747).

        Builds the mean point-source temperature from the native
        PointSourceModel, runs the vmapped per-pixel fit, and returns the
        residual cube and spectral-index map.
        """
        from ..models.foregrounds import PointSourceModel

        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        xside, yside = ang_x.size, ang_y.size

        psmodel = PointSourceModel(box)
        _, tpsmean = psmodel.construct_cube(flux_cutoff=flux_cutoff,
                                            beta=psaveind,
                                            delta_beta=indspread)

        res, spec = self.run_fit(jnp.asarray(T_obs), freqs, xside * yside,
                                 tpsmean, freeind)
        residual = res.reshape(xside, yside, freqs.size)
        bspec = spec.reshape(xside, yside)
        return residual, bspec
