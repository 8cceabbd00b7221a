"""Foreground emission models (L4).

JAX rebuild of the reference's ``fastbox/foregrounds.py``:

* ``ForegroundModel`` — the diffuse power-law foreground used by the
  end-to-end example (foregrounds.py:34-174): a 2D Gaussian random field with
  the Santos et al. (2005) angular power law, a smoothed Gaussian
  spectral-index map, and the (nu/nu_ref)^alpha datacube.  Runs entirely on
  device; smoothing reproduces scipy's wrap-mode truncated-Gaussian filter
  via exact circular convolution.

* ``PointSourceModel`` — the Battye et al. (2013) recipe
  (foregrounds.py:268-434).  The reference synthesises full-sky healpix maps
  and projects a patch with ``gnomview``; healpy is an *optional* dependency
  there (foregrounds.py:13-18).  Here the same empirical flux-count model and
  angular power spectra are realised directly on the flat-sky box patch
  (statistically equivalent for the small fields the box represents), with no
  healpix dependency.

* ``GlobalSkyModel`` / ``PlanckSkyModel`` — host-side ingest models that need
  pygdsm/healpy + external data files; gated on their imports exactly as in
  the reference.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from ..ops import fft_safe
from scipy.integrate import quad

from ..constants import C_MS, CMB_TEMP, H_PLANCK, KBOLTZ

__all__ = [
    "gaussian_smooth_wrap",
    "ForegroundModel",
    "PointSourceModel",
    "GlobalSkyModel",
    "PlanckSkyModel",
]


# ----------------------------------------------------------------------
# Smoothing helper
# ----------------------------------------------------------------------
def _scipy_gaussian_kernel1d(sigma: float, n: int) -> np.ndarray:
    """The truncated, normalised 1-D kernel scipy.ndimage uses (truncate=4)."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    # Embed circularly into length n (wrap mode == circular convolution)
    k = np.zeros(n, dtype=np.float64)
    for xi, p in zip(x.astype(int), phi):
        k[xi % n] += p
    return k


@partial(jax.jit, static_argnames=("shape", "dtype"))
def complex_white_noise(key, shape, dtype=jnp.float32):
    """Complex unit white noise re + i im, jitted.

    Jitted, so the Python ``1j`` scalar does not promote the result to
    complex128 in eager mode.
    """
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, shape, dtype)
            + 1j * jax.random.normal(k2, shape, dtype))


@partial(jax.jit, static_argnames=("sigma_pix",))
def gaussian_smooth_wrap(field2d, sigma_pix: float):
    """Separable wrap-mode Gaussian smoothing of a 2D field, on device.

    Bit-matches ``scipy.ndimage.gaussian_filter(mode='wrap')``
    (foregrounds.py:108-111) by circularly convolving with scipy's truncated
    kernel, applied via FFT.
    """
    n0, n1 = field2d.shape
    rdtype = field2d.dtype
    k0 = jnp.asarray(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n0)))
    k1 = jnp.asarray(np.fft.fft(_scipy_gaussian_kernel1d(sigma_pix, n1)))
    fk = fft_safe.fft2(field2d.astype(jnp.promote_types(rdtype, jnp.float32)))
    out = fft_safe.ifft2(fk * k0[:, None] * k1[None, :]).real
    return out.astype(rdtype)


# ----------------------------------------------------------------------
# Diffuse power-law foregrounds
# ----------------------------------------------------------------------
class ForegroundModel:
    """Diffuse foregrounds on top of a box realisation (foregrounds.py:34-174)."""

    def __init__(self, box):
        self.box = box

    # -- functional core (jit-safe) ---------------------------------
    @staticmethod
    @partial(jax.jit, static_argnames=("grid", "smoothing_sigma_pix"))
    def foreground_amp_from_whitenoise(white2d, grid, chi, amp, beta, monopole,
                                       smoothing_sigma_pix=None):
        """Colour 2D white noise by the Santos+2005 C_ell power law.

        Conventions matched (SURVEY.md §2.2 #8): C_ell = amp (l/1000)^beta
        with l = 0.5 k_perp chi (foregrounds.py:90), normalisation
        ``N^4/(Lx Ly)`` (foregrounds.py:95), zero mode removed, real part
        kept, monopole added.
        """
        rdtype = jnp.real(white2d).dtype
        kx, ky, _ = grid.kvec(rdtype)
        k_perp = jnp.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        ell = 0.5 * k_perp * chi / 1000.0
        C_ell = amp * jnp.where(ell > 0.0, ell, 1.0) ** beta
        C_ell = jnp.where(ell > 0.0, C_ell, 0.0)  # remove inf at k=0
        C_ell = C_ell * (grid.N**4 / (grid.Lx * grid.Ly))
        fg_k = white2d * jnp.sqrt(C_ell)
        fg_x = fft_safe.ifftn(fg_k).real + monopole
        if smoothing_sigma_pix is not None:
            fg_x = gaussian_smooth_wrap(fg_x, smoothing_sigma_pix)
        return fg_x.astype(rdtype)

    @staticmethod
    @jax.jit
    def construct_cube_fn(amps, spectral_idx, freqs, freq_ref):
        """cube = amps * (nu/nu_ref)^alpha (foregrounds.py:147-174)."""
        ffac_base = jnp.asarray(freqs) / freq_ref
        if jnp.ndim(spectral_idx) == 0:
            ffac = ffac_base[None, None, :] ** spectral_idx
        else:
            ffac = ffac_base[None, None, :] ** spectral_idx[:, :, None]
        return amps[:, :, None] * ffac

    @staticmethod
    @jax.jit
    def construct_cube_smallalpha_fn(amps, dalpha, ffac_mean, logf):
        """cube = amps * ffac_mean(nu) * exp(dalpha * logf(nu)), for
        |dalpha * logf| << 1 — the accurate f32 form of construct_cube_fn.

        Why this exists (a truth-gate finding): the cleaned P(k)'s low
        bins are dominated by the FOREGROUND cube's pixel-decorrelated
        f32 rounding — swapping only fg_cube into otherwise-f64 data
        reproduces +1.64e-2 of the +1.77e-2 bin-1 error at 256^3/key
        1001.  The
        generic ``(nu/nu_ref)**alpha`` evaluates exp(alpha*log(nu/ref))
        in f32: the log's rounding is amplified by |alpha*log| ~ 3.7,
        giving ~4e-7 relative error per VOXEL (decorrelated between
        pixels, so the PCA clean cannot remove it; it leaks straight
        into the cleaned spectrum).  Splitting alpha = mean + dalpha
        makes every large factor PIXEL-COMMON (absorbed into the
        empirical PCA subspace, harmless) and evaluates the tiny
        pixel-varying part exp(u), |u| <~ 2e-3, by a cubic Taylor
        polynomial — exact to 4e-13, leaving ~1 ulp of decorrelated
        rounding.  Callers precompute ffac_mean=(nu/ref)^mean and
        logf=log(nu/ref) in f64 on host.
        """
        u = dalpha[:, :, None] * logf[None, None, :]
        one_sixth = jnp.asarray(1.0 / 6.0, u.dtype)
        expu = 1.0 + u * (1.0 + u * (0.5 + u * one_sixth))
        return amps[:, :, None] * (ffac_mean[None, None, :] * expu)

    # -- reference-API methods ---------------------------------------
    def realise_foreground_amp(self, amp, beta, monopole, smoothing_scale=None,
                               redshift=None):
        """2D foreground amplitude map in field units (foregrounds.py:48-113)."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        shape2d = (box.grid.N, box.grid.N)
        white = complex_white_noise(box.next_key(), shape2d, box.dtype)
        sigma_pix = None
        if smoothing_scale is not None:
            ang_x, _ = box.grid.pixel_array(cosmology)
            sigma_pix = smoothing_scale / (ang_x[1] - ang_x[0])
        return self.foreground_amp_from_whitenoise(
            white, box.grid, cosmology.chi, amp, beta, monopole, sigma_pix
        )

    def realise_spectral_index(self, mean_spec_idx, std_spec_idx,
                               smoothing_scale, redshift=None):
        """Smoothed Gaussian spectral-index map (foregrounds.py:116-144)."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        alpha = mean_spec_idx + std_spec_idx * jax.random.normal(
            box.next_key(), (box.grid.N, box.grid.N), dtype=box.dtype
        )
        ang_x, _ = box.grid.pixel_array(cosmology)
        sigma_pix = smoothing_scale / (ang_x[1] - ang_x[0])
        return gaussian_smooth_wrap(alpha, sigma_pix)

    def construct_cube(self, amps, spectral_idx, freq_ref=130.0, redshift=None):
        """Foreground datacube from amplitude + spectral-index maps."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = jnp.asarray(box.grid.freq_array(cosmology), dtype=box.dtype)
        if isinstance(spectral_idx, float):
            spectral_idx = jnp.asarray(spectral_idx, dtype=box.dtype)
        return self.construct_cube_fn(amps, spectral_idx, freqs, freq_ref)


# ----------------------------------------------------------------------
# Point sources (Battye et al. 2013)
# ----------------------------------------------------------------------
class PointSourceModel:
    """Battye et al. (2013) point-source model (foregrounds.py:268-434).

    Flat-sky native: clustering and faint-Poisson components are realised as
    2D GRFs from their C_ell on the box's pixel grid; bright sources are
    injected into random pixels.  The empirical flux-count formulae match
    foregrounds.py:286-310 exactly.
    """

    def __init__(self, box):
        self.box = box

    def flux_amplitude(self, sjy):
        """Amplitude factor of the flux scaling (foregrounds.py:286-295)."""
        logS = np.log10(sjy)
        gamma = (
            2.593
            + 9.333e-2 * logS
            - 4.839e-4 * logS**2
            + 2.488e-1 * logS**3
            + 8.995e-2 * logS**4
            + 8.506e-3 * logS**5
        )
        return 10.0**gamma

    def integ_flux(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5) * sjy

    def poisson_pspec(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5) * sjy**2.0

    def number_count(self, sjy):
        return self.flux_amplitude(sjy) * sjy ** (-2.5)

    # ------------------------------------------------------------------
    def _grf_from_cl(self, key, cl_fn, chi):
        """Flat-sky 2D GRF whose angular spectrum follows cl_fn(ell)."""
        box = self.box
        grid = box.grid
        shape2d = (grid.N, grid.N)
        white = complex_white_noise(key, shape2d, box.dtype)
        kx, ky, _ = grid.kvec(box.dtype)
        k_perp = np.sqrt(np.asarray(kx)[:, None] ** 2 + np.asarray(ky)[None, :] ** 2)
        ell = k_perp * chi  # flat-sky ell = k_perp * chi
        cl = np.where(ell > 0.0, cl_fn(np.maximum(ell, 1.0)), 0.0)
        cl = cl * (grid.N**4 / (grid.Lx * grid.Ly)) * chi**2 / 1.0
        # chi^2 converts the per-steradian C_ell to the comoving pixel grid:
        # a transverse comoving length L corresponds to angle L/chi.
        fg = white * jnp.sqrt(jnp.asarray(cl, dtype=box.dtype))
        return fft_safe.ifftn(fg).real.astype(box.dtype)

    def construct_cube(self, flux_cutoff, beta, delta_beta, redshift=None,
                       seed_clustering=None, seed_poisson=None):
        """Point-source temperature cube + mean temperature, both in mK.

        Mirrors foregrounds.py:313-434: mean T from the integrated flux below
        the cutoff, a clustering GRF with C_l = 1.8e-4 l^-1.2 T0^2, a Gaussian
        Poisson component from the faint-source P(k), bright-source shot
        injection above 0.01 Jy, and per-pixel power-law frequency scaling.
        """
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = np.asarray(box.grid.freq_array(cosmology))
        nfreq = freqs.size
        n = box.grid.N
        chi = cosmology.chi

        cfact = C_MS**2 / (2.0 * KBOLTZ * (1.4e9) ** 2) * 1e-26

        # Mean temperature at 1.4 GHz (foregrounds.py:366-367)
        T_ps0 = cfact * quad(self.integ_flux, 0.0, flux_cutoff)[0]

        # Clustering component C_l = 1.8e-4 l^-1.2 T0^2 (foregrounds.py:371)
        key_c = (jax.random.PRNGKey(seed_clustering)
                 if seed_clustering is not None else box.next_key())
        clustmap = self._grf_from_cl(
            key_c, lambda ell: 1.8e-4 * ell**-1.2 * T_ps0**2, chi
        )

        # Faint-source Poisson component: flat C_l (foregrounds.py:376-384)
        cl_poisson = cfact**2 * quad(self.poisson_pspec, 0.0, min(0.01, flux_cutoff))[0]
        key_p = (jax.random.PRNGKey(seed_poisson)
                 if seed_poisson is not None else box.next_key())
        poisson_map = self._grf_from_cl(key_p, lambda ell: cl_poisson + 0.0 * ell, chi)

        # Bright sources above 0.01 Jy injected at random pixels
        shotmap = jnp.zeros((n, n), dtype=box.dtype)
        if flux_cutoff > 0.01:
            ang_x, ang_y = box.grid.pixel_array(cosmology)
            pixarea_sr = (np.deg2rad(ang_x[1] - ang_x[0])
                          * np.deg2rad(ang_y[1] - ang_y[0]))
            fov_sr = (np.deg2rad(ang_x[-1] - ang_x[0])
                      * np.deg2rad(ang_y[-1] - ang_y[0]))
            rng = np.random.default_rng(seed_poisson)
            shot = np.zeros((n, n))
            for ival in np.arange(0.01, flux_cutoff, (flux_cutoff - 0.01) / 10.0):
                numbster = quad(self.number_count, ival - 1e-3, ival + 1e-3)[0]
                nsrc = rng.poisson(max(numbster * ival, 0.0) * fov_sr)
                tempval = cfact * quad(self.integ_flux, 0.01, ival)[0] / pixarea_sr
                if nsrc > 0:
                    idx = rng.integers(0, n * n, size=nsrc)
                    shot.ravel()[idx] = tempval
            shotmap = jnp.asarray(shot, dtype=box.dtype)

        map0 = T_ps0 + poisson_map + clustmap + shotmap

        # Spectral index map (reference uses scale=delta_beta**2 at
        # foregrounds.py:416 — a documented quirk; we use the intended RMS).
        spidxs = beta + delta_beta * jax.random.normal(
            box.next_key(), (n, n), dtype=box.dtype
        )

        freqs_j = jnp.asarray(freqs, dtype=box.dtype)
        maps = map0[:, :, None] * (freqs_j[None, None, :] / 1400.0) ** spidxs[:, :, None]
        T_ps_mean = (T_ps0 * (freqs / 1400.0) ** beta).reshape(nfreq, 1)
        return maps * 1e3, T_ps_mean * 1e3  # mK


# ----------------------------------------------------------------------
# Host-side ingest models (optional heavy deps, like the reference)
# ----------------------------------------------------------------------
class GlobalSkyModel:
    """pyGDSM-based foregrounds (foregrounds.py:178-264); host-side ingest.

    Requires ``pygdsm`` and ``healpy``; raises ImportError otherwise, like
    the reference (foregrounds.py:192-197).
    """

    def __init__(self, box):
        self.box = box
        try:
            from pygdsm import GlobalSkyModel2016  # noqa: F401
        except ImportError as exc:
            raise ImportError("pygdsm is not installed") from exc
        self.gsm = GlobalSkyModel2016(freq_unit="MHz")

    def construct_cube(self, lat0=0.0, lon0=0.0, redshift=None, loop=True,
                       verbose=True):
        import healpy as hp
        from functools import partial

        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        dx = np.max(ang_x) - np.min(ang_x)
        dy = np.max(ang_y) - np.min(ang_y)
        npix = box.grid.N
        proj = hp.projector.CartesianProj(
            lonra=[lon0 - 0.5 * dx, lon0 + 0.5 * dx],
            latra=[lat0 - 0.5 * dy, lat0 + 0.5 * dy],
            coord="G", xsize=npix, ysize=npix,
        )
        fgcube = np.zeros(box.grid.shape)
        for i, freq in enumerate(freqs):
            if verbose and i % 10 == 0:
                print(f"    Channel {i} / {len(freqs)}")
            m = self.gsm.generate(freq)
            nside = hp.npix2nside(m.size)
            fgcube[:, :, i] = proj.projmap(m, vec2pix_func=partial(hp.vec2pix, nside))
        return fgcube


class PlanckSkyModel:
    """Planck FFP10 synchrotron + free-free model (foregrounds.py:438-681).

    The healpix map ingest/projection requires ``healpy`` and the Planck
    simulation files; the pure-math pieces (T_CMB -> T_RJ correction, the
    power-law cube assembly) are dependency-free.
    """

    def __init__(self, box, free_idx=-2.1, planck_sim_paths=None):
        try:
            import healpy  # noqa: F401
        except ImportError as exc:
            raise ImportError("healpy is not installed") from exc
        self.box = box
        self.free_idx = free_idx
        self.planck_sim_paths = planck_sim_paths or {}

    @staticmethod
    def planck_corr(freq_ghz):
        """T_CMB -> T_RJ correction factor (foregrounds.py:483-497)."""
        freq = freq_ghz * 1e9
        factor = H_PLANCK * freq / (KBOLTZ * CMB_TEMP)
        return (np.exp(factor) - 1.0) ** 2 / (factor**2 * np.exp(factor))

    @staticmethod
    def assemble_cube(sync_amp, free_amp, sync_idx, freqs, ref_freq, free_idx):
        """cube = sync x^sync_idx + free x^free_idx (foregrounds.py:677-681)."""
        x = jnp.asarray(freqs) / ref_freq
        return (
            sync_amp[:, :, None] * x[None, None, :] ** sync_idx[:, :, None]
            + free_amp[:, :, None] * x[None, None, :] ** free_idx
        )

    def read_planck_sim_maps(self):
        """Read the Planck FFP10 simulation maps, converting T_CMB -> T_RJ
        (foregrounds.py:500-520).  Requires healpy + the .fits files."""
        import healpy as hp

        out = []
        for key, ghz in (("ff217", 217.0), ("sync217", 217.0),
                         ("sync353", 353.0)):
            path = self.planck_sim_paths[key]
            out.append(hp.fitsfunc.read_map(path, field=0, nest=False)
                       / self.planck_corr(ghz))
        return tuple(out)

    def synch_freefree_maps(self, redshift=None, rotation=(0.0, -62.0, 0.0),
                            ref_freq=1000.0, free_idx=None, seed_syncidx=None):
        """Synchrotron/free-free amplitude + spectral-index maps on the box
        patch (foregrounds.py:523-635).

        Spherical-harmonic synthesis and gnomonic projection are healpy
        operations (host-side ingest, as in the reference); the resulting
        flat maps are resampled onto the box pixel grid.
        """
        import healpy as hp
        import numpy as _np
        import scipy.ndimage

        box = self.box
        cosmology = box.cosmology_at(redshift)
        ang_x, ang_y = box.grid.pixel_array(cosmology)
        xside, yside = len(ang_x), len(ang_y)

        free217, sync217, sync353 = self.read_planck_sim_maps()
        free217 = free217.copy()
        free217[free217 < 0.0] = _np.percentile(free217, 3)

        if free_idx is None:
            free_idx = self.free_idx

        sync_idx = _np.log(sync353 / sync217) / _np.log(353.0 / 217.0)
        sync_amp = sync217 * ((ref_freq / 1000.0) / 217.0) ** sync_idx
        free_amp = free217 * ((ref_freq / 1000.0) / 217.0) ** free_idx

        # Small-scale synch-index fluctuations with C_l ~ l^-2.4
        # (foregrounds.py:587-596)
        ells = _np.arange(1.0, 4001.0)
        rng = _np.random.default_rng(seed_syncidx)
        cl0 = _np.var(sync_idx) / 4000.0
        cls = cl0 * (1000.0 / ells) ** 2.4
        nside = hp.get_nside(sync_idx)
        sync_idx = sync_idx + hp.sphtfunc.synfast(cls, nside)

        reso_arcmin = hp.nside2resol(nside, arcmin=True)
        npix_proj = int(_np.ceil(54.1 * 60.0 / reso_arcmin))

        def project(m):
            proj = hp.visufunc.gnomview(m, coord="G", rot=rotation,
                                        xsize=npix_proj, ysize=npix_proj,
                                        reso=reso_arcmin, flip="astro",
                                        return_projected_map=True, no_plot=True)
            m2 = _np.asarray(proj)[::-1]
            zoom = _np.array([xside, yside]) / _np.array(m2.shape)
            return scipy.ndimage.zoom(m2, zoom, order=3)

        return (project(sync_amp) * 1e3, project(free_amp) * 1e3,
                project(sync_idx))

    def construct_cube(self, redshift=None, rotation=(0.0, -62.0, 0.0),
                       ref_freq=1000.0, seed_syncidx=None):
        """Planck Sky Model datacube in mK (foregrounds.py:638-681)."""
        box = self.box
        cosmology = box.cosmology_at(redshift)
        freqs = box.grid.freq_array(cosmology)
        sync_amp, free_amp, sync_idx = self.synch_freefree_maps(
            redshift=redshift, rotation=rotation, ref_freq=ref_freq,
            seed_syncidx=seed_syncidx)
        return self.assemble_cube(jnp.asarray(sync_amp), jnp.asarray(free_amp),
                                  jnp.asarray(sync_idx), freqs, ref_freq,
                                  self.free_idx)
