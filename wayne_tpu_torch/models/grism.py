"""Grism models: G102 / G141 (port of the JAX package's ``models/grism``):
the host handle that builds a grism's calibration Tables on a device,
optionally from real STScI products, and offers the reference-style query
API (trace, wavelength solution, sensitivity, PSF width) for tests and
tooling."""

from __future__ import annotations

import numpy as np
import torch

from wayne_tpu_torch import calibration as cal
from wayne_tpu_torch.ops import dispersion as disp


class Grism:
    """Host handle for one WFC3 IR grism."""

    name: str = "G141"

    def __init__(self, subarray: int = 512, n_lambda: int = 512,
                 samp_seq: str = "SPARS10", nsamp: int = 15,
                 conf_file: str | None = None, sens_file: str | None = None,
                 device: torch.device | str = "cpu", **detector_kwargs):
        self.subarray = subarray
        self.n_lambda = n_lambda
        self.samp_seq = samp_seq
        self.nsamp = nsamp
        self.tables = cal.synthetic_tables(
            self.name, subarray=subarray, n_lambda=n_lambda,
            samp_seq=samp_seq, nsamp=nsamp, device=device, **detector_kwargs)
        if conf_file or sens_file:
            self.tables = cal.with_loaded_grism(self.tables, conf_file,
                                                sens_file)
        defaults = cal._GRISM_DEFAULTS[self.name]
        self.wl_min = defaults["wl_min"]
        self.wl_max = defaults["wl_max"]

    # -- reference-style query API (host, for tests and diagnostics) -----

    def get_trace(self, x_ref: float, y_ref: float) -> disp.TraceParams:
        """Trace solution at a reference position (reference:
        Grism.get_trace)."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=self.tables.device)
        return disp.trace_params(self.tables, f32(x_ref), f32(y_ref))

    def _solve(self, fn, v, x_ref: float, y_ref: float) -> np.ndarray:
        v = np.array(v, np.float32)
        t = torch.as_tensor(v.reshape(-1), device=self.tables.device)
        out = fn(t, self.get_trace(x_ref, y_ref))
        return out.cpu().numpy().reshape(v.shape)

    def wl_to_x(self, wl, x_ref: float, y_ref: float) -> np.ndarray:
        return self._solve(disp.wl_to_x, wl, x_ref, y_ref)

    def x_to_wl(self, x, x_ref: float, y_ref: float) -> np.ndarray:
        return self._solve(disp.x_to_wl, x, x_ref, y_ref)

    def _interp(self, wl, leaf: torch.Tensor) -> np.ndarray:
        return np.interp(np.asarray(wl),
                         self.tables.wl_centers.cpu().numpy(),
                         leaf.cpu().numpy())

    def get_sensitivity(self, wl) -> np.ndarray:
        """Sensitivity interpolated at wl (reference:
        Grism.get_sensitivity)."""
        return self._interp(wl, self.tables.sensitivity)

    def psf_sigma(self, wl) -> np.ndarray:
        """Cross-dispersion Gaussian sigma (reference: Grism.flux_to_psf
        width)."""
        return self._interp(wl, self.tables.psf_sigma)


class G141(Grism):
    name = "G141"


class G102(Grism):
    name = "G102"


def make_grism(name: str, **kwargs) -> Grism:
    try:
        return {"G141": G141, "G102": G102}[name.upper()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown grism {name!r}") from None


def make_calibrated_grism(cfg, device: torch.device | str = "cpu") -> Grism:
    """The visit's grism handle with any real STScI calibration products
    from the YAML ``calibration:`` block applied (the loader seams of
    :mod:`wayne_tpu_torch.calibration`). A ``sequence_file`` is not loaded
    here: the caller wraps every timing-dependent derivation in
    :func:`~wayne_tpu_torch.calibration.sequence_tables_scope`."""
    calib = cfg.calibration
    grism = make_grism(cfg.grism, subarray=cfg.subarray,
                       n_lambda=cfg.n_lambda, samp_seq=cfg.samp_seq,
                       nsamp=cfg.nsamp, device=device,
                       dead_frac=cfg.dead_pixel_frac, n_blobs=cfg.n_blobs,
                       blob_atten=cfg.blob_attenuation,
                       rts_frac=cfg.unstable_pixel_frac,
                       rts_amplitude=cfg.rts_amplitude)
    if calib.any_set():
        tables = cal.with_loaded_grism(
            grism.tables,
            conf_path=calib.axe_conf or None,
            sens_path=calib.sensitivity_file or None,
            flat_path=calib.flat_file or None,
            sky_path=calib.sky_file or None,
            sky_he_path=calib.sky_he_file or None)
        if calib.nonlin_file:
            tables = cal.with_loaded_nonlin(tables, calib.nonlin_file)
        if calib.qe_file:
            tables = cal.with_loaded_qe(tables, calib.qe_file)
        grism.tables = tables
    return grism
