"""Stellar spectrum handling (reference: stellar loading/rescaling in
wayne/tools.py + wayne/observation.py setup).

Provides a blackbody fallback and a two-column file loader, with J-band
magnitude rescaling against the 2MASS-style zero point, binned
flux-conservingly onto the grism wavelength grid.
"""

from __future__ import annotations

import numpy as np

from wayne_tpu_torch.calibration import J_ZERO_POINT_FLAM_UM
from wayne_tpu_torch.config import StarConfig
from wayne_tpu_torch.utils.spectra import blackbody_flam_um, rebin_spectrum

_J_BAND_UM = 1.25


class Star:
    """Host-side star: produces F_lambda on the instrument grid."""

    def __init__(self, cfg: StarConfig):
        self.cfg = cfg
        if cfg.spectrum_file:
            data = np.loadtxt(cfg.spectrum_file)
            wl, flux = data[:, 0], data[:, 1]
            if wl.max() > 100.0:          # Angstrom input
                wl = wl * 1e-4
                flux = flux * 1e4          # per A -> per um
            # sort ascending: frequency-tabulated files come descending,
            # and interp/rebin silently break on non-monotonic input
            order = np.argsort(wl)
            self._wl, self._flux = wl[order], flux[order]
        else:
            self._wl = np.linspace(0.3, 3.0, 4096)
            self._flux = blackbody_flam_um(self._wl, cfg.temperature_k)
        self._apply_scale()

    def _apply_scale(self) -> None:
        if self.cfg.flux_scale is not None:
            self._flux = self._flux * self.cfg.flux_scale
            return
        # Rescale so F_lambda(1.25um) matches the J-band zero point at m_J.
        f_at_j = np.interp(_J_BAND_UM, self._wl, self._flux)
        target = J_ZERO_POINT_FLAM_UM * 10.0 ** (-0.4 * self.cfg.magnitude_j)
        if f_at_j <= 0:
            raise ValueError("stellar spectrum is non-positive at 1.25 um; "
                             "cannot rescale to J magnitude")
        self._flux = self._flux * (target / f_at_j)

    def flux_on_grid(self, wl_edges: np.ndarray) -> np.ndarray:
        """Mean F_lambda (erg/s/cm^2/um) in each instrument bin."""
        return rebin_spectrum(self._wl, self._flux, np.asarray(wl_edges))
