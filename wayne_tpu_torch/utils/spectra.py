"""Spectral utilities: flux-conserving rebinning, cropping, blackbody.

Host-side NumPy (these run once per visit at setup time); the reference
keeps the same functionality in wayne/tools.py (crop_spectrum, rebinning
helpers, stellar-spectrum loading/rescaling).
"""

from __future__ import annotations

import numpy as np

# Planck constants in cgs
_H = 6.62607015e-27   # erg s
_C = 2.99792458e10    # cm / s
_KB = 1.380649e-16    # erg / K


def crop_spectrum(wl: np.ndarray, flux: np.ndarray,
                  wl_min: float, wl_max: float) -> tuple[np.ndarray, np.ndarray]:
    """Restrict a spectrum to [wl_min, wl_max] (reference: tools.crop_spectrum)."""
    m = (wl >= wl_min) & (wl <= wl_max)
    return wl[m], flux[m]


def rebin_spectrum(wl_in: np.ndarray, flux_in: np.ndarray,
                   edges_out: np.ndarray) -> np.ndarray:
    """Flux-density-conserving rebin onto new bin edges.

    Treats the input as piecewise-constant flux density on bins centred on
    ``wl_in``; the output is the mean flux density over each output bin, so
    integral(F dlambda) is conserved where grids overlap (reference:
    wayne/tools.py flux-conserving rebin).
    """
    wl_in = np.asarray(wl_in, np.float64)
    flux_in = np.asarray(flux_in, np.float64)
    if wl_in.ndim != 1 or wl_in.size < 2:
        raise ValueError("need at least two input samples")
    # input bin edges: midpoints, clamped ends
    mid = 0.5 * (wl_in[1:] + wl_in[:-1])
    edges_in = np.concatenate([[wl_in[0] - (mid[0] - wl_in[0])], mid,
                               [wl_in[-1] + (wl_in[-1] - mid[-1])]])
    widths = np.diff(edges_in)
    # cumulative integral of F dlambda at input edges
    cum = np.concatenate([[0.0], np.cumsum(flux_in * widths)])
    cum_at = np.interp(edges_out, edges_in, cum,
                       left=0.0, right=cum[-1])
    out = np.diff(cum_at) / np.diff(edges_out)
    return out


def interp_to_grid(wl_in: np.ndarray, values: np.ndarray,
                   wl_out: np.ndarray, fill: float | None = None) -> np.ndarray:
    """Linear interpolation for non-density quantities (Rp/Rs, LD coeffs)."""
    left = right = fill
    if fill is None:
        left, right = values[0], values[-1]
    return np.interp(wl_out, wl_in, values, left=left, right=right)


def blackbody_flam_um(wl_um: np.ndarray, t_eff: float) -> np.ndarray:
    """Planck F_lambda in erg/s/cm^2/um (per unit emitting area, unnormalised).

    Only the spectral *shape* matters downstream — absolute scale comes from
    magnitude rescaling (see models/stellar.py).
    """
    lam_cm = np.asarray(wl_um, np.float64) * 1e-4
    b = (2.0 * _H * _C**2 / lam_cm**5
         / np.expm1(_H * _C / (lam_cm * _KB * t_eff)))
    return b * 1e-4 * np.pi  # per cm -> per um; pi for flux from intensity
