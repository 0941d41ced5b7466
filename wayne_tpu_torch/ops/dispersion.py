"""Grism dispersion geometry: trace, wavelength solution, x-deposit, flat
(port of the JAX package's ``ops/dispersion``).

aXe field-dependent trace formalism: for a direct-image position the +1st
order follows a straight trace with field-dependent slope and intercept,
and wavelength maps linearly to path length along it. Pixel index p covers
[p - 0.5, p + 0.5]; x_ref / y_ref are subarray coordinates, shifted to the
full frame (where the aXe polynomials live) internally.

Trace parameters may be batched: leaves of shape (B,) give per-exposure
results with a leading batch dimension.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wayne_tpu_torch.calibration import Tables, eval_field_poly
from wayne_tpu_torch.ops.psf import pixel_fractions_moving


@dataclass
class TraceParams:
    """Per-exposure scalar trace solution (leaves () or (B,))."""

    x_ref: torch.Tensor     # subarray coords
    y_ref: torch.Tensor
    dy0: torch.Tensor       # trace intercept offset at x = x_ref
    slope: torch.Tensor     # dy/dx along the trace
    wl0: torch.Tensor       # wavelength at zero path length (micron)
    dwl: torch.Tensor       # dispersion (micron per px of path length)
    inv_cos: torch.Tensor   # sqrt(1 + slope^2): path length per unit dx


def trace_params(tables: Tables, x_ref: torch.Tensor,
                 y_ref: torch.Tensor) -> TraceParams:
    """Evaluate the field-dependent trace at a (subarray) reference position."""
    xf = x_ref + tables.subarray_corner[0]
    yf = y_ref + tables.subarray_corner[1]
    slope = eval_field_poly(tables.dydx1, xf, yf)
    return TraceParams(
        x_ref=x_ref, y_ref=y_ref, dy0=eval_field_poly(tables.dydx0, xf, yf),
        slope=slope, wl0=eval_field_poly(tables.dldp0, xf, yf),
        dwl=eval_field_poly(tables.dldp1, xf, yf),
        inv_cos=torch.sqrt(1.0 + slope * slope))


def _b(x: torch.Tensor) -> torch.Tensor:
    """A trace leaf (B...) as a column against a per-exposure axis."""
    return x[..., None]


def wl_to_x(wl: torch.Tensor, tp: TraceParams) -> torch.Tensor:
    """Wavelength (..., N) -> x (subarray px): invert the linear solution."""
    path = (wl - _b(tp.wl0)) / _b(tp.dwl)
    return _b(tp.x_ref) + path / _b(tp.inv_cos)


def x_to_wl(x: torch.Tensor, tp: TraceParams) -> torch.Tensor:
    """x (subarray px) -> wavelength (micron)."""
    path = (x - _b(tp.x_ref)) * _b(tp.inv_cos)
    return _b(tp.wl0) + path * _b(tp.dwl)


def trace_y(x: torch.Tensor, tp: TraceParams) -> torch.Tensor:
    """Trace centre row at column x."""
    return _b(tp.y_ref) + _b(tp.dy0) + _b(tp.slope) * (x - _b(tp.x_ref))


def x_deposit_matrix(x_edges: torch.Tensor, n_pix: int) -> torch.Tensor:
    """Box-overlap deposit of each wavelength bin onto detector columns.

    ``x_edges`` (..., NL+1) x positions of the bin edges (either order).
    Returns (..., NL, S): X[l, p] = fraction of bin l landing in column p.
    Degenerate bins (edges within float32 rounding of each other, as in
    the undispersed imaging tables) deposit as point sources into the
    containing pixel instead of silently dropping their flux.
    """
    lo = torch.minimum(x_edges[..., :-1], x_edges[..., 1:])[..., None]
    hi = torch.maximum(x_edges[..., :-1], x_edges[..., 1:])[..., None]
    raw_w = hi - lo
    width = torch.clamp_min(raw_w, 1e-9)
    grid = torch.arange(n_pix, dtype=x_edges.dtype, device=x_edges.device)
    overlap = torch.clamp_min(torch.minimum(hi, grid + 0.5)
                              - torch.maximum(lo, grid - 0.5), 0.0)
    centre = 0.5 * (lo + hi)
    point = (torch.round(centre) == grid).to(x_edges.dtype)
    eps = 1e-5 * torch.clamp_min(torch.abs(centre), 1.0)
    return torch.where(raw_w <= eps, point, overlap / width)


def x_deposit_matrix_gaussian(x_edges: torch.Tensor, n_pix: int,
                              sigma_x: torch.Tensor) -> torch.Tensor:
    """Gaussian-blurred bin -> column deposit: each bin spread uniformly
    over [x_lo, x_hi] and convolved with the PSF of width sigma_x(lambda)
    along the dispersion — the path average of the pixel-integrated
    Gaussian as its centre sweeps lo -> hi."""
    lo = torch.minimum(x_edges[..., :-1], x_edges[..., 1:])
    hi = torch.maximum(x_edges[..., :-1], x_edges[..., 1:])
    pix_edges = (torch.arange(n_pix + 1, dtype=x_edges.dtype,
                              device=x_edges.device) - 0.5)
    return pixel_fractions_moving(pix_edges, lo, hi, sigma_x)


def flat_plane(tables: Tables, tp: TraceParams) -> torch.Tensor:
    """Wavelength-dependent flat at each column's wavelength:
    flat(x, y) = sum_j c_j(x, y) l(x)^j, l the normalised wavelength of
    column x under the current trace. Returns (..., S, S)."""
    S = tables.flat_coeffs.shape[-1]
    cols = torch.arange(S, dtype=tables.wl_edges.dtype,
                        device=tables.wl_edges.device)
    wl = x_to_wl(cols, tp)
    wl_min, wl_max = tables.wl_edges[0], tables.wl_edges[-1]
    l = torch.clamp((wl - wl_min) / (wl_max - wl_min), 0.0, 1.0)[..., None, :]
    c = tables.flat_coeffs
    return c[0] + l * (c[1] + l * (c[2] + l * c[3]))
