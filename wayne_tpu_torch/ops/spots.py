"""Starspots: unocculted dimming and crossing recovery (port of the JAX
package's ``ops/spots``).

Small-spot model: each spot is a circular patch at stellar latitude and
longitude with a per-wavelength contrast c(lambda); its projected shape is
a disk of radius r sqrt(mu) at sky position (cos(lat) sin(lon), sin(lat)),
the limb-darkened intensity taken at its centre, and rotation advances the
longitudes (lon(t) = lon0 + omega_rot t). The additive flux delta on the
immaculate-star light curve (normalised so the disk flux is
``claret_total_flux(ld)``):

  F = F_transit - sum_s vis_s r_s^2 mu_s I(mu_s) (1 - c_s) / F_tot
                + sum_s in_front vis_s A_lens(d_ps; p, r_s sqrt(mu_s)) / pi
                        * I(mu_s) (1 - c_s) / F_tot

Every function broadcasts over leading batch dimensions (one per exposure).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from wayne_tpu_torch.ops.kepler import OrbitParams, sky_position
from wayne_tpu_torch.ops.transit import claret_intensity, claret_total_flux


@dataclass
class SpotParams:
    """Starspot set of a visit (tensors; batched: a leading (B,) on each).

    The spin axis lies along sky +y (zero projected obliquity); latitudes
    in [-pi/2, pi/2]; longitude 0 faces the observer at t = 0.
    """

    lat_rad: torch.Tensor     # (NS,) spot centre latitude
    lon_rad: torch.Tensor     # (NS,) spot centre longitude at t = 0
    radius: torch.Tensor      # (NS,) angular radius (stellar radii)
    contrast: torch.Tensor    # (NS, NL) spot/photosphere brightness ratio
    rot_omega: torch.Tensor   # () stellar rotation rate (rad/s)

    @classmethod
    def create(cls, lat_rad, lon_rad, radius, contrast, rot_omega=0.0,
               device="cpu"):
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return cls(f32(lat_rad), f32(lon_rad), f32(radius), f32(contrast),
                   f32(rot_omega))


def circle_overlap_area(d: torch.Tensor, r1: torch.Tensor,
                        r2: torch.Tensor) -> torch.Tensor:
    """Area of the intersection of two disks, branch-free: 0 when
    disjoint, the smaller disk's area when contained, else the two
    circular segments."""
    d = torch.clamp_min(d, 1e-7)
    r1 = torch.clamp_min(r1, 1e-7)
    r2 = torch.clamp_min(r2, 1e-7)
    eps = 1e-7
    c1 = torch.clamp((d * d + r1 * r1 - r2 * r2) / (2.0 * d * r1),
                     -1.0 + eps, 1.0 - eps)
    c2 = torch.clamp((d * d + r2 * r2 - r1 * r1) / (2.0 * d * r2),
                     -1.0 + eps, 1.0 - eps)
    s = (r1 + r2 - d) * (d + r1 - r2) * (d - r1 + r2) * (d + r1 + r2)
    root = torch.where(s > 0.0, torch.sqrt(torch.where(s > 0.0, s, 1.0)),
                       torch.zeros_like(s))
    area = r1 * r1 * torch.arccos(c1) + r2 * r2 * torch.arccos(c2) - 0.5 * root
    area = torch.where(d >= r1 + r2, torch.zeros_like(area), area)
    rmin = torch.minimum(r1, r2)
    return torch.where(d <= torch.abs(r1 - r2), math.pi * rmin * rmin, area)


def spot_positions(times: torch.Tensor, spots: SpotParams
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sky positions and foreshortening (x_s, y_s, mu_s), each
    (..., NT, NS), of every spot at ``times`` (..., NT); mu_s <= 0 is the
    far hemisphere."""
    omega = spots.rot_omega.reshape(spots.rot_omega.shape + (1, 1))
    lon = spots.lon_rad[..., None, :] + omega * times[..., :, None]
    cos_lat = torch.cos(spots.lat_rad)[..., None, :]
    x = cos_lat * torch.sin(lon)
    y = torch.sin(spots.lat_rad)[..., None, :].expand_as(x)
    mu = cos_lat * torch.cos(lon)
    return x, y, mu


def spot_delta(times: torch.Tensor, orbit: OrbitParams,
               rp_over_rs: torch.Tensor, ld: torch.Tensor,
               spots: SpotParams) -> torch.Tensor:
    """Additive flux delta of the spot set, (..., NT, NL), to add to
    ``transit_light_curve``'s immaculate-star flux. ``rp_over_rs`` (..., NL);
    ``ld`` (..., 4) shared or (..., NL, 4) per channel."""
    xs, ys, mu = spot_positions(times, spots)          # (..., NT, NS)
    vis_mu = torch.clamp_min(mu, 0.0)
    visible = (mu > 0.0).to(xs.dtype)

    if ld.dim() == rp_over_rs.dim() + 1:               # per-channel LD
        ldc = ld[..., None, None, :, :]                # (..., 1, 1, NL, 4)
        inten = (claret_intensity(vis_mu[..., None], ldc)
                 / claret_total_flux(ldc))             # (..., NT, NS, NL)
    else:
        ldc = ld[..., None, None, :]
        inten = (claret_intensity(vis_mu, ldc)
                 / claret_total_flux(ldc))[..., None]  # (..., NT, NS, 1)

    one_minus_c = (1.0 - spots.contrast)[..., None, :, :]   # (..., 1, NS, NL)
    dim = (spots.radius[..., None, :] ** 2 * vis_mu)[..., None] * inten

    xp, yp, in_front = sky_position(times, orbit)      # (..., NT)
    d = torch.hypot(xp[..., None] - xs, yp[..., None] - ys)   # (..., NT, NS)
    r_spot = spots.radius[..., None, :] * torch.sqrt(vis_mu)
    lens = circle_overlap_area(d[..., None], rp_over_rs[..., None, None, :],
                               r_spot[..., None])      # (..., NT, NS, NL)
    rec = in_front[..., None, None] * lens / math.pi * inten
    return (visible[..., None] * one_minus_c * (rec - dim)).sum(dim=-2)
