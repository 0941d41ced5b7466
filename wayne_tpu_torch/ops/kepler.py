"""Keplerian orbit solution in PyTorch (port of the JAX package's
``ops/kepler``): a fixed-iteration Newton solve of Kepler's equation and
the sky-projected star-planet separation.

Every function broadcasts over leading batch dimensions: the leaves of a
batched :class:`OrbitParams` have shape (B,), times (B, NT).

Conventions: angles in radians, times in seconds, distances in stellar radii.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_NEWTON_ITERS = 12


@dataclass
class OrbitParams:
    """Orbital elements of the transiting planet (tensors, float32)."""

    period_s: torch.Tensor      # orbital period
    t0_s: torch.Tensor          # mid-transit epoch (exposure clock)
    sma_rs: torch.Tensor        # semi-major axis / stellar radius
    inc_rad: torch.Tensor       # orbital inclination
    ecc: torch.Tensor           # eccentricity
    omega_rad: torch.Tensor     # argument of periastron

    @classmethod
    def create(cls, period_s, t0_s, sma_rs, inc_rad, ecc=0.0,
               omega_rad=math.pi / 2, device="cpu"):
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
        return cls(f32(period_s), f32(t0_s), f32(sma_rs), f32(inc_rad),
                   f32(ecc), f32(omega_rad))


def eccentric_anomaly(mean_anomaly: torch.Tensor,
                      ecc: torch.Tensor) -> torch.Tensor:
    """Solve M = E - e sin E by 12 Newton steps from E0 = M + e sin M
    (converges to float32 precision for e < 0.95)."""
    M = mean_anomaly
    E = M + ecc * torch.sin(M)
    for _ in range(_NEWTON_ITERS):
        f = E - ecc * torch.sin(E) - M
        fp = 1.0 - ecc * torch.cos(E)
        E = E - f / fp
    return E


def true_anomaly(mean_anomaly: torch.Tensor, ecc: torch.Tensor) -> torch.Tensor:
    E = eccentric_anomaly(mean_anomaly, ecc)
    beta = torch.sqrt((1.0 + ecc) / (1.0 - ecc))
    return 2.0 * torch.atan(beta * torch.tan(0.5 * E))


def _b(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Orbit leaf (B...) broadcast against a time grid (B..., NT)."""
    return x.reshape(x.shape + (1,) * (t.dim() - x.dim()))


def transit_true_anomaly(t: torch.Tensor, orbit: OrbitParams
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(nu(t), nu_tr): true anomaly over the grid and at mid-transit."""
    e = _b(orbit.ecc, t)
    nu_tr = math.pi / 2.0 - _b(orbit.omega_rad, t)
    E_tr = 2.0 * torch.atan(torch.sqrt((1.0 - e) / (1.0 + e))
                            * torch.tan(0.5 * nu_tr))
    M_tr = E_tr - e * torch.sin(E_tr)
    M = M_tr + 2.0 * math.pi * (t - _b(orbit.t0_s, t)) / _b(orbit.period_s, t)
    return true_anomaly(M, e), nu_tr


def projected_separation(t: torch.Tensor, orbit: OrbitParams
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sky-projected separation z(t) (stellar radii) and ``in_front``
    (1.0 on the transit side of the orbit, 0.0 near secondary eclipse):
    r = a (1-e^2) / (1 + e cos nu), z = r sqrt(1 - sin^2(w+nu) sin^2 i)."""
    e = _b(orbit.ecc, t)
    nu, _ = transit_true_anomaly(t, orbit)
    r = _b(orbit.sma_rs, t) * (1.0 - e * e) / (1.0 + e * torch.cos(nu))
    sin_wnu = torch.sin(_b(orbit.omega_rad, t) + nu)
    z2 = 1.0 - (sin_wnu * torch.sin(_b(orbit.inc_rad, t))) ** 2
    z = r * torch.sqrt(torch.clamp(z2, 0.0, 1.0))
    in_front = (sin_wnu > 0.0).to(z.dtype)
    return z, in_front
