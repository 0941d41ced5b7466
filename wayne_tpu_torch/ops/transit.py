"""Limb-darkened transit light curve in PyTorch (port of the JAX package's
``ops/transit``).

Claret 4-parameter law; the occulted flux splits into a fully covered
inner disk (closed form) and a partially covered annulus integrated with
Gauss-Legendre nodes under r = r_lo + (r_hi - r_lo) sin^2(pi s / 2), which
absorbs the square-root behaviour at both contact points. The math and its
float32 evaluation order follow the JAX package line for line.

Every function broadcasts over leading batch dimensions (one per exposure).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from wayne_tpu_torch.ops.kepler import OrbitParams, projected_separation

_N_RP_CTRL = 16


def _n(like: torch.Tensor) -> torch.Tensor:
    """Claret exponents n = 1..4."""
    return torch.arange(1, 5, dtype=torch.float32, device=like.device)


def claret_intensity(mu: torch.Tensor, ld: torch.Tensor) -> torch.Tensor:
    """I(mu)/I(1); ``ld`` (..., 4) broadcasts against ``mu`` (...)."""
    n = _n(mu)
    mu = torch.clamp(mu, 0.0, 1.0)
    powers = mu[..., None] ** (n / 2.0)
    return 1.0 - torch.sum(ld * (1.0 - powers), dim=-1)


def claret_total_flux(ld: torch.Tensor) -> torch.Tensor:
    """integral_0^1 I(r) 2 r dr (disk-integrated flux, normalised units)."""
    n = _n(ld)
    return 1.0 - torch.sum(ld * n / (n + 4.0), dim=-1)


def _covered_core_flux(r_in: torch.Tensor, ld: torch.Tensor) -> torch.Tensor:
    """integral_0^{r_in} I(r) 2 r dr, closed form via mu-substitution."""
    n = _n(r_in)
    mu_in = torch.sqrt(torch.clamp(1.0 - r_in * r_in, 0.0, 1.0))
    base = (1.0 - torch.sum(ld, dim=-1)) * (1.0 - mu_in * mu_in)
    terms = torch.sum(ld * 4.0 / (n + 4.0)
                      * (1.0 - mu_in[..., None] ** ((n + 4.0) / 2.0)), dim=-1)
    return base + terms


@lru_cache(maxsize=8)
def _gl_nodes(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)      # on [-1, 1]
    return (0.5 * (x + 1.0)).astype(np.float32), (0.5 * w).astype(np.float32)


def _occulted_flux(z: torch.Tensor, p: torch.Tensor, ld: torch.Tensor,
                   n_quad: int) -> torch.Tensor:
    """Flux blocked by the planet. ``z``, ``p``: (...); ``ld``: (..., 4)
    broadcastable against them."""
    s_np, w_np = _gl_nodes(n_quad)
    s = torch.as_tensor(s_np, device=z.device)
    w = torch.as_tensor(w_np, device=z.device)

    z = torch.clamp_min(z, 1e-7)
    r_in = torch.clamp(p - z, 0.0, 1.0)
    core = _covered_core_flux(r_in, ld)

    r_lo = torch.clamp(torch.abs(z - p), 0.0, 1.0)
    r_hi = torch.clamp(z + p, 0.0, 1.0)
    span = torch.clamp_min(r_hi - r_lo, 0.0)

    u = torch.sin(0.5 * math.pi * s) ** 2          # node positions in [0, 1]
    du = 0.5 * math.pi * torch.sin(math.pi * s)    # d(u)/d(s)
    zq, pq = z[..., None], p[..., None]
    r = r_lo[..., None] + span[..., None] * u
    safe_r = torch.clamp_min(r, 1e-7)
    cos_k = (zq * zq + safe_r * safe_r - pq * pq) / (2.0 * zq * safe_r)
    kappa = torch.arccos(torch.clamp(cos_k, -1.0 + 1e-7, 1.0 - 1e-7))
    mu = torch.sqrt(torch.clamp(1.0 - r * r, 1e-12, 1.0))
    integrand = claret_intensity(mu, ld[..., None, :]) * (kappa / math.pi) * 2.0 * r
    annulus = span * torch.sum(w * du * integrand, dim=-1)

    occ = core + annulus
    return torch.where((p <= 0.0) | (z >= 1.0 + p), torch.zeros_like(occ), occ)


def transit_depth_curve(z: torch.Tensor, rp_over_rs: torch.Tensor,
                        ld: torch.Tensor, n_quad: int = 64) -> torch.Tensor:
    """Relative flux F(z, p)/F_star; ``ld`` (..., 4) broadcasts."""
    z, p = torch.broadcast_tensors(z.float(), rp_over_rs.float())
    ld = ld.float()
    occ = _occulted_flux(z, p, ld, n_quad)
    return 1.0 - occ / claret_total_flux(ld)


def transit_light_curve(times: torch.Tensor, orbit: OrbitParams,
                        rp_over_rs: torch.Tensor, ld: torch.Tensor,
                        n_quad: int = 64, interp_channels: bool = True,
                        fp_over_fs: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Light curve on a (time, wavelength) grid.

    Args:
      times: (..., NT) seconds (same clock as ``orbit.t0_s``).
      orbit: leaves of shape (...).
      rp_over_rs: (..., NL) per-channel radius ratio.
      ld: (..., 4) shared Claret coefficients, or (..., NL, 4) per channel.
      interp_channels: with shared LD the flux depends on wavelength only
        through rp, so the occultation integral runs at 16 rp control
        points and is interpolated per channel with hat weights (one fp32
        contraction, TF32 off — see the package docstring).
      fp_over_fs: planet dayside light (eclipse / phase curve) — not
        ported yet; must be None.

    Returns:
      (..., NT, NL) relative flux.
    """
    if fp_over_fs is not None:
        raise NotImplementedError(
            "eclipse / phase-curve light curves are not ported yet "
            "(ROADMAP Queue A7)")
    z, in_front = projected_separation(times, orbit)
    nl = rp_over_rs.shape[-1]
    per_channel_ld = ld.dim() == rp_over_rs.dim() + 1
    if per_channel_ld:
        flux = transit_depth_curve(z[..., :, None], rp_over_rs[..., None, :],
                                   ld[..., None, :, :], n_quad)
    elif interp_channels and nl > _N_RP_CTRL:
        rp_lo = torch.amin(rp_over_rs, dim=-1, keepdim=True)       # (..., 1)
        rp_hi = torch.maximum(torch.amax(rp_over_rs, dim=-1, keepdim=True),
                              rp_lo + 1e-4)
        # jnp.linspace's float32 recipe: start*(1-t) + stop*t, exact stop
        div = _N_RP_CTRL - 1
        t = (torch.arange(div, dtype=torch.float32, device=times.device)
             / float(div))
        ctrl = torch.cat([rp_lo * (1 - t) + rp_hi * t, rp_hi], dim=-1)
        f_ctrl = transit_depth_curve(z[..., :, None], ctrl[..., None, :],
                                     ld[..., None, None, :], n_quad)   # (..., NT, C)
        step = (rp_hi - rp_lo) / (_N_RP_CTRL - 1)
        rp_c = torch.minimum(torch.maximum(rp_over_rs, rp_lo), rp_hi)
        w = torch.clamp_min(
            1.0 - torch.abs(rp_c[..., :, None] - ctrl[..., None, :])
            / step[..., None], 0.0)
        w = w / torch.sum(w, dim=-1, keepdim=True)               # (..., NL, C)
        flux = torch.matmul(f_ctrl, w.transpose(-1, -2))         # (..., NT, NL)
    else:
        flux = transit_depth_curve(z[..., :, None], rp_over_rs[..., None, :],
                                   ld[..., None, None, :], n_quad)
    return 1.0 - (1.0 - flux) * in_front[..., :, None]
