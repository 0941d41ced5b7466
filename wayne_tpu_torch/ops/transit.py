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

from wayne_tpu_torch.ops.kepler import (
    OrbitParams, orbital_phase_angle, projected_separation,
)

_N_RP_CTRL = 16
_RP_SPAN_MIN = 2e-3   # the control grid's least span in Rp/Rs


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


@lru_cache(maxsize=16)
def _gl_nodes_on(n: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_gl_nodes` as tensors on ``device``, copied there once: a
    copy per call would make the host wait for the device each time."""
    s, w = _gl_nodes(n)
    return torch.as_tensor(s, device=device), torch.as_tensor(w, device=device)


def _occulted_flux(z: torch.Tensor, p: torch.Tensor, ld: torch.Tensor,
                   n_quad: int) -> torch.Tensor:
    """Flux blocked by the planet. ``z``, ``p``: (...); ``ld``: (..., 4)
    broadcastable against them."""
    s, w = _gl_nodes_on(n_quad, z.device)

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


def uniform_disk_hidden_frac(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Fraction of a uniform disk of radius ``p`` hidden behind the unit
    (stellar) disk at projected separation ``z``: the closed-form lens
    area / (pi p^2); 0 for z >= 1 + p, 1 for z <= 1 - p."""
    z = torch.clamp_min(z.float(), 1e-7)
    p = p.float()
    c1 = torch.clamp((z * z + p * p - 1.0) / (2.0 * z * p), -1.0, 1.0)
    c2 = torch.clamp((z * z + 1.0 - p * p) / (2.0 * z), -1.0, 1.0)
    s = torch.clamp_min((1.0 + p - z) * (z + p - 1.0) * (z - p + 1.0)
                        * (z + p + 1.0), 0.0)
    lens = p * p * torch.arccos(c1) + torch.arccos(c2) - 0.5 * torch.sqrt(s)
    frac = lens / (math.pi * torch.clamp_min(p * p, 1e-12))
    frac = torch.where(z >= 1.0 + p, torch.zeros_like(frac), frac)
    frac = torch.where(z <= 1.0 - p, torch.ones_like(frac), frac)
    return torch.clamp(frac, 0.0, 1.0)


def eclipse_visibility(z: torch.Tensor, in_front: torch.Tensor,
                       rp_over_rs: torch.Tensor) -> torch.Tensor:
    """Visible fraction of the planet's disk: 1 except behind the star
    (secondary eclipse)."""
    return 1.0 - uniform_disk_hidden_frac(z, rp_over_rs) * (1.0 - in_front)


def transit_light_curve(times: torch.Tensor, orbit: OrbitParams,
                        rp_over_rs: torch.Tensor, ld: torch.Tensor,
                        n_quad: int = 64, interp_channels: bool = True,
                        fp_over_fs: torch.Tensor | None = None,
                        phase_amp: torch.Tensor | float = 0.0,
                        phase_offset_rad: torch.Tensor | float = 0.0
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
      fp_over_fs: optional (..., NL) planet dayside contrast Fp/Fs; when
        given the flux includes the planet's light, 1 + fp out of eclipse,
        hidden behind the star at secondary eclipse (uniform disk).
      phase_amp, phase_offset_rad: thermal phase curve, scalars or (...):
        the contrast is fp * [1 - A (1 - cos(phi + phi0)) / 2], phi = 0 at
        mid-secondary-eclipse.

    Returns:
      (..., NT, NL) relative flux.
    """
    z, in_front = projected_separation(times, orbit)
    nl = rp_over_rs.shape[-1]
    per_channel_ld = ld.dim() == rp_over_rs.dim() + 1
    if per_channel_ld:
        flux = transit_depth_curve(z[..., :, None], rp_over_rs[..., None, :],
                                   ld[..., None, :, :], n_quad)
    elif interp_channels and nl > _N_RP_CTRL:
        # The control grid spans rp's own range; its bounds carry no
        # derivative, so a fitted channel at rp's minimum keeps its own
        # column (the JAX package differentiates min/max and the clip
        # there, and its per-channel columns come out identical). It spans
        # at least _RP_SPAN_MIN: a depth column is a float32 flux difference
        # across one grid step, which the JAX package's 1e-4 (a 6.7e-6
        # step) leaves 1% off central finite differences at a flat spectrum
        # (tests/test_torch_retrieval.py); interpolating across the wider
        # steps moves a flux by under 5e-9.
        rp_d = rp_over_rs.detach()
        rp_lo = torch.amin(rp_d, dim=-1, keepdim=True)             # (..., 1)
        rp_hi = torch.maximum(torch.amax(rp_d, dim=-1, keepdim=True),
                              rp_lo + _RP_SPAN_MIN)
        # jnp.linspace's float32 recipe: start*(1-t) + stop*t, exact stop
        div = _N_RP_CTRL - 1
        t = (torch.arange(div, dtype=torch.float32, device=times.device)
             / float(div))
        ctrl = torch.cat([rp_lo * (1 - t) + rp_hi * t, rp_hi], dim=-1)
        f_ctrl = transit_depth_curve(z[..., :, None], ctrl[..., None, :],
                                     ld[..., None, None, :], n_quad)   # (..., NT, C)
        step = (rp_hi - rp_lo) / (_N_RP_CTRL - 1)
        # hat weights; rp lies within [rp_lo, rp_hi], so the JAX package's
        # clip of rp to them is the identity
        w = torch.clamp_min(
            1.0 - torch.abs(rp_d[..., :, None] - ctrl[..., None, :])
            / step[..., None], 0.0)
        w = w / torch.sum(w, dim=-1, keepdim=True)               # (..., NL, C)
        # Their derivative is the slope of the grid segment [j, j + 1]
        # holding rp (j its first node of non-zero weight; the last segment
        # at the top node), carried by a term that is exactly zero in value:
        # no tie subgradient of the clip, abs or clamp takes its place.
        node = torch.arange(_N_RP_CTRL, device=w.device)
        j = torch.clamp_max(torch.argmax((w > 0.0).to(torch.int32), dim=-1,
                                         keepdim=True), _N_RP_CTRL - 2)
        seg = ((node == j + 1).to(w.dtype) - (node == j).to(w.dtype)
               ) / step[..., None]
        lin = rp_over_rs[..., :, None] * seg
        w = w + (lin - lin.detach())
        flux = torch.matmul(f_ctrl, w.transpose(-1, -2))         # (..., NT, NL)
    else:
        flux = transit_depth_curve(z[..., :, None], rp_over_rs[..., None, :],
                                   ld[..., None, None, :], n_quad)
    flux = 1.0 - (1.0 - flux) * in_front[..., :, None]
    if fp_over_fs is not None:
        vis = eclipse_visibility(z[..., :, None], in_front[..., :, None],
                                 rp_over_rs[..., None, :])
        phi = orbital_phase_angle(times, orbit)                   # (..., NT)
        amp = torch.as_tensor(phase_amp, dtype=torch.float32,
                              device=times.device)
        off = torch.as_tensor(phase_offset_rad, dtype=torch.float32,
                              device=times.device)
        amp = amp.reshape(amp.shape + (1,) * (phi.dim() - amp.dim()))
        off = off.reshape(off.shape + (1,) * (phi.dim() - off.dim()))
        mod = 1.0 - amp * 0.5 * (1.0 - torch.cos(phi + off))
        flux = flux + fp_over_fs[..., None, :] * mod[..., :, None] * vis
    return flux
