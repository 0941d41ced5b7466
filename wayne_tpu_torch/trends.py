"""Time-domain systematics in PyTorch (port of the JAX package's ``trends``):
scan-speed variations (SSV) and the visit-long hook x slope trend, as
flux multipliers on subsegment times. Pointing drift is drawn host-side in
:mod:`wayne_tpu_torch.observation`.

Leaves of a batched :class:`TrendParams` have shape (B,); time arrays carry
the batch as their leading dimension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class TrendParams:
    """Per-visit systematics parameters (float32 tensors)."""

    ssv_amp: torch.Tensor          # fractional sinusoid amplitude
    ssv_period_s: torch.Tensor
    ssv_phase: torch.Tensor        # radians
    ssv_rw_amp: torch.Tensor       # random-walk SSV amplitude (0 = off)
    visit_slope_per_s: torch.Tensor
    hook_amp: torch.Tensor
    hook_tau_s: torch.Tensor
    hook_orbit1_scale: torch.Tensor

    @classmethod
    def create(cls, ssv_amp=0.015, ssv_period_s=0.7, ssv_phase=0.0,
               ssv_rw_amp=0.0, visit_slope_per_s=0.01 / 86400.0,
               hook_amp=0.003, hook_tau_s=300.0, hook_orbit1_scale=2.0,
               device="cpu"):
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
        return cls(f32(ssv_amp), f32(ssv_period_s), f32(ssv_phase),
                   f32(ssv_rw_amp), f32(visit_slope_per_s), f32(hook_amp),
                   f32(hook_tau_s), f32(hook_orbit1_scale))


def _b(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Parameter leaf (B...) broadcast against a time array (B..., T...)."""
    return x.reshape(x.shape + (1,) * (t.dim() - x.dim()))


def ssv_mean_factor(t_a: torch.Tensor, t_b: torch.Tensor,
                    p: TrendParams) -> torch.Tensor:
    """Exact time-average of the SSV sinusoid over [t_a, t_b]:
    1 + amp [cos(w t_a + phi) - cos(w t_b + phi)] / (w (t_b - t_a))."""
    w = 2.0 * math.pi / _b(p.ssv_period_s, t_a)
    phase = _b(p.ssv_phase, t_a)
    dt = torch.clamp_min(t_b - t_a, 1e-9)
    mean_sin = (torch.cos(w * t_a + phase)
                - torch.cos(w * t_b + phase)) / (w * dt)
    return 1.0 + _b(p.ssv_amp, t_a) * mean_sin


def ssv_random_walk(steps: torch.Tensor, p: TrendParams) -> torch.Tensor:
    """Random-walk SSV factors for whole exposures from standard-normal
    ``steps`` (B, n_seg): 1 + amp * cumsum(steps) / sqrt(n_seg). The walk
    runs once per exposure, continuous across read boundaries."""
    n_seg = steps.shape[-1]
    walk = torch.cumsum(steps, dim=-1) / math.sqrt(float(n_seg))
    return 1.0 + _b(p.ssv_rw_amp, walk) * walk


def visit_trend_factor(t_since_visit: torch.Tensor,
                       t_since_orbit: torch.Tensor,
                       is_first_orbit: torch.Tensor,
                       p: TrendParams) -> torch.Tensor:
    """Hook + visit-long slope multiplier:
    F(t) = (1 - slope t_visit) (1 - A exp(-t_orbit / tau)), with A scaled
    up in the first orbit."""
    t = t_since_orbit
    amp = _b(p.hook_amp, t) * torch.where(_b(is_first_orbit, t) > 0.5,
                                          _b(p.hook_orbit1_scale, t),
                                          torch.ones_like(_b(p.hook_amp, t)))
    hook = 1.0 - amp * torch.exp(-t_since_orbit / _b(p.hook_tau_s, t))
    slope = 1.0 - _b(p.visit_slope_per_s, t) * t_since_visit
    return hook * slope
