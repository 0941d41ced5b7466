"""Pixel-integrated Gaussian PSF math, static and scan-moving (port of the
JAX package's ``ops/psf``).

The time average of a uniformly moving Gaussian over a linear centre path
c0 -> c1 is closed-form: with u_i = (y - c_i) / (sigma sqrt 2) the path
average of erf is [F(u0) - F(u1)] / (u0 - u1), F(u) = u erf(u) +
exp(-u^2)/sqrt(pi). A constant-rate scan segment needs no subsample loop.
"""

from __future__ import annotations

import torch
from torch.special import erf

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_PI = 0.5641895835477563


def ierf(x: torch.Tensor) -> torch.Tensor:
    """Antiderivative of erf: F(x) = x erf(x) + exp(-x^2)/sqrt(pi)."""
    return x * erf(x) + torch.exp(-x * x) * _INV_SQRT_PI


def pixel_fractions_static(y_edges: torch.Tensor, center: torch.Tensor,
                           sigma: torch.Tensor) -> torch.Tensor:
    """Fraction of a unit Gaussian in each pixel.

    ``y_edges`` (..., S+1); ``center``, ``sigma`` broadcastable against
    ``y_edges[..., 0]``. Returns (..., S): 0.5 [erf(hi) - erf(lo)].
    """
    u = (y_edges - center[..., None]) * (_INV_SQRT2 / sigma[..., None])
    e = erf(u)
    return 0.5 * (e[..., 1:] - e[..., :-1])


def mean_erf_moving(u0: torch.Tensor, du: torch.Tensor) -> torch.Tensor:
    """Path average of erf(u) as u sweeps linearly from u0 to u0 - du:
    the exact antiderivative difference for |du| >= 0.3, Simpson's rule
    below (immune to cancellation as du -> 0); ~1e-6 absolute in fp32."""
    small = torch.abs(du) < 0.3
    du_safe = torch.where(small, torch.ones_like(du), du)
    u1 = u0 - du
    e0, e1 = erf(u0), erf(u1)
    f0 = u0 * e0 + torch.exp(-u0 * u0) * _INV_SQRT_PI
    f1 = u1 * e1 + torch.exp(-u1 * u1) * _INV_SQRT_PI
    exact = (f0 - f1) / du_safe
    simpson = (e0 + 4.0 * erf(u0 - 0.5 * du) + e1) / 6.0
    return torch.where(small, simpson, exact)


def pixel_fractions_moving(y_edges: torch.Tensor, c0: torch.Tensor,
                           c1: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Time-averaged per-pixel fractions of a Gaussian moving c0 -> c1.
    Shapes as in :func:`pixel_fractions_static`; returns (..., S)."""
    inv = _INV_SQRT2 / sigma[..., None]
    u0 = (y_edges - c0[..., None]) * inv
    du = ((c1 - c0) * (_INV_SQRT2 / sigma))[..., None]
    m = mean_erf_moving(u0, du.expand_as(u0))
    return 0.5 * (m[..., 1:] - m[..., :-1])


def pixel_fractions_moving_path(y_edges: torch.Tensor, centers: torch.Tensor,
                                sigma: torch.Tensor) -> torch.Tensor:
    """Per-segment time-averaged fractions along a piecewise-linear path.

    The K segments share their interior nodes, so erf and exp run once per
    node. ``centers`` (K+1, ...) are the Gaussian centres at the nodes,
    ``y_edges`` (..., S+1), ``sigma`` (...); returns (K, ..., S). Below
    |du| = 0.15 the endpoint-corrected trapezoid (e0 + e1)/2 - du^2/12
    avg(erf''), erf''(u) = -(4/sqrt(pi)) u exp(-u^2), replaces the exact
    antiderivative difference. The exposure simulation uses the
    per-segment :func:`pixel_fractions_moving`.
    """
    inv = _INV_SQRT2 / sigma[..., None]                    # (..., 1)
    u = (y_edges[None] - centers[..., None]) * inv         # (K+1, ..., S+1)
    e = erf(u)
    g = torch.exp(-u * u)
    F = u * e + g * _INV_SQRT_PI
    u0, u1 = u[:-1], u[1:]
    du = u0 - u1                                           # (K, ..., S+1)
    small = torch.abs(du) < 0.15
    du_safe = torch.where(small, torch.ones_like(du), du)
    exact = (F[:-1] - F[1:]) / du_safe
    avg_fpp = (-2.0 * 2.0 * _INV_SQRT_PI) * 0.5 * (u0 * g[:-1] + u1 * g[1:])
    trap = 0.5 * (e[:-1] + e[1:]) - (du * du) * (1.0 / 12.0) * avg_fpp
    m = torch.where(small, trap, exact)
    return 0.5 * (m[..., 1:] - m[..., :-1])
