"""Scene: the per-exposure inputs of the simulation (port of the JAX
package's ``scene``).

A Scene is a dataclass of tensors. Batched over exposures, every leaf
carries a leading exposure dimension (B,): that batch dimension takes the
place of the JAX package's ``vmap``. The JAX ``key`` becomes ``seed``, two
int32 words per exposure that key the port's Philox streams
(:mod:`wayne_tpu_torch.ops.random`).

Not ported yet (ROADMAP): companions, starspots, persistence and RECTE
maps — the JAX Scene's optional leaves for those have no field here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.trends import TrendParams


@dataclass
class Scene:
    """Inputs of one exposure, or of B exposures with a leading batch dim."""

    x_ref: torch.Tensor           # direct-image reference col (subarray px)
    y_ref: torch.Tensor           # reference row at exposure start
    exp_start_s: torch.Tensor     # exposure start on the visit clock (s)
    orbit_start_s: torch.Tensor   # start of the current HST orbit (s)
    is_first_orbit: torch.Tensor  # 1.0 in the first orbit (stronger hook)
    scan_speed: torch.Tensor      # signed scan rate (px/s); 0 for staring
    stellar_flux: torch.Tensor    # (NL,) F_lambda, erg/s/cm^2/um on wl grid
    rp_over_rs: torch.Tensor      # (NL,) transmission spectrum
    fp_over_fs: torch.Tensor      # (NL,) dayside contrast (eclipse; unused
    #                               until the eclipse path is ported)
    phase_amp: torch.Tensor       # thermal phase-curve amplitude
    phase_offset: torch.Tensor    # hot-spot offset (rad)
    ld: torch.Tensor              # (4,) Claret coefficients, or (NL, 4)
    orbit: OrbitParams
    trends: TrendParams
    sky_level: torch.Tensor       # mean sky rate (e-/s/px)
    seed: torch.Tensor            # (2,) int32 Philox key words
    psf_scale: torch.Tensor | None = None     # PSF-width multiplier
    #                               (focus breathing); None = 1 exactly
    sky_he_level: torch.Tensor | None = None  # He 1.083 um airglow level
    #                               scaling Tables.sky_he_frame; None = off

    @property
    def n(self) -> int:
        """Exposures in a batched Scene."""
        return self.x_ref.shape[0]


def example_scene(n_lambda: int, *, seed: int = 0, scan_speed: float = 1.0,
                  device: torch.device | str = "cpu") -> Scene:
    """A synthetic WASP-43b-like scene (one exposure), for tests and
    benchmarks. ``seed`` is used as the first Philox key word."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    wl = torch.linspace(1.075, 1.7, n_lambda, device=device)
    stellar = 3.13e-10 * (wl / 1.25) ** -2
    rp = 0.1595 + 0.002 * torch.sin(8.0 * wl)
    orbit = OrbitParams.create(
        period_s=0.813475 * 86400.0, t0_s=2.0 * 3600.0,
        sma_rs=4.855, inc_rad=math.radians(82.1), device=device)
    return Scene(
        x_ref=f32(180.0), y_ref=f32(120.0), exp_start_s=f32(0.0),
        orbit_start_s=f32(0.0), is_first_orbit=f32(1.0),
        scan_speed=f32(scan_speed),
        stellar_flux=stellar, rp_over_rs=rp,
        fp_over_fs=torch.zeros(n_lambda, device=device),
        phase_amp=f32(0.0), phase_offset=f32(0.0),
        ld=f32([0.65, -0.25, 0.45, -0.2]),
        orbit=orbit, trends=TrendParams.create(device=device),
        sky_level=f32(1.2),
        seed=torch.tensor([seed, 0], dtype=torch.int32, device=device),
    )
