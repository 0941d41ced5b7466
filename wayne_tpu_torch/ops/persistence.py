"""Image persistence: the afterglow of earlier exposures (port of the JAX
package's ``ops/persistence``).

  rate_i(pixel) = A * sum_{j<i} W[i, j] * sigmoid((F_j - x0) / dx)

F_j is exposure j's noise-free end-of-exposure fluence map and W[i, j] the
exact mean of the (t / 1000 s)^(-gamma) decay over exposure i's
open-shutter window, measured from stimulus j's shutter close. The whole
visit's maps are one fp32 matmul, ``A * W @ sigmoid_stack`` (TF32 off),
and ride the Scene as ``persist_rate``: the released charge joins the
background rate and is Poisson-sampled by the readout.
"""

from __future__ import annotations

import torch

from wayne_tpu_torch.calibration import Tables
from wayne_tpu_torch.config import ExposureStatic, PersistenceConfig
from wayne_tpu_torch.scene import Scene


def decay_weights(exp_start_s: torch.Tensor, exptime_s: float,
                  gamma: float = 1.0, t_min_s: float = 1.0,
                  stim_end_s: torch.Tensor | None = None) -> torch.Tensor:
    """Mean (t/1000)^(-gamma) decay over each later exposure: (N, M).

    W[i, j] = (1/texp) * integral_{T_i - E_j}^{T_i + texp - E_j}
              (t / 1000)^(-gamma) dt for stimulus j before target i, else
    0; only the lower bound is clamped to ``t_min_s``. ``stim_end_s`` (M,)
    gives the stimuli's shutter-close times; by default the stimuli are the
    visit's own exposures, E_j = T_j + texp (a strictly causal lower
    triangle).
    """
    t = torch.as_tensor(exp_start_s, dtype=torch.float32)
    ends = (t + exptime_s if stim_end_s is None
            else torch.as_tensor(stim_end_s, dtype=torch.float32,
                                 device=t.device))
    a_raw = t[:, None] - ends[None, :]        # elapsed since stimulus end
    causal = a_raw >= -1e-3
    a = torch.clamp_min(a_raw, t_min_s)
    b = torch.maximum(a_raw + exptime_s, a + 1e-6)
    if abs(gamma - 1.0) < 1e-6:
        integral = 1000.0 * (torch.log(b) - torch.log(a))
    else:
        g1 = 1.0 - gamma
        integral = (1000.0 ** gamma) * (b ** g1 - a ** g1) / g1
    return integral / exptime_s * causal.to(torch.float32)


def stimulus_sigmoid(fluence_e: torch.Tensor, x0_e: float,
                     dx_e: float) -> torch.Tensor:
    """Trap-filling factor in [0, 1] as a function of stimulus fluence."""
    return torch.sigmoid((fluence_e - x0_e) / dx_e)


def persistence_rates(fluence_stack: torch.Tensor, exp_start_s: torch.Tensor,
                      exptime_s: float, amplitude_e_s: float, x0_e: float,
                      dx_e: float, gamma: float = 1.0, t_min_s: float = 1.0,
                      stim_end_s: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Per-exposure persistence rate maps (N, S, S), e-/s, from an
    (M, S, S) stimulus stack (with ``stim_end_s`` (M,) when the stimuli are
    not the N target exposures themselves)."""
    sig = stimulus_sigmoid(fluence_stack, x0_e, dx_e)
    w = decay_weights(exp_start_s, exptime_s, gamma, t_min_s, stim_end_s)
    return amplitude_e_s * torch.tensordot(w, sig, dims=1)


def visit_persistence_rates(scenes: Scene, tables: Tables,
                            cfg: ExposureStatic, pcfg: PersistenceConfig,
                            chunk: int = 8,
                            extra_fluence: torch.Tensor | None = None,
                            extra_end_s=None,
                            fluence_stack: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The whole visit's persistence maps (N, S, S) from its noise-free
    fluence stack (N, S, S): ``fluence_stack`` when given (Observation
    shares one with the RECTE model), else one noise-free pass of the
    visit here (:func:`ops.visit.visit_fluence_stack`, ``chunk`` exposures
    a launch). ``extra_fluence`` with ``extra_end_s`` prepends stimuli that
    are not the visit's exposures: one (S, S) map with a scalar end time,
    or an (M, S, S) stack with (M,) end times (the direct image, the prior
    observation's fluence).
    """
    if fluence_stack is None:
        from wayne_tpu_torch.ops.visit import visit_fluence_stack

        fluence_stack = visit_fluence_stack(scenes, tables, cfg, chunk)
    dev = fluence_stack.device
    exptime = float(tables.read_times[-1])
    fluence = fluence_stack
    stim_end = None
    if extra_fluence is not None:
        ef = torch.as_tensor(extra_fluence, dtype=torch.float32, device=dev)
        if ef.dim() == 2:
            ef = ef[None]
        ee = torch.as_tensor(extra_end_s, dtype=torch.float32,
                             device=dev).reshape(-1)
        if ef.shape[0] != ee.shape[0]:
            raise ValueError(
                f"{ef.shape[0]} extra stimuli but {ee.shape[0]} end times")
        fluence = torch.cat([ef, fluence])
        stim_end = torch.cat([ee, scenes.exp_start_s.float() + exptime])
    x0 = pcfg.x0_e if pcfg.x0_e > 0 else 0.95 * float(tables.full_well_e)
    return persistence_rates(
        fluence, scenes.exp_start_s, exptime,
        amplitude_e_s=pcfg.amplitude_e_s, x0_e=float(x0), dx_e=pcfg.dx_e,
        gamma=pcfg.gamma, t_min_s=pcfg.t_min_s, stim_end_s=stim_end)
