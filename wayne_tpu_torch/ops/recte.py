"""RECTE charge trapping (port of the JAX package's ``ops/recte``; Zhou,
Apai, Lew & Schneider 2017, AJ 153, 243).

Each pixel carries a slow and a fast trap population,

    dE_p/dt = eta_p * f * (1 - E_p / n_p) - E_p / tau_p ,   p in {s, f},

driven by the pixel's illumination rate f. Trap state depends only on the
noise-free illumination history, so every exposure's response is computed
once per visit, before the chunked simulation, by a loop over the visit's
exposures (the JAX package's ``lax.scan``), and handed to the readout as
two Scene leaves: the thinning plane ``trap_mult`` = 1 - capture / fluence
on the expected rates, and a release rate that joins ``persist_rate``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from wayne_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class RecteParams:
    """Trap populations. Defaults: Zhou et al. (2017) best-fit values."""

    n_trap_s: float = 1525.38    # slow-trap count per pixel
    eta_s: float = 0.013318     # slow capture efficiency
    tau_s: float = 1.63e4       # slow release timescale (s)
    n_trap_f: float = 162.38     # fast-trap count per pixel
    eta_f: float = 0.008407     # fast capture efficiency
    tau_f: float = 281.463      # fast release timescale (s)


def _evolve_constant_rate(e0: torch.Tensor, f: torch.Tensor, dt: float,
                          n_tot: float, eta: float, tau: float
                          ) -> torch.Tensor:
    """Trap population after ``dt`` s of constant illumination ``f``:
    E(dt) = a/b + (E0 - a/b) exp(-b dt), a = eta f, b = a/n + 1/tau."""
    a = eta * f
    b = a / n_tot + 1.0 / tau
    e_inf = a / b
    return e_inf + (e0 - e_inf) * torch.exp(-b * dt)


def _exposure_gaps(exp_start_s: torch.Tensor, exptime_s: float
                   ) -> torch.Tensor:
    """(N,) free-decay gap before each exposure; the first is 0."""
    t = torch.as_tensor(exp_start_s, dtype=torch.float32)
    gaps = torch.cat([torch.zeros(1, dtype=torch.float32, device=t.device),
                      t[1:] - t[:-1] - exptime_s])
    return torch.clamp_min(gaps, 0.0)


def _trap_scan(p: RecteParams, exptime_s: float, e_s, e_f, rates, gaps):
    """The two populations through the visit: free decay over each gap,
    then the constant-rate closed form over the exposure. Returns the
    final (e_s, e_f) and the (N, ...) signed per-exposure deficit."""
    deficit = []
    for f, gap in zip(rates, gaps):
        e_s = e_s * torch.exp(-gap / p.tau_s)
        e_f = e_f * torch.exp(-gap / p.tau_f)
        e_s_new = _evolve_constant_rate(e_s, f, exptime_s,
                                        p.n_trap_s, p.eta_s, p.tau_s)
        e_f_new = _evolve_constant_rate(e_f, f, exptime_s,
                                        p.n_trap_f, p.eta_f, p.tau_f)
        deficit.append((e_s_new - e_s) + (e_f_new - e_f))
        e_s, e_f = e_s_new, e_f_new
    return e_s, e_f, torch.stack(deficit)


def trap_deltas(rate_stack: torch.Tensor, exp_start_s: torch.Tensor,
                exptime_s: float, params: RecteParams = RecteParams(),
                f0_s: float = 0.0, f0_f: float = 0.0):
    """Net trapped-charge change per exposure, the observed deficit.

    ``rate_stack`` (N, S, S) noise-free illumination rates (e-/s);
    ``f0_s`` / ``f0_f`` initial fill fractions at the first exposure's
    start. Returns ``(deficit_e (N, S, S), e_s_end, e_f_end)``: positive
    deficit = net capture, negative = net release.
    """
    p = params
    rates = rate_stack.to(torch.float32)
    gaps = _exposure_gaps(exp_start_s, exptime_s).to(rates.device)
    shape = rates.shape[1:]
    e_s0 = torch.full(shape, f0_s * p.n_trap_s, dtype=torch.float32,
                      device=rates.device)
    e_f0 = torch.full(shape, f0_f * p.n_trap_f, dtype=torch.float32,
                      device=rates.device)
    e_s, e_f, deficit = _trap_scan(p, exptime_s, e_s0, e_f0, rates, gaps)
    return deficit, e_s, e_f


def thin_and_release(deficit_e: torch.Tensor, fluence_e: torch.Tensor,
                     exptime_s: float):
    """``(trap_mult, release_rate)``: the thinning plane in [0, 1] on the
    expected source + background, and the non-negative e-/s release rate
    that joins the persistence rate."""
    cap = torch.clamp_min(deficit_e, 0.0)
    rel = torch.clamp_min(-deficit_e, 0.0)
    trap_mult = torch.clamp(1.0 - cap / torch.clamp_min(fluence_e, 1e-20),
                            0.0, 1.0)
    return trap_mult, rel / exptime_s


def white_ramp(rate_e_s, exp_start_s: torch.Tensor, exptime_s: float,
               params: RecteParams = RecteParams(), f0_s=0.0,
               f0_f=0.0) -> torch.Tensor:
    """(N,) relative RECTE ramp 1 - deficit / (rate * exptime) of a light
    curve at a representative illuminated-pixel rate (scalar or (N,)).
    The trap loop is the span ``recte.ramp`` (``utils.profiling``); under
    a transform or a CUDA graph's capture it records the host's pass."""
    p = params
    t = torch.as_tensor(exp_start_s, dtype=torch.float32)
    # one trailing axis of length 1: forward-mode autodiff gives a 0-dim
    # float32 tensor times a Python float a float64 tangent, and the fits
    # differentiate this scan in float32, as the JAX package does
    f = torch.as_tensor(rate_e_s, dtype=torch.float32,
                        device=t.device).expand(t.shape)[:, None]
    gaps = _exposure_gaps(t, exptime_s)[:, None]
    e_s0 = torch.as_tensor(f0_s, dtype=torch.float32,
                           device=t.device).reshape(1) * p.n_trap_s
    e_f0 = torch.as_tensor(f0_f, dtype=torch.float32,
                           device=t.device).reshape(1) * p.n_trap_f
    with span("recte.ramp"):
        _, _, deficit = _trap_scan(p, exptime_s, e_s0, e_f0, f, gaps)
    return (1.0 - deficit / torch.clamp_min(f * exptime_s, 1e-20))[:, 0]


def visit_trap_maps(scenes, tables, cfg, rcfg, chunk: int = 8,
                    fluence_stack: torch.Tensor | None = None):
    """The whole visit's ``(trap_mult, release_rate)`` Scene leaves from
    its noise-free fluence stack (N, S, S): ``fluence_stack`` when given
    (shared with the persistence model), else one noise-free pass of the
    visit here (:func:`ops.visit.visit_fluence_stack`, ``chunk``
    exposures a launch)."""
    if fluence_stack is None:
        from wayne_tpu_torch.ops.visit import visit_fluence_stack

        fluence_stack = visit_fluence_stack(scenes, tables, cfg, chunk)
    exptime = float(tables.read_times[-1])
    params = RecteParams(
        n_trap_s=rcfg.n_trap_s, eta_s=rcfg.eta_s, tau_s=rcfg.tau_s,
        n_trap_f=rcfg.n_trap_f, eta_f=rcfg.eta_f, tau_f=rcfg.tau_f)
    deficit, _, _ = trap_deltas(
        fluence_stack / exptime, scenes.exp_start_s, exptime,
        params=params, f0_s=rcfg.f0_s, f0_f=rcfg.f0_f)
    return thin_and_release(deficit, fluence_stack, exptime)
