"""Affine-invariant ensemble MCMC in PyTorch (port of the JAX package's
``mcmc``): emcee's Goodman & Weare (2010) stretch move, its convergence
diagnostics, and the posteriors ``run_reduce --mcmc`` and ``run_retrieve
--program --mcmc`` quote.

Where the JAX package scans a jitted step over ``vmap``-ed walkers and
``vmap``-s the whole sampler over spectral channels, here every ensemble
carries an explicit leading batch axis: C independent ensembles (C = the
channels of :func:`sample_channel_posteriors`, 1 elsewhere) advance in
lockstep, ``log_prob`` maps (C, m, ndim) walkers to (C, m) log densities,
and each half-ensemble update is one batched evaluation. Random numbers
come from an explicit ``torch.Generator`` on the tensors' device (the JAX
call sites' integer seeds seed it; the draws are the port's own, so a
posterior is held to the JAX package's by its law, never bit for bit).
Rejection is ``torch.where``; nothing in the step loop waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch

from wayne_tpu_torch.ops.kepler import OrbitParams, projected_separation
from wayne_tpu_torch.ops.transit import eclipse_visibility, transit_depth_curve
from wayne_tpu_torch.reduction import (
    _clip, fit_white_ramp, orbit_phase, ramp_transit_model,
)


@dataclass
class EnsembleChain:
    """Output of :func:`ensemble_sample`."""

    samples: torch.Tensor      # (C, n_kept, n_walkers, ndim)
    log_probs: torch.Tensor    # (C, n_kept, n_walkers)
    acceptance: torch.Tensor   # (C,) mean acceptance fraction


@dataclass
class ChainDiagnostics:
    """Convergence diagnostics from :func:`chain_diagnostics`."""

    rhat: torch.Tensor         # (..., ndim) split-chain Gelman-Rubin R-hat
    ess: torch.Tensor          # (..., ndim) effective sample size


def chain_diagnostics(samples: torch.Tensor) -> ChainDiagnostics:
    """Split-chain R-hat and Geyer effective sample size of a post-burn-in
    chain tensor (..., n_steps, n_walkers, ndim), on its device.

    Each walker's trace is split in half (2 n_walkers chains of
    n_steps // 2 draws), so a chain whose halves disagree fails even when
    the walkers agree at every instant. R-hat = sqrt(var_plus / W) with W
    the mean within-chain variance (``ddof=1``); ESS from the multi-chain
    autocorrelation rho_t = 1 - (W - mean_c acf_c(t)) / var_plus (FFT),
    summed in Geyer's pairs up to the first non-positive pair (a
    cumulative-product mask, no branch)."""
    n, m, d = samples.shape[-3:]
    half = n // 2
    chains = torch.cat([samples[..., :half, :, :],
                        samples[..., half: 2 * half, :, :]], dim=-2)
    chains = chains.to(torch.float32)                   # (..., half, 2m, d)
    mean_c = chains.mean(dim=-3)                        # (..., 2m, d)
    var_c = chains.var(dim=-3, unbiased=True)
    w_var = var_c.mean(dim=-2)                          # (..., d)
    b_var = half * mean_c.var(dim=-2, unbiased=True)
    var_plus = (half - 1) / half * w_var + b_var / half
    rhat = torch.sqrt(var_plus / torch.clamp_min(w_var, 1e-30))

    x = (chains - mean_c.unsqueeze(-3)).movedim(-3, -1)  # (..., 2m, d, half)
    nfft = 2 * half
    f = torch.fft.rfft(x, n=nfft, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-1)[..., :half]
    acf = (acov / half).mean(dim=-3)                    # (..., d, half)
    rho = 1.0 - (w_var[..., None] - acf) / var_plus[..., None]
    rho = torch.cat([torch.ones_like(rho[..., :1]), rho[..., 1:]], dim=-1)
    n_pair = half // 2
    pairs = rho[..., : 2 * n_pair].reshape(
        *rho.shape[:-1], n_pair, 2).sum(dim=-1)
    keep = torch.cumprod((pairs > 0.0).to(torch.float32), dim=-1)
    tau = torch.clamp_min(-1.0 + 2.0 * torch.sum(pairs * keep, dim=-1), 1.0)
    return ChainDiagnostics(rhat=rhat, ess=(2 * m * half) / tau)


def ensemble_sample(log_prob: Callable[[torch.Tensor], torch.Tensor],
                    init: torch.Tensor, generator: torch.Generator,
                    n_steps: int, *, a: float = 2.0,
                    thin: int = 1) -> EnsembleChain:
    """Goodman & Weare (2010) stretch-move ensemble sampler over C
    independent ensembles at once.

    Args:
      log_prob: maps walkers (C, m, ndim) to log densities (C, m)
        (``-inf`` outside the prior support).
      init: (C, n_walkers, ndim) starting walkers; n_walkers even, and
        should be >= 2 ndim.
      generator: a ``torch.Generator`` on ``init``'s device; the chain is
        deterministic in (init, the generator's state).
      n_steps: ensemble updates (each moves every walker once); ``a`` the
        stretch scale; ``thin`` keeps every ``thin``-th step.

    Each step updates the two half-ensembles in turn, each mover stretched
    towards a partner drawn from the other half: one ``log_prob`` call of
    (C, n_walkers / 2) proposals per half.
    """
    C, n, ndim = init.shape
    if n % 2:
        raise ValueError("n_walkers must be even")
    half = n // 2
    dev = init.device
    x = init.to(torch.float32)
    lp = log_prob(x)
    acc = torch.zeros(C, dtype=torch.float32, device=dev)
    xs, lps = [], []
    for step in range(n_steps):
        for lo, clo in ((0, half), (half, 0)):
            movers = x[:, lo: lo + half]
            comp = x[:, clo: clo + half]
            u = torch.rand((C, half), generator=generator, device=dev)
            z = ((a - 1.0) * u + 1.0) ** 2 / a          # g(z) ~ 1/sqrt(z)
            j = torch.randint(0, half, (C, half), generator=generator,
                              device=dev)
            partner = torch.gather(comp, 1, j[..., None].expand(-1, -1, ndim))
            prop = partner + z[..., None] * (movers - partner)
            lp_prop = log_prob(prop)
            lp_cur = lp[:, lo: lo + half]
            log_ratio = (ndim - 1) * torch.log(z) + lp_prop - lp_cur
            accept = torch.log(torch.rand((C, half), generator=generator,
                                          device=dev)) < log_ratio
            moved = torch.where(accept[..., None], prop, movers)
            moved_lp = torch.where(accept, lp_prop, lp_cur)
            keep, keep_lp = x[:, clo: clo + half], lp[:, clo: clo + half]
            parts = (moved, keep) if lo == 0 else (keep, moved)
            x = torch.cat(parts, dim=1)
            lp = torch.cat((moved_lp, keep_lp) if lo == 0
                           else (keep_lp, moved_lp), dim=1)
            acc = acc + accept.to(torch.float32).mean(dim=-1)
        if step % thin == 0:
            xs.append(x)
            lps.append(lp)
    return EnsembleChain(samples=torch.stack(xs, dim=1),
                         log_probs=torch.stack(lps, dim=1),
                         acceptance=acc / (2 * n_steps))


def _generator(seed: int, device: torch.device) -> torch.Generator:
    """The samplers' generator on ``device``, seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _check_burn(n_burn: int, n_steps: int) -> None:
    if not 0 <= n_burn < n_steps:
        raise ValueError(f"n_burn ({n_burn}) must be < n_steps ({n_steps}) "
                         "— nothing would remain after burn-in")


def _percentiles(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The 16th, 50th and 84th percentiles along ``dim`` (linear
    interpolation, as ``jnp.percentile``), stacked first."""
    q = torch.tensor([0.16, 0.5, 0.84], dtype=x.dtype, device=x.device)
    return torch.quantile(x, q, dim=dim)


@dataclass
class WhitePosterior:
    """Marginal posterior summaries from :func:`sample_white_posterior`."""

    rp_median: torch.Tensor
    rp_minus: torch.Tensor       # median - 16th percentile
    rp_plus: torch.Tensor        # 84th percentile - median
    samples: torch.Tensor        # (n_kept * n_walkers, ndim), post burn-in:
    #                              (c, rp, ra, rb, rbf, log_tau[, dt0_s,
    #                              sma_rs, cos_i], log_sigma)
    acceptance: torch.Tensor
    rhat: torch.Tensor           # (ndim,) split R-hat
    ess: torch.Tensor            # (ndim,) effective sample size


def _white_bounds(dev, fit_geometry: bool, eclipse: bool,
                  t0_window_s: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The white posterior's flat prior box (lo, hi) over theta."""
    depth_lo, depth_hi = (-0.02, 0.1) if eclipse else (0.01, 0.5)
    t0_span = 3.0 * t0_window_s   # the prior tracks the LM seeding window
    lo = ([0.2, depth_lo, -1.0, -0.05, -0.05, math.log(30.0)]
          + ([-t0_span, 1.5, 0.0] if fit_geometry else []) + [math.log(1e-6)])
    hi = ([5.0, depth_hi, 1.0, 0.05, 0.05, math.log(20000.0)]
          + ([t0_span, 50.0, 0.6] if fit_geometry else []) + [math.log(0.1)])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    return f32(lo), f32(hi)


def white_log_prob(white_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                   orbit: OrbitParams, ld, rp_geom, *, gap_s: float = 1200.0,
                   n_quad: int = 32, fit_geometry: bool = False,
                   t0_window_s: float = 600.0, eclipse: bool = False,
                   weights: torch.Tensor | None = None):
    """The log density :func:`sample_white_posterior` samples, as a
    function of walkers theta (C, m, ndim) -> (C, m): the Gaussian
    likelihood of the ramp x transit model
    (:func:`~wayne_tpu_torch.reduction.ramp_transit_model`) with the free
    noise scale exp(theta[-1]), -inf outside the prior box. With
    ``fit_geometry`` each walker carries its own orbit (t0 offset, a/Rs,
    cos i). Returns (log_prob, lo, hi)."""
    lc = torch.as_tensor(white_lc).to(torch.float32)
    dev = lc.device
    t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
    ld = torch.as_tensor(ld, dtype=torch.float32, device=dev)
    w = (torch.ones_like(lc) if weights is None
         else torch.as_tensor(weights, device=dev).to(torch.float32))
    n_kept = torch.sum(w)
    t_orb, first = orbit_phase(t, gap_s)
    firstf = first.to(torch.float32)
    t_day = (t - t.mean()) / 86400.0
    z, in_front = projected_separation(t, orbit)
    vis = (eclipse_visibility(z, in_front, torch.as_tensor(
        rp_geom, dtype=torch.float32, device=dev)) if eclipse else None)
    ndim = 10 if fit_geometry else 7
    lo, hi = _white_bounds(dev, fit_geometry, eclipse, t0_window_s)
    t_grid = t.reshape(1, 1, -1)

    def log_prob(theta):                                # (C, m, ndim)
        inside = torch.all((theta > lo) & (theta < hi), dim=-1)
        if fit_geometry:
            orb = dataclasses.replace(
                orbit, t0_s=orbit.t0_s + theta[..., 6],
                sma_rs=_clip(theta[..., 7], 1.5, 50.0),
                inc_rad=torch.arccos(_clip(theta[..., 8], 0.0, 0.6)))
            zz, infr = projected_separation(t_grid, orb)
        else:
            zz, infr = z, in_front
        m = ramp_transit_model(theta[..., :6].movedim(-1, 0)[..., None],
                               t_day, t_orb, firstf, zz, infr, ld, n_quad,
                               vis)[0]                  # (C, m, n_exp)
        log_sig = theta[..., ndim - 1]
        loglike = (-0.5 * torch.sum(
            w * ((m - lc) / torch.exp(log_sig)[..., None]) ** 2, dim=-1)
            - n_kept * log_sig)
        return torch.where(inside, loglike, -torch.inf)

    return log_prob, lo, hi


def sample_white_posterior(white_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                           orbit: OrbitParams, ld, rp_init, seed, *,
                           n_steps: int = 2000, n_walkers: int = 32,
                           n_burn: int = 500, gap_s: float = 1200.0,
                           n_quad: int = 32, fit_geometry: bool = False,
                           t0_window_s: float = 600.0, eclipse: bool = False,
                           weights: torch.Tensor | None = None
                           ) -> WhitePosterior:
    """Posterior over the joint white-light ramp x transit model
    (:func:`white_log_prob`, the model the LM fit solves): theta = (c, rp,
    ra, rb, rb_first, log tau, log sigma) under broad flat priors, walkers
    started in a small ball around
    :func:`~wayne_tpu_torch.reduction.fit_white_ramp`'s solution.
    ``fit_geometry`` adds (t0 offset [s], a/Rs, cos i); ``t0_window_s``
    sets the LM's seeding grid and the flat t0 prior (+-3 t0_window_s).
    ``eclipse`` samples Fp/Fs on the eclipse visibility at the geometric
    radius ``rp_init``. ``weights`` (n_exp,) is a keep mask (0 =
    excluded), e.g. a robust point fit's. ``seed``: the integer that
    seeds a ``torch.Generator`` on the curve's device.
    """
    if eclipse and fit_geometry:
        raise ValueError("fit the ephemeris on a transit visit")
    _check_burn(n_burn, n_steps)
    lc = torch.as_tensor(white_lc).to(torch.float32)
    dev = lc.device
    t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
    ld = torch.as_tensor(ld, dtype=torch.float32, device=dev)
    w = (torch.ones_like(lc) if weights is None
         else torch.as_tensor(weights, device=dev).to(torch.float32))
    log_prob, lo, hi = white_log_prob(
        lc, t, orbit, ld, rp_init, gap_s=gap_s, n_quad=n_quad,
        fit_geometry=fit_geometry, t0_window_s=t0_window_s, eclipse=eclipse,
        weights=w)
    lm = fit_white_ramp(lc, t, orbit, ld, rp_init, gap_s=gap_s,
                        n_quad=n_quad, fit_geometry=fit_geometry,
                        t0_window_s=t0_window_s, eclipse=eclipse)
    # the noise scale's seed: the residual scatter at the FITTED ephemeris
    # (the input orbit's would leave residuals at the contacts)
    base6 = [lm.c, lm.rp, lm.slope_per_day, lm.hook_amp, lm.hook_amp_first,
             torch.log(lm.hook_tau_s)]
    geo = ([lm.t0_offset_s, lm.orbit.sma_rs, torch.cos(lm.orbit.inc_rad)]
           if fit_geometry else [])
    t_orb, first = orbit_phase(t, gap_s)
    z_lm, infr_lm = projected_separation(t, lm.orbit)
    vis = (eclipse_visibility(z_lm, infr_lm, torch.as_tensor(
        rp_init, dtype=torch.float32, device=dev)) if eclipse else None)
    resid = lc - ramp_transit_model(
        torch.stack(base6), (t - t.mean()) / 86400.0, t_orb,
        first.to(torch.float32), z_lm, infr_lm, ld, n_quad, vis)[0]
    n_kept = torch.sum(w)
    mu_r = torch.sum(w * resid) / torch.clamp_min(n_kept, 1.0)
    sigma0 = torch.clamp_min(torch.sqrt(
        torch.sum(w * (resid - mu_r) ** 2)
        / torch.clamp_min(n_kept - 1.0, 1.0)), 1e-6)
    ndim = 10 if fit_geometry else 7
    center = torch.stack([v.to(torch.float32).reshape(())
                          for v in base6 + geo] + [torch.log(sigma0)])
    center = torch.clamp(center, lo + 1e-4, hi - 1e-4)
    scale = torch.tensor([1e-3, 1e-3, 1e-3, 1e-4, 1e-4, 0.05]
                         + ([5.0, 0.02, 2e-3] if fit_geometry else [])
                         + [0.05], dtype=torch.float32, device=dev)
    gen = _generator(seed, dev)
    init = center + scale * torch.randn((1, n_walkers, ndim),
                                        generator=gen, device=dev)
    init = torch.clamp(init, lo + 1e-5, hi - 1e-5)

    chain = ensemble_sample(log_prob, init, gen, n_steps)
    post = chain.samples[0, n_burn:]                    # (n, n_walkers, ndim)
    diag = chain_diagnostics(post)
    kept = post.reshape(-1, ndim)
    q16, q50, q84 = _percentiles(kept[:, 1])
    return WhitePosterior(rp_median=q50, rp_minus=q50 - q16,
                          rp_plus=q84 - q50, samples=kept,
                          acceptance=chain.acceptance[0], rhat=diag.rhat,
                          ess=diag.ess)


@dataclass
class ChannelPosteriors:
    """Per-channel depth posteriors from :func:`sample_channel_posteriors`."""

    rp_median: torch.Tensor    # (n_chan,)
    rp_minus: torch.Tensor     # (n_chan,) median - 16th percentile
    rp_plus: torch.Tensor      # (n_chan,) 84th percentile - median
    acceptance: torch.Tensor   # (n_chan,)
    rhat: torch.Tensor         # (n_chan,) split R-hat of the rp chain
    ess: torch.Tensor          # (n_chan,) rp effective sample size


def channel_log_prob(channel_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                     orbit: OrbitParams, ld, *, n_quad: int = 32,
                     eclipse: bool = False, rp_geom=0.15,
                     weights: torch.Tensor | None = None):
    """The log density :func:`sample_channel_posteriors` samples: walkers
    theta (n_chan, m, 3) = (c, depth, log sigma) of each channel's curve
    (``channel_lc`` (n_exp, n_chan)) -> (n_chan, m), -inf outside the prior
    box. Returns (log_prob, lo, hi)."""
    lcs = torch.as_tensor(channel_lc).to(torch.float32).T  # (n_chan, n_exp)
    dev = lcs.device
    t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
    w = (torch.ones_like(t) if weights is None
         else torch.as_tensor(weights, device=dev).to(torch.float32))
    n_kept = torch.sum(w)
    z, in_front = projected_separation(t, orbit)
    depth_lo, depth_hi = (-0.02, 0.1) if eclipse else (0.01, 0.5)
    lo = torch.tensor([0.2, depth_lo, math.log(1e-6)], dtype=torch.float32,
                      device=dev)
    hi = torch.tensor([5.0, depth_hi, math.log(0.1)], dtype=torch.float32,
                      device=dev)
    vis = (eclipse_visibility(z, in_front, torch.as_tensor(
        rp_geom, device=dev).to(torch.float32)) if eclipse else None)
    ld = torch.as_tensor(ld, device=dev).to(torch.float32)
    ld_chan = torch.broadcast_to(ld if ld.dim() == 2 else ld[None, :],
                                 (lcs.shape[0], 4))[:, None, None, :]

    def log_prob(theta):                                # (n_chan, m, 3)
        inside = torch.all((theta > lo) & (theta < hi), dim=-1)
        c, depth = theta[..., 0:1], theta[..., 1:2]
        if eclipse:
            m = c * (1.0 + depth * vis)
        else:
            f = transit_depth_curve(z, depth, ld_chan, n_quad)
            m = c * (1.0 - (1.0 - f) * in_front)       # (n_chan, m, n_exp)
        log_sig = theta[..., 2]
        loglike = (-0.5 * torch.sum(
            w * ((m - lcs[:, None, :]) / torch.exp(log_sig)[..., None]) ** 2,
            dim=-1) - n_kept * log_sig)
        return torch.where(inside, loglike, -torch.inf)

    return log_prob, lo, hi


def sample_channel_posteriors(channel_lc: torch.Tensor,
                              exp_mid_s: torch.Tensor, orbit: OrbitParams,
                              ld, rp_init, seed, *, n_steps: int = 1500,
                              n_walkers: int = 16, n_burn: int = 400,
                              n_quad: int = 32, eclipse: bool = False,
                              rp_geom=0.15,
                              weights: torch.Tensor | None = None
                              ) -> ChannelPosteriors:
    """Every channel's depth posterior at once: the channels are the
    ensemble axis C of :func:`ensemble_sample`, each a ``n_walkers``
    ensemble over theta = (c, rp, log sigma) with the model c T(t; rp) on
    already detrended curves ``channel_lc`` (n_exp, n_chan)
    (:func:`channel_log_prob`). ``ld``: shared (4,) or per-channel
    (n_chan, 4). ``eclipse`` samples Fp/Fs instead, model c (1 + fp vis)
    at the geometric radius ``rp_geom`` (``rp_init`` then seeds the
    per-channel fp). ``weights`` (n_exp,) is a keep mask shared by the
    channels. ``seed``: the integer that seeds a ``torch.Generator`` on
    the curves' device."""
    _check_burn(n_burn, n_steps)
    lcs = torch.as_tensor(channel_lc).to(torch.float32).T  # (n_chan, n_exp)
    dev = lcs.device
    w = (torch.ones_like(lcs[0]) if weights is None
         else torch.as_tensor(weights, device=dev).to(torch.float32))
    n_kept = torch.sum(w)
    n_chan = lcs.shape[0]
    log_prob, lo, hi = channel_log_prob(
        lcs.T, exp_mid_s, orbit, ld, n_quad=n_quad, eclipse=eclipse,
        rp_geom=rp_geom, weights=w)
    rp0 = torch.broadcast_to(torch.as_tensor(rp_init, device=dev).to(
        torch.float32), (n_chan,))
    mu = torch.sum(w * lcs, dim=-1) / torch.clamp_min(n_kept, 1.0)
    sigma0 = torch.clamp(torch.sqrt(
        torch.sum(w * (lcs - mu[:, None]) ** 2, dim=-1)
        / torch.clamp_min(n_kept - 1.0, 1.0)), 1e-5, 0.05)
    center = torch.clamp(torch.stack([mu, rp0, torch.log(sigma0)], dim=-1),
                         lo + 1e-4, hi - 1e-4)          # (n_chan, 3)
    scale = torch.tensor([3e-4, 1e-3, 0.05], dtype=torch.float32, device=dev)
    gen = _generator(seed, dev)
    init = center[:, None, :] + scale * torch.randn(
        (n_chan, n_walkers, 3), generator=gen, device=dev)
    init = torch.clamp(init, lo + 1e-5, hi - 1e-5)
    chain = ensemble_sample(log_prob, init, gen, n_steps)
    post = chain.samples[:, n_burn:]                    # (n_chan, n, m, 3)
    diag = chain_diagnostics(post)
    q16, q50, q84 = _percentiles(post[..., 1].reshape(n_chan, -1))
    return ChannelPosteriors(rp_median=q50, rp_minus=q50 - q16,
                             rp_plus=q84 - q50, acceptance=chain.acceptance,
                             rhat=diag.rhat[:, 1], ess=diag.ess[:, 1])


@dataclass
class ProgramPosterior:
    """Joint program posterior (:func:`sample_program_posterior`)."""

    rp_median: torch.Tensor      # (n_chan,) shared spectrum medians
    rp_minus: torch.Tensor       # median - 16th percentile
    rp_plus: torch.Tensor        # 84th - median
    t0_median_s: torch.Tensor    # (n_vis,) per-visit mid-time offsets
    t0_minus_s: torch.Tensor
    t0_plus_s: torch.Tensor
    samples: torch.Tensor        # (n_kept * n_walkers, ndim)
    acceptance: torch.Tensor
    rhat: torch.Tensor           # (ndim,) split R-hat
    ess: torch.Tensor            # (ndim,)


def program_log_prob(channel_lc: torch.Tensor, exp_mid_s: torch.Tensor,
                     orbit: OrbitParams, ld, sigma, n_oot, *,
                     n_quad: int = 32, t0_window_s: float = 1800.0):
    """The log density :func:`sample_program_posterior` samples: walkers
    theta (C, m, K + V + V K + 1) -> (C, m) over the V visits' curves
    ``channel_lc`` (V, n_exp, K), the visits and channels explicit axes
    of one evaluation. Returns (log_prob, b_sig), b_sig (V, K) the
    baselines' prior widths."""
    lc = torch.as_tensor(channel_lc).to(torch.float32)
    dev = lc.device
    V, n_exp, K = lc.shape
    t = torch.as_tensor(exp_mid_s, device=dev).to(torch.float32)
    sig = torch.as_tensor(sigma, device=dev).to(torch.float32)
    ld = torch.as_tensor(ld, device=dev).to(torch.float32)
    ld_chan = torch.broadcast_to(ld if ld.dim() == 2 else ld[None, :],
                                 (K, 4))[:, None, :]    # (K, 1, 4)
    b_sig = sig / torch.sqrt(torch.clamp_min(torch.as_tensor(
        n_oot, device=dev).to(torch.float32), 1.0))[:, None]     # (V, K)
    lc_vk = lc.transpose(-1, -2)                        # (V, K, n_exp)
    t_grid = t.reshape(1, 1, V, n_exp)

    def log_prob(theta):                                # (C, m, ndim)
        rp = theta[..., :K]
        dt0 = theta[..., K: K + V]
        b = theta[..., K + V: K + V + V * K].reshape(*theta.shape[:-1], V, K)
        log_s = theta[..., -1]
        inside = (torch.all((rp > 0.01) & (rp < 0.5), dim=-1)
                  & torch.all(torch.abs(dt0) < 3.0 * t0_window_s, dim=-1)
                  & torch.all(torch.abs(b - 1.0) < 0.05, dim=-1).all(dim=-1)
                  & (torch.abs(log_s) < 2.0))
        orb = dataclasses.replace(orbit, t0_s=orbit.t0_s + dt0)
        z, infr = projected_separation(t_grid, orb)     # (C, m, V, n_exp)
        f = transit_depth_curve(z[..., None, :], rp[..., None, :, None],
                                ld_chan, n_quad)        # (C, m, V, K, n_exp)
        model = (1.0 - (1.0 - f) * infr[..., None, :]) * b[..., None]
        r = (model - lc_vk) / (sig[..., None]
                               * torch.exp(log_s)[..., None, None, None])
        ll = -0.5 * torch.sum(r * r, dim=(-1, -2, -3))
        ll = ll - (V * n_exp * K) * log_s
        ll = ll - 0.5 * torch.sum(((b - 1.0) / b_sig) ** 2, dim=(-1, -2))
        return torch.where(inside, ll, -torch.inf)

    return log_prob, b_sig


def sample_program_posterior(channel_lc: torch.Tensor,
                             exp_mid_s: torch.Tensor, orbit: OrbitParams,
                             ld, rp_init, t0_init_s, sigma, n_oot, seed, *,
                             n_steps: int = 2000, n_walkers: int = 0,
                             n_burn: int = 500, n_quad: int = 32,
                             t0_window_s: float = 1800.0
                             ) -> ProgramPosterior:
    """Joint posterior over a multi-visit program: one shared per-channel
    Rp/Rs spectrum, per-visit transit-time offsets, per-(visit, channel)
    baseline scales with a Gaussian prior of width sigma_vc /
    sqrt(N_oot_v), and a global noise rescale: theta = [rp (K), dt0_s (V),
    b (V K), log s] (:func:`program_log_prob`).

    Args:
      channel_lc: (V, n_exp, K) OOT-normalised channel light curves.
      exp_mid_s: (V, n_exp) mid-times, each on its own visit's clock.
      ld: (4,) shared or (K, 4) per-channel limb darkening.
      rp_init / t0_init_s: the LM solution (seeds the walker ball; chi2(t0)
        is multimodal, so the seed must be grid-refined, as the joint LM's
        is).
      sigma: (V, K) per-point noise of the normalised curves.
      n_oot: (V,) out-of-transit exposure counts.
      seed: the integer that seeds a ``torch.Generator`` on the curves'
        device.
    """
    lc = torch.as_tensor(channel_lc).to(torch.float32)
    dev = lc.device
    V, _, K = lc.shape
    ndim = K + V + V * K + 1
    if n_walkers == 0:
        n_walkers = 2 * ndim + (2 * ndim) % 2 + 8
    if not 0 <= n_burn < n_steps:
        raise ValueError("n_burn must be < n_steps")
    log_prob, b_sig = program_log_prob(
        lc, exp_mid_s, orbit, ld, sigma, n_oot, n_quad=n_quad,
        t0_window_s=t0_window_s)
    f32 = lambda v: torch.as_tensor(v, device=dev).to(torch.float32)
    center = torch.cat([
        torch.clamp(torch.broadcast_to(f32(rp_init), (K,)), 0.011, 0.49),
        f32(t0_init_s).reshape(V), torch.ones(V * K, device=dev),
        torch.zeros(1, device=dev)])
    scale = torch.cat([
        torch.full((K,), 1e-3, device=dev), torch.full((V,), 5.0, device=dev),
        (0.3 * b_sig).reshape(-1), torch.full((1,), 0.05, device=dev)])
    gen = _generator(seed, dev)
    init = center + scale * torch.randn((1, n_walkers, ndim), generator=gen,
                                        device=dev)
    chain = ensemble_sample(log_prob, init, gen, n_steps)
    post = chain.samples[0, n_burn:]
    diag = chain_diagnostics(post)
    kept = post.reshape(-1, ndim)
    q = _percentiles(kept, dim=0)                       # (3, ndim)
    return ProgramPosterior(
        rp_median=q[1, :K], rp_minus=q[1, :K] - q[0, :K],
        rp_plus=q[2, :K] - q[1, :K], t0_median_s=q[1, K: K + V],
        t0_minus_s=q[1, K: K + V] - q[0, K: K + V],
        t0_plus_s=q[2, K: K + V] - q[1, K: K + V], samples=kept,
        acceptance=chain.acceptance[0], rhat=diag.rhat, ess=diag.ess)
