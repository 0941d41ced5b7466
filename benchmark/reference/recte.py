"""Plain reference of the physical RECTE white-light fit, the detrending
and the channel depth fits (what ``run_reduce --detrend recte`` runs), in
any floating dtype; float64 for the reference.

Written from Zhou, Apai, Lew & Schneider (2017, AJ 153, 243). Each pixel
holds a slow (s) and a fast (f) trap population E_p that fills under the
illumination rate f (e-/s) and empties by itself:

    dE_p/dt = eta_p f (1 - E_p / N_p) - E_p / tau_p .

At constant f this is linear in E_p, so over an exposure of ``dt`` s

    E_p(dt) = a / b + (E_p(0) - a / b) exp(-b dt),   a = eta_p f,
                                                      b = a / N_p + 1 / tau_p,

and over a gap between exposures (f = 0) the population decays freely,
E_p -> E_p exp(-gap / tau_p). The charge an exposure loses to the traps is
the change of E_s + E_f over it (positive: net capture). Composed over the
visit, the state after exposure k is the linear recurrence

    E_k = A_k E_{k-1} + B_k,   A_k = exp(-gap_k / tau - b_k dt),
                               B_k = (a_k / b_k) (1 - exp(-b_k dt)),

whose solution E_k = P_k E_0 + sum_{j <= k} (P_k / P_j) B_j, with log P_k
the running sum of log A_k, is evaluated here as one lower-triangular
product: every ratio P_k / P_j (j <= k) is exp of a difference of running
sums that is never positive, so nothing overflows in any precision.

Departures from the published description, each the program's own:

- One representative illuminated rate for the whole white-light aperture
  (its out-of-transit mean per pixel, times a fitted scale), where the
  paper evolves every pixel at its own rate; the light curve's ramp is
  then 1 - deficit / (rate * exptime) at that rate.
- The rate is constant over an exposure: a spatial scan sweeps the
  spectrum over the pixels, which the rate scale absorbs.
- Exposure starts are the mid-times less half the exposure time; the
  first exposure follows no gap.
- The initial fills are fitted as logits and the rate scale as a log
  clipped to [-3, 3], as the program parametrises them.

The fit: theta = (c, Rp/Rs, slope per day, logit f0_s, logit f0_f, log
rate scale), the model F = c (1 - ra t_day) R(t; theta) T(t; rp), the
fixed-step Levenberg-Marquardt, the transit, the orbit and the depth fits
of ``fits.py``; the channels are divided by the fitted systematic
(1 - ra t_day) R and renormalised to their out-of-transit mean, as
``ramp_detrend`` does. It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import fits

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Traps:
    """The two trap populations: counts per pixel, capture efficiencies,
    release timescales (s). Defaults: Zhou et al. (2017)'s best fit."""

    n_s: float = 1525.38
    eta_s: float = 0.013318
    tau_s: float = 1.63e4
    n_f: float = 162.38
    eta_f: float = 0.008407
    tau_f: float = 281.463


def fill(e0, rate, dt: float, n: float, eta: float, tau: float):
    """A population after ``dt`` s of constant illumination ``rate``."""
    a = eta * rate
    b = a / n + 1.0 / tau
    return a / b + (e0 - a / b) * torch.exp(-b * dt)


def decay(e, gap, tau: float):
    """A population after ``gap`` s in the dark."""
    return e * torch.exp(-gap / tau)


def population(e0, rate, gaps, dt: float, n: float, eta: float, tau: float):
    """One population through the visit: (before each exposure, after
    it), each (N,); ``rate`` and ``gaps`` (N,), ``e0`` the state before
    the first gap."""
    b = eta * rate / n + 1.0 / tau
    log_a = -gaps / tau - b * dt
    big_b = fill(torch.zeros_like(rate), rate, dt, n, eta, tau)
    lp = torch.cumsum(log_a, dim=0)
    ratio = torch.tril(torch.exp(torch.tril(lp[:, None] - lp[None, :])))
    after = torch.exp(lp) * e0 + ratio @ big_b
    before = decay(torch.cat([e0.reshape(1), after[:-1]]), gaps, tau)
    return before, after


def white_ramp(rate, starts, exptime: float, traps: Traps = Traps(),
               f0_s=0.0, f0_f=0.0):
    """(N,) relative ramp 1 - deficit / (rate * exptime) of a light curve
    at one illuminated rate (scalar or (N,)); ``f0_*`` the fills at the
    first exposure's start."""
    dtype = starts.dtype
    gaps = torch.clamp_min(torch.cat([
        torch.zeros(1, dtype=dtype), starts[1:] - starts[:-1] - exptime]), 0)
    f = torch.as_tensor(rate, dtype=dtype).expand(starts.shape)
    p = traps
    deficit = 0.0
    for e0, n, eta, tau in ((f0_s * p.n_s, p.n_s, p.eta_s, p.tau_s),
                            (f0_f * p.n_f, p.n_f, p.eta_f, p.tau_f)):
        before, after = population(torch.as_tensor(e0, dtype=dtype), f, gaps,
                                   exptime, n, eta, tau)
        deficit = deficit + (after - before)
    return 1.0 - deficit / (f * exptime)


def fit_recte_visit(white_lc, channel_lc, t_mid_s, exptime_s: float,
                    orbit: fits.Orbit, ld, rp0: float, rate_e_s: float,
                    n_lm: int = 80, *, traps: Traps = Traps(),
                    dtype=torch.float64, n_newton: int = 12,
                    n_quad: int = 32) -> fits.Fit:
    """The white RECTE fit, its systematic divided out of the channels,
    then the channel depths. ``dtype``: the model's arithmetic (float64
    for the reference; bfloat16 for the control, whose parameters and
    linear algebra stay float32). ``Fit.white``: c, Rp/Rs, slope per day,
    f0_s, f0_f, rate scale, with their 1-sigma from the curvature."""
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    t = torch.as_tensor(t_mid_s, dtype=torch.float64)
    lc = torch.as_tensor(white_lc, dtype=torch.float64)
    chan = torch.as_tensor(channel_lc, dtype=torch.float64)
    ld = torch.as_tensor(ld, dtype=torch.float64)
    t_day = (t - t.mean()) / 86400.0
    starts = t - 0.5 * exptime_s
    z, front = fits.separation(t, orbit)
    oot = ((z > fits.OOT_Z) | (front < 0.5)).to(torch.float64)
    c0 = torch.sum(lc * oot) / max(float(oot.sum()), 1.0)
    m = lambda a: a.to(dtype)

    def white_model(theta):
        # (1,) slices: forward-mode AD gives a 0-dim tensor times a Python
        # float a float64 tangent, whatever the tensor's dtype
        c, rp, ra, u_s, u_f, log_rs = m(theta).split(1)
        rate = rate_e_s * torch.exp(fits._mid_clip(log_rs, -3.0, 3.0))
        ramp = white_ramp(rate, m(starts), exptime_s, traps,
                          torch.sigmoid(u_s), torch.sigmoid(u_f))
        sys = (1 - ra * m(t_day)) * ramp
        f = fits.transit_flux(m(z), fits._mid_clip(rp, 0.01, 0.5), m(ld),
                              n_quad)
        return c * sys * (1 - (1 - f) * m(front)), sys

    def resid(theta):
        return white_model(theta)[0] - m(lc)

    theta0 = torch.tensor([float(c0), rp0, 0.0, -1.5, -1.5, 0.0],
                          dtype=solve)
    theta, c2 = fits._lm(resid, theta0, n_lm, solve)
    J = torch.func.jacfwd(resid)(theta).to(solve)
    noise_var = c2 / max(lc.shape[0] - 6, 1)
    cov = torch.linalg.inv(J.T @ J + 1e-9 * torch.eye(6, dtype=solve))
    sig = torch.sqrt(torch.clamp_min(torch.diagonal(cov) * noise_var, 0))
    th = theta.to(torch.float64)
    sig = sig.to(torch.float64)
    fills = torch.sigmoid(th[3:5])
    scale = torch.exp(torch.clamp(th[5], -3.0, 3.0))
    white = torch.stack([th[0], torch.clamp(th[1], 0.01, 0.5), th[2],
                         fills[0], fills[1], scale])
    # d sigmoid(u) = s (1 - s) du, d exp(v) = exp(v) dv
    white_sig = torch.cat([sig[:3], sig[3:5] * fills * (1 - fills),
                           (sig[5] * scale).reshape(1)])

    template = white_model(theta)[1].to(torch.float64)
    corr = chan / template[:, None]
    base = (torch.sum(corr * oot[:, None], dim=0)
            / torch.clamp_min(oot.sum(), 1))
    depth, depth_sig = fits._depths(corr / base[None, :], z, front, oot, ld,
                                    rp0, dtype, solve, n_newton, n_quad)
    return fits.Fit(white, white_sig, depth, depth_sig)

