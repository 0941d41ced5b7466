"""Plain reference of the Iraclis white-light ramp fit, the detrending and
the channel depth fits (what ``run_reduce --detrend ramp`` runs), in any
floating dtype.

Written from the method the program states: the Claret 4-parameter
limb-darkened transit (occulted flux = a closed-form covered core plus
the partially covered annulus by Gauss-Legendre nodes under
r = r_lo + (r_hi - r_lo) sin^2(pi s / 2)), the Keplerian sky separation,
the ramp F = c (1 - ra t) (1 - rb exp(-t_orb / tau)) T(t; rp) with its own
first-orbit amplitude, a damped Levenberg-Marquardt of a fixed step count
(each step kept only if chi^2 falls; lambda x0.3 on a kept step, x5 on a
refused one), and per-channel Newton steps on chi^2 with the out-of-
transit and red-noise terms of the depth error. The reference runs it in
float64; the control evaluates the white model in bfloat16 and rounds the
depth model's values to it. It imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

OOT_Z = 1.25          # out of transit: projected separation above this


@dataclass
class Orbit:
    """Orbital elements on the visit clock (seconds), Python floats."""

    period_s: float
    t0_s: float
    sma_rs: float
    inc_rad: float
    ecc: float = 0.0
    omega_rad: float = math.pi / 2


def separation(t: torch.Tensor, o: Orbit) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Projected separation z(t) in stellar radii and the in-front mask
    (1 on the transit side of the orbit)."""
    e = o.ecc
    nu_tr = math.pi / 2 - o.omega_rad
    E_tr = 2.0 * math.atan(math.sqrt((1 - e) / (1 + e)) * math.tan(nu_tr / 2))
    M = (E_tr - e * math.sin(E_tr)) + 2 * math.pi * (t - o.t0_s) / o.period_s
    E = M + e * torch.sin(M)
    for _ in range(30):
        E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    nu = 2.0 * torch.atan(math.sqrt((1 + e) / (1 - e)) * torch.tan(E / 2))
    r = o.sma_rs * (1 - e * e) / (1 + e * torch.cos(nu))
    s = torch.sin(o.omega_rad + nu)
    z = r * torch.sqrt(torch.clamp(1 - (s * math.sin(o.inc_rad)) ** 2, 0, 1))
    return z, (s > 0).to(t.dtype)


def _claret(mu, ld):
    n = torch.arange(1, 5, dtype=mu.dtype, device=mu.device)
    return 1 - torch.sum(ld * (1 - torch.clamp(mu, 0, 1)[..., None]
                               ** (n / 2)), dim=-1)


def transit_flux(z, p, ld, n_quad: int):
    """Relative stellar flux F(z, p) / F_star, Claret law ``ld`` (..., 4)."""
    dt = z.dtype
    n = torch.arange(1, 5, dtype=dt, device=z.device)
    x, w = np.polynomial.legendre.leggauss(n_quad)
    s = torch.as_tensor(0.5 * (x + 1), dtype=dt, device=z.device)
    w = torch.as_tensor(0.5 * w, dtype=dt, device=z.device)
    z, p = torch.broadcast_tensors(z, p)
    z = torch.clamp_min(z, 1e-7)
    r_in = torch.clamp(p - z, 0, 1)
    mu_in = torch.sqrt(torch.clamp(1 - r_in * r_in, 0, 1))
    core = ((1 - torch.sum(ld, dim=-1)) * (1 - mu_in * mu_in)
            + torch.sum(ld * 4 / (n + 4)
                        * (1 - mu_in[..., None] ** ((n + 4) / 2)), dim=-1))
    r_lo = torch.clamp(torch.abs(z - p), 0, 1)
    span = torch.clamp_min(torch.clamp(z + p, 0, 1) - r_lo, 0)
    u = torch.sin(0.5 * math.pi * s) ** 2
    du = 0.5 * math.pi * torch.sin(math.pi * s)
    r = r_lo[..., None] + span[..., None] * u
    rs = torch.clamp_min(r, 1e-7)
    cos_k = (z[..., None] ** 2 + rs * rs - p[..., None] ** 2) / (
        2 * z[..., None] * rs)
    kappa = torch.arccos(torch.clamp(cos_k, -1 + 1e-7, 1 - 1e-7))
    mu = torch.sqrt(torch.clamp(1 - r * r, 1e-12, 1))
    annulus = span * torch.sum(
        w * du * _claret(mu, ld[..., None, :]) * (kappa / math.pi) * 2 * r,
        dim=-1)
    occ = torch.where((p <= 0) | (z >= 1 + p), torch.zeros_like(core),
                      core + annulus)
    total = 1 - torch.sum(ld * n / (n + 4), dim=-1)
    return 1 - occ / total


def orbit_clock(t: torch.Tensor, gap_s: float = 1200.0):
    """(time since the HST orbit's first exposure, first-orbit mask): a
    gap above ``gap_s`` starts an orbit."""
    start = t.clone()
    orbit = torch.zeros_like(t)
    for i in range(1, t.shape[0]):
        new = bool(t[i] - t[i - 1] > gap_s)
        start[i] = t[i] if new else start[i - 1]
        orbit[i] = orbit[i - 1] + (1 if new else 0)
    return t - start, orbit == 0


def _mid_clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


@dataclass
class Fit:
    """One visit's fitted numbers (float64 on the CPU)."""

    white: torch.Tensor        # (6,) c, rp, ra / day, rb, rb first, tau s
    white_sigma: torch.Tensor  # (6,) each one's 1-sigma from the curvature
    depth: torch.Tensor        # (n_chan,) channel Rp/Rs
    depth_sigma: torch.Tensor  # (n_chan,)


def _lm(resid, theta0, n_steps: int, solve_dtype, lam0: float = 1e-3):
    """The fixed-step damped Levenberg-Marquardt; theta in ``solve_dtype``,
    the residuals in whatever ``resid`` computes."""
    nd = theta0.shape[0]
    eye = torch.eye(nd, dtype=solve_dtype)

    def chi2(th):
        return torch.sum(resid(th).to(solve_dtype) ** 2)

    theta, c2, lam = theta0, chi2(theta0), lam0
    for _ in range(n_steps):
        J = torch.func.jacfwd(resid)(theta).to(solve_dtype)
        r = resid(theta).to(solve_dtype)
        JTJ, g = J.T @ J, J.T @ r
        diag = torch.diagonal(JTJ)
        ridge = 1e-7 * diag.sum() / nd + 1e-12
        A = JTJ + lam * torch.diag(diag) + ridge * eye
        th_new = theta - torch.linalg.solve(A, g)
        c2_new = chi2(th_new)
        if bool(c2_new < c2):
            theta, c2, lam = th_new, c2_new, min(max(lam * 0.3, 1e-8), 1e8)
        else:
            lam = min(max(lam * 5.0, 1e-8), 1e8)
    return theta, c2


def fit_visit(white_lc, channel_lc, t_mid_s, orbit: Orbit, ld, rp0: float,
              *, dtype=torch.float64, n_lm: int = 60, n_newton: int = 12,
              n_quad: int = 32) -> Fit:
    """The white ramp fit, its template divided out of the channels, then
    the channel depths. ``dtype``: the model's arithmetic (float64 for the
    reference; bfloat16 for the control, whose parameters and linear
    algebra stay float32)."""
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    t = torch.as_tensor(t_mid_s, dtype=torch.float64)
    lc = torch.as_tensor(white_lc, dtype=torch.float64)
    chan = torch.as_tensor(channel_lc, dtype=torch.float64)
    ld = torch.as_tensor(ld, dtype=torch.float64)
    t_orb, first = orbit_clock(t)
    t_day = (t - t.mean()) / 86400.0
    z, front = separation(t, orbit)
    oot = ((z > OOT_Z) | (front < 0.5)).to(torch.float64)
    c0 = torch.sum(lc * oot) / max(float(oot.sum()), 1.0)
    m = lambda a: a.to(dtype)

    def white_model(theta):
        th = m(theta)
        c, rp, ra, rb, rbf, log_tau = th
        tau = _mid_clip(torch.exp(log_tau), 30.0, 20000.0)
        amp = torch.where(m(first.to(torch.float64)) > 0.5, rbf, rb)
        sys = (1 - ra * m(t_day)) * (1 - amp * torch.exp(-m(t_orb) / tau))
        f = transit_flux(m(z), _mid_clip(rp, 0.01, 0.5), m(ld), n_quad)
        return c * sys * (1 - (1 - f) * m(front)), sys

    def resid(theta):
        return white_model(theta)[0] - m(lc)

    theta0 = torch.tensor([float(c0), rp0, 0.0, 2e-3, 4e-3, math.log(250.0)],
                          dtype=solve)
    theta, c2 = _lm(resid, theta0, n_lm, solve)
    J = torch.func.jacfwd(resid)(theta).to(solve)
    noise_var = c2 / max(lc.shape[0] - 6, 1)
    cov = torch.linalg.inv(J.T @ J + 1e-9 * torch.eye(6, dtype=solve))
    sig = torch.sqrt(torch.clamp_min(torch.diagonal(cov) * noise_var, 0))
    white = theta.to(torch.float64).clone()
    white[1] = torch.clamp(white[1], 0.01, 0.5)
    white[5] = torch.clamp(torch.exp(white[5]), 30.0, 20000.0)
    sig = sig.to(torch.float64).clone()
    sig[5] = sig[5] * white[5]            # d tau = tau d log tau

    template = white_model(theta)[1].to(torch.float64)
    corr = chan / template[:, None]
    base = (torch.sum(corr * oot[:, None], dim=0)
            / torch.clamp_min(oot.sum(), 1))
    chan = corr / base[None, :]
    depth, depth_sig = _depths(chan, z, front, oot, ld, rp0, dtype, solve,
                               n_newton, n_quad)
    return Fit(white, sig, depth, depth_sig)


def _depths(lc, z, front, oot, ld, rp0, dtype, solve, n_newton, n_quad):
    """Per-channel Newton steps on chi^2 (the Hessian is diagonal), then
    the depth's error: curvature, the out-of-transit normalisation and the
    Pont red-noise factor."""
    n_exp, n_chan = lc.shape
    # A low-precision control keeps the model's values in ``dtype`` and
    # takes their derivatives in ``solve``: in bfloat16 the limb's bound
    # 1 - 1e-7 on arccos's argument rounds to 1, where its derivative is
    # infinite.
    exact = dtype == solve

    def model(rp):
        f = transit_flux(z[:, None].to(solve), rp[None, :],
                         ld[None, :].to(solve), n_quad)
        out = 1 - (1 - f) * front[:, None].to(solve)
        if exact:
            return out
        return out + (out.to(dtype).to(solve) - out).detach()

    def chi2(rp):
        return torch.sum((model(rp) - lc.to(solve)) ** 2, dim=0)

    def grad_curv(rp):
        g = torch.func.jacfwd(lambda r: chi2(r).sum())(rp)
        h = torch.diagonal(torch.func.jacfwd(
            torch.func.jacfwd(lambda r: chi2(r).sum()))(rp))
        return g, h

    rp = torch.full((n_chan,), rp0, dtype=solve)
    for _ in range(n_newton):
        g, h = grad_curv(rp)
        rp = torch.clamp(rp - g / torch.where(torch.abs(h) > 1e-12, h, 1e-12),
                         0.01, 0.5)
    lcs = lc.to(solve)
    resid = model(rp) - lcs
    noise_var = torch.sum(resid ** 2, dim=0) / max(n_exp - 1.0, 1.0)
    h = torch.clamp_min(grad_curv(rp)[1], 1e-12)
    var = 2 * noise_var / h
    mprime = torch.diagonal(torch.func.jacfwd(model)(rp), dim1=1, dim2=2)
    drp = 2 * torch.sum(mprime * lcs, dim=0) / h
    var = var + drp ** 2 * noise_var / max(float(oot.sum()), 1.0)
    sigma = torch.sqrt(var) * _beta_red(resid.T, max(n_exp // 8, 2))
    return rp.to(torch.float64), sigma.to(torch.float64)


def _beta_red(resid, n_bin: int):
    """Pont et al. (2006): the scatter of bin means of ``n_bin`` points
    over its white-noise expectation, floored at 1."""
    n = resid.shape[-1]
    nb = n // n_bin
    bmean = resid[..., : nb * n_bin].reshape(resid.shape[:-1] + (nb, n_bin)
                                            ).mean(dim=-1)
    var_b = torch.sum((bmean - bmean.mean(dim=-1, keepdim=True)) ** 2,
                      dim=-1) / max(nb - 1, 1)
    expect = (torch.sum(resid ** 2, dim=-1) / max(n - 1.0, 1.0)) / n_bin
    return torch.sqrt(torch.clamp_min(var_b / torch.clamp_min(expect, 1e-30),
                                      1.0))
