"""The port's ensemble MCMC (wayne_tpu_torch.mcmc) against the JAX
package's (wayne_tpu.mcmc), in process, on inputs made from NumPy seeds.

The two packages draw different random numbers (JAX keys against a torch
Generator), so the samplers are held to their law, never bit for bit:
``chain_diagnostics`` and every posterior's log density are deterministic
and held to float bars; ``ensemble_sample`` to a correlated Gaussian's
mean and covariance within 5 Monte-Carlo sigmas of its ESS; each posterior
to the JAX package's on the same curve: medians within 0.25 of the
posterior half-width, half-widths within 25%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wayne_tpu.mcmc as mcmc_j
import wayne_tpu_torch.mcmc as mcmc_t
from wayne_tpu.ops.kepler import projected_separation as psep_j
from wayne_tpu.ops.transit import (
    eclipse_visibility as vis_j, transit_depth_curve as tdc_j,
)
from wayne_tpu.reduction import orbit_phase as orbit_phase_j
from wayne_tpu.reduction import ramp_transit_model as model_j
from wayne_tpu.scene import example_scene
from wayne_tpu.trends import TrendParams, visit_trend_factor
from wayne_tpu_torch.ops.kepler import OrbitParams

from tests.test_ramp_fit import _orbit_times, _white_model

torch.set_num_threads(1)

BASE = example_scene(16)
LD = np.array(BASE.ld)
TRENDS = TrendParams.create(hook_amp=0.003, hook_tau_s=300.0,
                            visit_slope_per_s=0.01 / 86400.0)


def _orbit_t(orbit_j) -> OrbitParams:
    return OrbitParams(**{f.name: torch.tensor(np.array(getattr(orbit_j,
                                                                 f.name)))
                          for f in dataclasses.fields(OrbitParams)})


def _white_curve(seed=11, orbit=None, eclipse=False):
    """A noisy white ramp x transit curve (4 orbits of 14 exposures), or
    ramp x eclipse (5 of 20, the eclipse centred), float32."""
    t, t_orb, first = _orbit_times(*((5, 20) if eclipse else (4, 14)))
    orbit = BASE.orbit if orbit is None else orbit
    rng = np.random.default_rng(seed)
    if eclipse:
        t = t + (float(orbit.t0_s) + float(orbit.period_s) / 2.0
                 - 0.5 * (t[0] + t[-1]))
        z, infr = psep_j(jnp.asarray(t), orbit)
        sys = np.asarray(visit_trend_factor(
            jnp.asarray(t), jnp.asarray(t_orb), jnp.asarray(first), TRENDS))
        lc = sys * np.asarray(1.0 + 1.5e-3 * vis_j(z, infr,
                                                   jnp.float32(0.1595)))
        sigma = 2e-4
    else:
        lc = _white_model(t, t_orb, first, TRENDS, orbit, BASE.ld, 0.1595)
        sigma = 3e-4
    lc = lc + sigma * rng.standard_normal(t.size)
    return lc.astype(np.float32), t.astype(np.float32)


def _channel_curves(seed=3, rp=(0.155, 0.158, 0.1595, 0.162)):
    t, _, _ = _orbit_times()
    rng = np.random.default_rng(seed)
    z, infr = psep_j(jnp.asarray(t), BASE.orbit)
    chans = np.stack([
        np.asarray(1.0 - (1.0 - tdc_j(z, jnp.float32(r), BASE.ld, 32))
                   * infr) + 4e-4 * rng.standard_normal(t.size)
        for r in rp], axis=1)
    return chans.astype(np.float32), t.astype(np.float32)


def _program_curves(seed=7, V=2, n_exp=24, rp=(0.158, 0.161, 0.159),
                    dt0=(0.0, 120.0), sig=4e-4):
    K = len(rp)
    t = np.broadcast_to(np.linspace(0.0, 4.0 * 3600.0, n_exp),
                        (V, n_exp)).astype(np.float32)
    rng = np.random.default_rng(seed)
    lc = np.zeros((V, n_exp, K), np.float32)
    for v in range(V):
        orb = dataclasses.replace(BASE.orbit, t0_s=BASE.orbit.t0_s + dt0[v])
        z, infr = psep_j(jnp.asarray(t[v]), orb)
        for c in range(K):
            f = tdc_j(z, jnp.float32(rp[c]), BASE.ld, 32)
            lc[v, :, c] = (np.asarray(1.0 - (1.0 - f) * infr)
                           + sig * rng.standard_normal(n_exp))
    return lc, t, np.full((V, K), sig, np.float32), np.full(V, 14.0,
                                                             np.float32)


# ---------------------------------------------------------------------------
# chain_diagnostics and ensemble_sample
# ---------------------------------------------------------------------------

def _chains(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "converged":
        return rng.standard_normal((400, 16, 3)).astype(np.float32)
    if kind == "drifting":
        return (0.1 * rng.standard_normal((400, 16, 2))
                + np.linspace(0.0, 1.0, 400)[:, None, None]).astype(
                    np.float32)
    ar = np.zeros((600, 8, 2), np.float32)        # AR(1), phi = 0.9
    eps = rng.standard_normal(ar.shape).astype(np.float32)
    for i in range(1, ar.shape[0]):
        ar[i] = 0.9 * ar[i - 1] + eps[i]
    return ar


@pytest.mark.parametrize("kind", ["converged", "drifting", "ar1"])
def test_chain_diagnostics_matches_jax(kind):
    """Split R-hat and the Geyer ESS on identical samples, rtol 1e-5
    (measured: R-hat 1.2e-7, ESS 1.6e-6 apart at most); a batch of two
    chain sets gives each set's own numbers."""
    x = _chains(kind)
    want = mcmc_j.chain_diagnostics(jnp.asarray(x))
    got = mcmc_t.chain_diagnostics(torch.from_numpy(x))
    np.testing.assert_allclose(got.rhat.numpy(), np.asarray(want.rhat),
                               rtol=1e-5)
    np.testing.assert_allclose(got.ess.numpy(), np.asarray(want.ess),
                               rtol=1e-5)
    both = mcmc_t.chain_diagnostics(torch.from_numpy(np.stack([x, x[::-1]])))
    np.testing.assert_allclose(both.ess[0].numpy(), got.ess.numpy(),
                               rtol=1e-6)
    if kind == "drifting":
        assert float(got.rhat.min()) > 1.5           # flagged


def test_ensemble_sample_recovers_correlated_gaussians():
    """Two independent ensembles in one batch, each on its own correlated
    2-D Gaussian: the kept samples' mean and covariance within 5
    Monte-Carlo sigmas of the truth (sigmas from the chain's ESS)."""
    cov = np.array([[1.0, 0.6], [0.6, 0.8]], np.float32)
    mus = np.array([[1.5, -0.5], [-2.0, 3.0]], np.float32)
    prec = torch.from_numpy(np.linalg.inv(cov))
    mu_t = torch.from_numpy(mus)

    def log_prob(x):                                  # (2, m, 2)
        d = x - mu_t[:, None, :]
        return -0.5 * torch.einsum("cmi,ij,cmj->cm", d, prec, d)

    gen = torch.Generator().manual_seed(0)
    init = mu_t[:, None, :] + 0.1 * torch.randn((2, 32, 2), generator=gen)
    chain = mcmc_t.ensemble_sample(log_prob, init, gen, 2500)
    assert chain.samples.shape == (2, 2500, 32, 2)
    post = chain.samples[:, 500:]
    ess = mcmc_t.chain_diagnostics(post).ess.numpy()      # (2, 2)
    acc = chain.acceptance.numpy()
    assert np.all((acc > 0.15) & (acc < 0.95)), acc
    for c in range(2):
        kept = post[c].reshape(-1, 2).double().numpy()
        sd = np.sqrt(np.diag(cov))
        np.testing.assert_array_less(np.abs(kept.mean(0) - mus[c]),
                                     5.0 * sd / np.sqrt(ess[c]))
        # var of a sample (co)variance: (s_ii s_jj + s_ij^2) / ESS
        emp = np.cov(kept.T)
        se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2)
                     / ess[c].min())
        np.testing.assert_array_less(np.abs(emp - cov), 5.0 * se)


def test_ensemble_sample_respects_support():
    """-inf regions are never entered and every kept log density is the
    target's at its sample."""
    def log_prob(x):
        return torch.where(torch.all(x > 0.0, dim=-1),
                           -0.5 * torch.sum(x ** 2, dim=-1), -torch.inf)

    gen = torch.Generator().manual_seed(2)
    init = torch.abs(torch.randn((3, 16, 2), generator=gen)) + 0.1
    chain = mcmc_t.ensemble_sample(log_prob, init, gen, 400, thin=4)
    assert chain.samples.shape == (3, 100, 16, 2)
    assert float(chain.samples.min()) > 0.0
    torch.testing.assert_close(chain.log_probs, log_prob(
        chain.samples.reshape(3, -1, 2)).reshape(3, 100, 16))
    with pytest.raises(ValueError, match="even"):
        mcmc_t.ensemble_sample(log_prob, init[:, :15], gen, 2)


# ---------------------------------------------------------------------------
# The posteriors' log densities, rebuilt from the JAX package's functions
# ---------------------------------------------------------------------------

def _white_lp_jax(lc, t, orbit, ld, rp_geom, fit_geometry, eclipse):
    """wayne_tpu.mcmc.sample_white_posterior's log density."""
    lc, t = jnp.asarray(lc), jnp.asarray(t)
    t_orb, first = orbit_phase_j(t, 1200.0)
    firstf = first.astype(jnp.float32)
    t_day = (t - t.mean()) / 86400.0
    z, infr = psep_j(t, orbit)
    vis = vis_j(z, infr, jnp.float32(rp_geom)) if eclipse else None
    ndim = 10 if fit_geometry else 7
    dlo, dhi = (-0.02, 0.1) if eclipse else (0.01, 0.5)
    lo = jnp.array([0.2, dlo, -1.0, -0.05, -0.05, jnp.log(30.0)]
                   + ([-1800.0, 1.5, 0.0] if fit_geometry else [])
                   + [jnp.log(1e-6)], jnp.float32)
    hi = jnp.array([5.0, dhi, 1.0, 0.05, 0.05, jnp.log(20000.0)]
                   + ([1800.0, 50.0, 0.6] if fit_geometry else [])
                   + [jnp.log(0.1)], jnp.float32)

    def lp(theta):
        inside = jnp.all((theta > lo) & (theta < hi))
        if fit_geometry:
            orb = dataclasses.replace(
                orbit, t0_s=orbit.t0_s + theta[6],
                sma_rs=jnp.clip(theta[7], 1.5, 50.0),
                inc_rad=jnp.arccos(jnp.clip(theta[8], 0.0, 0.6)))
            zz, ii = psep_j(t, orb)
        else:
            zz, ii = z, infr
        m = model_j(theta[:6], t_day, t_orb, firstf, zz, ii, ld, 32, vis)[0]
        r = (m - lc) / jnp.exp(theta[ndim - 1])
        ll = -0.5 * jnp.sum(r ** 2) - lc.shape[0] * theta[ndim - 1]
        return (jnp.where(inside, ll, -jnp.inf), ULP * jnp.sum(
            jnp.abs(r * m) / jnp.exp(theta[ndim - 1])))

    return jax.vmap(lp)


ULP = 2.0 ** -23     # float32's spacing at 1


def _close(got, want, ulp_shift):
    """A log density against the JAX package's: -inf where it is, and
    otherwise within ``ulp_shift``, the change of the log density when
    every model value moves by one float32 ulp (sum |r_i| ulp(m_i) /
    sigma_i). The two packages' float32 models of a flux near 1 round up
    to an ulp (6e-8) apart, which at sigma 3e-4 is 2e-4 of a residual, so
    a relative bar on a log density whose 0.5 chi^2 and n log sigma terms
    nearly cancel would measure rounding, not the port (measured: at most
    0.11 of ``ulp_shift``)."""
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    ok = ~np.isneginf(want)
    np.testing.assert_array_less(np.abs(got - want)[ok], ulp_shift[ok])


def _thetas(center, scale, n=64, seed=0):
    rng = np.random.default_rng(seed)
    th = center + scale * rng.standard_normal((n, len(center)))
    th[-1, 1] = 0.9                                   # outside the box
    return th.astype(np.float32)


@pytest.mark.parametrize("variant", ["plain", "fit_geometry", "eclipse"])
def test_white_log_density_matches_jax(variant):
    """At 64 thetas around the truth (one outside the prior box), within
    the log density's one-ulp shift (``_close``)."""
    geo, ecl = variant == "fit_geometry", variant == "eclipse"
    lc, t = _white_curve(eclipse=ecl)
    center = [1.0, 1.5e-3 if ecl else 0.1595, 0.01, 0.003, 0.006,
              np.log(300.0)] + ([20.0, 4.855, 0.137] if geo else []) \
        + [np.log(3e-4)]
    scale = [1e-4, 1e-4 if ecl else 1e-3, 1e-3, 2e-4, 2e-4, 0.05] \
        + ([30.0, 0.05, 5e-3] if geo else []) + [0.05]
    th = _thetas(np.asarray(center), np.asarray(scale))
    want, shift = (np.asarray(v) for v in _white_lp_jax(
        lc, t, BASE.orbit, BASE.ld, 0.1595, geo, ecl)(jnp.asarray(th)))
    lp, lo, hi = mcmc_t.white_log_prob(
        torch.from_numpy(lc), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(LD), 0.1595, fit_geometry=geo, eclipse=ecl)
    got = lp(torch.from_numpy(th)[None])[0].numpy()
    assert np.isneginf(want[-1])
    _close(got, want, shift)


def test_channel_log_density_matches_jax():
    """sample_channel_posteriors' per-channel log density (per-channel LD
    and a keep mask) at 64 thetas per channel (``_close``)."""
    chans, t = _channel_curves()
    K = chans.shape[1]
    ld_chan = np.stack([LD + 0.01 * k for k in range(K)]).astype(np.float32)
    w = np.ones(t.size, np.float32)
    w[7] = 0.0
    z, infr = psep_j(jnp.asarray(t), BASE.orbit)
    lo = jnp.array([0.2, 0.01, jnp.log(1e-6)], jnp.float32)
    hi = jnp.array([5.0, 0.5, jnp.log(0.1)], jnp.float32)

    def lp_j(theta, lc, ld_c):
        inside = jnp.all((theta > lo) & (theta < hi))
        f = tdc_j(z, theta[1], ld_c, 32)
        m = theta[0] * (1.0 - (1.0 - f) * infr)
        r = (m - lc) / jnp.exp(theta[2])
        ll = (-0.5 * jnp.sum(jnp.asarray(w) * r ** 2)
              - jnp.sum(jnp.asarray(w)) * theta[2])
        return (jnp.where(inside, ll, -jnp.inf), ULP * jnp.sum(
            jnp.asarray(w) * jnp.abs(r * m) / jnp.exp(theta[2])))

    th = np.stack([_thetas(np.array([1.0, r, np.log(4e-4)]),
                           np.array([2e-4, 1e-3, 0.05]), seed=k)
                   for k, r in enumerate((0.155, 0.158, 0.1595, 0.162))])
    want, shift = (np.asarray(v) for v in jax.vmap(jax.vmap(
        lp_j, (0, None, None)))(jnp.asarray(th), jnp.asarray(chans.T),
                                jnp.asarray(ld_chan)))
    lp, _, _ = mcmc_t.channel_log_prob(
        torch.from_numpy(chans), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(ld_chan), weights=torch.from_numpy(w))
    _close(lp(torch.from_numpy(th)).numpy(), want, shift)


def test_program_log_density_matches_jax():
    """sample_program_posterior's joint log density over (spectrum, t0
    offsets, baselines, noise scale) at 64 thetas (``_close``)."""
    lc, t, sig, n_oot = _program_curves()
    V, n_exp, K = lc.shape
    b_sig = sig / np.sqrt(n_oot)[:, None]

    def lp_j(theta):
        rp, dt0 = theta[:K], theta[K: K + V]
        b = theta[K + V: K + V + V * K].reshape(V, K)
        log_s = theta[-1]
        inside = (jnp.all((rp > 0.01) & (rp < 0.5))
                  & jnp.all(jnp.abs(dt0) < 5400.0)
                  & jnp.all(jnp.abs(b - 1.0) < 0.05) & (jnp.abs(log_s) < 2))

        def visit_ll(t_v, lc_v, sig_v, dt0_v, b_v):
            orb = dataclasses.replace(BASE.orbit,
                                      t0_s=BASE.orbit.t0_s + dt0_v)
            z, infr = psep_j(t_v, orb)
            f = jax.vmap(lambda r: tdc_j(z, r, BASE.ld, 32))(rp)
            model = (1.0 - (1.0 - f) * infr[None, :]).T * b_v[None, :]
            r = (model - lc_v) / (sig_v[None, :] * jnp.exp(log_s))
            return -0.5 * jnp.sum(r * r), ULP * jnp.sum(jnp.abs(
                r * model) / (sig_v[None, :] * jnp.exp(log_s)))

        ll, shift = jax.vmap(visit_ll)(jnp.asarray(t), jnp.asarray(lc),
                                       jnp.asarray(sig), dt0, b)
        ll = jnp.sum(ll) - (V * n_exp * K) * log_s - 0.5 * jnp.sum(
            ((b - 1.0) / jnp.asarray(b_sig)) ** 2)
        return jnp.where(inside, ll, -jnp.inf), jnp.sum(shift)

    center = np.concatenate([[0.158, 0.161, 0.159], [0.0, 120.0],
                             np.ones(V * K), [0.0]])
    scale = np.concatenate([np.full(K, 1e-3), np.full(V, 20.0),
                            np.full(V * K, 5e-5), [0.05]])
    th = _thetas(center, scale)
    th[-1, 1] = 0.6                                   # rp outside (0.01, 0.5)
    want, shift = (np.asarray(v) for v in jax.vmap(lp_j)(jnp.asarray(th)))
    lp, _ = mcmc_t.program_log_prob(
        torch.from_numpy(lc), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(LD), torch.from_numpy(sig),
        torch.from_numpy(n_oot))
    _close(lp(torch.from_numpy(th)[None])[0].numpy(), want, shift)


def test_posterior_refusals():
    """The JAX package's argument errors."""
    lc, t = _white_curve()
    args = (torch.from_numpy(lc), torch.from_numpy(t), _orbit_t(BASE.orbit),
            torch.from_numpy(LD), 0.15, 0)
    with pytest.raises(ValueError, match="transit visit"):
        mcmc_t.sample_white_posterior(*args, fit_geometry=True, eclipse=True)
    with pytest.raises(ValueError, match="burn-in"):
        mcmc_t.sample_white_posterior(*args, n_steps=10, n_burn=10)
    with pytest.raises(ValueError, match="burn-in"):
        mcmc_t.sample_channel_posteriors(
            torch.from_numpy(lc)[:, None], *args[1:], n_steps=5, n_burn=9)
