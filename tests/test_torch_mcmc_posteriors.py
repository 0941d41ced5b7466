"""The port's posteriors (wayne_tpu_torch.mcmc.sample_white_posterior,
sample_channel_posteriors, sample_program_posterior) against the JAX
package's on the same curves, in process, by their law: the two packages
draw different random numbers, so each posterior's medians must lie within
0.25 of the JAX half-width ((84th - 16th percentile) / 2) and its
half-widths within 25% of the JAX package's. Both run 16 quadrature nodes
(the samplers' ``n_quad``) to keep the file short on one core; the curves
are tests/test_torch_mcmc.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wayne_tpu.mcmc as mcmc_j
import wayne_tpu_torch.mcmc as mcmc_t

from tests.test_torch_mcmc import (
    BASE, LD, _channel_curves, _orbit_t, _program_curves, _white_curve,
)

torch.set_num_threads(1)


def _same_law(med_t, w_t, med_j, w_j):
    """Medians within 0.25 of the JAX half-width, half-widths within
    25%."""
    med_t, w_t, med_j, w_j = (np.atleast_1d(np.asarray(v, np.float64))
                              for v in (med_t, w_t, med_j, w_j))
    assert np.all(np.abs(med_t - med_j) <= 0.25 * w_j), (med_t, med_j, w_j)
    assert np.all(np.abs(w_t / w_j - 1.0) <= 0.25), (w_t, w_j)


@pytest.mark.parametrize("variant", ["plain", "fit_geometry", "eclipse"])
def test_white_posterior_matches_jax(variant):
    """sample_white_posterior on one curve in both packages (32 walkers;
    64 with the free ephemeris, whose 10-dimensional valley mixes slower).
    Measured, depth median apart in units of the half-width (half-widths
    apart): plain 0.034 (7.6%), geometry 0.093 (5.0%), eclipse 0.081
    (6.0%); the noise scale within 0.08 (1.3%)."""
    geo, ecl = variant == "fit_geometry", variant == "eclipse"
    lc, t = _white_curve(seed={"plain": 11, "fit_geometry": 19,
                               "eclipse": 23}[variant], eclipse=ecl)
    kw = dict(n_steps=1200, n_burn=400 if geo else 500,
              n_walkers=64 if geo else 32, fit_geometry=geo, eclipse=ecl,
              n_quad=16)
    rp0 = 0.1595 if ecl else 0.15
    pj = mcmc_j.sample_white_posterior(
        jnp.asarray(lc), jnp.asarray(t), BASE.orbit, BASE.ld, rp0,
        jax.random.PRNGKey(4), **kw)
    pt = mcmc_t.sample_white_posterior(
        torch.from_numpy(lc), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(LD), rp0, 4, **kw)
    ndim = 10 if geo else 7
    assert pt.samples.shape == ((kw["n_steps"] - kw["n_burn"])
                                * kw["n_walkers"], ndim)
    assert pt.rhat.shape == pt.ess.shape == (ndim,)
    assert 0.1 < float(pt.acceptance) < 0.95
    _same_law(pt.rp_median, 0.5 * (pt.rp_minus + pt.rp_plus),
              pj.rp_median, 0.5 * (pj.rp_minus + pj.rp_plus))
    # the free noise scale too
    _same_law(np.median(pt.samples[:, -1].numpy()),
              pt.samples[:, -1].numpy().std(),
              np.median(np.asarray(pj.samples[:, -1])),
              np.asarray(pj.samples[:, -1]).std())


def test_channel_posteriors_match_jax():
    """Every channel at once (the channels are the ensemble batch), with a
    keep mask: each channel's median and half-width against the JAX
    package's vmapped sampler (measured: at most 0.084 of the half-width
    apart, half-widths 8.8%), and the per-channel R-hat / ESS shapes."""
    chans, t = _channel_curves()
    w = np.ones(t.size, np.float32)
    w[10] = 0.0
    kw = dict(n_steps=1200, n_burn=400, weights=w, n_quad=16)
    pj = mcmc_j.sample_channel_posteriors(
        jnp.asarray(chans), jnp.asarray(t), BASE.orbit, BASE.ld, 0.158,
        jax.random.PRNGKey(7), **kw)
    pt = mcmc_t.sample_channel_posteriors(
        torch.from_numpy(chans), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(LD), 0.158, 7,
        **dict(kw, weights=torch.from_numpy(w)))
    assert pt.rhat.shape == pt.ess.shape == pt.acceptance.shape == (4,)
    _same_law(pt.rp_median.numpy(), 0.5 * (pt.rp_minus + pt.rp_plus).numpy(),
              np.asarray(pj.rp_median),
              0.5 * (np.asarray(pj.rp_minus) + np.asarray(pj.rp_plus)))


def test_program_posterior_matches_jax():
    """The joint program posterior (2 visits x 3 channels, visit 2's
    transit 120 s late): the shared spectrum's and the t0 offsets' medians
    and half-widths against the JAX package's (measured: the spectrum 0.14
    of the half-width apart at most, half-widths 2.1%; the offsets 0.071,
    9.5%)."""
    lc, t, sig, n_oot = _program_curves()
    rp0, dt00 = np.array([0.158, 0.161, 0.159]), np.array([0.0, 118.0])
    kw = dict(n_steps=1200, n_burn=400, n_quad=16)
    pj = mcmc_j.sample_program_posterior(
        jnp.asarray(lc), jnp.asarray(t), BASE.orbit, BASE.ld,
        jnp.asarray(rp0, jnp.float32), jnp.asarray(dt00, jnp.float32),
        jnp.asarray(sig), jnp.asarray(n_oot), jax.random.PRNGKey(11), **kw)
    pt = mcmc_t.sample_program_posterior(
        torch.from_numpy(lc), torch.from_numpy(t), _orbit_t(BASE.orbit),
        torch.from_numpy(LD), torch.from_numpy(rp0.astype(np.float32)),
        torch.from_numpy(dt00.astype(np.float32)), torch.from_numpy(sig),
        torch.from_numpy(n_oot), 11, **kw)
    for name in ("rp", "t0"):
        m = "rp_median" if name == "rp" else "t0_median_s"
        lo_, hi_ = (("rp_minus", "rp_plus") if name == "rp"
                    else ("t0_minus_s", "t0_plus_s"))
        _same_law(getattr(pt, m).numpy(),
                  0.5 * (getattr(pt, lo_) + getattr(pt, hi_)).numpy(),
                  np.asarray(getattr(pj, m)),
                  0.5 * (np.asarray(getattr(pj, lo_))
                         + np.asarray(getattr(pj, hi_))))
    assert pt.samples.shape[1] == 3 + 2 + 6 + 1
