"""The port's background and linear science fits (wayne_tpu_torch.reduction:
fit_sky_model, fit_eclipse_depths, fit_phase_curve) against the JAX
package's on the same NumPy inputs, made from a seed.

Bars: sky weights rtol 1e-5 and the model within 1e-5 of its scale; Fp/Fs
|d| <= max(1e-5, 0.01 sigma), sigma rtol 1e-3; the phase fit's fp, A and
offset within 0.1 sigma or the coefficients' float32 floor, fp_sigma and
chi2 rtol 1e-3, amp_sigma within 1e-3 + 0.2 sigma_fp / |fp| relative (see
_assert_phase).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import reduction as red_j
from wayne_tpu.ops.kepler import OrbitParams as OrbitJ
from wayne_tpu.ops.kepler import orbital_phase_angle as phase_j
from wayne_tpu.ops.kepler import projected_separation as sep_j
from wayne_tpu.ops.transit import eclipse_visibility as vis_j
from wayne_tpu.ops.transit import transit_depth_curve as tdc_j
from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams

torch.set_num_threads(1)

PERIOD_S = 0.813475 * 86400.0
ORBIT = dict(period_s=PERIOD_S, t0_s=7200.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = np.array([0.65, -0.25, 0.45, -0.2], np.float32)
RP = 0.1595


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _orbits():
    return OrbitJ.create(**ORBIT), OrbitParams.create(**ORBIT)


# ---------------------------------------------------------------------------
# fit_sky_model
# ---------------------------------------------------------------------------

def _sky_inputs(seed, S=64, n_exp=5):
    """Net frames (n_exp, S, S): per-exposure weights of the four
    component frames run_reduce --sky-fit fits (constant, the master sky
    and the He airglow frames less 1, the dark map; the synthetic
    calibration's), a bright trace in rows S/3..S/2, read noise and a few
    cosmic-ray pixels."""
    from wayne_tpu_torch.calibration import synthetic_tables

    tab = synthetic_tables("G141", subarray=S, n_lambda=32, nsamp=3)
    comps = np.stack([np.ones((S, S)), tab.sky_frame.numpy() - 1.0,
                      tab.sky_he_frame.numpy() - 1.0,
                      tab.dark_map.numpy()]).astype(np.float32)
    rng = np.random.default_rng(seed)
    w_true = np.array([20.0, 70.0, 30.0, 12.0]) * (
        1.0 + 0.1 * rng.standard_normal((n_exp, 4)))
    nets = np.einsum("ek,kij->eij", w_true, comps)
    nets[:, S // 3: S // 2, 5: S - 10] += 3.0e4
    nets += 3.0 * rng.standard_normal(nets.shape)
    hits = rng.integers(0, S, size=(n_exp, 6, 2))
    for e in range(n_exp):
        nets[e, hits[e, :, 0], hits[e, :, 1]] += 5.0e3
    mask = np.ones((S, S), np.float32)
    mask[S // 3 - 12: S // 2 + 12, :] = 0.0   # the trace and a margin
    return nets.astype(np.float32), comps, mask, w_true


def test_fit_sky_model_matches_jax():
    nets, comps, mask, w_true = _sky_inputs(5)
    w_j, model_j = red_j.fit_sky_model(jnp.asarray(nets), jnp.asarray(comps),
                                       jnp.asarray(mask))
    w_t, model_t = red.fit_sky_model(_t(nets), _t(comps), _t(mask))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)
    model_j = np.asarray(model_j)
    np.testing.assert_allclose(model_t.numpy(), model_j, rtol=0,
                               atol=1e-5 * np.abs(model_j).max())
    # the robust refit drops the cosmic rays: the weights near the truth
    np.testing.assert_allclose(w_t.numpy(), w_true, rtol=0.1, atol=1.0)


def test_fit_sky_model_refit_uses_the_masked_mean():
    """The first pass's centre is the masked MEAN residual (the JAX
    package's "MAD" is a mean absolute deviation about it): a frame whose
    sky pixels carry one large outlier moves that mean, and the port
    drops the same pixels as the JAX function does."""
    nets, comps, mask, _ = _sky_inputs(6, n_exp=2)
    nets[0, 2:4, :] += 40.0         # two contaminated sky rows
    w_j, _ = red_j.fit_sky_model(jnp.asarray(nets), jnp.asarray(comps),
                                 jnp.asarray(mask))
    w_t, _ = red.fit_sky_model(_t(nets), _t(comps), _t(mask))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)


# ---------------------------------------------------------------------------
# fit_eclipse_depths
# ---------------------------------------------------------------------------

def _eclipse_curves(seed, n_exp=60, n_chan=4, both_events=False):
    """Channel curves over the secondary eclipse (and, with
    ``both_events``, over the transit too): c (1 + fp vis) x noise."""
    orb_j, _ = _orbits()
    centre = ORBIT["t0_s"] + PERIOD_S / 2.0
    span = PERIOD_S * 0.6 if both_events else 6.0 * 3600.0
    t = np.linspace(centre - span / 2, centre + span / 2,
                    n_exp).astype(np.float32)
    if both_events:
        t = t - 0.2 * PERIOD_S
    z, front = sep_j(jnp.asarray(t), orb_j)
    vis = np.asarray(vis_j(z, front, jnp.float32(RP)))
    tr = np.asarray(1.0 - (1.0 - tdc_j(z, jnp.float32(RP),
                                       jnp.asarray(LD), 32)) * front)
    fp = np.linspace(4e-4, 1.2e-3, n_chan)
    rng = np.random.default_rng(seed)
    lc = (0.97 * tr[:, None] * (1.0 + fp[None, :] * vis[:, None])
          * (1.0 + 1e-4 * rng.standard_normal((n_exp, n_chan))))
    return lc.astype(np.float32), t, fp


@pytest.mark.parametrize("case", ["eclipse", "both_events", "weights"])
def test_fit_eclipse_depths_matches_jax(case):
    lc, t, fp_true = _eclipse_curves(7, both_events=case == "both_events")
    orb_j, orb = _orbits()
    w = None
    if case == "weights":
        w = np.ones(t.size, np.float32)
        w[[3, 17, 40]] = 0.0
        lc[[3, 17, 40]] *= 1.01             # outliers the weights skip
    want = red_j.fit_eclipse_depths(
        jnp.asarray(lc), jnp.asarray(t), orb_j, jnp.float32(RP),
        weights=None if w is None else jnp.asarray(w))
    got = red.fit_eclipse_depths(_t(lc), _t(t), orb, RP,
                                 weights=None if w is None else _t(w))
    fp_j, sig_j = (np.asarray(v) for v in want)
    fp_t, sig_t = (v.numpy() for v in got)
    assert np.all(np.abs(fp_t - fp_j) <= np.maximum(1e-5, 0.01 * sig_j))
    np.testing.assert_allclose(sig_t, sig_j, rtol=1e-3)
    assert np.all(np.abs(fp_t - fp_true) < 5.0 * sig_t)


# ---------------------------------------------------------------------------
# fit_phase_curve
# ---------------------------------------------------------------------------

def _phase_curves(seed, t, fp, amp, off, noise=2e-4, scale=1.0):
    orb_j, _ = _orbits()
    z, front = sep_j(jnp.asarray(t), orb_j)
    vis = np.asarray(vis_j(z, front, jnp.float32(RP)))
    phi = np.asarray(phase_j(jnp.asarray(t), orb_j))
    fp = np.atleast_1d(fp)
    mod = 1.0 - amp * 0.5 * (1.0 - np.cos(phi + off))
    rng = np.random.default_rng(seed)
    lc = scale * (1.0 + fp[None, :] * (mod * vis)[:, None]
                  + noise * rng.standard_normal((t.size, fp.size)))
    return lc.astype(np.float32)


def _assert_phase(got, want):
    """fp, A and the offset within 0.1 of their sigmas (the offset's:
    amp_sigma / amp) or the float32 floor of the harmonic coefficients
    (1e-5, the depth fits' floor: fp 1e-5, A 3e-5 / |fp|, the offset
    2e-5 / (A |fp|)), whichever is larger; fp_sigma and chi2 rtol 1e-3;
    amp_sigma within 1e-3 + 0.2 sigma_fp / |fp| relative (amp_sigma ~
    1/fp^2 moves by twice fp's relative shift). The packages'
    separations, visibilities and phase angles round 1 ulp apart (the
    card's transcendentals a few), and the near-collinear [1, vis]
    columns of the 5x5 solve amplify that to ~0.1 sigma at high S/N."""
    g = {k: np.atleast_1d(getattr(got, k).numpy()) for k in
         ("fp", "fp_sigma", "amp", "amp_sigma", "offset_rad", "slope",
          "chi2")}
    w = {k: np.atleast_1d(np.asarray(getattr(want, k))) for k in g}
    fp = np.abs(w["fp"])
    s_off = w["amp_sigma"] / np.maximum(w["amp"], 1e-9)
    for k, bar in (("fp", np.maximum(0.1 * w["fp_sigma"], 1e-5)),
                   ("amp", np.maximum(0.1 * w["amp_sigma"], 3e-5 / fp)),
                   ("offset_rad", np.maximum(0.1 * s_off,
                                             2e-5 / (w["amp"] * fp)))):
        assert np.all(np.abs(g[k] - w[k]) <= bar), (k, g[k], w[k], bar)
    np.testing.assert_allclose(g["slope"], w["slope"], rtol=0, atol=1e-5)
    for k in ("fp_sigma", "chi2"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
    rel = np.abs(g["amp_sigma"] / w["amp_sigma"] - 1.0)
    assert np.all(rel <= 1e-3 + 0.2 * w["fp_sigma"] / np.abs(w["fp"])), rel


@pytest.mark.parametrize("shape", ["white", "channels"])
def test_fit_phase_curve_matches_jax(shape):
    t = np.linspace(0.0, PERIOD_S, 240).astype(np.float32)
    fp = 1.5e-3 if shape == "white" else [1.2e-3, 1.5e-3, 2.0e-3]
    lc = _phase_curves(8, t, fp, 0.6, 0.3, scale=0.37)
    if shape == "white":
        lc = lc[:, 0]
    orb_j, orb = _orbits()
    want = red_j.fit_phase_curve(jnp.asarray(lc), jnp.asarray(t), orb_j, RP)
    got = red.fit_phase_curve(_t(lc), _t(t), orb, RP)
    assert got.fp.shape == (() if shape == "white" else (3,))
    _assert_phase(got, want)
    assert np.all(np.abs(np.atleast_1d(got.fp.numpy()) - np.asarray(fp))
                  < 5.0 * np.atleast_1d(got.fp_sigma.numpy()))


def test_fit_phase_curve_degenerate_coverage():
    """A window far from transit and eclipse (vis = 1 throughout): fp is
    unidentifiable, so the reported fp and A are clamped to their ranges
    while the delta-method sigmas of the UNCLIPPED map stay huge (the
    well-covered fit above: fp_sigma 7e-5, amp_sigma 0.03). The 5x5 solve
    is singular up to its 1e-7 ridge, so its float32 solution is rounding
    along the null direction in either package: the properties are held
    in both, the values are not compared."""
    t = np.linspace(0.2 * PERIOD_S, 0.3 * PERIOD_S, 80).astype(np.float32)
    rng = np.random.default_rng(3)
    lc = (1.0 + 2e-4 * rng.standard_normal(t.size)).astype(np.float32)
    orb_j, orb = _orbits()
    want = red_j.fit_phase_curve(jnp.asarray(lc), jnp.asarray(t), orb_j, RP)
    got = red.fit_phase_curve(_t(lc), _t(t), orb, RP)
    for fit in (got, want):
        assert -0.0501 <= float(fit.fp) <= 0.5001
        assert 0.0 <= float(fit.amp) <= 2.0001
        assert float(fit.fp_sigma) > 0.01
        assert float(fit.amp_sigma) > 0.05
