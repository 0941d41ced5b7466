"""The port's white-light systematics fits (wayne_tpu_torch.reduction:
orbit_phase, the Levenberg-Marquardt core, fit_white_ramp with every
option, ramp_detrend, fit_white_recte) against the JAX package's on the same
NumPy light curves, made from a seed.

Bars: depth |d| <= max(1e-5, 0.01 sigma); template rtol 1e-6; sigma rtol
1e-3; weights identical; the LM Jacobians within 1e-5 of each column's
largest entry, the clip bounds included (jnp.clip's derivative there is 1/2:
the port's clips are minimum(maximum(.)), not torch.clamp, whose derivative
there is 1).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import reduction as red_j
from wayne_tpu.ops.kepler import OrbitParams as OrbitJ
from wayne_tpu.ops import recte as recte_j
from wayne_tpu.ops import transit as transit_j
from wayne_tpu.ops.kepler import projected_separation as sep_j
from wayne_tpu.ops.transit import eclipse_visibility as vis_j
from wayne_tpu.ops.transit import transit_depth_curve as tdc_j
from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams

torch.set_num_threads(1)

ORBIT_S = 95.47 * 60.0                  # HST orbital period
PERIOD_S = 0.813475 * 86400.0
ORBIT = dict(period_s=PERIOD_S, t0_s=9700.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = np.array([0.65, -0.25, 0.45, -0.2], np.float32)
RP = 0.1595
NOISE = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _orbits(**kw):
    d = dict(ORBIT, **kw)
    return OrbitJ.create(**d), OrbitParams.create(**d)


def _times(n_orbits=5, per_orbit=11, cadence_s=250.0, offset_s=60.0,
           shift_s=0.0):
    """Exposure mid-times (s) of a gapped HST visit, the true orbit clocks
    and the first-orbit flags."""
    t, t_orb, first = [], [], []
    for k in range(n_orbits):
        for i in range(per_orbit):
            ti = k * ORBIT_S + offset_s + i * cadence_s
            t.append(ti + shift_s)
            t_orb.append(ti - k * ORBIT_S)
            first.append(k == 0)
    return (np.asarray(t, np.float32), np.asarray(t_orb, np.float32),
            np.asarray(first))


def _systematic(t, t_orb, first):
    """The simulator's hook x slope trend (trends.visit_trend_factor):
    0.003 hooks of tau 300 s, doubled in orbit 1, 0.01/day slope."""
    amp = 0.003 * np.where(first, 2.0, 1.0)
    return ((1.0 - 0.01 / 86400.0 * (t - t[0]))
            * (1.0 - amp * np.exp(-t_orb / 300.0)))


def _recte_systematic(t):
    """A two-trap RECTE ramp (JAX ops.recte.white_ramp at 450 e-/s, 100 s
    exposures, fills 0.3 and 0.6) x the 0.01/day slope."""
    ramp = np.asarray(recte_j.white_ramp(450.0, jnp.asarray(t - 50.0), 100.0,
                                         f0_s=0.3, f0_f=0.6))
    return (1.0 - 0.01 / 86400.0 * (t - t[0])) * ramp


def _white(seed, eclipse=False, orbit_kw=None, recte=False, **times_kw):
    """(light curve, mid-times): transit (or eclipse) x trend (the hook
    trend, or ``recte``'s) x noise."""
    t, t_orb, first = _times(**times_kw)
    orb_j, _ = _orbits(**(orbit_kw or {}))
    z, front = sep_j(jnp.asarray(t), orb_j)
    if eclipse:
        sig = 1.0 + 1.5e-3 * np.asarray(vis_j(z, front, jnp.float32(RP)))
    else:
        f = tdc_j(z, jnp.float32(RP), jnp.asarray(LD), 32)
        sig = np.asarray(1.0 - (1.0 - f) * front)
    rng = np.random.default_rng(seed)
    trend = _recte_systematic(t) if recte else _systematic(t, t_orb, first)
    lc = sig * trend * (
        1.0 + NOISE * rng.standard_normal(t.size))
    return lc.astype(np.float32), t


ECLIPSE_SHIFT = ORBIT["t0_s"] + PERIOD_S / 2.0 - 2.5 * ORBIT_S


def _both_ramp(lc, t, orbit_kw=None, **kw):
    orb_j, orb = _orbits(**(orbit_kw or {}))
    want = red_j.fit_white_ramp(jnp.asarray(lc), jnp.asarray(t), orb_j,
                                jnp.asarray(LD), 0.15, **kw)
    got = red.fit_white_ramp(_t(lc), _t(t), orb, _t(LD), 0.15, **kw)
    return got, want


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fit(got, want, template=True):
    sig = float(want.rp_sigma)
    assert abs(float(got.rp) - float(want.rp)) <= max(1e-5, 0.01 * sig), (
        float(got.rp), float(want.rp), sig)
    np.testing.assert_allclose(float(got.rp_sigma), sig, rtol=1e-3)
    if template:
        np.testing.assert_allclose(_np(got.template), _np(want.template),
                                   rtol=1e-6)


def test_orbit_phase_matches_jax():
    t, t_orb_true, first_true = _times(n_orbits=4, per_orbit=9)
    t = np.concatenate([t, t[-1:] + 900.0])   # a gap below gap_s
    got = red.orbit_phase(_t(t))
    want = red_j.orbit_phase(jnp.asarray(t))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy()[:-1], t_orb_true - 60.0,
                               atol=1e-3)
    assert got[1].numpy()[:-1].tolist() == first_true.tolist()


class _Captured(Exception):
    pass


def _residual(module, fit, *args, **kw):
    """The residual function a fit hands its first Levenberg-Marquardt
    run, captured there (the fit stops at that point)."""
    real = module._lm_minimize

    def spy(resid, theta0, n_steps, lam0=1e-3):
        raise _Captured(resid, theta0)

    module._lm_minimize = spy
    try:
        fit(*args, **kw)
    except _Captured as c:
        return c.args
    finally:
        module._lm_minimize = real
    raise AssertionError("the fit never reached _lm_minimize")


def _rp_column_x64(kind, th, J_j):
    """The rp column of the residual's Jacobian with the occultation
    integral and its derivative in float64 (the JAX package's
    ``_occulted_flux`` under ``jax.enable_x64``), the other factors (c x
    the systematic) from JAX's own c column, the clip's 1/2 at the bound."""
    lc, t = _white(11 if kind == "recte" else 12)
    orb_j, _ = _orbits()
    z, front = sep_j(jnp.asarray(t), orb_j)
    p = float(th[1])
    with jax.enable_x64(True):
        z = jnp.asarray(np.asarray(z), jnp.float64)
        ld = jnp.asarray(LD, jnp.float64)

        def occ(pp):
            return (transit_j._occulted_flux(z, jnp.full_like(z, pp), ld, 32)
                    / transit_j.claret_total_flux(ld))

        o = np.asarray(occ(jnp.float64(p)))
        d_occ = np.asarray(jax.jacfwd(occ)(jnp.float64(p)))
    front = np.asarray(front, np.float64)
    tr = 1.0 - o * front
    c_sys = float(th[0]) * np.asarray(J_j[:, 0], np.float64) / tr
    return -c_sys * front * d_occ * 0.5


def _jacobian_problem(kind):
    """(port residual, JAX residual, theta list, the columns' names): the
    residuals the fits build, on data of their own kind."""
    orb_j, orb = _orbits()
    if kind == "recte":
        lc, t = _white(11)
        args = (dict(rate_e_s=300.0, exptime_s=100.0), )
        res_t, _ = _residual(red, red.fit_white_recte, _t(lc), _t(t), orb,
                             _t(LD), 0.15, **args[0])
        res_j, _ = _residual(red_j, red_j.fit_white_recte.__wrapped__,
                             jnp.asarray(lc), jnp.asarray(t), orb_j,
                             jnp.asarray(LD), 0.15, **args[0])
        return res_t, res_j, [1.0, RP, 0.01, -1.0, 0.5, 0.3]
    eclipse = kind == "eclipse"
    lc, t = _white(12, eclipse=eclipse,
                   shift_s=ECLIPSE_SHIFT if eclipse else 0.0)
    kw = dict(eclipse=eclipse, fit_geometry=kind == "geometry")
    res_t, _ = _residual(red, red.fit_white_ramp, _t(lc), _t(t), orb,
                         _t(LD), RP, **kw)
    res_j, _ = _residual(red_j, red_j.fit_white_ramp.__wrapped__,
                         jnp.asarray(lc), jnp.asarray(t), orb_j,
                         jnp.asarray(LD), RP, **kw)
    theta = [1.0, 1.5e-3 if eclipse else RP, 0.01, 3e-3, 5e-3,
             math.log(280.0)]
    if kind == "geometry":
        theta += [40.0, 4.9, math.cos(math.radians(82.3))]
    return res_t, res_j, theta


# (fit kind, parameter index, value on a clip bound, or None for interior)
_BOUNDS = [
    ("ramp", None, None), ("ramp", 1, 0.01), ("ramp", 1, 0.5),
    ("ramp", 5, math.log(10.0)), ("ramp", 5, math.log(40000.0)),
    ("eclipse", None, None), ("eclipse", 1, -0.02), ("eclipse", 1, 0.1),
    ("geometry", None, None), ("geometry", 7, 1.5), ("geometry", 7, 50.0),
    ("geometry", 8, 0.0), ("geometry", 8, 0.6),
    ("recte", None, None), ("recte", 1, 0.01), ("recte", 1, 0.5),
    ("recte", 5, -3.0), ("recte", 5, 3.0),
]


@pytest.mark.parametrize("kind,index,value", _BOUNDS,
                         ids=[f"{k}-{i}-{v}" for k, i, v in _BOUNDS])
def test_lm_jacobian_matches_jax(kind, index, value):
    """The Jacobian of each fit's residual (torch.func.jacfwd against
    jax.jacfwd) at an interior theta and with one parameter exactly on a
    clip bound, where jnp.clip's derivative is 1/2; and the normal
    equations _lm_normal_eqs builds from it."""
    res_t, res_j, theta = _jacobian_problem(kind)
    if index is not None:
        theta[index] = value
    th = np.asarray(theta, np.float32)
    if index is not None:
        assert float(th[index]) == np.float32(value)
    J_t = torch.func.jacfwd(res_t)(_t(th))
    assert J_t.dtype == torch.float32         # float32 tangents, as JAX's
    J_t = J_t.numpy()
    J_j = np.asarray(jax.jacfwd(res_j)(jnp.asarray(th)))
    ref = J_j.astype(np.float64)
    if index == 1 and value == 0.01:
        # JAX's float32 rp column at the lower bound is 1.75e-5 of the
        # column's largest entry from its float64 evaluation, the port's
        # 2.8e-6 (ROADMAP Queue C7): hold that column to float64
        ref[:, 1] = _rp_column_x64(kind, th, J_j)
    scale = np.abs(ref).max(axis=0)
    assert (scale > 0).all() or index is not None
    gap = np.abs(J_t - ref).max(axis=0)
    assert (gap <= 1e-5 * scale + 1e-12).all(), (gap, scale)
    JTJ_t, g_t = red._lm_normal_eqs(res_t, _t(th))
    JTJ_j, g_j = red_j._lm_normal_eqs(res_j, jnp.asarray(th))
    np.testing.assert_allclose(JTJ_t.numpy(), np.asarray(JTJ_j),
                               rtol=1e-4, atol=1e-6 * float(
                                   np.abs(np.asarray(JTJ_j)).max()))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(g_j)).max()))


def test_clip_derivative_is_half_at_a_bound():
    """The port's _clip has jnp.clip's derivative at a bound, 1/2, under
    both autodiff modes; torch.clamp's is 1."""
    for x in (0.01, 0.5):
        v = torch.tensor(x)
        fwd = torch.func.jacfwd(lambda a: red._clip(a, 0.01, 0.5))(v)
        rev = torch.func.grad(lambda a: red._clip(a, 0.01, 0.5))(v)
        ref = jax.grad(lambda a: jnp.clip(a, 0.01, 0.5))(jnp.float32(x))
        assert float(fwd) == float(rev) == float(ref) == 0.5


_RAMP_CASES = {
    "plain": dict(),
    "eclipse": dict(eclipse=True),
    "fit_geometry": dict(fit_geometry=True),
    "clip_sigma": dict(clip_sigma=4.0),
}


@pytest.mark.parametrize("case", list(_RAMP_CASES))
def test_fit_white_ramp_matches_jax(case):
    kw = _RAMP_CASES[case]
    eclipse = kw.get("eclipse", False)
    orbit_kw = None
    if case == "fit_geometry":
        # data from a shifted, wider, lower-inclination ephemeris (ingress
        # in one orbit, egress in the next); the fit starts from the
        # catalogue's
        lc, t = _white(21, orbit_kw=dict(t0_s=ORBIT["t0_s"] + 90.0,
                                         sma_rs=4.855 * 1.04,
                                         inc_rad=math.radians(81.7)),
                       per_orbit=14, cadence_s=200.0)
    else:
        lc, t = _white(20, eclipse=eclipse,
                       shift_s=ECLIPSE_SHIFT if eclipse else 0.0)
    outliers = []
    if case == "clip_sigma":
        # a spot-crossing bump in transit and a baseline spike
        in_tr = np.abs(t - ORBIT["t0_s"]) < 900.0
        bump = np.flatnonzero(in_tr)[2:4]
        lc[bump] *= 1.004
        lc[5] *= 1.006
        outliers = sorted(bump.tolist() + [5])
    got, want = _both_ramp(lc, t, orbit_kw=orbit_kw, **kw)
    _assert_fit(got, want)
    np.testing.assert_array_equal(_np(got.weights), _np(want.weights))
    if case == "clip_sigma":
        assert np.flatnonzero(_np(got.weights) == 0.0).tolist() == outliers
    if case == "fit_geometry":
        np.testing.assert_allclose(float(got.t0_offset_s),
                                   float(want.t0_offset_s), atol=0.05)
        for k in ("sma_rs", "inc_rad"):
            np.testing.assert_allclose(float(getattr(got.orbit, k)),
                                       float(getattr(want.orbit, k)),
                                       rtol=1e-4)
        assert abs(float(got.t0_offset_s) - 90.0) < 30.0
    assert abs(float(got.rp) - (1.5e-3 if eclipse else RP)) < 5.0 * max(
        float(got.rp_sigma), 1e-5)


def test_fit_white_ramp_refuses_geometry_in_eclipse_mode():
    lc, t = _white(3)
    _, orb = _orbits()
    with pytest.raises(ValueError, match="transit-mode"):
        red.fit_white_ramp(_t(lc), _t(t), orb, _t(LD), 0.15, eclipse=True,
                           fit_geometry=True)


def test_ramp_detrend_matches_jax():
    lc, t = _white(30)
    rng = np.random.default_rng(31)
    chans = (lc[:, None] * (1.0 + 3e-4 * rng.standard_normal((t.size, 4)))
             ).astype(np.float32)
    got, want = _both_ramp(lc, t)
    orb_j, orb = _orbits()
    out_t = red.ramp_detrend(_t(chans), got, _t(t), orb)
    out_j = red_j.ramp_detrend(jnp.asarray(chans), want, jnp.asarray(t),
                               orb_j)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=5e-6)


def test_fit_white_recte_matches_jax():
    lc, t = _white(40, recte=True, per_orbit=10)
    orb_j, orb = _orbits()
    kw = dict(rate_e_s=450.0, exptime_s=100.0)
    want = red_j.fit_white_recte(jnp.asarray(lc), jnp.asarray(t), orb_j,
                                 jnp.asarray(LD), 0.15, **kw)
    got = red.fit_white_recte(_t(lc), _t(t), orb, _t(LD), 0.15, **kw)
    _assert_fit(got, want)
    assert abs(float(got.rp) - RP) < 5.0 * float(got.rp_sigma)
    for k in ("f0_s", "f0_f", "rate_scale", "slope_per_day"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want, k)), rtol=1e-2,
                                   atol=1e-5)
