"""The port's deterministic physics against the JAX package, on identical
inputs made with numpy from a seed. Both sides compute in float32; the
tolerances below cover the two frameworks' different transcendental
implementations and summation orders (ulps of float32), and are stated
per function."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu import calibration as cal_j
from wayne_tpu.ops import dispersion as disp_j
from wayne_tpu.ops import kepler as kep_j
from wayne_tpu.ops import psf as psf_j
from wayne_tpu.ops import transit as tr_j
from wayne_tpu import trends as trends_j
from wayne_tpu_torch import calibration as cal_t
from wayne_tpu_torch.convert import numpy_leaves, tables_from_numpy
from wayne_tpu_torch.ops import dispersion as disp_t
from wayne_tpu_torch.ops import kepler as kep_t
from wayne_tpu_torch.ops import psf as psf_t
from wayne_tpu_torch.ops import transit as tr_t
from wayne_tpu_torch import trends as trends_t

torch.set_num_threads(1)

T = torch.as_tensor
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=2.0 * 3600.0, sma_rs=4.855,
             inc_rad=np.deg2rad(82.1), ecc=0.05, omega_rad=1.2)


def _orbits():
    return kep_j.OrbitParams.create(**ORBIT), kep_t.OrbitParams.create(**ORBIT)


def _times():
    # the whole transit (ingress, flat bottom, egress) and out of transit
    return np.linspace(0.0, 4.0 * 3600.0, 97).astype(np.float32)


def test_projected_separation():
    oj, ot = _orbits()
    t = _times()
    zj, fj = kep_j.projected_separation(jnp.asarray(t), oj)
    zt, ft = kep_t.projected_separation(T(t), ot)
    # stellar radii ~ 0..5: float32 Kepler solve, 1e-5 relative
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("nl", [12, 64])   # direct path / 16-point rp grid
def test_transit_light_curve(nl):
    rng = np.random.RandomState(4)
    rp = (0.1595 + 0.003 * rng.standard_normal(nl)).astype(np.float32)
    ld = np.asarray([0.65, -0.25, 0.45, -0.2], np.float32)
    oj, ot = _orbits()
    t = _times()
    fj = tr_j.transit_light_curve(jnp.asarray(t), oj, jnp.asarray(rp),
                                  jnp.asarray(ld), 64)
    ft = tr_t.transit_light_curve(T(t), ot, T(rp), T(ld), 64)
    assert ft.shape == (t.size, nl)
    # relative flux ~1 with ~2.5% depth: float32 rounding of the
    # quadrature terms, 2e-6 absolute
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=2e-6)
    assert float(ft.min()) < 0.98                    # the transit is in it


def test_transit_light_curve_per_channel_ld():
    rng = np.random.RandomState(5)
    nl = 8
    rp = np.full(nl, 0.15, np.float32)
    ld = (np.asarray([0.65, -0.25, 0.45, -0.2])
          + 0.05 * rng.standard_normal((nl, 4))).astype(np.float32)
    oj, ot = _orbits()
    t = _times()
    fj = tr_j.transit_light_curve(jnp.asarray(t), oj, jnp.asarray(rp),
                                  jnp.asarray(ld), 32)
    ft = tr_t.transit_light_curve(T(t), ot, T(rp), T(ld), 32)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def tables():
    kw = dict(subarray=64, n_lambda=32, samp_seq="SPARS10", nsamp=3)
    tj = cal_j.synthetic_tables("G141", **kw)
    return tj, cal_t.synthetic_tables("G141", **kw)


def _assert_tables_equal(tj, tt):
    lj, lt = numpy_leaves(tj), numpy_leaves(tt)
    assert lj.keys() == lt.keys()
    for k in lj:
        if lj[k] is None:
            assert lt[k] is None, k
            continue
        # both sides round the same float64 NumPy values to float32
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


def test_synthetic_tables_leaf_by_leaf():
    kw = dict(subarray=64, n_lambda=32, nsamp=4, dead_frac=0.01, n_blobs=2,
              rts_frac=0.01)
    for grism in ("G141", "G102"):
        _assert_tables_equal(cal_j.synthetic_tables(grism, **kw),
                             cal_t.synthetic_tables(grism, **kw))


def test_imaging_tables_leaf_by_leaf(tables):
    tj, tt = tables
    _assert_tables_equal(cal_j.imaging_tables(tj, "F140W", nsamp=4),
                         cal_t.imaging_tables(tt, "F140W", nsamp=4))


def test_tables_from_numpy_round_trip(tables):
    tj, _ = tables
    _assert_tables_equal(tj, tables_from_numpy(numpy_leaves(tj), "cpu"))


def test_quadrant_map():
    for s in (64, 512):
        np.testing.assert_array_equal(cal_t.quadrant_map(s).numpy(),
                                      np.asarray(cal_j.quadrant_map(s)))
    corner = (400.0, 500.0)
    np.testing.assert_array_equal(
        cal_t.quadrant_map(256, corner).numpy(),
        np.asarray(cal_j.quadrant_map(256, corner)))


@pytest.mark.parametrize("x_ref,y_ref", [(30.0, 40.0), (10.5, 50.25)])
def test_dispersion_geometry(tables, x_ref, y_ref):
    tj, tt = tables
    S = 64
    pj = disp_j.trace_params(tj, jnp.float32(x_ref), jnp.float32(y_ref))
    pt = disp_t.trace_params(tt, T(x_ref), T(y_ref))
    xj = disp_j.wl_to_x(tj.wl_edges, pj)
    xt = disp_t.wl_to_x(tt.wl_edges, pt)
    # pixel coordinates ~0..200: float32 polynomial, 1e-5 px
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5)
    xc = disp_t.wl_to_x(tt.wl_centers, pt)
    np.testing.assert_allclose(
        disp_t.trace_y(xc, pt).numpy(),
        np.asarray(disp_j.trace_y(disp_j.wl_to_x(tj.wl_centers, pj), pj)),
        atol=1e-5)
    # deposit fractions in [0, 1]: 1e-5 absolute
    np.testing.assert_allclose(
        disp_t.x_deposit_matrix(xt, S).numpy(),
        np.asarray(disp_j.x_deposit_matrix(xj, S)), atol=1e-5)
    np.testing.assert_allclose(
        disp_t.x_deposit_matrix_gaussian(xt, S, tt.psf_sigma).numpy(),
        np.asarray(disp_j.x_deposit_matrix_gaussian(xj, S, tj.psf_sigma)),
        atol=1e-5)
    # the flat ~1 +- few %: 1e-6 absolute
    np.testing.assert_allclose(disp_t.flat_plane(tt, pt).numpy(),
                               np.asarray(disp_j.flat_plane(tj, pj)),
                               atol=1e-6)


def test_undispersed_deposit_matches(tables):
    """The imaging tables' degenerate bins deposit as point sources."""
    tj, tt = tables
    ij = cal_j.imaging_tables(tj)
    it = cal_t.imaging_tables(tt)
    pj = disp_j.trace_params(ij, jnp.float32(30.0), jnp.float32(40.0))
    pt = disp_t.trace_params(it, T(30.0), T(40.0))
    xj = disp_j.wl_to_x(ij.wl_edges, pj)
    xt = disp_t.wl_to_x(it.wl_edges, pt)
    np.testing.assert_allclose(
        disp_t.x_deposit_matrix(xt, 64).numpy(),
        np.asarray(disp_j.x_deposit_matrix(xj, 64)), atol=1e-6)


def test_pixel_fractions():
    rng = np.random.RandomState(2)
    nl, w = 16, 24
    y_edges = (np.arange(w + 1) - 0.5 + 40.0).astype(np.float32)
    c0 = rng.uniform(45, 55, nl).astype(np.float32)
    # both Simpson (|du| < 0.3) and exact-antiderivative branches
    c1 = (c0 + np.r_[rng.uniform(0, 0.1, nl // 2),
                     rng.uniform(1, 8, nl - nl // 2)]).astype(np.float32)
    sigma = rng.uniform(0.4, 0.8, nl).astype(np.float32)
    eb = np.ascontiguousarray(np.broadcast_to(y_edges, (nl, w + 1)))
    # fractions in [0, 1]: 2e-6 absolute
    np.testing.assert_allclose(
        psf_t.pixel_fractions_static(T(eb), T(c0), T(sigma)).numpy(),
        np.asarray(psf_j.pixel_fractions_static(
            jnp.asarray(eb), jnp.asarray(c0), jnp.asarray(sigma))), atol=2e-6)
    np.testing.assert_allclose(
        psf_t.pixel_fractions_moving(T(eb), T(c0), T(c1), T(sigma)).numpy(),
        np.asarray(psf_j.pixel_fractions_moving(
            jnp.asarray(eb), jnp.asarray(c0), jnp.asarray(c1),
            jnp.asarray(sigma))), atol=2e-6)


def test_trend_factors():
    kw = dict(ssv_amp=0.015, ssv_period_s=0.7, ssv_phase=1.3,
              visit_slope_per_s=0.01 / 86400.0, hook_amp=0.003,
              hook_tau_s=300.0, hook_orbit1_scale=2.0)
    pj = trends_j.TrendParams.create(**kw)
    pt = trends_t.TrendParams.create(**kw)
    ta = np.linspace(0.0, 100.0, 41).astype(np.float32)
    tb = ta + np.float32(0.99)
    # multipliers ~1 +- 1.5%: float32 cos/exp, 1e-6 absolute
    np.testing.assert_allclose(
        trends_t.ssv_mean_factor(T(ta), T(tb), pt).numpy(),
        np.asarray(trends_j.ssv_mean_factor(jnp.asarray(ta), jnp.asarray(tb),
                                            pj)), atol=1e-6)
    tv = ta + np.float32(3000.0)
    for first in (0.0, 1.0):
        np.testing.assert_allclose(
            trends_t.visit_trend_factor(T(tv), T(ta), T(first), pt).numpy(),
            np.asarray(trends_j.visit_trend_factor(
                jnp.asarray(tv), jnp.asarray(ta), jnp.float32(first), pj)),
            atol=1e-6)


def test_batched_trends_broadcast_per_exposure():
    """A batched TrendParams (B,) applies each exposure's own phase."""
    phases = np.asarray([0.0, 1.0, 2.5], np.float32)
    pt = dataclasses.replace(trends_t.TrendParams.create(),
                             ssv_phase=T(phases))
    ta = torch.linspace(0.0, 5.0, 6).expand(3, 6)
    got = trends_t.ssv_mean_factor(ta, ta + 0.5, pt)
    for i, ph in enumerate(phases):
        pj = trends_j.TrendParams.create(ssv_phase=float(ph))
        want = trends_j.ssv_mean_factor(jnp.asarray(ta[i].numpy()),
                                        jnp.asarray((ta[i] + 0.5).numpy()), pj)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=1e-6)
