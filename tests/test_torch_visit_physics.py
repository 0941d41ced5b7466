"""The port's visit-level physics against the JAX package, function by
function, on identical inputs made with numpy from a seed: the eclipse and
phase-curve light, the sky-plane geometry, starspots, persistence, RECTE
and the noise-free fluence stack. Tolerances: rtol 1e-5 / atol 2e-6
(float32 rounding of the two frameworks' transcendentals and sums), as
tests/test_torch_physics.py states them, unless a function says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.config import PersistenceConfig as PersistenceConfig_j
from wayne_tpu.config import RecteConfig as RecteConfig_j
from wayne_tpu.config import config_from_dict as config_from_dict_j
from wayne_tpu.observation import Observation as Observation_j
from wayne_tpu.ops import kepler as kep_j
from wayne_tpu.ops import persistence as pers_j
from wayne_tpu.ops import recte as recte_j
from wayne_tpu.ops import spots as spots_j
from wayne_tpu.ops import transit as tr_j
from wayne_tpu.ops.visit import visit_fluence_stack as fluence_j
from wayne_tpu_torch.config import PersistenceConfig, RecteConfig
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops import kepler as kep_t
from wayne_tpu_torch.ops import persistence as pers_t
from wayne_tpu_torch.ops import recte as recte_t
from wayne_tpu_torch.ops import spots as spots_t
from wayne_tpu_torch.ops import transit as tr_t
from wayne_tpu_torch.ops.visit import visit_fluence_stack
from wayne_tpu_torch.config import ExposureStatic, NoiseFlags

torch.set_num_threads(1)

T = torch.as_tensor
TOL = dict(rtol=1e-5, atol=2e-6)
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=2.0 * 3600.0, sma_rs=4.855,
             inc_rad=np.deg2rad(82.1), ecc=0.05, omega_rad=1.2)


def _orbits():
    return kep_j.OrbitParams.create(**ORBIT), kep_t.OrbitParams.create(**ORBIT)


def _times(span_h=4.0, n=97, t0=0.0):
    return (t0 + np.linspace(0.0, span_h * 3600.0, n)).astype(np.float32)


def _half_orbit_times():
    # transit at 2 h, secondary eclipse half a period later: cover both
    p = ORBIT["period_s"]
    return np.concatenate([_times(), _times(t0=2.0 * 3600.0 + 0.5 * p
                                            - 2.0 * 3600.0)])


def test_orbital_phase_angle_and_sky_position():
    oj, ot = _orbits()
    t = _half_orbit_times()
    np.testing.assert_allclose(
        kep_t.orbital_phase_angle(T(t), ot).numpy(),
        np.asarray(kep_j.orbital_phase_angle(jnp.asarray(t), oj)), **TOL)
    xj, yj, fj = kep_j.sky_position(jnp.asarray(t), oj)
    xt, yt, ft = kep_t.sky_position(T(t), ot)
    # stellar radii ~0..5: the Kepler solve's 1e-5 relative
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    # the resolved vector has the projected separation's length
    z, _ = kep_t.projected_separation(T(t), ot)
    np.testing.assert_allclose(torch.hypot(xt, yt).numpy(), z.numpy(),
                               rtol=1e-5)


def test_batched_sky_position_is_per_exposure():
    """Batched orbit leaves (B,) against times (B, NT): each row is the
    unbatched call on its own orbit."""
    ot = kep_t.OrbitParams.create(**ORBIT)
    ob = kep_t.OrbitParams(**{k: v.expand(2).clone() for k, v in
                              dataclasses.asdict(ot).items()})
    ob.omega_rad = T([1.2, 1.5])
    t = torch.stack([T(_times()), T(_times()) + 100.0])
    xb, yb, _ = kep_t.sky_position(t, ob)
    for i in range(2):
        oi = dataclasses.replace(ot, omega_rad=ob.omega_rad[i])
        xi, yi, _ = kep_t.sky_position(t[i], oi)
        assert torch.equal(xb[i], xi) and torch.equal(yb[i], yi)


def test_eclipse_visibility():
    rng = np.random.RandomState(11)
    z = rng.uniform(0.0, 1.4, 200).astype(np.float32)
    p = rng.uniform(0.05, 0.3, 200).astype(np.float32)
    front = (rng.uniform(size=200) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tr_t.uniform_disk_hidden_frac(T(z), T(p)).numpy(),
        np.asarray(tr_j.uniform_disk_hidden_frac(jnp.asarray(z),
                                                 jnp.asarray(p))), **TOL)
    np.testing.assert_allclose(
        tr_t.eclipse_visibility(T(z), T(front), T(p)).numpy(),
        np.asarray(tr_j.eclipse_visibility(jnp.asarray(z),
                                           jnp.asarray(front),
                                           jnp.asarray(p))), **TOL)


@pytest.mark.parametrize("amp,offset", [(0.0, 0.0), (0.9, 0.21)],
                         ids=["eclipse", "phase_curve"])
@pytest.mark.parametrize("nl", [12, 64])   # direct path / 16-point rp grid
def test_eclipse_and_phase_curve_light_curve(nl, amp, offset):
    rng = np.random.RandomState(4)
    rp = (0.1595 + 0.003 * rng.standard_normal(nl)).astype(np.float32)
    fp = (5e-4 + 1e-4 * rng.standard_normal(nl)).astype(np.float32)
    ld = np.asarray([0.65, -0.25, 0.45, -0.2], np.float32)
    oj, ot = _orbits()
    t = _half_orbit_times()
    fj = tr_j.transit_light_curve(jnp.asarray(t), oj, jnp.asarray(rp),
                                  jnp.asarray(ld), 64,
                                  fp_over_fs=jnp.asarray(fp),
                                  phase_amp=jnp.float32(amp),
                                  phase_offset_rad=jnp.float32(offset))
    ft = tr_t.transit_light_curve(T(t), ot, T(rp), T(ld), 64,
                                  fp_over_fs=T(fp), phase_amp=T(amp),
                                  phase_offset_rad=T(offset))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    assert float(ft.max()) > 1.0 + 3e-4          # the planet's light is in it
    assert float(ft.min()) < 0.98                # and the transit


def test_batched_phase_curve_takes_each_exposures_amplitude():
    oj, ot = _orbits()
    t = T(_half_orbit_times())
    rp, fp = torch.full((8,), 0.16), torch.full((8,), 5e-4)
    ld = T([0.65, -0.25, 0.45, -0.2])
    amps = T([0.0, 0.9])
    got = tr_t.transit_light_curve(
        t.expand(2, -1), kep_t.OrbitParams(**{
            k: v.expand(2) for k, v in dataclasses.asdict(ot).items()}),
        rp.expand(2, -1), ld.expand(2, -1), 64, fp_over_fs=fp.expand(2, -1),
        phase_amp=amps, phase_offset_rad=T([0.0, 0.0]))
    for i in range(2):
        want = tr_t.transit_light_curve(t, ot, rp, ld, 64, fp_over_fs=fp,
                                        phase_amp=amps[i])
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)


def _spots(nl, rng, rot=2.0 * np.pi / (15.6 * 86400.0)):
    lat = np.deg2rad([41.8, -20.0]).astype(np.float32)
    lon = np.deg2rad([-1.0, -35.0]).astype(np.float32)
    rad = np.asarray([0.10, 0.06], np.float32)
    con = rng.uniform(0.5, 0.9, (2, nl)).astype(np.float32)
    return (spots_j.SpotParams.create(lat, lon, rad, con, rot),
            spots_t.SpotParams.create(lat, lon, rad, con, rot))


@pytest.mark.parametrize("per_channel_ld", [False, True])
def test_spot_delta(per_channel_ld):
    nl = 12
    rng = np.random.RandomState(8)
    rp = (0.16 + 0.003 * rng.standard_normal(nl)).astype(np.float32)
    ld = np.asarray([0.65, -0.25, 0.45, -0.2], np.float32)
    if per_channel_ld:
        ld = (ld + 0.05 * rng.standard_normal((nl, 4))).astype(np.float32)
    sj, st = _spots(nl, rng)
    oj, ot = _orbits()
    # a circular orbit whose chord crosses the first spot near mid-transit
    oj = dataclasses.replace(oj, ecc=jnp.float32(0.0),
                             omega_rad=jnp.float32(np.pi / 2))
    ot = dataclasses.replace(ot, ecc=T(0.0), omega_rad=T(np.pi / 2))
    t = _times()
    dj = spots_j.spot_delta(jnp.asarray(t), oj, jnp.asarray(rp),
                            jnp.asarray(ld), sj)
    dt = spots_t.spot_delta(T(t), ot, T(rp), T(ld), st)
    assert dt.shape == (t.size, nl)
    # deltas ~1e-3 of the flux: 2e-8 absolute is float32 rounding there
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=2e-8)
    assert float(dt.min()) < -1e-4               # the unocculted dimming
    assert float(dt.max() - dt.min()) > 1e-4     # and the crossing bump


def test_circle_overlap_area_regimes():
    rng = np.random.RandomState(3)
    d = rng.uniform(0.0, 0.5, 300).astype(np.float32)
    r1 = rng.uniform(0.02, 0.2, 300).astype(np.float32)
    r2 = rng.uniform(0.02, 0.2, 300).astype(np.float32)
    np.testing.assert_allclose(
        spots_t.circle_overlap_area(T(d), T(r1), T(r2)).numpy(),
        np.asarray(spots_j.circle_overlap_area(
            jnp.asarray(d), jnp.asarray(r1), jnp.asarray(r2))),
        rtol=1e-5, atol=1e-7)


def _stack(n=6, s=24, seed=5):
    rng = np.random.RandomState(seed)
    # fluences across the sigmoid's knee (0.95 * 80000 e- by default)
    f = rng.uniform(0.0, 1.3e5, (n, s, s)).astype(np.float32)
    starts = (np.arange(n) * 150.0 + rng.uniform(0, 20, n)).astype(np.float32)
    return f, starts


@pytest.mark.parametrize("gamma", [1.0, 1.3])
def test_persistence_rates(gamma):
    f, starts = _stack()
    kw = dict(exptime_s=103.0, amplitude_e_s=0.3, x0_e=76000.0,
              dx_e=18000.0, gamma=gamma, t_min_s=1.0)
    want = pers_j.persistence_rates(jnp.asarray(f), jnp.asarray(starts),
                                    **kw)
    got = pers_t.persistence_rates(T(f), T(starts), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0].abs().max()) == 0.0        # nothing before the first
    assert float(got[-1].max()) > 0.01


def test_decay_weights_with_extra_stimuli():
    _, starts = _stack()
    ends = np.asarray([-600.0, -60.0], np.float32)
    np.testing.assert_allclose(
        pers_t.decay_weights(T(starts), 103.0, 1.0, 1.0,
                             T(np.r_[ends, starts + 103.0])).numpy(),
        np.asarray(pers_j.decay_weights(
            jnp.asarray(starts), 103.0, 1.0, 1.0,
            jnp.asarray(np.r_[ends, starts + 103.0]))), **TOL)


def test_trap_deltas_and_white_ramp():
    f, starts = _stack()
    rates = f / 103.0
    p = recte_j.RecteParams()
    dj, sj, fj = recte_j.trap_deltas(jnp.asarray(rates), jnp.asarray(starts),
                                     103.0, params=p, f0_s=0.1, f0_f=0.05)
    dt, st, ft = recte_t.trap_deltas(T(rates), T(starts), 103.0,
                                     params=recte_t.RecteParams(),
                                     f0_s=0.1, f0_f=0.05)
    # trapped charge ~1e2..1e3 e-: float32 rounding of exp() chains
    for got, want in ((dt, dj), (st, sj), (ft, fj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    tm_j, rel_j = recte_j.thin_and_release(dj, jnp.asarray(f), 103.0)
    tm_t, rel_t = recte_t.thin_and_release(dt, T(f), 103.0)
    np.testing.assert_allclose(tm_t.numpy(), np.asarray(tm_j), **TOL)
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), **TOL)
    np.testing.assert_allclose(
        recte_t.white_ramp(300.0, T(starts), 103.0, f0_s=0.2).numpy(),
        np.asarray(recte_j.white_ramp(300.0, jnp.asarray(starts), 103.0,
                                      f0_s=0.2)), **TOL)


# a tiny visit with every source of stimulus: sky, dark and the spectrum
VISIT = {"grism": "G141", "subarray": 64, "NSAMP": 3, "SAMPSEQ": "SPARS10",
         "scan": True, "x_ref": 10.0, "y_ref": 12.0, "num_orbits": 1,
         "exposures_per_orbit": 5, "n_lambda": 32, "n_sub": 2, "seed": 3,
         "noise": {"preset": "all", "poisson": False, "read_noise": False,
                   "cosmic_rays": False, "bias_drift": False}}


@pytest.fixture(scope="module")
def visit():
    """The JAX package's visit and the port's copy of its inputs."""
    obs = Observation_j(config_from_dict_j(VISIT))
    scenes_t = scenes_from_numpy(numpy_leaves(obs.scenes), "cpu")
    tables_t = tables_from_numpy(numpy_leaves(obs.tables), "cpu")
    kw = dataclasses.asdict(obs.static)
    kw["noise"] = NoiseFlags(**kw["noise"])
    return obs, scenes_t, tables_t, ExposureStatic(**kw)


def test_visit_fluence_stack(visit):
    obs, scenes_t, tables_t, static_t = visit
    want = np.asarray(fluence_j(obs.scenes, obs.tables, obs.static, 4))
    got = visit_fluence_stack(scenes_t, tables_t, static_t, 4).numpy()
    assert got.shape == (5, 64, 64)
    # the noise-off bar of tests/test_torch_observation.py
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=max(1e-3, 5e-6 * float(want.max())))


def test_visit_persistence_and_trap_maps_on_one_stack(visit):
    """Both visit-level wrappers, fed the same numpy fluence stack (and a
    prepended stimulus, as the direct image is)."""
    obs, scenes_t, tables_t, static_t = visit
    f, _ = _stack(n=5, s=64, seed=9)
    extra = np.random.RandomState(10).uniform(0, 1e5, (64, 64)
                                              ).astype(np.float32)
    pj = PersistenceConfig_j(enabled=True)
    want = pers_j.visit_persistence_rates(
        obs.scenes, obs.tables, obs.static, pj, extra_fluence=jnp.asarray(
            extra), extra_end_s=-60.0, fluence_stack=jnp.asarray(f))
    got = pers_t.visit_persistence_rates(
        scenes_t, tables_t, static_t, PersistenceConfig(
            enabled=True), extra_fluence=T(extra), extra_end_s=-60.0,
        fluence_stack=T(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rj = RecteConfig_j(enabled=True, f0_s=0.1)
    tm_j, rel_j = recte_j.visit_trap_maps(obs.scenes, obs.tables, obs.static,
                                          rj, fluence_stack=jnp.asarray(f))
    tm_t, rel_t = recte_t.visit_trap_maps(
        scenes_t, tables_t, static_t,
        RecteConfig(enabled=True, f0_s=0.1), fluence_stack=T(f))
    np.testing.assert_allclose(tm_t.numpy(), np.asarray(tm_j), **TOL)
    # the release is a difference of trap populations up to ~1.5e3 e-,
    # where float32 rounds at 1.2e-4 e-: 1e-3 e- over the 103 s exposure
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), rtol=1e-5,
                               atol=1e-3 / 103.0)
    assert float(tm_t.min()) < 1.0


def test_jax_scene_leaves_carry_across(visit):
    """convert.py carries persist_rate, trap_mult, spots and companions
    from a JAX Scene to the port's."""
    obs, _, _, _ = visit
    n, nl = 5, 32
    rng = np.random.RandomState(12)
    sj, _ = _spots(nl, rng)
    from wayne_tpu.scene import CompanionParams
    comp = CompanionParams(dx_px=jnp.ones((n, 2)), dy_px=jnp.zeros((n, 2)),
                           flux=jnp.ones((n, 2, nl)))
    maps = jnp.asarray(rng.uniform(size=(n, 64, 64)), jnp.float32)
    full = dataclasses.replace(
        obs.scenes, persist_rate=maps, trap_mult=maps,
        spots=jax.tree_util.tree_map(lambda x: jnp.broadcast_to(
            x, (n,) + x.shape), sj), companions=comp)
    got = scenes_from_numpy(numpy_leaves(full), "cpu")
    np.testing.assert_array_equal(got.persist_rate.numpy(), np.asarray(maps))
    np.testing.assert_array_equal(got.trap_mult.numpy(), np.asarray(maps))
    assert isinstance(got.spots, spots_t.SpotParams)
    np.testing.assert_array_equal(got.spots.contrast.numpy(),
                                  np.asarray(full.spots.contrast))
    assert got.companions.flux.shape == (n, 2, nl)
