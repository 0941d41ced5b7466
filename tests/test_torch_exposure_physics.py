"""The port's simulate_exposure with the visit-level physics against the
JAX package's, on identical tables and scenes (carried across with
wayne_tpu_torch.convert), the stochastic effects off: extra beams,
companions in the band, starspots, the eclipse and phase-curve light and
the charge-memory leaves. Unstable (RTS) pixels draw their state from the
port's own Philox stream, so they are held to their law instead.

Tolerances are the noise-off bar of tests/test_torch_observation.py:
rtol 2e-5 with an absolute floor of max(1e-3, 5e-6 of the frame's peak)
on reads_dn and ideal_e — the faint PSF wings are differences of erf
values near 1 that the two frameworks round differently in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.ops.spots import SpotParams
from wayne_tpu.scene import CompanionParams, example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops.exposure import simulate_exposure

torch.set_num_threads(1)

S, NL, NSAMP = 64, 32, 3
DETERMINISTIC = dataclasses.replace(NoiseFlags.all(), poisson=False,
                                    read_noise=False, cosmic_rays=False,
                                    bias_drift=False)


def _static_t(cfg_j: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg_j)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


def _tables(**kw):
    return synthetic_tables("G141", subarray=S, n_lambda=NL,
                            samp_seq="SPARS10", nsamp=NSAMP, **kw)


def _scene(seed=0, **kw):
    kw = dict(dict(x_ref=jnp.float32(10.0), y_ref=jnp.float32(14.0)), **kw)
    return dataclasses.replace(example_scene(NL, seed=seed, scan_speed=1.0),
                               **kw)


def _cfg(band=16, **kw):
    kw.setdefault("noise", DETERMINISTIC)
    return ExposureStatic(subarray=S, n_lambda=NL, n_sub=4, nsamp=NSAMP,
                          samp_seq="SPARS10", scan=True, band_px=band,
                          transit_quad=16, compute_ideal=True, **kw)


def _run_port(cfg_j, tables_j, *scenes_j):
    batched = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scenes_j)
    return simulate_exposure(
        scenes_from_numpy(numpy_leaves(batched), "cpu"),
        tables_from_numpy(numpy_leaves(tables_j), "cpu"), _static_t(cfg_j))


def _assert_matches_jax(cfg, tables, scene):
    ref = simulate_exposure_j(scene, tables, cfg)
    got = _run_port(cfg, tables, scene)
    for name in ("reads_dn", "ideal_e"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            getattr(got, name)[0].numpy(), want, rtol=2e-5,
            atol=max(1e-3, 5e-6 * float(want.max())), err_msg=name)
    assert float(np.asarray(ref.ideal_e).max()) > 0.0
    return got


# G141's +1st order lands 40..182 px right of x_ref, the 2nd 80..364 px,
# the 0th order 207 px left: x_ref -60 puts both dispersed orders on the
# 64 px subarray, x_ref 230 the 0th-order spot alone
@pytest.mark.parametrize("band,x_ref", [(16, -60.0), (0, -60.0),
                                        (16, 230.0)])
def test_extra_beams_match_jax(band, x_ref):
    scene = _scene(x_ref=jnp.float32(x_ref))
    got = _assert_matches_jax(_cfg(band, extra_beams=True), _tables(), scene)
    base = _run_port(_cfg(band), _tables(), scene)
    # the beams add light
    assert float(got.ideal_e.sum()) > 1.001 * float(base.ideal_e.sum())


def _companions(n):
    flux = 0.3 * np.asarray(example_scene(NL).stellar_flux)
    dx, dy = [6.0, -4.0][:n], [7.0, -5.0][:n]
    return CompanionParams(dx_px=jnp.asarray(dx, jnp.float32),
                           dy_px=jnp.asarray(dy, jnp.float32),
                           flux=jnp.asarray(np.stack([flux] * n),
                                            jnp.float32))


@pytest.mark.parametrize("n_comp", [1, 2])
def test_companions_in_the_band_match_jax(n_comp):
    """One and two companions with the band on: the port against the JAX
    package, and the port's band against its own full frame — the band
    covers both companions' traces (as tests/test_companions.py holds
    the JAX package's)."""
    scene = _scene(companions=_companions(n_comp))
    got = _assert_matches_jax(_cfg(48), _tables(), scene)
    full = _run_port(_cfg(0), _tables(), scene)
    f = full.ideal_e.double()
    # the band drops the >5-sigma tails the full frame keeps: 1e-5 of peak
    torch.testing.assert_close(got.ideal_e.double(), f, rtol=0,
                               atol=1e-5 * float(f.max()))
    alone = _run_port(_cfg(48), _tables(), _scene())
    # 0.3 of the target's flux, partly off the 64 px subarray
    assert float(got.ideal_e.sum()) > 1.05 * float(alone.ideal_e.sum())


def _spots():
    rng = np.random.RandomState(8)
    return SpotParams.create(
        np.deg2rad([41.8, -20.0]), np.deg2rad([-1.0, -35.0]), [0.10, 0.06],
        rng.uniform(0.5, 0.9, (2, NL)), 2.0 * np.pi / (15.6 * 86400.0))


def _charge_maps(seed=3):
    rng = np.random.RandomState(seed)
    persist = jnp.asarray(rng.uniform(0.0, 0.5, (S, S)), jnp.float32)
    trap = jnp.asarray(rng.uniform(0.95, 1.0, (S, S)), jnp.float32)
    return persist, trap


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_read"])
def test_visit_physics_leaves_match_jax(fused):
    """Spots, the eclipse light with a phase curve, a companion, a
    breathing PSF, persistence and RECTE thinning together, on both
    readout routes (the per-read route runs the banded step, B2, with IPC
    on)."""
    persist, trap = _charge_maps()
    # mid-transit, so the spot crossing and the planet light both count
    scene = _scene(spots=_spots(), companions=_companions(1),
                   psf_scale=jnp.float32(1.012),
                   persist_rate=persist, trap_mult=trap,
                   fp_over_fs=jnp.full(NL, 5e-4, jnp.float32),
                   phase_amp=jnp.float32(0.5),
                   phase_offset=jnp.float32(0.2),
                   exp_start_s=jnp.float32(2.0 * 3600.0 - 50.0))
    cfg = _cfg(48, eclipse=True, fused_reads=fused)
    got = _assert_matches_jax(cfg, _tables(), scene)
    # the background carries the persistence: more charge than without
    bare = _run_port(cfg, _tables(), dataclasses.replace(
        scene, persist_rate=None))
    assert float(got.reads_dn[0, -1].sum()) > float(bare.reads_dn[0, -1].sum())


def test_persistence_alone_reaches_the_background_sampler():
    """Sky and dark off, persistence on: the persistence charge is
    Poisson-sampled (its variance shows in a noisy run)."""
    noise = dataclasses.replace(NoiseFlags.none(), poisson=True)
    cfg = _cfg(16, noise=noise)
    persist = jnp.full((S, S), 5.0, jnp.float32)
    dark = _scene(stellar_flux=jnp.zeros(NL, jnp.float32))
    with_p = _run_port(cfg, _tables(), dataclasses.replace(
        dark, persist_rate=persist))
    without = _run_port(cfg, _tables(), dark)
    assert float(without.reads_dn.abs().max()) == 0.0
    last = with_p.reads_dn[0, -1].double()
    t_exp = float(np.asarray(_tables().read_times)[-1])
    mean = 5.0 * t_exp / float(np.asarray(_tables().gain))
    active = torch.as_tensor(np.array(_tables().active_mask)) > 0
    # Poisson counts: mean and variance both ~ rate x time (in e-)
    assert abs(float(last[active].mean()) / mean - 1.0) < 0.05
    assert float(last[active].std()) > 0.5 * mean ** 0.5 / float(
        np.asarray(_tables().gain)) ** 0.5


def _rts_ratio(n_exp, amp=0.1):
    """(n_exp, S, S) ideal_e with every pixel unstable over ideal_e
    without, on the pixels that hold signal; and its mask."""
    noise = NoiseFlags.none()
    cfg = _static_t(_cfg(0, noise=noise))
    tj = _tables()
    tables = tables_from_numpy(numpy_leaves(tj), "cpu")
    scenes = [_scene(seed=i, scan_speed=jnp.float32(8.0),
                     y_ref=jnp.float32(2.0)) for i in range(n_exp)]
    batched = scenes_from_numpy(numpy_leaves(jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *scenes)), "cpu")
    base = simulate_exposure(batched, tables, cfg).ideal_e
    rts = dataclasses.replace(tables, rts_amp=torch.full((S, S), amp))
    got = simulate_exposure(batched, rts, cfg).ideal_e
    lit = base > 1e-3 * float(base.max())
    return got / torch.where(lit, base, 1.0), lit


def test_rts_pixels_follow_their_law():
    """The response ratio takes only 1 +- amp; the high state's share is
    1/2 within 4 sigma over pixels x exposures; two exposures' states are
    independent (their correlation within 4 sigma of 0)."""
    amp, n_exp = 0.1, 4
    ratio, lit = _rts_ratio(n_exp, amp)
    r = ratio[lit]
    assert lit.sum() > 2000
    high = torch.isclose(r, torch.tensor(1.0 + amp), rtol=1e-5)
    low = torch.isclose(r, torch.tensor(1.0 - amp), rtol=1e-5)
    assert bool((high | low).all())
    n = r.numel()
    assert abs(float(high.double().mean()) - 0.5) < 4 * 0.5 / n ** 0.5
    both = lit[0] & lit[1]
    s0 = torch.sign(ratio[0][both] - 1.0)
    s1 = torch.sign(ratio[1][both] - 1.0)
    m = s0.numel()
    assert m > 500
    corr = float((s0 * s1).double().mean())
    assert abs(corr) < 4 / m ** 0.5


def test_rts_state_is_a_pure_function_of_the_exposure_seed():
    """The same seed gives the same states in any batch; another seed
    gives other states."""
    ratio_a, lit = _rts_ratio(2)
    ratio_b, _ = _rts_ratio(3)
    assert torch.equal(ratio_a[lit], ratio_b[:2][lit])
    both = lit[0] & lit[1]
    assert not torch.equal(ratio_a[0][both], ratio_a[1][both])
