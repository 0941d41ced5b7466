"""The port's simulate_exposure against the JAX package's on identical
tables and scenes (carried across with wayne_tpu_torch.convert), with the
stochastic effects off, and against the fp64 NumPy oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import quadrant_map, synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.oracle.numpy_oracle import oracle_ideal_frame
from wayne_tpu.scene import example_scene
from wayne_tpu_torch import config as config_t
from wayne_tpu_torch.convert import (
    numpy_leaves, scenes_from_numpy, tables_from_numpy,
)
from wayne_tpu_torch.ops.exposure import simulate_exposure

torch.set_num_threads(1)

# every deterministic effect on (IPC included); Poisson, read noise,
# cosmic rays and the bias drift off (the two packages draw their random
# numbers from different generators)
DETERMINISTIC = dataclasses.replace(NoiseFlags.all(), poisson=False,
                                    read_noise=False, cosmic_rays=False,
                                    bias_drift=False)


def _static_t(cfg_j: ExposureStatic) -> config_t.ExposureStatic:
    kw = dataclasses.asdict(cfg_j)
    kw["noise"] = config_t.NoiseFlags(**kw["noise"])
    return config_t.ExposureStatic(**kw)


def _run_port(cfg_j, tables_j, scene_j):
    """The port on the JAX package's inputs (one exposure, batched)."""
    batched = jax.tree_util.tree_map(lambda x: x[None], scene_j)
    return simulate_exposure(
        scenes_from_numpy(numpy_leaves(batched), "cpu"),
        tables_from_numpy(numpy_leaves(tables_j), "cpu"), _static_t(cfg_j))


def _run_both(cfg_j, tables_j, scene_j):
    return (simulate_exposure_j(scene_j, tables_j, cfg_j),
            _run_port(cfg_j, tables_j, scene_j))


@pytest.mark.parametrize("scan,band", [(True, 16), (True, 0), (False, 16)])
def test_matches_jax_deterministic(scan, band):
    S, NL, NSAMP = 64, 32, 3
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                              samp_seq="SPARS10", nsamp=NSAMP)
    scene = dataclasses.replace(
        example_scene(NL, scan_speed=1.0 if scan else 0.0),
        x_ref=jnp.float32(10.0), y_ref=jnp.float32(10.0))
    cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=4, nsamp=NSAMP,
                         samp_seq="SPARS10", scan=scan, noise=DETERMINISTIC,
                         band_px=band, transit_quad=16, use_pallas=False)
    ref, got = _run_both(cfg, tables, scene)
    # the bar of tests/test_pallas.py's Pallas-vs-XLA check
    np.testing.assert_allclose(got.reads_dn[0].numpy(),
                               np.asarray(ref.reads_dn), rtol=2e-5, atol=1e-3)
    # ideal_e: the same rtol, but its faint wings are differences of erf
    # values that the two frameworks round differently in float32 — a gap
    # measured at <= 1.8e-6 of the frame's peak (up to 0.11 e- at a 1.5e5
    # e- peak), so its absolute floor is 5e-6 of the peak, not 1e-3 e-
    peak = float(np.asarray(ref.ideal_e).max())
    np.testing.assert_allclose(got.ideal_e[0].numpy(),
                               np.asarray(ref.ideal_e), rtol=2e-5,
                               atol=5e-6 * peak)
    assert float(got.saturated_frac[0]) == float(ref.saturated_frac)
    assert float(got.ideal_e.sum()) > 0.0            # the spectrum is on it


def test_bias_drift_adds_one_offset_per_amplifier_and_read():
    """The bias drift (random, so not comparable with the JAX package's
    bits) adds per-read, per-amplifier offsets and changes nothing else."""
    S, NL, NSAMP = 64, 32, 2
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                              samp_seq="SPARS10", nsamp=NSAMP)
    scene = dataclasses.replace(example_scene(NL), x_ref=jnp.float32(10.0),
                                y_ref=jnp.float32(10.0))
    base = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP,
                          samp_seq="SPARS10", scan=True, noise=DETERMINISTIC,
                          band_px=16, transit_quad=16)
    drift = dataclasses.replace(
        base, noise=dataclasses.replace(DETERMINISTIC, bias_drift=True))
    _, a = _run_both(base, tables, scene)
    _, b = _run_both(drift, tables, scene)
    # back to electrons through the per-pixel gain the reads divided by
    d = (b.reads_dn - a.reads_dn)[0] * torch.tensor(
        np.asarray(tables.gain_map))
    # the centred 64^2 subarray straddles all four amplifier quadrants
    quad = torch.tensor(np.asarray(quadrant_map(S)))
    for r in range(NSAMP + 1):
        for q in range(4):
            v = d[r][quad == q]
            assert float(v.max() - v.min()) < 0.05, (r, q)
            assert 0.0 < abs(float(v.mean())) < 6 * 3.0   # 3 e- RMS drift


@pytest.mark.parametrize("scan", [False, True])
def test_ideal_frame_matches_fp64_oracle(scan):
    S, NL, NSAMP = 128, 64, 4
    cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=8, nsamp=NSAMP,
                         samp_seq="SPARS10", scan=scan,
                         noise=NoiseFlags.none())
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                              samp_seq="SPARS10", nsamp=NSAMP)
    scene = dataclasses.replace(
        example_scene(NL, scan_speed=1.5 if scan else 0.0),
        x_ref=jnp.float32(30.0), y_ref=jnp.float32(40.0))
    _, got = _run_both(cfg, tables, scene)
    o = scene.orbit
    want = oracle_ideal_frame(
        tables, cfg, x_ref=30.0, y_ref=40.0,
        scan_speed=float(scene.scan_speed), exp_start_s=0.0,
        stellar_flux=np.asarray(scene.stellar_flux),
        rp_over_rs=np.asarray(scene.rp_over_rs), ld=np.asarray(scene.ld),
        orbit=dict(period_s=float(o.period_s), t0_s=float(o.t0_s),
                   sma_rs=float(o.sma_rs), inc_rad=float(o.inc_rad),
                   ecc=float(o.ecc), omega_rad=float(o.omega_rad)))
    scale = want.max()
    # the bar of tests/test_exposure.py's oracle diff
    np.testing.assert_allclose(got.ideal_e[0].numpy().astype(np.float64)
                               / scale, want / scale, atol=2e-4)


def test_ssv_random_walk_is_decided_on_the_host():
    """The config decides whether the random-walk SSV is drawn; with a
    zero amplitude the drawn walk's factor is exactly 1, so skipping it
    changes no bit, and a non-zero amplitude does change the reads."""
    small = {"subarray": 64, "NSAMP": 2, "n_lambda": 16}
    assert not config_t.config_from_dict(small).exposure_static().ssv_walk
    assert config_t.config_from_dict(
        dict(small, ssv_rw_amplitude=0.02)).exposure_static().ssv_walk

    S, NL, NSAMP = 64, 16, 2
    tables = tables_from_numpy(numpy_leaves(synthetic_tables(
        "G141", subarray=S, n_lambda=NL, samp_seq="SPARS10", nsamp=NSAMP)),
        "cpu")
    scene = dataclasses.replace(example_scene(NL), x_ref=jnp.float32(10.0),
                                y_ref=jnp.float32(10.0))
    walk = _static_t(ExposureStatic(
        subarray=S, n_lambda=NL, n_sub=2, nsamp=NSAMP, samp_seq="SPARS10",
        scan=True, noise=DETERMINISTIC, band_px=16, transit_quad=16))
    assert walk.ssv_walk

    def reads(amp, static):
        s = dataclasses.replace(scene, trends=dataclasses.replace(
            scene.trends, ssv_rw_amp=jnp.float32(amp)))
        batched = jax.tree_util.tree_map(lambda x: x[None], s)
        return simulate_exposure(scenes_from_numpy(
            numpy_leaves(batched), "cpu"), tables, static).reads_dn

    flat = reads(0.0, walk)
    assert torch.equal(flat, reads(0.0, dataclasses.replace(
        walk, ssv_walk=False)))
    assert not torch.allclose(reads(0.05, walk), flat, rtol=1e-4, atol=0)


def test_unported_paths_raise():
    S, NL = 64, 16
    tables = synthetic_tables("G141", subarray=S, n_lambda=NL, nsamp=2)
    scene = example_scene(NL)
    for kw in (dict(fused_reads=False), dict(exact_poisson=True),
               dict(extra_beams=True), dict(eclipse=True)):
        cfg = ExposureStatic(subarray=S, n_lambda=NL, nsamp=2, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _run_port(cfg, tables, scene)
