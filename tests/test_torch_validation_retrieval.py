"""The noise-free cores of the port's three forward-model retrieval sections
of ``wayne_tpu_torch.tools.validate_recovery`` (``retrieval_mode``,
``program_mode``, ``spots_mode``) on the CPU against the same composition
of ``wayne_tpu`` functions on CPU JAX, written out here as the JAX tool
composes them (``tools/validate_recovery.py:1398-1478``, ``:1552-1562``,
``:1704-1735``): 64^2, 12 exposures, 3 channels, 3 LM steps (5 for the
spot fits).

Both retrievals fit the JAX tool's deterministic-twin data; the port's
own data are held against them at the bar of
tests/test_torch_retrieval.py's forward spectra (rtol 1e-5, atol 1e-3 DN).
Bars: Rp/Rs rtol 1e-5 (the spot-blind fit atol 1e-5, see its test); the
program's t0 offsets atol 0.05 s (the joint retrieval test's). The file
takes ~30 s on one core (JAX compiles of the Jacobian passes dominate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables
from wayne_tpu.config import ExposureStatic, NoiseFlags
from wayne_tpu.ops.spots import SpotParams
from wayne_tpu.ops.visit import simulate_visit
from wayne_tpu.retrieval import (
    deterministic_cfg, retrieve_transmission, retrieve_transmission_joint,
)
from wayne_tpu.scene import example_scene
from wayne_tpu_torch.tools import validate_recovery as vr

torch.set_num_threads(1)

S, NL, NSAMP, N_EXP, N_CHAN = 64, 32, 2, 12, 3
X_WIN, X_REF, Y_REF, N_LM = (0, 61), -120.0, 30.0, 3
RETRIEVAL = dict(S=S, NL=NL, NSAMP=NSAMP, N_EXP=N_EXP, N_CHAN=N_CHAN,
                 x_window=X_WIN, x_ref=X_REF, y_ref=Y_REF, n_lm=N_LM)
RP_RTOL = 1e-5


class _Jax:
    """The JAX tool's retrieval visit at the test's size."""

    def __init__(self):
        flags = dataclasses.replace(NoiseFlags.none(), poisson=True,
                                    read_noise=True, sky=True, dark=True)
        self.cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=2,
                                  nsamp=NSAMP, samp_seq="SPARS10", scan=True,
                                  noise=flags, band_px=48)
        self.cfg0 = deterministic_cfg(self.cfg)
        self.tables = synthetic_tables("G141", subarray=S, n_lambda=NL,
                                       samp_seq="SPARS10", nsamp=NSAMP)
        base = example_scene(NL, scan_speed=0.6)
        self.wl = np.asarray(self.tables.wl_centers)
        base = dataclasses.replace(
            base, x_ref=jnp.float32(X_REF), y_ref=jnp.float32(Y_REF),
            rp_over_rs=jnp.asarray(0.1595 + 0.004 * np.sin(9.0 * self.wl),
                                   jnp.float32))
        visit = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), base)
        self.visit = dataclasses.replace(visit, exp_start_s=jnp.asarray(
            np.linspace(0.0, 4.0 * 3600.0, N_EXP), jnp.float32))

    def scenes(self, t0_shift_s=0.0, spots=None):
        keys = jax.vmap(lambda e: jax.random.fold_in(
            jax.random.PRNGKey(0), e))(jnp.arange(N_EXP))
        sc = dataclasses.replace(self.visit, key=keys, spots=spots)
        if t0_shift_s:
            sc = dataclasses.replace(sc, orbit=dataclasses.replace(
                sc.orbit, t0_s=sc.orbit.t0_s + t0_shift_s))
        return sc

    def observe0(self, scenes):
        res = simulate_visit(scenes, self.tables, self.cfg0, chunk=6)
        return np.asarray((res.reads_dn[:, -1] - res.reads_dn[:, 0])
                          .sum(axis=1))

    def retrieve(self, data, scenes, **kw):
        opts = dict(x_window=X_WIN, n_chan=N_CHAN, rp_init=0.15, chunk=6,
                    n_lm=N_LM)
        opts.update(kw)
        return retrieve_transmission(jnp.asarray(data), scenes, self.tables,
                                     self.cfg, **opts)


@pytest.fixture(scope="module")
def rc():
    return vr.build_retrieval_core("cpu", **RETRIEVAL)


@pytest.fixture(scope="module")
def jx():
    return _Jax()


def _same_data(monkeypatch, *data):
    """Make the port's ``observe`` calls, in order, hand on the JAX tool's
    ``data``, after holding the port's own against them."""
    queue = list(data)
    real = vr.observe

    def same(rc, scenes, deterministic=False):
        assert deterministic
        mine = real(rc, scenes, deterministic)
        want = queue.pop(0)
        np.testing.assert_allclose(mine.numpy(), want, rtol=1e-5, atol=1e-3)
        return torch.as_tensor(want)

    monkeypatch.setattr(vr, "observe", same)
    return queue


def test_retrieval_reference_matches_jax(rc, jx, monkeypatch):
    """The twin's data retrieved with a fixed sigma of 1e-4; the channel
    truth is the JAX tool's."""
    sc = jx.scenes()
    data = jx.observe0(sc)
    queue = _same_data(monkeypatch, data)
    got = vr.retrieval_mode_reference(rc)
    want = jx.retrieve(data, sc, sigma=np.full(N_CHAN, 1e-4))
    np.testing.assert_allclose(got, want.rp, rtol=RP_RTOL, atol=0)
    assert not queue
    from wayne_tpu.retrieval import bin_channel_map

    idx, inw = bin_channel_map(jx.visit, jx.tables, X_WIN, N_CHAN)
    rp_inj = 0.1595 + 0.004 * np.sin(9.0 * jx.wl)
    np.testing.assert_array_equal(
        rc.rp_true, [rp_inj[inw & (idx == c)].mean() for c in range(N_CHAN)])


def test_program_reference_matches_jax(rc, jx, monkeypatch):
    """The joint fit of two visits, the second's true ephemeris 180 s late
    and the model's stale: the shared spectrum and the t0 offsets."""
    sc_a, sc_b = jx.scenes(), jx.scenes()
    data = [jx.observe0(sc_a), jx.observe0(jx.scenes(t0_shift_s=180.0))]
    queue = _same_data(monkeypatch, *data)
    got = vr.program_mode_reference(rc)
    want = retrieve_transmission_joint(
        [jnp.asarray(d) for d in data], [sc_a, sc_b], jx.tables, jx.cfg,
        x_window=X_WIN, n_chan=N_CHAN, rp_init=0.15, fit_t0=True,
        t0_window_s=600.0, chunk=6, n_lm=N_LM)
    np.testing.assert_allclose(got["rp"], want.rp, rtol=RP_RTOL, atol=0)
    np.testing.assert_allclose(got["t0_offsets_s"], want.t0_offsets_s,
                               rtol=0, atol=0.05)
    assert not queue


def test_spots_reference_matches_jax(rc, jx, monkeypatch):
    """The spotted star's twin retrieved spot-blind and spot-aware. The
    blind fit (a misspecified model in a shallow valley) at the retrieval
    tests' depth bar, atol 1e-5: JAX's blind depths are the same after 5,
    8 and 10 LM steps, the port's within 4.1e-6 of them (1e-6 apart between
    those step counts)."""
    wl = jx.wl
    b_imp = 4.855 * np.cos(np.deg2rad(82.1))
    contrast = np.stack([0.4 + 0.2 * (wl - wl.min()) / np.ptp(wl),
                         np.full(NL, 0.6)]).astype(np.float32)
    spots = SpotParams.create(
        [float(np.arcsin(b_imp)), -0.5], [0.0, 0.4], [0.22, 0.12], contrast,
        rot_omega=2.0 * np.pi / (10.0 * 86400.0))
    spots_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), spots)
    sc0 = jx.scenes(spots=spots_b)
    data = jx.observe0(sc0)
    queue = _same_data(monkeypatch, data)
    got = vr.spots_mode_reference(rc)
    kw = dict(n_lm=N_LM + 2, sigma=np.full(N_CHAN, 1e-4))
    blind = jx.retrieve(data, dataclasses.replace(sc0, spots=None), **kw)
    aware = jx.retrieve(data, sc0, **kw)
    np.testing.assert_allclose(got["rp_blind"], blind.rp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rp_aware"], aware.rp, rtol=RP_RTOL,
                               atol=0)
    assert not queue
