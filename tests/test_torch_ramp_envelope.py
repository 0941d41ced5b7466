"""The port's ramp-fit envelope (``wayne_tpu_torch.tools.ramp_envelope``)
on the CPU at a small size, against the JAX package's tool.

- The noise-free points (the walk off: rw = 0 at two sinusoid amplitudes,
  and two hook points) against the JAX tool's composition
  (``tools/ramp_envelope.py:104-133``: the four trend amplitudes on every
  exposure, ``reduce_visit`` without the CR repair or the amplifier
  correction, ``fit_white_ramp``, ``ramp_detrend``, ``fit_depths``),
  written out here with ``wayne_tpu`` functions at 128^2, NSAMP 3, 16
  exposures, 4 channels. Both pipelines reduce the JAX tool's reads; the
  port's own are held to them at rtol 2e-5 (the noise-off bar of
  tests/test_torch_observation.py). White and channel Rp/Rs at rtol 2e-5,
  the ramp path's bar (ROADMAP C13: the fit's valley). The injected proxy
  (every flag off, plain ``fit_depths``) at rtol 1e-5.
- Draw d's walk is the same at every amplitude: the reads' deviation from
  the walk-off reads doubles from rw 0.005 to 0.01.
- A 2-draw sweep into ``tmp_path``: ``RAMP_ENVELOPE.json``'s keys plus
  ``card``, and the gates recomputed from its grid by the JAX tool's own
  statements (lifted with ``ast``) agree; nothing is written to the
  repository. The committed ``RAMP_ENVELOPE_TORCH.json`` carries every key
  of the JAX record.

The file takes ~90 s on one core (JAX compiles dominate).
"""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import synthetic_tables as synthetic_tables_j
from wayne_tpu.config import ExposureStatic as ExposureStatic_j
from wayne_tpu.config import NoiseFlags as NoiseFlags_j
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.reduction import (
    fit_depths as fit_depths_j, fit_white_ramp as fit_white_ramp_j,
    ramp_detrend as ramp_detrend_j, reduce_visit as reduce_visit_j,
)
from wayne_tpu.scene import example_scene as example_scene_j
from wayne_tpu_torch.ops.random import mc_seed_words
from wayne_tpu_torch.tools import ramp_envelope as re_
from wayne_tpu_torch.tools import validate_recovery as vr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NL, NSAMP, N_EXP, N_CHAN = 128, 64, 3, 16, 4
SEQ = "SPARS10"
X_REF, Y_REF = -60.0, 30.0
X_WIN, Y_WIN, BG = (4, 124), (20, 50), (90, 125)
CORE = dict(S=S, NL=NL, NSAMP=NSAMP, N_EXP=N_EXP, N_CHAN=N_CHAN,
            samp_seq=SEQ, band_px=32, x_ref=X_REF, y_ref=Y_REF,
            x_window=X_WIN, y_window=Y_WIN, bg_rows=BG)
RP_RTOL = 2e-5


class _Jax:
    """The JAX tool's visit at the test's size, its ``run`` and
    ``run_clean`` (``tools/ramp_envelope.py:80-151``)."""

    def __init__(self):
        flags = dataclasses.replace(NoiseFlags_j.none(), ssv=True,
                                    visit_trend=True)
        self.cfg = ExposureStatic_j(subarray=S, n_lambda=NL, n_sub=4,
                                    nsamp=NSAMP, samp_seq=SEQ, scan=True,
                                    noise=flags, band_px=32)
        self.tables = synthetic_tables_j("G141", subarray=S, n_lambda=NL,
                                         samp_seq=SEQ, nsamp=NSAMP)
        base = example_scene_j(NL, scan_speed=0.5)
        wl = np.asarray(self.tables.wl_centers)
        self.base = dataclasses.replace(
            base, x_ref=jnp.float32(X_REF), y_ref=jnp.float32(Y_REF),
            rp_over_rs=jnp.asarray(0.1595 + 0.003 * np.sin(8.0 * wl),
                                   jnp.float32))
        starts = np.linspace(0.0, 4.0 * 3600.0, N_EXP)
        exptime = float(self.tables.read_times[-1])
        self.mid = jnp.asarray(starts + exptime / 2.0, jnp.float32)
        visit0 = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape),
            self.base)
        self.visit0 = dataclasses.replace(
            visit0, exp_start_s=jnp.asarray(starts, jnp.float32))
        self._sim = jax.jit(self._reads, static_argnums=(5,))

    def _reads(self, sin_amp, rw_amp, hook_amp, orbit1_scale, draw, clean):
        def bfill(v, like):
            return jnp.broadcast_to(jnp.float32(v), like.shape)

        tr = self.visit0.trends
        trends = dataclasses.replace(
            tr, ssv_amp=bfill(sin_amp, tr.ssv_amp),
            ssv_rw_amp=bfill(rw_amp, tr.ssv_rw_amp),
            hook_amp=bfill(hook_amp, tr.hook_amp),
            hook_orbit1_scale=bfill(orbit1_scale, tr.hook_orbit1_scale))
        scenes = dataclasses.replace(
            self.visit0, trends=trends,
            key=jax.vmap(lambda e: jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(123), draw), e)
            )(jnp.arange(N_EXP)))
        cfg = (dataclasses.replace(self.cfg, noise=NoiseFlags_j.none())
               if clean else self.cfg)
        return jax.lax.map(
            lambda s: simulate_exposure_j(s, self.tables, cfg).reads_dn,
            scenes)

    def reads(self, sin_amp, rw_amp, hook_amp, orbit1_scale, draw=0,
              clean=False):
        return np.asarray(self._sim(sin_amp, rw_amp, hook_amp, orbit1_scale,
                                    draw, clean))

    def reduce(self, reads):
        return reduce_visit_j(jnp.asarray(reads), self.tables.gain, self.mid,
                              self.base.orbit, y_window=Y_WIN,
                              x_window=X_WIN, bg_rows=BG, n_chan=N_CHAN)

    def run(self, reads):
        """(white Rp/Rs, channel Rp/Rs) of the joint ramp fit."""
        red = self.reduce(reads)
        orbit, ld = self.base.orbit, self.base.ld
        wfit = fit_white_ramp_j(red.white_lc, self.mid, orbit, ld,
                                jnp.float32(0.155))
        chan = ramp_detrend_j(red.channel_lc, wfit, self.mid, orbit)
        rp_hat, _ = fit_depths_j(chan, self.mid, orbit, ld,
                                 jnp.float32(0.155))
        return float(wfit.rp), np.asarray(rp_hat, np.float64)

    def run_clean(self, reads):
        red = self.reduce(reads)
        rp_hat, _ = fit_depths_j(red.channel_lc, self.mid, self.base.orbit,
                                 self.base.ld, jnp.float32(0.155))
        return np.asarray(rp_hat, np.float64)


@pytest.fixture(scope="module")
def jx():
    return _Jax()


@pytest.fixture(scope="module")
def env():
    return re_.build_envelope("cpu", **CORE)


def _same_reads(monkeypatch, *reads):
    """Make the port's ``sim_reads`` calls, in order, hand on the JAX
    tool's ``reads``, after holding the port's own reads against them
    (rtol 2e-5, floor max(1e-3, 5e-6 of the peak))."""
    queue = list(reads)
    real = vr.sim_reads

    def same(scenes, tables, cfg):
        mine, cr_pos, cr_count = real(scenes, tables, cfg)
        want = queue.pop(0)
        np.testing.assert_allclose(
            mine.numpy(), want, rtol=2e-5,
            atol=max(1e-3, 5e-6 * float(np.abs(want).max())))
        return torch.as_tensor(want), cr_pos, cr_count

    monkeypatch.setattr(vr, "sim_reads", same)
    return queue


def test_envelope_visit_is_the_jax_tools(env, jx):
    """The visit, the mid-times and the configs are the JAX tool's: SSV
    and visit trend on, nothing else; the sweep reduces without the
    amplifier correction."""
    np.testing.assert_array_equal(env.core.mid.numpy(), np.asarray(jx.mid))
    assert env.cfg.noise == re_.vr.noise_off(env.core.cfg, ssv=True,
                                             visit_trend=True).noise
    assert [f.name for f in dataclasses.fields(env.cfg.noise) if
            getattr(env.cfg.noise, f.name)] == ["ssv", "visit_trend"]
    assert env.run.quad is None and env.run.seed == 123


@pytest.mark.parametrize("point", [
    (0.0, 0.0, 0.003, 2.0), (0.015, 0.0, 0.003, 2.0),
    (0.015, 0.0, 0.0, 1.0), (0.015, 0.0, 0.012, 4.0)],
    ids=["sin0", "sin0.015", "hook0x1", "hook4x4"])
def test_noise_free_point_matches_jax(env, jx, monkeypatch, point):
    reads = jx.reads(*point)
    queue = _same_reads(monkeypatch, reads)
    w, ch = re_.run_point(env, *point, draw=0)
    w_j, ch_j = jx.run(reads)
    np.testing.assert_allclose(w, w_j, rtol=RP_RTOL, atol=0)
    np.testing.assert_allclose(ch, ch_j, rtol=RP_RTOL, atol=0)
    assert not queue


def test_injected_proxy_matches_jax(env, jx, monkeypatch):
    reads = jx.reads(0.015, 0.005, 0.003, 2.0, clean=True)
    queue = _same_reads(monkeypatch, reads)
    np.testing.assert_allclose(re_.run_clean(env), jx.run_clean(reads),
                               rtol=1e-5, atol=0)
    assert not queue


def test_draws_walk_is_the_same_at_every_amplitude(env):
    """Draw d keys exposure e by mc_seed_words(123, d, e) at every grid
    point, so the walk's factor deviation, and with the noise off the
    reads' deviation from the walk-off reads, doubles from rw 0.005 to
    0.01; another draw walks otherwise."""
    core = env.core

    def reads(rw, draw):
        run = dataclasses.replace(env.run, visit=vr.with_trends(
            core.visit, ssv_amp=0.0, ssv_rw_amp=rw))
        seeds = mc_seed_words(run.seed, draw, torch.arange(core.n_exp))
        return vr.sim_reads(dataclasses.replace(run.visit, seed=seeds),
                            core.tables, env.cfg)[0].double()

    off = reads(0.0, 0)
    d1, d2 = reads(0.005, 0) - off, reads(0.01, 0) - off
    peak = float(off.abs().max())
    assert float(d1.abs().max()) > 1e-3 * peak        # the walk is on
    torch.testing.assert_close(d2, 2.0 * d1, rtol=0, atol=2e-6 * peak)
    other = reads(0.005, 1) - off
    assert float((other - d1).abs().max()) > 0.1 * float(d1.abs().max())


def _lift_gates():
    """The JAX tool's statements from ``default = ...`` to ``ok_hook =
    ...`` in its ``main``, as a function of the grid and the hook delta."""
    path = os.path.join(REPO, "tools", "ramp_envelope.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    main, = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    names = [{t.id for t in getattr(s, "targets", [])
              if isinstance(t, ast.Name)} for s in main.body]
    start = next(i for i, n in enumerate(names) if "default" in n)
    stop = next(i for i, n in enumerate(names) if "ok_hook" in n)
    code = compile(ast.Module(body=main.body[start: stop + 1],
                              type_ignores=[]), path, "exec")

    def run(grid, hook_delta):
        ns = {"grid": grid, "hook_delta": hook_delta, "np": np}
        exec(code, ns)
        return ns
    return run


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    out = tmp_path_factory.mktemp("envelope") / "RAMP_ENVELOPE_TORCH.json"
    before = set(os.listdir(REPO))
    record, ok = re_.sweep(2, "cpu", str(out), core_kw=CORE)
    assert set(os.listdir(REPO)) == before
    with open(out) as fh:
        assert json.load(fh) == record
    return record, ok


def test_sweep_record_has_the_jax_keys(swept):
    record, _ = swept
    with open(os.path.join(REPO, "RAMP_ENVELOPE.json")) as fh:
        jax_record = json.load(fh)
    assert list(record) == list(jax_record) + ["card"]
    assert record["backend"] == "cpu" and record["card"] is None
    assert [list(g) for g in record["grid"]] == \
        [list(g) for g in jax_record["grid"]]
    assert [(g["ssv_sin_amp"], g["ssv_rw_amp"], g["n_draw"])
            for g in record["grid"]] == [
        (sa, ra, 2 if ra > 0 else 1) for sa in re_.SIN_AMPS
        for ra in re_.RW_AMPS]


def test_sweep_gates_match_the_jax_tools_statements(swept):
    record, ok = swept
    ns = _lift_gates()(record["grid"], record["hook_absorption_max_delta"])
    assert record["default_point_white_bias"] == ns["default"][
        "white_bias_mean"]
    for key, name in (("default_white_bias_below_2e-3", "ok_default"),
                      ("channel_bias_monotone_in_rw_amp", "ok_monotone"),
                      ("sin_ssv_absorbed_below_1e-4", "ok_sin"),
                      ("hook_fully_absorbed_below_5e-4", "ok_hook")):
        assert record[key] == bool(ns[name]), key
    assert ok == all(bool(ns[n]) for n in
                     ("ok_default", "ok_monotone", "ok_sin", "ok_hook"))
    # the walk-off rows are noise-free: their statistics are the sweep's
    # deterministic points
    for g in record["grid"]:
        if g["ssv_rw_amp"] == 0.0:
            assert g["white_bias_sem"] == g["white_bias_draw_std"] == 0.0


def test_committed_record_carries_the_jax_keys():
    with open(os.path.join(REPO, "RAMP_ENVELOPE.json")) as fh:
        jax_record = json.load(fh)
    with open(os.path.join(REPO, "RAMP_ENVELOPE_TORCH.json")) as fh:
        record = json.load(fh)
    assert set(jax_record) <= set(record) and "card" in record
    assert record["backend"] == "cuda" and record["card"]
    assert len(record["grid"]) == len(jax_record["grid"])
    for g, gj in zip(record["grid"], jax_record["grid"]):
        assert set(gj) <= set(g)
        assert (g["ssv_sin_amp"], g["ssv_rw_amp"], g["n_draw"]) == \
            (gj["ssv_sin_amp"], gj["ssv_rw_amp"], gj["n_draw"])


def test_cli_raises_without_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        re_.main(["--n-draw", "2", "--out", str(out)])
    assert not out.exists()
