"""The port's science-validation tools (``wayne_tpu_torch.tools.
validate_recovery`` and ``.uncertainty_triangle``) on the CPU at a small
size, against the JAX package's tools.

- The gates: ``sigma_calibration`` and ``pairwise_rel_ratio`` are lifted
  with ``ast`` from ``tools/validate_recovery.py`` (closures inside its
  ``main``), the triangle's gate arithmetic from
  ``tools/uncertainty_triangle.py``'s ``main``; the port's functions must
  give the same values and flags on seeded stacks (exactly).
- Each scan-mode section's noise-free core (its ``*_reference``) against
  the same composition of ``wayne_tpu`` functions on CPU JAX, written out
  here as the JAX tool composes them (``make_run``,
  ``tools/validate_recovery.py:177-235``): 128^2, 16 exposures, 4
  channels. Both pipelines reduce the JAX tool's simulated reads (the
  port's own are held against them at the noise-off bar of
  tests/test_torch_observation.py, rtol 2e-5): end to end, the two float32
  simulations differ by up to 7e-6 of a column, which moves the faint red
  channel's depth by 2e-6 (1.2e-5 relative; measured on the main visit).
  Bars: Rp/Rs rtol 1e-5 (white and channel depths; the RECTE ramp path
  rtol 2e-5, see its test); Fp/Fs and the phase curve's fp atol 2e-6 (a
  1.5e-3 and 2e-3 signal); the phase amplitude and offset atol 1e-3; the
  aligned reduction against the JAX function in float64 and its shifts
  atol 1e-4 px (tests/test_torch_reduce_visit.py's treatment). The
  systematics section's clean core runs with the random-walk SSV
  amplitude at 0 (the port's walk draws its own steps).
- A seeded ``run_sections`` into ``tmp_path``: the record's keys are
  ``VALIDATION.json``'s plus ``backend`` and ``card``, a second section
  merges, nothing is written to the repository; the committed
  ``VALIDATION_TORCH.json`` and ``UNCERTAINTY_TORCH.json`` carry every
  section and key of the JAX records.
- The CLIs refuse an unknown section as the JAX tool does.

The file takes ~120 s on one core (JAX compiles dominate).
"""

import ast
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wayne_tpu.calibration import quadrant_map as quadrant_map_j
from wayne_tpu.calibration import synthetic_tables as synthetic_tables_j
from wayne_tpu.config import ExposureStatic as ExposureStatic_j
from wayne_tpu.config import NoiseFlags as NoiseFlags_j
from wayne_tpu.config import RecteConfig as RecteConfig_j
from wayne_tpu.ops.exposure import simulate_exposure as simulate_exposure_j
from wayne_tpu.ops.recte import visit_trap_maps as visit_trap_maps_j
from wayne_tpu.reduction import (
    divide_white_fit_depths as divide_white_j, fit_depths as fit_depths_j,
    fit_eclipse_depths as fit_eclipse_j, fit_phase_curve as fit_phase_j,
    fit_white_ramp as fit_white_ramp_j, linearize_reads as linearize_j,
    ramp_detrend as ramp_detrend_j,
    reduce_visit as reduce_visit_j,
)
from wayne_tpu.scene import example_scene as example_scene_j
from wayne_tpu.visit_plan import HST_PERIOD_S
from wayne_tpu_torch.tools import uncertainty_triangle as ut
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
STARING = dict(y_window=(18, 46), dead_window=(4, 128))
G102 = dict(x_ref=-70.0, x_window=(8, 124))
RP_RTOL = 1e-5


# ---------------------------------------------------------------------------
# The gates, lifted from the JAX tools' source
# ---------------------------------------------------------------------------

def _main_body(path):
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    main, = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return main.body


def _lift_functions(path, names):
    """The named functions defined inside ``main`` of a JAX tool."""
    defs = [n for n in _main_body(path)
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return [ns[n] for n in names]


def _assigned(stmt):
    return {t.id for t in getattr(stmt, "targets", []) if
            isinstance(t, ast.Name)}


def _lift_triangle_gates():
    """The statements of ``tools/uncertainty_triangle.py``'s ``main`` from
    ``scatter = ...`` to ``ok_agree = ...``, as a function of the arrays
    they read."""
    body = _main_body("tools/uncertainty_triangle.py")
    start = next(i for i, s in enumerate(body) if "scatter" in _assigned(s))
    stop = next(i for i, s in enumerate(body) if "ok_agree" in _assigned(s))
    code = compile(ast.Module(body=body[start: stop + 1], type_ignores=[]),
                   "tools/uncertainty_triangle.py", "exec")

    def run(**arrays):
        ns = dict(arrays, np=np)
        exec(code, ns)
        return ns
    return run


SIGMA_CAL_J, PAIRWISE_J = _lift_functions(
    "tools/validate_recovery.py", ["sigma_calibration", "pairwise_rel_ratio"])


def _stacks(seed, n=24, n_chan=8):
    rng = np.random.default_rng(seed)
    sig = rng.uniform(3e-4, 1.5e-3, n_chan)
    rp = 0.157 + rng.standard_normal((n, n_chan)) * sig * rng.uniform(
        0.5, 1.6, n_chan)
    return rp, sig


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sigma_calibration_matches_the_jax_tool(seed):
    """Ratios and flags equal, two-sided and one-sided; an honestly
    unconstrained channel (huge sigma, huge scatter) passes, a blown sigma
    over a small scatter fails."""
    rp, sig = _stacks(seed)
    scat = rp.std(axis=0, ddof=1)
    cases = [(scat, sig, {}), (scat, sig, {"lo": 0.0}),
             (scat * 2.0, sig, {}), (scat, sig * 3.0, {"lo": 0.0})]
    dead = sig.copy()
    dead[-1] = 4.0
    wild = scat.copy()
    wild[-1] = 0.5
    cases += [(wild, dead, {}), (scat, dead, {}),
              (np.array([scat[0]]), np.array([sig[0]]), {})]
    for a, b, kw in cases:
        assert vr.sigma_calibration(a, b, **kw) == SIGMA_CAL_J(a, b, **kw)
    assert vr.sigma_calibration(wild, dead)[1] == \
        vr.sigma_calibration(np.delete(scat, -1), np.delete(sig, -1))[1]
    assert vr.sigma_calibration(scat, dead)[1] is False


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_rel_ratio_matches_the_jax_tool(seed):
    """Per-channel pairwise ratios equal, with and without ``keep``."""
    rp, sig = _stacks(seed)
    np.testing.assert_array_equal(vr.pairwise_rel_ratio(rp, sig),
                                  PAIRWISE_J(rp, sig))
    keep = np.ones(rp.shape[1], bool)
    keep[[2, 7]] = False
    got = vr.pairwise_rel_ratio(rp, sig, keep=keep)
    assert got.shape == (6,)
    np.testing.assert_array_equal(got, PAIRWISE_J(rp, sig, keep=keep))


@pytest.mark.parametrize("seed", [0, 1])
def test_triangle_gates_match_the_jax_tool(seed):
    """The ratios, flags and pulls of the triangle equal the JAX tool's
    statements on the same arrays (one case fails the convergence gate)."""
    rng = np.random.default_rng(seed)
    rp, sig_lm = _stacks(seed, n=32)
    sig_lm = np.broadcast_to(sig_lm, rp.shape) * rng.uniform(
        0.9, 1.1, rp.shape)
    med_mc = rp + 0.2 * sig_lm * rng.standard_normal(rp.shape)
    width_mc = sig_lm * rng.uniform(0.85, 1.05, rp.shape)
    rhat = rng.uniform(1.0, 1.02 + 0.05 * seed, rp.shape)
    ess = rng.uniform(150.0 + 100.0 * (1 - seed), 900.0, rp.shape)
    want = _lift_triangle_gates()(rp=rp, sig_lm=sig_lm, med_mc=med_mc,
                                  width_mc=width_mc, rhat=rhat, ess=ess)
    got = ut.triangle_gates(rp, sig_lm, med_mc, width_mc, rhat, ess)
    for key in ("scatter", "scatter_med", "a_over_c", "b_over_c"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("ok_a", "ok_b", "ok_mean", "ok_conv", "med_agree",
                "pull_mean", "ok_agree"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# The noise-free cores against the JAX composition
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def core():
    return vr.build_core("cpu", **CORE)


@functools.partial(jax.jit, static_argnums=(2,))
def _sim_visit(scenes, tables, cfg):
    """The JAX tool's ``sim_reads`` mapped over a visit's exposures."""
    def sim(s):
        reads = simulate_exposure_j(s, tables, cfg).reads_dn
        if cfg.noise.non_linearity:
            reads = linearize_j(
                reads, tables.nonlin_coeffs, tables.full_well_e,
                tables.gain,
                bias_e=tables.bias_map if cfg.noise.bias else None
            ) / tables.gain
        return reads

    return jax.lax.map(sim, scenes)


class _Jax:
    """The JAX tool's visit at the test's size and its ``make_run``."""

    def __init__(self, ssv_rw_amp=0.005):
        self.cfg = ExposureStatic_j(subarray=S, n_lambda=NL, n_sub=4,
                                    nsamp=NSAMP, samp_seq=SEQ, scan=True,
                                    noise=NoiseFlags_j.none(), band_px=32)
        self.tables = synthetic_tables_j("G141", subarray=S, n_lambda=NL,
                                         samp_seq=SEQ, nsamp=NSAMP)
        self.quad = quadrant_map_j(S, self.tables.subarray_corner)
        base = example_scene_j(NL, scan_speed=0.5)
        wl = np.asarray(self.tables.wl_centers)
        rp_inj = 0.1595 + 0.003 * np.sin(8.0 * wl)
        self.rp_inj = rp_inj
        self.base = dataclasses.replace(
            base, x_ref=jnp.float32(X_REF), y_ref=jnp.float32(Y_REF),
            rp_over_rs=jnp.asarray(rp_inj, jnp.float32),
            trends=dataclasses.replace(base.trends,
                                       ssv_rw_amp=jnp.float32(ssv_rw_amp)))
        self.starts = np.linspace(0.0, 4.0 * 3600.0, N_EXP)
        self.exptime = float(self.tables.read_times[-1])
        self.mid = jnp.asarray(self.starts + self.exptime / 2.0, jnp.float32)
        visit = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape),
            self.base)
        self.visit = dataclasses.replace(
            visit, exp_start_s=jnp.asarray(self.starts, jnp.float32))

    def reads(self, cfg, visit=None, tables=None):
        """The visit's noise-free reads as the JAX tool simulates them."""
        visit = self.visit if visit is None else visit
        keys = jax.vmap(lambda e: jax.random.fold_in(
            jax.random.PRNGKey(0), e))(jnp.arange(N_EXP))
        return np.asarray(_sim_visit(dataclasses.replace(visit, key=keys),
                                     self.tables if tables is None
                                     else tables, cfg))

    def run(self, reads, *, mid=None, tables=None, quad="core",
            y_window=Y_WIN, x_window=X_WIN, align=False, scan_dir=None,
            kind="depths", rp_geom=None, x64=False):
        """The rest of the JAX tool's ``make_run`` on ``reads``: the
        reduction and the section's fit. ``x64``: in float64."""
        mid = self.mid if mid is None else mid
        tables = self.tables if tables is None else tables
        quad = self.quad if quad == "core" else quad
        orbit, ld = self.base.orbit, self.base.ld
        rp0 = jnp.float32(0.155)
        cast = (lambda a: a) if not x64 else (
            lambda a: jax.tree_util.tree_map(
                lambda x: jnp.asarray(np.asarray(x), jnp.float64), a))
        with jax.enable_x64(x64):
            mid, orbit, ld, rp0 = (cast(a) for a in (mid, orbit, ld, rp0))
            red = reduce_visit_j(cast(jnp.asarray(reads)), cast(tables.gain),
                                 mid, orbit, y_window=y_window,
                                 x_window=x_window, bg_rows=BG,
                                 n_chan=N_CHAN, align=align, ld=ld, rp0=rp0,
                                 scan_dir=scan_dir, quad_map=quad)
            chan, white = red.channel_lc, red.white_lc
            out = {"x_shifts": red.x_shifts, "white_lc": white}
            if kind == "depths":
                out["rp"], out["sig"] = fit_depths_j(chan, mid, orbit, ld, rp0)
            if kind in ("divide-white", "both"):
                out["rp"], out["sig"], out["sig_rel"], out["sig_com"] = (
                    divide_white_j(white, chan, mid, orbit, ld, rp0,
                                   return_components=True))
            if kind in ("ramp", "both"):
                wfit = fit_white_ramp_j(white, mid, orbit, ld, rp0)
                pre = "" if kind == "ramp" else "_ramp"
                out["rp" + pre], out["sig" + pre] = fit_depths_j(
                    ramp_detrend_j(chan, wfit, mid, orbit), mid, orbit, ld,
                    rp0)
                out["white_rp"] = wfit.rp
            if kind == "eclipse":
                out["fp"], out["fp_sigma"] = fit_eclipse_j(chan, mid, orbit,
                                                           rp_geom)
            if kind == "phase":
                fit = fit_phase_j(white, mid, orbit, rp_geom)
                out.update(fp=fit.fp, amp=fit.amp, offset=fit.offset_rad,
                           fp_sigma=fit.fp_sigma)
            return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.fixture(scope="module")
def jx():
    return _Jax()


def _same_reads(monkeypatch, *reads):
    """Make the port's ``sim_reads`` calls, in order, hand on the JAX
    tool's ``reads``, after holding the port's own reads against them at
    the noise-off bar of tests/test_torch_observation.py (rtol 2e-5, floor
    max(1e-3, 5e-6 of the peak))."""
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


def _rp(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RP_RTOL, atol=0, err_msg=what)


def test_core_visit_matches_jax(core, jx):
    """The port's core visit is the JAX tool's: injected spectrum and
    mid-times exactly, the scene leaves at rtol 1e-6 (the example scene's
    power law rounds an ulp apart in 17% of the stellar flux bins)."""
    np.testing.assert_array_equal(core.rp_inj, jx.rp_inj.astype(np.float32))
    np.testing.assert_array_equal(core.mid.numpy(), np.asarray(jx.mid))
    for name in ("x_ref", "y_ref", "exp_start_s", "scan_speed",
                 "stellar_flux", "rp_over_rs", "sky_level"):
        np.testing.assert_allclose(
            getattr(core.visit, name).numpy(),
            np.asarray(getattr(jx.visit, name)), rtol=1e-6, err_msg=name)


def test_main_reference_matches_jax(core, jx, monkeypatch):
    reads = jx.reads(jx.cfg)
    queue = _same_reads(monkeypatch, reads)
    _rp(vr.main_reference(core), jx.run(reads)["rp"], "main")
    assert not queue


def test_with_systematics_clean_core_matches_jax(monkeypatch):
    """The systematics section's clean run (sinusoidal SSV and the visit
    trend, no noise) through divide-white and the ramp fit, with the
    random-walk amplitude at 0. (Its sigmas, 2e-7 to 1.3e-6 from residuals
    at float32 rounding, are not held.)"""
    c = vr.build_core("cpu", **dict(CORE, ssv_rw_amp=0.0))
    j = _Jax(ssv_rw_amp=0.0)
    _, clean = vr._systematics_cfgs(c)
    reads = j.reads(dataclasses.replace(j.cfg, noise=dataclasses.replace(
        NoiseFlags_j.none(), ssv=True, visit_trend=True)))
    queue = _same_reads(monkeypatch, reads)
    got = {k: v[0] for k, v in vr.ensemble(c, vr.scan_run(c, 123), clean,
                                           "both", 1).items()}
    want = j.run(reads, kind="both")
    for key in ("rp", "rp_ramp", "white_rp"):
        _rp(got[key], want[key], key)
    assert not queue


def test_with_pointing_drift_reference_matches_jax(core, jx, monkeypatch):
    """The drifting visit without and with alignment. Aligned, the JAX
    function runs in float64, as tests/test_torch_reduce_visit.py holds
    the align path (ROADMAP C4: the reference's float32 regressor solve)."""
    drift = np.linspace(0.0, 0.4, N_EXP).astype(np.float32)
    reads = jx.reads(jx.cfg, dataclasses.replace(
        jx.visit, x_ref=jnp.asarray(np.float32(X_REF) + drift)))
    queue = _same_reads(monkeypatch, reads, reads)
    got = vr.with_pointing_drift_reference(core)
    _rp(got["rp_raw"], jx.run(reads)["rp"], "raw")
    al = jx.run(reads, align=True, x64=True)
    _rp(got["rp_aligned"], al["rp"], "aligned")
    np.testing.assert_allclose(got["x_shifts"], al["x_shifts"], atol=1e-4)
    assert not queue


def test_with_recte_reference_matches_jax(core, jx, monkeypatch):
    """The RECTE visit (trap maps from the noise-free stimulus), raw and
    through the joint white ramp fit. The ramp-detrended depths at rtol
    2e-5: the parametric ramp fits the physical ramp only in a valley,
    where the JAX function's own depths move by more than rtol 1e-5 when
    its reads move by 1e-7 relative (held below; the port is 1.95e-6,
    1.2e-5 relative, from it: ROADMAP C13)."""
    noisy = dataclasses.replace(jx.cfg, noise=dataclasses.replace(
        NoiseFlags_j.none(), poisson=True, read_noise=True, sky=True,
        dark=True, cosmic_rays=True, non_linearity=True, bias=True))
    trap_mult, trap_rel = visit_trap_maps_j(jx.visit, jx.tables, noisy,
                                            RecteConfig_j(), chunk=8)
    reads = jx.reads(jx.cfg, dataclasses.replace(
        jx.visit, trap_mult=trap_mult, persist_rate=trap_rel))
    queue = _same_reads(monkeypatch, reads, reads)
    got = vr.with_recte_reference(core)
    _rp(got["rp_raw"], jx.run(reads)["rp"], "raw")
    want = jx.run(reads, kind="ramp")
    np.testing.assert_allclose(got["rp"], want["rp"], rtol=2e-5, atol=0)
    _rp(got["white_rp"], want["white_rp"], "white")
    assert not queue
    rng = np.random.default_rng(0)
    moved = jx.run((reads * (1.0 + 1e-7 * rng.standard_normal(reads.shape))
                    ).astype(np.float32), kind="ramp")
    assert np.max(np.abs(moved["rp"] / want["rp"] - 1.0)) > RP_RTOL


def test_eclipse_reference_matches_jax(core, jx, monkeypatch):
    """Fp/Fs atol 2e-6 (measured 3.7e-7; the closed-form fit's own test
    floor is 1e-5)."""
    period_s = float(np.asarray(jx.base.orbit.period_s))
    t0_s = float(np.asarray(jx.base.orbit.t0_s))
    starts = (t0_s + period_s / 2.0
              + np.linspace(-2.0 * 3600.0, 2.0 * 3600.0, N_EXP))
    cfg = dataclasses.replace(jx.cfg, eclipse=True)
    reads = jx.reads(cfg, dataclasses.replace(
        jx.visit, exp_start_s=jnp.asarray(starts, jnp.float32),
        fp_over_fs=jnp.broadcast_to(jnp.full((NL,), 1.5e-3, jnp.float32),
                                    (N_EXP, NL))))
    queue = _same_reads(monkeypatch, reads)
    got = vr.eclipse_mode_reference(core)
    want = jx.run(reads,
                  mid=jnp.asarray(starts + jx.exptime / 2.0, jnp.float32),
                  kind="eclipse",
                  rp_geom=jnp.float32(float(jx.rp_inj.mean())))
    np.testing.assert_allclose(got, want["fp"], rtol=0, atol=2e-6)
    assert not queue


def test_staring_reference_matches_jax(core, jx, monkeypatch):
    orbit_ph = 2.0 * np.pi * (jx.starts % HST_PERIOD_S) / HST_PERIOD_S
    rng_env = np.random.default_rng(9)
    sky_var = (np.asarray(jx.visit.sky_level, np.float64)
               * (1.0 + 0.10 * np.cos(orbit_ph)
                  + 0.03 * rng_env.standard_normal(N_EXP)))
    reads = jx.reads(dataclasses.replace(jx.cfg, scan=False),
                     dataclasses.replace(
        jx.visit, stellar_flux=jx.visit.stellar_flux * jnp.float32(0.05),
        scan_speed=jnp.zeros((N_EXP,), jnp.float32),
        psf_scale=jnp.asarray(1.0 + 0.015 * np.sin(orbit_ph), jnp.float32),
        sky_level=jnp.asarray(sky_var, jnp.float32)))
    queue = _same_reads(monkeypatch, reads)
    got = vr.staring_mode_reference(core, STARING["y_window"])
    want = jx.run(reads, y_window=STARING["y_window"], kind="divide-white")
    _rp(got, want["rp"], "staring")
    assert not queue


def test_scan_direction_reference_matches_jax(core, jx, monkeypatch):
    """Both directions' depths, and the white curves at atol 5e-6 (the
    reduction tests' bar)."""
    rev = np.arange(N_EXP) % 2 == 1
    reads = jx.reads(jx.cfg, dataclasses.replace(
        jx.visit,
        scan_speed=jnp.asarray(np.where(rev, -0.5, 0.5), jnp.float32),
        y_ref=jnp.asarray(np.where(rev, Y_REF + 0.5 * jx.exptime, Y_REF),
                          jnp.float32),
        stellar_flux=jx.visit.stellar_flux
        * jnp.asarray(np.where(rev, 1.005, 1.0), jnp.float32)[:, None]))
    queue = _same_reads(monkeypatch, reads, reads)
    got = vr.scan_direction_reference(core)
    for name, scan_dir in (("raw", None),
                           ("corrected", jnp.asarray(rev, jnp.float32))):
        want = jx.run(reads, scan_dir=scan_dir)
        _rp(got[name]["rp"], want["rp"], name)
        np.testing.assert_allclose(got[name]["white_lc"], want["white_lc"],
                                   atol=5e-6, err_msg=name)
    assert not queue


def test_phase_curve_reference_matches_jax(core, jx, monkeypatch):
    """fp atol 2e-6 (measured 8.2e-7; the fit's own test floor is 1e-5),
    the amplitude and offset atol 1e-3 (measured 2.3e-4 and 1.5e-4; the
    fit's own test floor for A is 3e-5 / fp = 0.015); its noise-free
    fp_sigma, ~1e-7 from a residual at float32 rounding, is not held."""
    period_s = float(np.asarray(jx.base.orbit.period_s))
    starts = np.linspace(0.0, period_s, N_EXP)
    cfg = dataclasses.replace(jx.cfg, eclipse=True)
    reads = jx.reads(cfg, dataclasses.replace(
        jx.visit, exp_start_s=jnp.asarray(starts, jnp.float32),
        fp_over_fs=jnp.broadcast_to(jnp.full((NL,), 2.0e-3, jnp.float32),
                                    (N_EXP, NL)),
        phase_amp=jnp.full_like(jx.visit.phase_amp, 0.5),
        phase_offset=jnp.full_like(jx.visit.phase_offset, 0.3)))
    queue = _same_reads(monkeypatch, reads)
    got = vr.phase_curve_mode_reference(core)
    want = jx.run(reads,
                  mid=jnp.asarray(starts + jx.exptime / 2.0, jnp.float32),
                  kind="phase", rp_geom=jnp.float32(float(jx.rp_inj.mean())))
    np.testing.assert_allclose(got[0], want["fp"], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[[1, 2]], [want["amp"], want["offset"]],
                               rtol=0, atol=1e-3)
    assert not queue


def test_g102_reference_matches_jax(core, jx, monkeypatch):
    tables = synthetic_tables_j("G102", subarray=S, n_lambda=NL,
                                samp_seq=SEQ, nsamp=NSAMP)
    base = example_scene_j(NL, scan_speed=0.5)
    wl = np.asarray(tables.wl_centers)
    base = dataclasses.replace(
        base, x_ref=jnp.float32(G102["x_ref"]), y_ref=jnp.float32(Y_REF),
        rp_over_rs=jnp.asarray(0.1595 + 0.003 * np.sin(8.0 * wl),
                               jnp.float32),
        trends=dataclasses.replace(base.trends,
                                   ssv_rw_amp=jnp.float32(0.005)))
    visit = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (N_EXP,) + x.shape), base)
    visit = dataclasses.replace(
        visit, exp_start_s=jnp.asarray(jx.starts, jnp.float32))
    reads = jx.reads(jx.cfg, visit, tables)
    queue = _same_reads(monkeypatch, reads)
    got = vr.g102_mode_reference(core, **G102)
    want = jx.run(reads, tables=tables,
                  quad=quadrant_map_j(S, tables.subarray_corner),
                  x_window=G102["x_window"], kind="divide-white")
    _rp(got, want["rp"], "g102")
    assert not queue

# ---------------------------------------------------------------------------
# The run, its record and the CLIs
# ---------------------------------------------------------------------------

def _validation_keys():
    with open(os.path.join(REPO, "VALIDATION.json")) as fh:
        ref = json.load(fh)
    main = {k for k, v in ref.items() if not isinstance(v, dict)}
    return ref, main


def test_run_sections_writes_the_jax_keys_and_merges(tmp_path):
    """A seeded main section (4 realisations) and then eclipse_mode (its
    8) into tmp_path: the JAX record's keys plus backend and card, the
    second merged into the first, the repository's files untouched; the
    same seeds give the same numbers."""
    root = os.path.join(REPO, "VALIDATION_TORCH.json")
    before = os.stat(root).st_mtime_ns if os.path.exists(root) else None
    out = str(tmp_path / "v.json")
    rec, gates = vr.run_sections(["main"], n_mc=4, device="cpu", out=out,
                                 core_kw=CORE)
    ref, main_keys = _validation_keys()
    assert set(rec) == main_keys | {"card"}
    assert rec["backend"] == "cpu" and rec["card"] is None
    assert rec["n_mc"] == 4 and rec["n_exp"] == N_EXP
    assert set(gates) == {"main_noise", "main_sys", "main_sigma",
                          "main_coverage"}
    assert np.all(np.isfinite(rec["rp_recovered_mean"]))
    rec2, _ = vr.run_sections(["eclipse_mode"], n_mc=4, device="cpu",
                              out=out, core_kw=CORE)
    assert set(rec2) == {"eclipse_mode"}
    assert set(rec2["eclipse_mode"]) == set(ref["eclipse_mode"]) | {
        "backend", "card"}
    assert rec2["eclipse_mode"]["n_mc"] == 8
    with open(out) as fh:
        merged = json.load(fh)
    assert merged == dict(rec, **rec2)
    again, _ = vr.run_sections(["main"], n_mc=4, device="cpu",
                               out=str(tmp_path / "w.json"), core_kw=CORE)
    for key in ("rp_recovered_mean", "reported_sigma"):
        assert again[key] == rec[key]
    after = os.stat(root).st_mtime_ns if os.path.exists(root) else None
    assert after == before


def test_triangle_runs_and_writes_the_jax_keys(tmp_path):
    """Four realisations, 300 MCMC steps: the JAX record's keys plus
    card, finite ratios, one sampler call over every realisation's
    channels."""
    with open(os.path.join(REPO, "UNCERTAINTY.json")) as fh:
        ref = json.load(fh)
    rec, ok = ut.run_triangle(n_mc=4, device="cpu",
                              out=str(tmp_path / "u.json"), core_kw=CORE,
                              n_steps=300, n_burn=100)
    assert set(rec) == set(ref) | {"card"}
    assert rec["backend"] == "cpu" and rec["n_mc"] == 4
    assert len(rec["lm_over_scatter"]) == N_CHAN
    assert np.all(np.isfinite(rec["mcmc_over_scatter"]))
    assert isinstance(ok, bool)
    with open(tmp_path / "u.json") as fh:
        assert json.load(fh) == rec


def test_committed_records_carry_the_jax_keys():
    """VALIDATION_TORCH.json has every section and key of VALIDATION.json
    (plus backend and card), from the card; UNCERTAINTY_TORCH.json every
    key of UNCERTAINTY.json (plus card)."""
    ref, main_keys = _validation_keys()
    with open(os.path.join(REPO, "VALIDATION_TORCH.json")) as fh:
        got = json.load(fh)
    assert set(got) == set(ref) | {"card"}
    for name, section in ref.items():
        if isinstance(section, dict):
            assert set(got[name]) == set(section) | {"backend", "card"}, name
            assert got[name]["backend"] == "cuda", name
    assert got["backend"] == "cuda" and got["card"]
    with open(os.path.join(REPO, "UNCERTAINTY.json")) as fh:
        uref = json.load(fh)
    with open(os.path.join(REPO, "UNCERTAINTY_TORCH.json")) as fh:
        ugot = json.load(fh)
    assert set(ugot) == set(uref) | {"card"}
    assert ugot["backend"] == "cuda" and ugot["card"]


def test_unknown_section_is_refused_as_the_jax_tool_refuses(monkeypatch):
    """``--sections`` with an unknown name exits with the JAX tool's
    message, before anything runs."""
    sys.path.insert(0, REPO)
    from tools import validate_recovery as jax_tool

    argv = ["--sections", "main,bogus,eclipse"]
    monkeypatch.setattr(sys, "argv", ["validate_recovery.py"] + argv)
    with pytest.raises(SystemExit) as want:
        jax_tool.main()
    with pytest.raises(SystemExit) as got:
        vr.main(argv)
    assert str(got.value) == str(want.value)
    assert "bogus" in str(got.value) and "eclipse" in str(got.value)
    with pytest.raises(ValueError, match="bogus"):
        vr.run_sections(["bogus"], device="cpu")


def test_scan_crossing_repair_matches_jax_and_misses_the_crossing():
    """ROADMAP C15: a cosmic ray in the read interval in which the scan
    crosses a pixel. The interval repair (both packages) takes the
    crossing's shape from the clean column neighbours and its amplitude
    from the ratio of the pixel's own clean intervals to theirs, which
    carry only the background (sky, dark, the trace's wings): where that
    ratio differs from the crossings', the repaired charge misses the
    crossing's by tens of percent, the heavy tail of the main and eclipse
    sections' bluest channel. The port's repair equals the JAX package's
    (rtol 1e-6)."""
    from wayne_tpu.reduction import repair_read_stack as repair_j
    from wayne_tpu_torch.reduction import repair_read_stack

    rng = np.random.default_rng(3)
    n_read, rows, cols = 6, 5, 9
    # ~10 DN an interval of background, 17 in the hit pixel's column; the
    # scan lights the row band in interval 2
    diffs = 10.0 + rng.normal(0.0, 1.0, (n_read - 1, rows, cols))
    diffs[:, :, 4] += 7.0
    diffs[2] += 15600.0
    reads = np.concatenate([np.zeros((1, rows, cols)),
                            np.cumsum(diffs, axis=0)]).astype(np.float32)
    truth = reads[-1] - reads[0]
    good = np.ones((n_read - 1, rows, cols), bool)
    good[2, 2, 4] = False                # the hit, in the crossing interval
    got = repair_read_stack(torch.as_tensor(reads),
                            torch.as_tensor(good)).numpy()
    want = np.asarray(repair_j(jnp.asarray(reads), jnp.asarray(good)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    cds = got[-1] - got[0]
    np.testing.assert_allclose(np.delete(cds.ravel(), 2 * cols + 4),
                               np.delete(truth.ravel(), 2 * cols + 4),
                               rtol=1e-6, atol=1e-2)
    assert abs(cds[2, 4] / truth[2, 4] - 1.0) > 0.1, (cds[2, 4], truth[2, 4])
