"""The port's RECTE white fit (``reduction.fit_white_recte`` over
``ops.recte.white_ramp``) against the benchmark's plain float64 reference
written from Zhou et al. (2017) (``benchmark/reference/recte.py``), and
its spans.

On the CPU: the trap ramp on seeded rates, fills, start times and
exposure times; a 12-step fit of a visit the reference made, against the
reference's fit of the same float32 arrays; with tracing on, one
``fit.recte`` span holding the 12 ``lm.step`` spans and the ``recte.ramp``
spans of the trap loop, and the same bits as with tracing off; ``run_reduce
--detrend recte --trace`` lists ``fit.recte`` under ``reduce.fit``. On the
card (marker ``cuda``): the graph path's spans (1 eager step, 1 capture,
79 replays, no host sync in the capture or a replay), the same bits with
tracing on and off, and ``run_reduce``'s trace. This file imports neither
JAX nor the JAX package:

    python -m pytest tests/test_torch_recte_reference.py --noconftest \
        -m cuda -q
"""

import contextlib
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams
from wayne_tpu_torch.ops.recte import white_ramp
from wayne_tpu_torch.utils.profiling import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import fits as ref  # noqa: E402
from benchmark.reference import recte as rec  # noqa: E402

torch.set_num_threads(1)

MIDTIMES = os.path.join(ROOT, "benchmark", "configs",
                        "wasp43b-g141-fullsys.midtimes.json")
LD = [0.65, -0.25, 0.45, -0.2]
RP = 0.1595
RATE = 300.0                # e-/s per pixel, the order of a G141 scan's
N_CHAN = 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("seed", range(8))
def test_white_ramp_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 90))
    exptime = float(rng.uniform(10.0, 300.0))
    gaps = np.where(rng.random(n) < 0.1, rng.uniform(1e3, 3e3, n),
                    rng.uniform(0.0, 60.0, n))
    starts = (np.cumsum(gaps + exptime) + rng.uniform(0.0, 5e4)
              ).astype(np.float32)
    rate = float(np.exp(rng.uniform(math.log(5.0), math.log(5e3))))
    f0_s, f0_f = (float(f) for f in rng.uniform(0.0, 1.0, 2))
    got = white_ramp(torch.tensor(rate), torch.from_numpy(starts), exptime,
                     f0_s=f0_s, f0_f=f0_f).double()
    want = rec.white_ramp(rate, torch.from_numpy(starts.astype(np.float64)),
                          exptime, rec.Traps(), f0_s, f0_f)
    # the ramp lies within a few percent of 1, where float32 is spaced
    # 6e-8: the port's float32 loop carries a few such roundings (4.6e-8 at
    # most over 200 seeds), while a wrong trap parameter, gap or fill moves
    # it by 1e-4 and more
    assert float((got - want).abs().max()) < 1e-6


def _orbit_elements():
    with open(MIDTIMES) as fh:
        frozen = json.load(fh)
    f32 = lambda v: float(np.float32(v))
    orbit = ref.Orbit(period_s=f32(0.813475 * 86400.0),
                      t0_s=f32((56000.0 - frozen["visit_start_mjd"])
                               * 86400.0),
                      sma_rs=f32(4.855), inc_rad=f32(math.radians(82.1)),
                      ecc=0.0, omega_rad=f32(math.radians(90.0)))
    return (np.asarray(frozen["exp_mid_s"], np.float32),
            float(frozen["exptime_s"]), orbit)


@pytest.fixture(scope="module")
def visit():
    """The full-systematics visit's clock, one white and N_CHAN channel
    curves the reference made: transit x the RECTE ramp (fills 0.3 and
    0.1, rate x1.1) x a slope, plus 2e-4 and 6e-4 noise."""
    t_mid, exptime, orbit = _orbit_elements()
    t = torch.from_numpy(t_mid.astype(np.float64))
    z, front = ref.separation(t, orbit)
    ld = torch.tensor(LD, dtype=torch.float64)
    ramp = rec.white_ramp(RATE * 1.1, t - 0.5 * exptime, exptime,
                          rec.Traps(), 0.3, 0.1)
    sys_ = (1 - 0.002 * (t - t.mean()) / 86400.0) * ramp
    rng = np.random.default_rng(17)

    def curve(rp, noise):
        f = ref.transit_flux(z, torch.tensor(rp, dtype=torch.float64), ld, 64)
        return (sys_ * (1 - (1 - f) * front)
                + noise * torch.from_numpy(rng.standard_normal(len(t))))

    white = curve(RP + 4e-4, 2e-4).numpy().astype(np.float32)
    chan = torch.stack([curve(RP + 0.001 * c, 6e-4) for c in range(N_CHAN)],
                       dim=1).numpy().astype(np.float32)
    return t_mid, exptime, orbit, white, chan


def _args(visit, device):
    t_mid, exptime, o, white, chan = visit
    orbit = OrbitParams.create(o.period_s, o.t0_s, o.sma_rs, o.inc_rad,
                               o.ecc, o.omega_rad, device=device)
    to = lambda a: torch.as_tensor(a, device=device)
    return (to(white), to(t_mid), orbit, to(np.float32(LD))), to(chan)


def _recte(visit, device, n_iter):
    (white, t, orbit, ld), _ = _args(visit, device)
    return red.fit_white_recte(white, t, orbit, ld, RP, rate_e_s=RATE,
                               exptime_s=visit[1], n_iter=n_iter)


@pytest.fixture(scope="module")
def traced_fit(visit):
    """A 12-step fit on the CPU with tracing on, and its handle."""
    with tracing() as handle:
        fit = _recte(visit, "cpu", 12)
    return fit, handle


def _six(fit):
    return torch.stack([fit.c, fit.rp, fit.slope_per_day, fit.f0_s,
                        fit.f0_f, fit.rate_scale]).double()


@pytest.fixture(scope="module")
def reference_fit(visit):
    t_mid, exptime, orbit, white, chan = visit
    return rec.fit_recte_visit(white, chan, t_mid, exptime, orbit, LD, RP,
                               RATE, 12)


@pytest.mark.parametrize("i, name", enumerate(
    ["c", "rp", "slope_per_day", "f0_s", "f0_f", "rate_scale"]))
def test_fit_white_recte_matches_the_reference(traced_fit, reference_fit, i,
                                              name):
    fit, _ = traced_fit
    f = reference_fit
    # in units of the reference's own 1-sigma: float32 against float64
    # along the same 12 steps from the same start reads 0.019 at most here;
    # a tenth of a sigma is far below what a fit's user resolves, and a
    # wrong ramp or step moves the numbers by many sigma
    gap = abs(float(_six(fit)[i]) - float(f.white[i])) / float(
        f.white_sigma[i])
    assert gap < 0.1, (name, gap)


def test_depths_after_the_recte_detrend_match_the_reference(
        visit, traced_fit, reference_fit):
    fit, _ = traced_fit
    (_, t, orbit, ld), chan = _args(visit, "cpu")
    rp, _ = red.fit_depths(red.ramp_detrend(chan, fit, t, orbit), t, orbit,
                           ld, RP)
    gap = ((rp.double() - reference_fit.depth).abs()
           / reference_fit.depth_sigma)
    # the channels' systematic is the white fit's: its float32 gap above,
    # diluted in each channel's 3x larger noise, reads 0.0013 sigma at most
    assert float(gap.max()) < 0.05, gap


def test_one_fit_recte_span_holds_the_steps_and_the_trap_loops(traced_fit):
    _, handle = traced_fit
    spans = handle.spans
    (root,) = [s for s in spans if s.name == "fit.recte"]
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "lm.step"]
    ramps = [s for s in spans if s.name == "recte.ramp"]
    assert len(steps) == 12 and all(s.parent == root.id for s in steps)
    assert {s.name for s in spans} == {"fit.recte", "lm.step", "recte.ramp"}
    # each step differentiates the model once and tries its step once;
    # the start's chi^2, the template and the curvature add three
    under = [by_id[s.parent].name for s in ramps]
    assert under.count("lm.step") == 2 * 12
    assert under.count("fit.recte") == 3
    assert all(s.root == root.id and s.end_ns >= s.start_ns for s in spans)


def _tensors(fit):
    return [getattr(fit, f) for f in fit.__dataclass_fields__]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_tracing_leaves_the_fit_bit_for_bit(visit, traced_fit, device):
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        dev = _card()
        with tracing():
            on = [_recte(visit, dev, 80)]
            # under the profiler each span also opens an annotation, inside
            # jacfwd and inside the capture
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                on.append(_recte(visit, dev, 80))
        off = _recte(visit, dev, 80)
    else:
        on, off = [traced_fit[0]], _recte(visit, "cpu", 12)
    for fit in on:
        for a, b in zip(_tensors(fit), _tensors(off)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_graph_path_under_one_fit_recte_span(visit):
    dev = _card()
    _recte(visit, dev, 80)                      # the card's first calls
    with tracing() as handle:
        _recte(visit, dev, 80)
        torch.cuda.synchronize()
    spans = handle.spans
    (root,) = [s for s in spans if s.name == "fit.recte"]
    by_id = {s.id: s for s in spans}

    def under_root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s is root

    counts = {}
    for s in spans:
        assert under_root(s)
        counts.setdefault(s.name, []).append(s.host_syncs)
    assert len(counts["lm.step"]) == 1
    assert counts["lm.capture"] == [0]
    assert counts["lm.replay"] == [0] * 79
    # the trap loop runs in the eager step and in the capture, never in a
    # replay: 2 a step, and 3 outside the steps
    ramps = [by_id[s.parent].name for s in spans if s.name == "recte.ramp"]
    assert ramps.count("lm.step") == 2 and ramps.count("lm.capture") == 2
    assert ramps.count("fit.recte") == 3
    assert all(by_id[s.parent].name != "lm.replay" for s in spans
               if s.parent is not None)


@pytest.fixture(scope="module")
def small_visit(tmp_path_factory):
    """A 64^2 NSAMP 3 transit visit of 16 exposures the port writes."""
    from wayne_tpu_torch.run_visit import main as run_visit

    root = tmp_path_factory.mktemp("recte")
    pars = root / "pars.yml"
    pars.write_text(yaml.safe_dump({
        "observation": {
            "grism": "G141", "subarray": 64, "NSAMP": 3,
            "SAMPSEQ": "SPARS10", "scan": True, "scan_speed": 1.0,
            "x_ref": -60.0, "y_ref": 10.0, "exposure_overhead_s": 600.0,
            "n_lambda": 48, "n_sub": 2, "num_orbits": 4,
            "exposures_per_orbit": 4, "start_mjd": 55999.86, "seed": 3,
            "outdir": str(root / "visit")},
        "target": {"name": "WASP-43", "mag_J": 9.995},
        "recte": True,
        "planet": {"period": 0.813475, "t0": 56000.0, "sma_over_rs": 4.855,
                   "inclination": 82.1, "rp_over_rs": 0.1595,
                   "ld_coeffs": LD}}))
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_visit(["-p", str(pars), "--cpu", "--chunk", "8"]) == 0
    return str(root / "visit"), str(pars)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_run_reduce_trace_lists_fit_recte_under_reduce_fit(small_visit,
                                                           tmp_path, device):
    from wayne_tpu_torch.run_reduce import main as reduce

    if device == "cuda":
        _card()
    visit, pars = small_visit
    out = tmp_path / "trace"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert reduce(["-d", visit, "-p", pars, "--n-chan", "3",
                       "--detrend", "recte", "-o", str(tmp_path / "r.json"),
                       "--trace", str(out)]
                      + (["--cpu"] if device == "cpu" else [])) == 0
    assert "white RECTE fit" in printed.getvalue()
    with open(out / "spans.json") as fh:
        spans = json.load(fh)["spans"]
    by_id = {s["id"]: s for s in spans}
    (fit,) = [s for s in spans if s["name"] == "fit.recte"]
    assert by_id[fit["parent"]]["name"] == "reduce.fit"
    steps = [s for s in spans if s["name"] in ("lm.step", "lm.replay")]
    assert len(steps) == 80 and all(s["parent"] == fit["id"] for s in steps)
    assert any(s["name"] == "recte.ramp" for s in spans)
