"""The port's tracer (``wayne_tpu_torch.utils.profiling``) and the spans
inside the fits.

Off, a span is one shared object that records nothing, and the fits give
the same bits as with tracing on. On, every span has its name, its parent
and its root (one root id per top-level call), ``_lm_minimize`` leaves one
``lm.step`` a step, and the per-name totals' self time is the total less
the children. Under ``torch.profiler`` each span leaves a ``wt:``
annotation on the records' clock. ``run_reduce --trace`` writes the Chrome
trace and the spans' records. The host-sync counter needs a card.
"""

import contextlib
import io
import json
import math
import statistics

import numpy as np
import pytest
import torch
import yaml

from wayne_tpu_torch import reduction as red
from wayne_tpu_torch.ops.kepler import OrbitParams, projected_separation
from wayne_tpu_torch.ops.transit import transit_depth_curve
from wayne_tpu_torch.utils import profiling
from wayne_tpu_torch.utils.profiling import StageTimers, span, tracing

torch.set_num_threads(1)

ORBIT_S = 95.47 * 60.0                  # HST orbital period
ORBIT = dict(period_s=0.813475 * 86400.0, t0_s=9700.0, sma_rs=4.855,
             inc_rad=math.radians(82.1))
LD = torch.tensor([0.65, -0.25, 0.45, -0.2])
RP = 0.1595
N_CHAN = 4


@pytest.fixture(scope="module")
def curves():
    """A four-orbit visit's white and channel curves: transit x the hook
    trend (doubled in orbit 1) x a slope, plus 1e-4 noise."""
    k, i = np.meshgrid(np.arange(4), np.arange(11), indexing="ij")
    t_orb = (60.0 + 250.0 * i).ravel()
    t = (k.ravel() * ORBIT_S + t_orb).astype(np.float32)
    trend = ((1.0 - 0.01 / 86400.0 * (t - t[0]))
             * (1.0 - 0.003 * np.where(k.ravel() == 0, 2.0, 1.0)
                * np.exp(-t_orb / 300.0)))
    orbit = OrbitParams.create(**ORBIT)
    tt = torch.from_numpy(t)
    z, front = projected_separation(tt, orbit)
    rng = np.random.default_rng(5)

    def curve(rp):
        f = transit_depth_curve(z, torch.tensor(rp), LD, 32)
        sig = (1.0 - (1.0 - f) * front).numpy()
        return (sig * trend * (1.0 + 1e-4 * rng.standard_normal(t.size))
                ).astype(np.float32)

    white = torch.from_numpy(curve(RP))
    chan = torch.from_numpy(np.stack(
        [curve(RP + 0.002 * c) for c in range(N_CHAN)], axis=1))
    return tt, orbit, white, chan


def _fit_white(curves, **kw):
    t, orbit, white, _ = curves
    return red.fit_white_ramp(white, t, orbit, LD, 0.15, **kw)


def _fit_depths(curves):
    t, orbit, _, chan = curves
    return red.fit_depths(chan, t, orbit, LD, RP)


def _detrend(curves):
    t, orbit, _, chan = curves
    return red.ramp_detrend(chan, _fit_white(curves, n_iter=10), t, orbit)


def _tensors(out):
    """Every tensor of a fit's result, in a fixed order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, tuple):
        return [x for o in out for x in _tensors(o)]
    return [x for f in out.__dataclass_fields__
            for x in _tensors(getattr(out, f))]


CASES = {
    "white_plain": lambda c: _fit_white(c, n_iter=60),
    "white_clip": lambda c: _fit_white(c, n_iter=20, clip_sigma=3.0),
    "white_geometry_vmap": lambda c: _fit_white(c, n_iter=10,
                                                fit_geometry=True),
    "detrend": _detrend,
    "depths": _fit_depths,
}


def test_off_is_one_shared_object_and_records_nothing(curves):
    assert not profiling._on
    a, b = span("fit.white"), span("lm.step")
    assert a is b and not hasattr(a, "__dict__")
    with a as entered:
        assert entered is a
    _fit_white(curves, n_iter=3)
    _fit_depths(curves)
    assert profiling._spans == [] and profiling._syncs == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_results_bit_for_bit_with_tracing_on_and_off(curves, case):
    off = _tensors(CASES[case](curves))
    with tracing() as handle:
        on = _tensors(CASES[case](curves))
    assert handle.spans, "tracing on recorded no span"
    assert len(on) == len(off)
    for x, y in zip(off, on):
        assert torch.allclose(x, y, rtol=0.0, atol=0.0, equal_nan=True)


def test_span_tree_of_a_fit(curves):
    t, orbit, _, chan = curves
    with tracing() as handle:
        w = _fit_white(curves, n_iter=60)
        detrended = red.ramp_detrend(chan, w, t, orbit)
        red.fit_depths(detrended, t, orbit, LD, RP)
    spans = handle.spans
    names = [s.name for s in spans]
    assert names == ["fit.white"] + ["lm.step"] * 60 + ["fit.detrend",
                                                       "fit.depths"]
    white = spans[0]
    assert white.parent is None and white.root == white.id
    for s in spans[1:61]:
        assert s.parent == white.id and s.root == white.id
        assert white.start_ns <= s.start_ns <= s.end_ns <= white.end_ns
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["fit.white", "fit.detrend",
                                       "fit.depths"]
    assert len({s.root for s in roots}) == 3
    assert all(s.start_ns <= s.end_ns for s in spans)
    # CPU tensors: none to count, and nothing counts them without a card
    assert handle.counters() == {
        "host_syncs": 0 if torch.cuda.is_available() else None}
    summary = StageTimers(spans).summary()
    steps = sum(s.end_ns - s.start_ns for s in spans[1:61]) / 1e9
    wall = (white.end_ns - white.start_ns) / 1e9
    assert summary["lm.step"]["count"] == 60
    assert summary["fit.white"]["total_s"] == pytest.approx(wall, abs=1e-9)
    assert summary["fit.white"]["self_s"] == pytest.approx(wall - steps,
                                                           abs=1e-9)
    assert summary["lm.step"]["self_s"] == pytest.approx(steps, abs=1e-9)
    assert profiling._spans == []           # off again: the handle holds them


def test_clipped_and_vmapped_fits_step_once_a_step(curves):
    with tracing() as handle:
        _fit_white(curves, n_iter=5, clip_sigma=3.0, clip_rounds=2)
        _fit_white(curves, n_iter=4, fit_geometry=True)
    steps = [s for s in handle.spans if s.name == "lm.step"]
    # 5 + 2 x 5 steps clipped; 4 + 25 (every seed at once, in vmap) + 4
    assert len(steps) == 5 + 2 * 5 + 4 + 25 + 4


def test_handles_nest_and_keep_their_records():
    first = profiling.enable()
    with span("a"):
        pass
    second = profiling.enable()
    with span("b"):
        pass
    first.restore()
    assert profiling._on
    with span("c"):
        pass
    second.restore()
    second.restore()                        # a second restore does nothing
    assert not profiling._on and profiling._users == 0
    assert [s.name for s in first.spans] == ["a", "b"]
    assert [s.name for s in second.spans] == ["b", "c"]
    with span("d"):
        pass
    assert profiling._spans == []


def test_threads_keep_their_own_nesting():
    """Eight threads open nested spans at once, with the interpreter
    switching threads every microsecond: every child's parent is a span of
    its own thread, and no record is lost."""
    import sys
    import threading

    per_thread, n_threads = 200, 8
    owner = {}

    def work(k):
        for _ in range(per_thread):
            with span("outer") as outer:
                owner[outer.id] = k
                with span("inner") as inner:
                    owner[inner.id] = k

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing() as handle:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    spans = handle.spans
    assert len(spans) == 2 * per_thread * n_threads
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        if s.name == "inner":
            assert owner[s.parent] == owner[s.id] and s.root == s.parent
        else:
            assert s.parent is None and s.root == s.id


def test_timers_report_every_name():
    with tracing() as handle:
        with span("stage"):
            with span("inner"):
                pass
        open_span = span("left_open")
        open_span.__enter__()
    timers = StageTimers(handle.spans)
    assert set(timers.summary()) == {"stage", "inner"}
    assert "stage" in timers.report() and "inner" in timers.report()
    open_span.__exit__(None, None, None)


def test_annotations_share_the_records_clock(curves):
    from torch.profiler import ProfilerActivity, profile

    with tracing() as handle, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with span("warm"):                  # the profiler's first event
            pass
        _fit_white(curves, n_iter=8)
        _fit_depths(curves)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiling.PREFIX):
            events.setdefault(ev.name(), []).append(ev)
    spans = [s for s in handle.spans if s.name != "warm"]
    assert [s.name for s in spans] == (["fit.white"] + ["lm.step"] * 8
                                       + ["fit.depths"])
    starts, ends = [], []
    for name in ("fit.white", "lm.step", "fit.depths"):
        evs = sorted(events[profiling.PREFIX + name],
                     key=lambda e: e.start_ns())
        mine = [s for s in spans if s.name == name]
        assert len(evs) == len(mine)
        for s, ev in zip(mine, evs):
            assert ev.is_user_annotation()
            starts.append(ev.start_ns() - s.start_ns)
            ends.append(s.end_ns - (ev.start_ns() + ev.duration_ns()))
    # within 0.1 ms at either end (each record encloses its annotation)
    assert all(abs(g) < 100_000 for g in starts + ends), (starts, ends)
    assert statistics.median(starts + ends) >= 0


@pytest.mark.cuda
def test_host_syncs_are_counted_on_the_card(curves):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    mode = torch.cuda.get_sync_debug_mode()
    x = torch.ones(8, device=dev)
    t, orbit, white, _ = curves
    orbit_d = OrbitParams.create(**ORBIT, device=dev)
    with tracing() as handle:
        with span("two"):
            x.sum().item()
            x.cpu()
        red.fit_white_ramp(white.to(dev), t.to(dev), orbit_d, LD.to(dev),
                           0.15, n_iter=5)
        torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == mode
    by_name = {}
    for s in handle.spans:
        by_name.setdefault(s.name, []).append(s.host_syncs)
    assert by_name["two"] == [2]
    # no sync inside a step: the eager first, the capture, the replays
    assert by_name["lm.step"] == [0]
    assert by_name["lm.capture"] == [0]
    assert by_name["lm.replay"] == [0] * 4
    total = handle.counters()["host_syncs"]
    assert total == len(handle.syncs) >= 2
    assert sum(h for hs in by_name.values() for h in hs) <= total


@pytest.fixture(scope="module")
def tiny_visit(tmp_path_factory):
    """A 64^2 NSAMP 3 transit visit of 40 exposures the port writes."""
    from wayne_tpu_torch.run_visit import main as visit

    root = tmp_path_factory.mktemp("trace")
    pars = root / "pars.yml"
    pars.write_text(yaml.safe_dump({
        "observation": {
            "grism": "G141", "subarray": 64, "NSAMP": 3,
            "SAMPSEQ": "SPARS10", "scan": True, "scan_speed": 1.0,
            "x_ref": -60.0, "y_ref": 10.0, "exposure_overhead_s": 280.0,
            "n_lambda": 48, "n_sub": 2, "num_orbits": 4,
            "exposures_per_orbit": 10, "start_mjd": 55999.86, "seed": 3,
            "outdir": str(root / "visit")},
        "target": {"name": "WASP-43", "mag_J": 9.995},
        "planet": {"period": 0.813475, "t0": 56000.0, "sma_over_rs": 4.855,
                   "inclination": 82.1, "rp_over_rs": 0.1595,
                   "ld_coeffs": [0.65, -0.25, 0.45, -0.2]}}))
    with contextlib.redirect_stdout(io.StringIO()):
        assert visit(["-p", str(pars), "--cpu", "--chunk", "8"]) == 0
    return str(root / "visit"), str(pars)


def test_run_reduce_trace_writes_the_trace_and_the_spans(tiny_visit,
                                                         tmp_path):
    from wayne_tpu_torch.run_reduce import main as reduce

    visit, pars = tiny_visit
    out = tmp_path / "trace"
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert reduce(["-d", visit, "-p", pars, "--cpu", "--n-chan", "3",
                       "--detrend", "ramp", "-o", str(tmp_path / "r.json"),
                       "--trace", str(out)]) == 0
    assert "lm.step" in printed.getvalue()
    with open(out / "spans.json") as fh:
        rec = json.load(fh)
    with open(out / "trace.json") as fh:
        annotations = {e["name"] for e in json.load(fh)["traceEvents"]
                       if e.get("name", "").startswith(profiling.PREFIX)}
    spans = rec["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert names[0] == "reduce.extract" and names[1] == "reduce.fit"
    assert names.count("lm.step") == 60
    assert {"fit.white", "fit.detrend", "fit.depths"} <= set(names)
    fit_root = spans[1]["id"]
    for s in spans[2:]:
        assert s["root"] == fit_root and s["parent"] in by_id
    assert spans[0]["parent"] is None and spans[0]["root"] == spans[0]["id"]
    assert rec["counters"] == {
        "host_syncs": 0 if torch.cuda.is_available() else None}
    assert rec["summary"]["lm.step"]["count"] == 60
    assert set(rec["summary"]["reduce.fit"]) >= {"count", "total_s",
                                                 "self_s"}
    assert annotations == {profiling.PREFIX + n for n in set(names)}
    assert not profiling._on
