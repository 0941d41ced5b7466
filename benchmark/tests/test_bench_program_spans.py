"""The readers of the program's own spans (``metrics/lm_step_ms``,
``device_idle.lm_step``, ``depth_fit_ms``, ``host_syncs_per_fit``) on
hand-made traces, a traced CPU run of ``scan-rampfit`` that reports them,
the same run on a program without the tracer (they fall silent), and, on
the card, the spans' clock against the device trace."""

import json
import statistics
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import program_spans, registry, runner
from benchmark.harness import trace as tr
from benchmark.harness.registry import load_module
from benchmark.tests.conftest import ROOT, cell_of, cpu_devices

READERS = ("lm_step_ms", "device_idle.lm_step", "depth_fit_ms",
           "host_syncs_per_fit")
MS = 1_000_000


def _span(name, start_ms, end_ms):
    return SimpleNamespace(name=name, start_ns=start_ms * MS,
                           end_ns=end_ms * MS)


def _trace(spans, syncs=None, kernels=(), fits=2, devices=(0,)):
    """A trace whose plain phase is 0-1000 ms (``fits`` visits) and whose
    spanned phase follows; every reader's handle holds ``spans`` and
    ``syncs``."""
    handle = SimpleNamespace(spans=spans, syncs=syncs)
    return tr.Trace(
        kernels=[tr.Kernel("k", 0, s * MS, e * MS, None) for s, e in kernels],
        devices=list(devices), plain=tr.Phase(0, 1000 * MS, {"fits": fits}),
        spanned=tr.Phase(1000 * MS, 2000 * MS, {"fits": fits}),
        installed={name: handle for name in READERS})


SPANS = [
    _span("fit.white", 0, 300), _span("lm.step", 10, 20),
    _span("lm.step", 20, 50), _span("lm.step", 50, 60),
    _span("fit.detrend", 300, 310), _span("fit.depths", 310, 400),
    _span("fit.white", 500, 800), _span("lm.step", 510, 530),
    _span("fit.depths", 810, 910),
    # the spanned phase: never read
    _span("lm.step", 1100, 1900), _span("fit.depths", 1200, 1900),
]


def _read(name, trace):
    return load_module("metrics", name).read(trace)


def test_lm_step_ms_is_the_median_step_of_the_plain_phase():
    # plain steps of 10, 30, 10 and 20 ms
    assert _read("lm_step_ms", _trace(SPANS)) == pytest.approx(15.0)


def test_depth_fit_ms_is_the_depth_fits_time_per_fit():
    assert _read("depth_fit_ms", _trace(SPANS)) == pytest.approx(
        (90 + 100) / 2)
    assert _read("depth_fit_ms", _trace(SPANS, fits=0)) is None


def test_device_idle_lm_step_counts_the_union_inside_the_steps():
    # steps 10-20, 20-50, 50-60 and 510-530 (70 ms); kernels 5-15 and
    # 12-25 (union 5-25: 10 ms in the first step, 5 in the second), 40-45
    # (5), 100-200 (outside every step), 525-600 (5)
    kernels = [(5, 15), (12, 25), (40, 45), (100, 200), (525, 600)]
    got = _read("device_idle.lm_step", _trace(SPANS, kernels=kernels))
    assert got == pytest.approx(100.0 * (1.0 - 25.0 / 70.0))
    # no card in the trace, or no activity: nothing to read
    assert _read("device_idle.lm_step",
                 _trace(SPANS, kernels=kernels, devices=())) is None
    assert _read("device_idle.lm_step", _trace(SPANS)) is None


def test_host_syncs_per_fit_counts_the_plain_phase():
    syncs = [(1 * MS, 1), (5 * MS, None), (990 * MS, 7), (1500 * MS, 9)]
    assert _read("host_syncs_per_fit",
                 _trace(SPANS, syncs=syncs)) == pytest.approx(1.5)
    assert _read("host_syncs_per_fit", _trace(SPANS, syncs=[])) == 0.0
    # no card: the program counted nothing
    assert _read("host_syncs_per_fit", _trace(SPANS, syncs=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name):
    empty = _trace([], syncs=None, kernels=[(0, 10)])
    assert _read(name, empty) is None
    # a program without the tracer: no handle at all
    bare = _trace(SPANS, syncs=[(1, 1)], kernels=[(0, 10)])
    bare.installed = {}
    assert _read(name, bare) is None


def test_benchmark_json_names_the_readers():
    spec = registry.load_spec(ROOT)
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["workloads"], m["moves"], m["better"], m["source"]) == (
            ["scan-rampfit"], "fits_per_s", "lower", "device_trace")
        assert hasattr(load_module("metrics", name), "install")


def _traced():
    cell = cell_of("scan-rampfit")
    return runner.run_cell(cell, 2 ** 31 + 57, 0.5, True, time.time(),
                           devices=cpu_devices(cell), log=lambda s: None)


def test_traced_cpu_run_reports_the_span_metrics():
    from wayne_tpu_torch.utils import profiling

    res = _traced()
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["lm_step_ms"]["value"] > 0
    assert metrics["lm_step_ms"]["unit"] == "ms"
    assert metrics["depth_fit_ms"]["value"] > 0
    # no card: no device intervals and no sync counter
    assert "device_idle.lm_step" not in metrics
    assert "host_syncs_per_fit" not in metrics
    assert not profiling._on


def test_a_program_without_the_tracer_leaves_them_out(monkeypatch):
    from wayne_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    res = _traced()
    assert res["correct"]
    assert not set(READERS) & set(res["metrics"])


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock_on_the_card():
    """The median gap between a span's record and its ``wt:`` annotation
    is under 0.1 ms, and the fit spans hold at least 95% of the card's idle
    time; prints the numbers and the idle time by span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from wayne_tpu_torch.utils import profiling

    cell = cell_of("scan-rampfit")
    kind = registry.load_module("kinds", cell.traffic["kind"])
    device = torch.device("cuda")
    state = kind.setup(cell.config, cell.traffic, 2 ** 31 + 11, [device])
    with profiling.tracing() as handle, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.time_ns()
        for i in range(cell.traffic["trace_requests"]):
            with torch.profiler.record_function("bench:request"):
                state.request(i)
        torch.cuda.synchronize()
        end = time.time_ns()
    kernels, _ = tr.reduce_profile(prof, start, end)
    notes: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.name().startswith(profiling.PREFIX)
                and ev.device_type() == torch.autograd.DeviceType.CPU):
            notes.setdefault(ev.name()[len(profiling.PREFIX):], []).append(ev)
    gaps = []
    for name, evs in notes.items():
        mine = [s for s in handle.spans if s.name == name]
        assert len(mine) == len(evs), name
        for s, ev in zip(mine, sorted(evs, key=lambda e: e.start_ns())):
            gaps += [abs(ev.start_ns() - s.start_ns),
                     abs(s.end_ns - ev.start_ns() - ev.duration_ns())]
    dev = device.index or 0
    window = [SimpleNamespace(start_ns=start, end_ns=end)]
    idle = (end - start) / 1e9 - program_spans.busy_inside(kernels, dev,
                                                            window)
    by_name = {}
    for name in ("fit.white", "lm.step", "fit.detrend", "fit.depths"):
        spans = [s for s in handle.spans if s.name == name]
        by_name[name] = (program_spans.seconds(spans)
                         - program_spans.busy_inside(kernels, dev, spans))
    in_fits = by_name["fit.white"] + by_name["fit.detrend"] + by_name[
        "fit.depths"]
    print(json.dumps({"median_gap_ms": statistics.median(gaps) / 1e6,
                      "max_gap_ms": max(gaps) / 1e6,
                      "idle_s": idle, "idle_in_fit_spans": in_fits / idle,
                      "idle_s_by_span": by_name,
                      "idle_s_rest": idle - in_fits,
                      "host_syncs": handle.counters()["host_syncs"]}))
    assert statistics.median(gaps) < 100_000
    assert in_fits >= 0.95 * idle
