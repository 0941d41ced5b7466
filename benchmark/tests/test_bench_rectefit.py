"""The ``rectefit`` kind (``fullsys-rectefit``) on the CPU at a short LM:
``correct`` true as the program is, false with the timed path broken
underneath; and the readers of its three metrics (``recte_fit_ms``,
``device_idle.recte_fit``, ``recte_ramp_share``) on hand-made traces,
None where the program left nothing to read."""

import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import registry, runner
from benchmark.harness import trace as tr
from benchmark.harness.registry import load_module
from benchmark.tests.conftest import ROOT, cell_of, cpu_devices

CELL = "fullsys-rectefit"
READERS = ("recte_fit_ms", "device_idle.recte_fit", "recte_ramp_share")
MS = 1_000_000
SEED = 2 ** 31 + 321


def _short_cell(n_lm):
    """The cell with ``n_lm`` LM steps on both sides and no warm-up."""
    cell = cell_of(CELL)
    cell.traffic = dict(cell.traffic, n_lm=n_lm, warmup_requests=0)
    return cell


def _run(trace=False, n_lm=8, seed=SEED):
    cell = _short_cell(n_lm)
    return runner.run_cell(cell, seed, 0.1, trace, time.time(),
                           devices=cpu_devices(cell), log=lambda s: None)


def test_the_kind_at_a_short_lm_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert {c["name"] for c in res["checks"]} == {"white_gap", "depth_gap"}
    assert set(res["metrics"]) == {"fits_per_s", "setup_s"}


def test_a_traced_cpu_run_reports_the_span_readers():
    from wayne_tpu_torch.utils import profiling

    res = _run(trace=True)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["recte_fit_ms"]["value"] > 0
    assert 0 < metrics["recte_ramp_share"]["value"] < 100
    # no card: no device intervals
    assert "device_idle.recte_fit" not in metrics
    assert not profiling._on


def _fault(monkeypatch, fault):
    from wayne_tpu_torch import reduction

    if fault == "state_unchanged":
        def unchanged(resid, theta0, n_steps, lam0=1e-3):
            return theta0, torch.sum(resid(theta0) ** 2)

        monkeypatch.setattr(reduction, "_lm_minimize", unchanged)
        return
    if fault == "fills_swapped":
        fit = reduction.fit_white_recte

        def swapped(*a, **kw):
            w = fit(*a, **kw)
            return dataclasses.replace(w, f0_s=w.f0_f, f0_f=w.f0_s)

        monkeypatch.setattr(reduction, "fit_white_recte", swapped)
        return
    depths = reduction.fit_depths

    def altered(*a, **kw):
        rp, sig = depths(*a, **kw)
        return rp * torch.where(torch.arange(rp.shape[0]) == 3, 1.05,
                                1.0), sig

    monkeypatch.setattr(reduction, "fit_depths", altered)


# 8 steps leave the fills near their common start, so the swap is read at
# the cell's own 80 steps, on a seed whose first visit has fills 0.09 and
# 0.27 (a swap of two equal fills changes nothing)
@pytest.mark.parametrize("fault, n_lm, seed", [
    ("state_unchanged", 8, SEED), ("answer_altered", 8, SEED),
    ("fills_swapped", 80, SEED + 1)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, n_lm, seed):
    _fault(monkeypatch, fault)
    res = _run(n_lm=n_lm, seed=seed)
    assert res["attempted"] >= 1
    assert not res["correct"], res["checks"]


def _span(name, start_ms, end_ms, id_, parent=None):
    return SimpleNamespace(name=name, start_ns=start_ms * MS,
                           end_ns=end_ms * MS, id=id_, parent=parent)


def _trace(spans, kernels=(), fits=2, devices=(0,)):
    """A plain phase of 0-1000 ms (``fits`` visits) and a spanned phase
    after it; every reader's handle holds ``spans``."""
    handle = SimpleNamespace(spans=spans, syncs=None)
    return tr.Trace(
        kernels=[tr.Kernel("k", 0, s * MS, e * MS, None) for s, e in kernels],
        devices=list(devices), plain=tr.Phase(0, 1000 * MS, {"fits": fits}),
        spanned=tr.Phase(1000 * MS, 2000 * MS, {"fits": fits}),
        installed={name: handle for name in READERS})


SPANS = [
    _span("fit.recte", 0, 400, 1),
    _span("recte.ramp", 5, 8, 2, 1),          # the start's chi^2: not a step
    _span("lm.step", 10, 110, 3, 1),
    _span("recte.ramp", 20, 60, 4, 3), _span("recte.ramp", 70, 100, 5, 3),
    _span("lm.capture", 120, 220, 6, 1),
    _span("recte.ramp", 130, 190, 7, 6),
    _span("lm.replay", 230, 232, 8, 1),
    _span("fit.depths", 400, 500, 9),
    _span("fit.recte", 500, 700, 10),
    _span("lm.step", 510, 610, 11, 10), _span("recte.ramp", 520, 560, 12, 11),
    # the spanned phase: never read
    _span("fit.recte", 1100, 1900, 13),
    _span("lm.step", 1110, 1200, 14, 13),
    _span("recte.ramp", 1120, 1190, 15, 14),
]


def _read(name, trace):
    return load_module("metrics", name).read(trace)


def test_recte_fit_ms_is_the_fits_time_per_fit():
    assert _read("recte_fit_ms", _trace(SPANS)) == pytest.approx(
        (400 + 200) / 2)
    assert _read("recte_fit_ms", _trace(SPANS, fits=0)) is None


def test_device_idle_recte_fit_counts_the_union_inside_the_fits():
    # fits 0-400 and 500-700 (600 ms); kernels 100-300 and 250-450 (union
    # 100-450: 300 ms inside the first), 450-520 (20 inside the second),
    # 800-900 (outside)
    kernels = [(100, 300), (250, 450), (450, 520), (800, 900)]
    got = _read("device_idle.recte_fit", _trace(SPANS, kernels=kernels))
    assert got == pytest.approx(100.0 * (1.0 - 320.0 / 600.0))
    assert _read("device_idle.recte_fit",
                 _trace(SPANS, kernels=kernels, devices=())) is None
    assert _read("device_idle.recte_fit", _trace(SPANS)) is None


def test_recte_ramp_share_is_the_loops_under_the_steps():
    # under the steps and the capture: 40 + 30 + 60 + 40 ms of 100 + 100 +
    # 100 ms; the loop under fit.recte alone is left out
    assert _read("recte_ramp_share", _trace(SPANS)) == pytest.approx(
        100.0 * 170.0 / 300.0)
    no_loops = [s for s in SPANS if s.name != "recte.ramp"]
    assert _read("recte_ramp_share", _trace(no_loops)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name):
    assert _read(name, _trace([], kernels=[(0, 10)])) is None
    # a program without the tracer: no handle at all
    bare = _trace(SPANS, kernels=[(0, 10)])
    bare.installed = {}
    assert _read(name, bare) is None
    # the scan-rampfit's spans: no RECTE fit to read
    ramp = [_span("fit.white", 0, 300, 1), _span("lm.step", 10, 20, 2, 1)]
    assert _read(name, _trace(ramp, kernels=[(0, 10)])) is None


def test_benchmark_json_names_the_cell_and_its_readers():
    spec = registry.load_spec(ROOT)
    cell = cell_of(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "rectefit"
    assert {m["name"] for m in cell.end_to_end} == {"fits_per_s", "setup_s"}
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["workloads"], m["moves"]) == ([CELL], "fits_per_s")
        assert hasattr(load_module("metrics", name), "install")
    assert set(READERS) < {m["name"] for m in cell.per_layer}
