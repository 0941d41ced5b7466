"""The harness finds cells, traffic kinds and metrics by name, runs each
cell on the CPU with ``correct`` true, and sees ``correct`` come out false
with the timed path broken underneath, and under the bfloat16 control."""

import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import registry, runner
from benchmark.tests.conftest import ROOT, cell_of, cpu_devices

CELLS = [w["name"] for w in registry.load_spec(ROOT)["workloads"]]


def test_finds_everything_by_name():
    spec = registry.load_spec(ROOT)
    for name in CELLS:
        cell = registry.find_cell(name, spec)
        kind = registry.load_module("kinds", cell.traffic["kind"])
        assert hasattr(kind, "setup") and hasattr(kind, "control")
        for m in cell.end_to_end:
            assert hasattr(registry.load_module("e2e", m["name"]), "read")
        for m in cell.per_layer:
            assert hasattr(registry.load_module("metrics", m["name"]),
                           "read")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_refuses_unknown_names():
    spec = registry.load_spec(ROOT)
    with pytest.raises(registry.UnknownName):
        registry.find_cell("no-such-cell", spec)
    with pytest.raises(registry.UnknownName):
        registry.load_module("kinds", "no_such_kind")
    with pytest.raises(registry.UnknownName):
        registry.load_module("metrics", "no_such_metric")
    spec["workloads"][0] = dict(spec["workloads"][0], traffic="no-such-mix")
    with pytest.raises(registry.UnknownName):
        registry.find_cell(spec["workloads"][0]["name"], spec)


def test_cells_report_what_benchmark_json_says():
    fit = registry.find_cell("scan-rampfit", registry.load_spec(ROOT))
    assert {m["name"] for m in fit.end_to_end} == {"fits_per_s", "setup_s"}
    assert {m["name"] for m in fit.per_layer} == {"launches_per_fit",
                                                  "device_idle.fit"}


def _run(cell, trace=False, seconds=0.5, seed=2 ** 31 + 99):
    return runner.run_cell(cell, seed, seconds, trace, time.time(),
                           devices=cpu_devices(cell), log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    res = _run(cell_of(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    cell = cell_of(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_run_on_the_cpu():
    res = _run(cell_of("scan-rampfit"), trace=True)
    assert res["correct"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _patch_output(monkeypatch, module, name, change):
    """Wrap ``module.name`` so that ``change(out, call)`` edits its result
    where it is produced."""
    original = getattr(module, name)
    calls = []

    def broken(*a, **kw):
        out = original(*a, **kw)
        calls.append(out)
        return change(out, calls)

    monkeypatch.setattr(module, name, broken)


def _fit_fault(monkeypatch, fault):
    from wayne_tpu_torch import reduction

    if fault == "state_unchanged":
        def unchanged(resid, theta0, n_steps, lam0=1e-3):
            return theta0, torch.sum(resid(theta0) ** 2)

        monkeypatch.setattr(reduction, "_lm_minimize", unchanged)
        return

    def half(out, calls):
        rp, sig = out
        rp = rp.clone()
        rp[4:] = rp[:4].mean()
        return rp, sig

    def altered(out, calls):
        rp, sig = out
        return rp * torch.where(torch.arange(rp.shape[0]) == 0, 1.05, 1.0), sig

    _patch_output(monkeypatch, reduction, "fit_depths",
                  {"half_batch_mean": half, "answer_altered": altered}[fault])


FAULTS = [("scan-rampfit", f) for f in ("state_unchanged", "half_batch_mean",
                                         "answer_altered")]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = cell_of(name)
    _fit_fault(monkeypatch, fault)
    res = _run(cell)
    assert res["attempted"] >= 1
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = cell_of(name)
    kind = registry.load_module("kinds", cell.traffic["kind"])
    for seed in (3, 2 ** 31 + 7):
        readings = kind.control(cell.config, cell.traffic, seed,
                                torch.device("cpu"))
        limits = cell.traffic["limits"]
        assert any(r["value"] > limits[r["name"]] for r in readings), readings


def _bench(*args, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=600, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _bench("--workload", "scan-rampfit", "--seed", "1", "--seconds",
                 "1", "--trace", "0")
    assert out.returncode == 3 and out.stdout == ""


def test_unknown_cell_no_result():
    out = _bench("--workload", "no-such-cell", "--seed", "1", "--seconds",
                 "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    out = _bench("--workload", "scan-rampfit", "--seed", str(2 ** 31 + 3),
                 "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
