"""The reader of ``lm_graph_share`` (the Levenberg-Marquardt steps the
program replayed from a CUDA graph, as a share of all its steps) on
hand-made traces, and its entry in ``BENCHMARK.json``."""

from types import SimpleNamespace

import pytest

from benchmark.harness import registry
from benchmark.harness import trace as tr
from benchmark.harness.registry import load_module
from benchmark.tests.conftest import ROOT

NAME = "lm_graph_share"
MS = 1_000_000


def _trace(names, installed=True):
    """A plain phase of 0-1000 ms holding one span a name, in turn, and a
    spanned phase after it that holds a replay and a step of its own."""
    spans = [SimpleNamespace(name=n, start_ns=(10 + 10 * i) * MS,
                             end_ns=(15 + 10 * i) * MS)
             for i, n in enumerate(names)]
    spans += [SimpleNamespace(name=n, start_ns=1100 * MS, end_ns=1200 * MS)
              for n in ("lm.replay", "lm.step")]
    handle = SimpleNamespace(spans=spans, syncs=None)
    return tr.Trace(
        kernels=[], devices=[0], plain=tr.Phase(0, 1000 * MS, {"fits": 1}),
        spanned=tr.Phase(1000 * MS, 2000 * MS, {"fits": 1}),
        installed={NAME: handle} if installed else {})


@pytest.mark.parametrize("names, share", [
    (["fit.white", "lm.step", "lm.capture"] + ["lm.replay"] * 59
     + ["fit.depths"], 100.0 * 59 / 60),
    (["fit.white"] + ["lm.step"] * 60 + ["fit.depths"], 0.0),
    (["fit.white", "fit.depths"], None),
    ([], None),
])
def test_the_share_of_replayed_steps_in_the_plain_phase(names, share):
    got = load_module("metrics", NAME).read(_trace(names))
    if share is None:
        assert got is None
    else:
        assert got == pytest.approx(share)


def test_a_program_without_the_tracer_reads_none():
    trace = _trace(["lm.step", "lm.replay"], installed=False)
    assert load_module("metrics", NAME).read(trace) is None


def test_benchmark_json_names_the_reader():
    entries = {m["name"]: m for m in registry.load_spec(ROOT)["per_layer"]}
    m = entries[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "device_trace", "fits",
                                "fits_per_s", ["scan-rampfit"])
    assert hasattr(load_module("metrics", NAME), "install")
