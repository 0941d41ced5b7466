"""The yardstick's arithmetic on hand-checked inputs: the end-to-end rate
and tail, the frozen roofline count, and the attribution of a kernel to
the port's layer that launched it."""

import pytest
import torch

from benchmark.harness import roofline, stats
from benchmark.harness import trace as tr
from benchmark.harness.registry import load_module
from benchmark.harness.runner import Window


def test_percentile_is_linear_between_ranks():
    xs = [0.01 * k for k in range(1, 101)]
    assert stats.percentile(xs, 95) == pytest.approx(0.9505)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rates_are_all_work_over_all_time():
    # 100 requests: 99 of 0.1 s and one stall of 5 s; the window is their
    # whole time
    spans, t = [], 0.0
    for k in range(100):
        wall = 5.0 if k == 37 else 0.1
        spans.append((t, t + wall))
        t += wall
    w = Window(spans=spans, work={"fits": 100}, seconds=t, setup_s=12.5)
    assert load_module("e2e", "fits_per_s").read(w) == pytest.approx(
        100 / 14.9)
    assert load_module("e2e", "fits_per_s").read(
        Window(spans=spans, work={}, seconds=t)) is None
    # the tail is over every request: the stall is the 100th value, so
    # the 95th percentile stays at 0.1, and the 100th is the stall
    walls = stats.request_walls(spans)
    assert stats.percentile(walls, 95) == pytest.approx(0.1)
    assert stats.percentile(walls, 100) == pytest.approx(5.0)
    assert load_module("e2e", "setup_s").read(w) == 12.5


def _readout_args():
    """B = 1, two emitted reads, W = 1, S = 2."""
    i32, f32 = torch.int32, torch.float32
    seed = torch.zeros((1, 2), dtype=i32)
    y0s = torch.zeros((1, 2), dtype=i32)
    dts = torch.tensor([[0.0, 1.0]])
    bands = torch.tensor([[[[0.0, 0.0]], [[4.0, 2.0]]]])
    bg = torch.tensor([[[0.0, 1.0], [5.0, 10.0]]])
    bias = torch.zeros((2, 2), dtype=f32)
    inv_gain = torch.ones((2, 2), dtype=f32)
    nl = torch.zeros((3, 2, 2), dtype=f32)
    cr_pos = torch.zeros((1, 2, 2, 1), dtype=i32)
    cr_q = torch.tensor([[[0.0], [100.0]]])
    return (seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q,
            (20.0, 1e5, 2.5, 0.0))


FLAGS = dict(poisson=True, read_noise=True, non_linearity=True, bias=True,
             scalar_gain=False, with_cr=True, bg_poisson=True, ipc=False,
             exact_poisson=False)


def test_roofline_count_by_hand():
    args = _readout_args()
    lam = args[4][:, None] * args[2][:, :, None, None]
    work = roofline._read_work(lam, 8, args[9], FLAGS)
    roofline._add_band_work(work, args[3])
    # 8 pixel-reads, each with a normal (read noise); background: 5 and 10
    # by the normal sampler, 1 by the small-lambda sum; the band: 4 by the
    # sampler (its own block and Box-Muller), 2 by the sum; one hit
    assert work == dict(readout=8, philox=11, box_muller=9, sampler=3,
                        small_lam=2, knuth=0, ptrs=0, cr=1)
    b = roofline.bound_of(args, FLAGS)
    # bytes: 160 in, 48 out (reads 32, cum 16)
    assert b["bytes_ms"] == pytest.approx(208 / 3.35e12 * 1e3)
    # IMAD 11 x 21, ALU 11 x 20 + 9 x 2 + 2, other 11 + 126 + 36 + 128 +
    # 128 + 1: all 901 at the issue rate bind the operations
    issue = 128 * 132 * 1.98e9
    assert b["issue_ms"] == pytest.approx(901 / issue * 1e3)
    assert b["ops_ms"] == b["issue_ms"]
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(6.2090e-8, rel=1e-4)


class _Ev:
    """A stand-in for the profiler's raw event; ``span`` marks a user
    annotation (a ``record_function`` span)."""

    def __init__(self, name, start, dur, tid=1, corr=0, linked=0,
                 device=None, span=False):
        self._name, self._s, self._d, self._span = name, start, dur, span
        self._tid, self._corr, self._linked, self._dev = (tid, corr, linked,
                                                         device)

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._span

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_index(self):
        return self._dev or 0

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._dev is None else DeviceType.CUDA


class _Prof:
    def __init__(self, events):
        class R:
            def events(self_inner):
                return events

        class P:
            kineto_results = R()

        self.profiler = P()


def _synthetic_trace():
    events = [
        _Ev("bench:request", 0, 2000, span=True),
        _Ev("port:ops/exposure.py:simulate_exposure", 10, 1000, span=True),
        _Ev("port:ops/transit.py:transit_light_curve", 100, 100, span=True),
        _Ev("another annotation", 300, 100, span=True),
        _Ev("aten::mul", 150, 10, corr=1),
        _Ev("aten::einsum", 350, 10, corr=2),
        _Ev("aten::add", 1500, 10, corr=3),
        _Ev("void elementwise_kernel<128>(mul)", 160, 10, linked=1,
            device=0),
        _Ev("sm90_gemm", 360, 20, linked=2, device=0),
        _Ev("void exposure_readout_kernel<false>(Args)", 500, 400,
            device=0),
        _Ev("void elementwise_kernel<128>(add)", 1600, 100, linked=3,
            device=0),
        _Ev("Memcpy DtoH", 1800, 50, linked=3, device=0),
        # a span's copy on the device's timeline is no work
        _Ev("port:ops/exposure.py:simulate_exposure", 10, 1000, device=0,
            span=True),
    ]
    kernels, host = tr.reduce_profile(_Prof(events), 0, 2000)
    # one phase serves as both here
    phase = tr.Phase(0, 2000, {"exposures": 1, "fits": 1})
    return tr.Trace(kernels, [0], phase, phase, host_frames=host)


def test_stack_attribution_puts_kernels_in_their_layer():
    t = _synthetic_trace()
    frames = {k.name: k.frame for k in t.kernels}
    # the innermost port span, not another span inside it
    assert frames["void elementwise_kernel<128>(mul)"] == (
        "ops/transit.py:transit_light_curve")
    assert frames["sm90_gemm"] == "ops/exposure.py:simulate_exposure"
    # launched from the benchmark's own frame, or by ctypes: no port layer
    assert frames["void elementwise_kernel<128>(add)"] is None
    assert frames["void exposure_readout_kernel<false>(Args)"] is None
    in_front = [k for k in t.launched(t.spanned)
                if tr.in_layer(k.frame, ("ops/exposure", "ops/transit"))]
    assert len(in_front) == 2
    assert tr.in_layer("ops/exposure.py:simulate_exposure", ("ops/exp",))
    assert tr.in_layer("parallel/ensemble.py:_reduce",
                       ("parallel/ensemble.py:_reduce",))
    assert not tr.in_layer("parallel/ensemble.py:_ensemble_block",
                           ("parallel/ensemble.py:_reduce",))
    assert len(t.launched(t.plain)) == 4
    assert load_module("metrics", "launches_per_fit").read(t) == 4


def test_busy_idle_and_breakdown():
    t = _synthetic_trace()
    assert tr.busy_s(t.kernels, 0, 0, 2000) == pytest.approx(580e-9)
    # clipped to the window; activity outside it counts nothing
    assert tr.busy_s(t.kernels, 0, 0, 400) == pytest.approx(30e-9)
    assert tr.busy_s(t.kernels, 0, 600, 1000) == pytest.approx(300e-9)
    assert tr.busy_s(t.kernels, 0, 1000, 1500) == 0.0
    idle = load_module("metrics", "device_idle.fit").read(t)
    assert idle == pytest.approx(100 * (1 - 580 / 2000))
    gaps = tr.idle_gaps(t, 0, t.spanned)
    assert sum(gaps.values()) == pytest.approx(1420e-9)
    # the gap [1000, 1500) has its middle in the benchmark's request only
    assert gaps["bench:request"] > 0
    assert "ops/exposure.py:simulate_exposure" in gaps
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["void exposure_readout_kernel<false>(Args)",
                                  pytest.approx(400e-9)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
