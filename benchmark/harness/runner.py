"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, then the comparison with the reference."""

from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass, field

from benchmark.harness import frames, registry
from benchmark.harness import trace as tr
from benchmark.harness.idle import mean_busy_s

FORBIDDEN = ("jax", "jaxlib", "flax", "wayne_tpu")


class NoDevice(RuntimeError):
    """The card, or as many cards as the cell asks for, is missing."""


@dataclass
class Window:
    """The measured window: each request's (start, end) on the host's
    monotonic clock, the work every completed request did, and set-up."""

    spans: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    seconds: float = 0.0
    setup_s: float = 0.0


def cuda_devices(chips: int) -> list:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".", 1)[0] in FORBIDDEN})


def _synchronize(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             t0: float, devices: list | None = None,
             log=lambda s: print(s, file=sys.stderr)) -> dict:
    """Run ``cell`` once; returns the result line's fields plus
    ``checks``. ``devices``: None for the cell's cards (raises NoDevice
    without them); the tests pass CPU devices."""
    import torch

    if devices is None:
        devices = cuda_devices(cell.chips)
    kind = registry.load_module("kinds", cell.traffic["kind"])
    e2e = {m["name"]: registry.load_module("e2e", m["name"])
           for m in cell.end_to_end}
    layer = ({m["name"]: registry.load_module("metrics", m["name"])
              for m in cell.per_layer} if trace else {})
    state = kind.setup(cell.config, cell.traffic, seed, devices)
    installed = {}
    try:
        for name, reader in layer.items():
            if hasattr(reader, "install"):
                installed[name] = reader.install(state)
        if trace:
            window, traced = _traced(state, devices, log)
        else:
            window, traced = _timed(state, seconds, devices, t0, log), None
    finally:
        for handle in reversed(list(installed.values())):
            if handle is not None:
                handle.restore()
    on_cuda = [d for d in devices if d.type == "cuda"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in on_cuda),
               default=0)
    result = {"attempted": window.work.get("attempted", 0),
              "failed": window.work.get("failed", 0)}
    metrics = {}
    device_extra = {}
    if trace:
        traced.installed = installed
        for m in cell.per_layer:
            value = layer[m["name"]].read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_extra = {"busy_s": mean_busy_s(traced),
                        "window_s": traced.plain.seconds}
        result["breakdown"] = tr.breakdown(traced)
    else:
        for m in cell.end_to_end:
            value = e2e[m["name"]].read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_cuda else devices[0].type,
        "kind": (torch.cuda.get_device_name(on_cuda[0]) if on_cuda
                 else devices[0].type),
        "count": len({str(d) for d in devices}) if on_cuda else 0,
        "memory_peak_bytes": int(peak), **device_extra}
    # the program's state goes before the reference runs: a process's peak
    # never falls again
    traced = None
    state.release()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    done = window.work.get("completed", 0)
    checks = state.check(done) if done else []
    result["checks"] = checks
    result["correct"] = bool(
        checks and result["failed"] == 0
        and all(c["value"] <= c["limit"] for c in checks))
    return result


def _request(state, i: int, window: Window, log, span=None) -> None:
    """One request, its wall and its work added to ``window``; a request
    that raises is counted as failed and shown."""
    import torch

    work = window.work
    a = time.perf_counter()
    work["attempted"] = work.get("attempted", 0) + 1
    try:
        if span is None:
            done = state.request(i)
        else:
            with torch.profiler.record_function(span):
                done = state.request(i)
    except Exception:                       # noqa: BLE001 - counted, shown
        work["failed"] = work.get("failed", 0) + 1
        log(traceback.format_exc())
        return
    window.spans.append((a, time.perf_counter()))
    work["completed"] = work.get("completed", 0) + 1
    for k, v in done.items():
        work[k] = work.get(k, 0) + v


def _timed(state, seconds, devices, t0, log) -> Window:
    """Requests one at a time, one in flight, until ``seconds`` have
    passed; the window ends with the request that crosses them."""
    window = Window(work={"attempted": 0, "failed": 0, "completed": 0})
    _synchronize(devices)
    start = time.perf_counter()
    window.setup_s = time.time() - t0
    i = 0
    while True:
        _request(state, i, window, log)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    _synchronize(devices)
    window.seconds = time.perf_counter() - start
    walls = sorted(b - a for a, b in window.spans)
    if walls:
        log(f"window: {len(walls)} requests in {window.seconds:.3f} s, "
            f"request walls min {walls[0]:.4f} median "
            f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s")
    return window


def _traced(state, devices, log):
    """The traced window under ``torch.profiler``: ``trace_requests``
    requests as the program runs (the plain phase), then as many with the
    port's functions in spans (the spanned phase)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    window = Window(work={"attempted": 0, "failed": 0, "completed": 0})
    phases = []
    prof = profile(activities=acts)
    prof.start()
    try:
        i = 0
        for spanned in (False, True):
            spans = frames.Spans() if spanned else None
            phase = Window(work={})
            try:
                _synchronize(devices)
                start_ns = time.time_ns()
                for _ in range(state.trace_requests):
                    _request(state, i, phase, log, span="bench:request")
                    i += 1
                _synchronize(devices)
                end_ns = time.time_ns()
            finally:
                if spans is not None:
                    spans.restore()
            phases.append(tr.Phase(start_ns, end_ns, phase.work))
            for k, v in phase.work.items():
                window.work[k] = window.work.get(k, 0) + v
            window.spans += phase.spans
    finally:
        prof.stop()
    kernels, host = tr.reduce_profile(prof, phases[0].start_ns,
                                      phases[1].end_ns)
    log(f"trace: {len(kernels)} device records, "
        f"{sum(k.frame is not None for k in kernels)} tied to a span of "
        f"the port")
    used = sorted({d.index or 0 for d in devices if d.type == "cuda"})
    traced = tr.Trace(kernels, used, phases[0], phases[1], host_frames=host)
    return window, traced
