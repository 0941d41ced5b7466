"""The traced window: ``torch.profiler`` over the requests, reduced to
device intervals, each kernel's launching frame in the port, and the
breakdown. Per-layer metric readers (``benchmark/metrics/``) read a
:class:`Trace`.

A kernel launched by a torch operator is tied to that operator through the
profiler's correlation id, and the operator to the innermost span of the
port's functions open on its thread when it started: the spans that
``benchmark/harness/frames.py`` puts around every function of the port
for the traced window (user annotations named ``port:<path>:<function>``;
the harness's own are named ``bench:...``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

PORT = "port:"
BENCH = "bench:"


@dataclass
class Kernel:
    """One device activity: a kernel, a copy or a fill."""

    name: str
    device: int
    start_ns: int
    end_ns: int
    frame: str | None        # "ops/exposure.py:simulate_exposure", or None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Phase:
    """A stretch of the traced window on the host's clock (Unix
    nanoseconds, the profiler's clock) and the work its requests did."""

    start_ns: int
    end_ns: int
    work: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Trace:
    """What one traced window left: every device activity, and its two
    phases of ``trace_requests`` requests each: ``plain``, as the program
    runs, for times and the idle share; then ``spanned``, with the port's
    functions in spans (``frames.py``), for the launching layer of each
    kernel. The spans cost host time, so the second phase is slower."""

    kernels: list[Kernel]
    devices: list[int]
    plain: Phase
    spanned: Phase
    installed: dict = field(default_factory=dict)
    host_frames: "HostFrames | None" = None

    def kernels_in(self, phase: Phase) -> list[Kernel]:
        return [k for k in self.kernels
                if k.start_ns >= phase.start_ns and k.end_ns <= phase.end_ns]

    def launched(self, phase: Phase) -> list[Kernel]:
        """Kernels proper in ``phase``: no copies or fills."""
        return [k for k in self.kernels_in(phase) if not _is_copy(k.name)]


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def port_frame(name: str) -> str | None:
    """"port:ops/exposure.py:simulate_exposure" ->
    "ops/exposure.py:simulate_exposure"; None for any other span."""
    return name[len(PORT):] if name.startswith(PORT) else None


def bench_frame(name: str) -> str | None:
    """A span of the benchmark's own, kept whole ("bench:request")."""
    return name if name.startswith(BENCH) else None


def in_layer(frame: str | None, patterns) -> bool:
    """Whether ``frame`` ("path.py:func") matches one of ``patterns``: a
    path prefix ("ops/exposure", "models/") or "path.py:func"."""
    if frame is None:
        return False
    path, _, func = frame.partition(":")
    for p in patterns:
        if ":" in p:
            if frame == p:
                return True
        elif path.startswith(p):
            return True
    return False


class HostFrames:
    """The innermost frame of the port open on a host thread at given
    times, from the profiler's Python-function events (which nest on a
    thread): one sweep over each thread's frames and queries."""

    def __init__(self, frames_by_thread: dict):
        # per thread: (start, end, label, kind) sorted by start
        self._by_thread = {tid: sorted(frames)
                           for tid, frames in frames_by_thread.items()}
        self.op_thread: dict = {}

    def resolve(self, queries) -> dict:
        """``queries``: (thread, t_ns, key) triples. Returns key -> the
        innermost port frame open at t on that thread, else the innermost
        benchmark frame, else None."""
        by_thread: dict = {}
        for tid, t, key in queries:
            by_thread.setdefault(tid, []).append((t, key))
        out = {}
        for tid, qs in by_thread.items():
            qs.sort(key=lambda q: q[0])
            frames = self._by_thread.get(tid, [])
            stack: list = []
            i = 0
            for t, key in qs:
                while i < len(frames) and frames[i][0] <= t:
                    s, e, label, kind = frames[i]
                    while stack and stack[-1][0] < s:
                        stack.pop()
                    stack.append((e, label, kind))
                    i += 1
                while stack and stack[-1][0] < t:
                    stack.pop()
                port = next((lab for e, lab, kind in reversed(stack)
                             if kind == "port" and e >= t), None)
                bench = next((lab for e, lab, kind in reversed(stack)
                              if kind == "bench" and e >= t), None)
                out[key] = port or bench
        return out


def reduce_profile(prof, start_ns: int, end_ns: int) -> tuple[list[Kernel],
                                                               HostFrames]:
    """Every device activity of the profile that overlaps [start_ns,
    end_ns], each with the port span that launched it, and the host's
    spans."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    frames_by_thread: dict[int, list] = {}
    ops = []                                   # (start, tid, correlation)
    device = []
    for ev in events:
        if ev.device_type() != DeviceType.CPU:
            # the spans leave a copy of themselves on the device's
            # timeline: no work ran there
            if not ev.is_user_annotation():
                device.append(ev)
            continue
        tid = ev.start_thread_id()
        name = ev.name()
        if ev.is_user_annotation():
            label = port_frame(name)
            kind = "port"
            if label is None:
                label, kind = bench_frame(name), "bench"
            if label is not None:
                start = ev.start_ns()
                frames_by_thread.setdefault(tid, []).append(
                    (start, start + ev.duration_ns(), label, kind))
        elif ev.correlation_id():
            ops.append((ev.start_ns(), tid, ev.correlation_id()))
    host = HostFrames(frames_by_thread)
    op_frame = host.resolve((tid, s, corr) for s, tid, corr in ops)
    host.op_thread = {corr: tid for _, tid, corr in ops}
    kernels = []
    for ev in device:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e < start_ns or s > end_ns:
            continue
        frame = op_frame.get(ev.linked_correlation_id())
        if frame is not None and frame.startswith("bench:"):
            frame = None
        kernels.append(Kernel(ev.name(), ev.device_index(), s, e, frame))
    kernels.sort(key=lambda k: k.start_ns)
    return kernels, host


def busy_s(kernels: list[Kernel], device: int, start_ns: int,
           end_ns: int) -> float:
    """Seconds in [start_ns, end_ns] in which some activity ran on
    ``device``: the union of its intervals. Frozen copy of
    ``torch_perf_breakdown.py``'s ``_busy_ms`` (commit a57e3cf), clipped to
    the window and in seconds."""
    spans = sorted((max(k.start_ns, start_ns), min(k.end_ns, end_ns))
                   for k in kernels if k.device == device
                   and k.end_ns > start_ns and k.start_ns < end_ns)
    busy, cur = 0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e9


def per_kernel_s(kernels: list[Kernel]) -> dict[str, float]:
    """Device seconds of each activity name. Frozen copy of
    ``torch_perf_breakdown.py``'s ``_per_kernel_ms`` (commit a57e3cf), in
    seconds."""
    out: dict[str, float] = {}
    for k in kernels:
        out[k.name] = out.get(k.name, 0.0) + k.seconds
    return out


def idle_gaps(trace: Trace, device: int, phase: Phase) -> dict[str, float]:
    """The device's idle time in ``phase``, summed by what the host was
    doing: the innermost port span open, at the gap's middle, on the
    thread that launched most operators ("host:other" where neither a
    port nor a benchmark span was open)."""
    host = trace.host_frames
    threads = list(host.op_thread.values()) if host is not None else []
    main = max(set(threads), key=threads.count) if threads else None
    gaps = []                                   # (middle, seconds)
    t = phase.start_ns
    for k in [k for k in trace.kernels_in(phase) if k.device == device] + [
            None]:
        nxt = phase.end_ns if k is None else k.start_ns
        if nxt > t:
            gaps.append(((t + nxt) // 2, (nxt - t) / 1e9))
        if k is not None:
            t = max(t, k.end_ns)
    labels = (host.resolve((main, mid, i) for i, (mid, _) in enumerate(gaps))
              if host is not None else {})
    out: dict[str, float] = {}
    for i, (_, seconds) in enumerate(gaps):
        label = labels.get(i) or "host:other"
        out[label] = out.get(label, 0.0) + seconds
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the plain phase, and
    the idle time of the spanned phase by what the host was doing (the
    spans lengthen it), at most ``top`` of each."""
    ops = sorted(per_kernel_s(trace.kernels_in(trace.plain)).items(),
                 key=lambda kv: -kv[1])
    gaps: dict[str, float] = {}
    for d in trace.devices:
        for label, s in idle_gaps(trace, d, trace.spanned).items():
            gaps[label] = gaps.get(label, 0.0) + s / len(trace.devices)
    gaps_sorted = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps_sorted[:top]]}
