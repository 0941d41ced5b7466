"""The port's tracer: spans and a host-sync counter inside the program, off
by default, per-name totals of what they recorded, and a wrapper over
``torch.profiler`` that writes a Chrome trace.

A span records its name, its start and end on the profiler's clock (Unix
nanoseconds, ``time.time_ns()``, the clock of ``torch.profiler``'s events),
its parent span and the id of its root: the spans under one top-level call
share that id. While a ``torch.profiler`` run is active, each span also
opens a ``record_function`` annotation ``wt:<name>``, so that it shows in
the Chrome trace beside the kernels it launched.

Tracing is off until :func:`enable` (or ``with tracing():``); the calls
nest, and it stays on until the last handle is restored. Off, ``with
span(name):`` costs one flag test and returns a shared object that does
nothing: no allocation, no clock reading, no torch call. On a CUDA card,
tracing on also counts every host-device synchronisation torch performs
(``host_syncs``, through its sync debug mode), each charged to the
innermost span open on its thread.

The spans in the program, and what reads them:

- ``reduce.extract``, ``reduce.fit``: ``run_reduce``'s two stages, the
  entry layer (``run_reduce --trace``);
- ``fit.white`` (``reduction.fit_white_ramp``), ``fit.detrend``
  (``ramp_detrend``) and ``fit.depths`` (``fit_depths``), the fits layer:
  the benchmark's ``depth_fit_ms`` and, with the counter,
  ``host_syncs_per_fit``;
- the steps of ``reduction._lm_minimize``, also the fits layer:
  ``lm.step`` for each step run eagerly (every step on the CPU and under
  ``vmap``, the first on a card), ``lm.capture`` for the capture of the
  CUDA graph the later steps replay, and ``lm.replay`` for each replay:
  the benchmark's ``lm_step_ms`` and ``device_idle.lm_step`` (eager steps
  only) and ``lm_graph_share`` (replays among all steps);
- ``fit.recte`` (``reduction.fit_white_recte``, the steps' spans under
  it), the fits layer: the benchmark's ``recte_fit_ms`` and
  ``device_idle.recte_fit``;
- ``recte.ramp`` (the trap recurrence of ``ops.recte.white_ramp``: the
  RECTE kernel's value and tangent launches, or the loop for a rate per
  exposure; run inside the LM's ``jacfwd``, so it records in the eager
  step and the capture, never in a replay): the benchmark's
  ``recte_ramp_share``, those under an ``lm.step`` or ``lm.capture`` over
  those spans' time.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
import warnings
from typing import Iterator

import torch

log = logging.getLogger("wayne_tpu_torch.profiling")

PREFIX = "wt:"
# the start of the warning torch gives for each synchronising operation
# while its sync debug mode is "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

_on = False                 # the one flag an idle span tests
_users = 0                  # handles not yet restored
_spans: list = []           # every span opened while on, in start order
_syncs: list = []           # (t_ns, id of the span charged or None)
_ids = itertools.count(1)
_sync_state = None          # (warnings catcher, previous sync mode)
_switch = threading.Lock()  # guards _users and turning on and off


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_local = _Stack()


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class span:
    """``with span("fit.white"):`` records the block as a span while tracing
    is on; off, it is a shared no-op. Only dunder methods, so that nothing
    runs per span but the span itself."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "host_syncs", "_note")

    def __new__(cls, name: str):
        if not _on:
            return _OFF
        return object.__new__(cls)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.open
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.host_syncs = 0
        self.end_ns = None
        self._note = None
        stack.append(self)
        _spans.append(self)
        # the record encloses its annotation: clock first in, last out
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._note = torch.profiler.record_function(PREFIX + self.name)
            self._note.__enter__()
        return self

    def __exit__(self, *exc):
        if self._note is not None:
            self._note.__exit__(*exc)
            self._note = None
        self.end_ns = time.time_ns()
        stack = _local.open
        if stack and stack[-1] is self:
            stack.pop()
        return False


def _sync_counter(previous):
    """A ``warnings.showwarning`` that counts torch's sync warnings and
    hands every other warning to ``previous``."""

    def show(message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_WARNING):
            return previous(message, category, filename, lineno, file, line)
        stack = _local.open
        top = stack[-1] if stack else None
        if top is not None:
            top.host_syncs += 1
        _syncs.append((time.time_ns(), None if top is None else top.id))
        return None

    return show


def _turn_on() -> None:
    global _on, _sync_state
    if torch.cuda.is_available():
        catcher = warnings.catch_warnings()
        catcher.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = _sync_counter(warnings.showwarning)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        _sync_state = (catcher, mode)
    _on = True


def _turn_off() -> None:
    global _on, _sync_state
    _on = False
    if _sync_state is not None:
        catcher, mode = _sync_state
        torch.cuda.set_sync_debug_mode(mode)
        catcher.__exit__(None, None, None)
        _sync_state = None
    _spans.clear()
    _syncs.clear()


class Tracing:
    """One holder's share of the tracer being on (:func:`enable`).
    ``restore()`` lets go of it and keeps what was recorded meanwhile:
    ``spans`` (the span objects, in start order) and ``syncs`` ((t_ns, span
    id or None) of each host sync; None where none could be counted)."""

    def __init__(self):
        self._span0, self._sync0 = len(_spans), len(_syncs)
        self._counting = _sync_state is not None
        self.spans: list | None = None
        self.syncs: list | None = None

    def restore(self) -> None:
        global _users
        with _switch:
            if self.spans is not None:
                return
            self.spans = _spans[self._span0:]
            self.syncs = _syncs[self._sync0:] if self._counting else None
            _users -= 1
            if _users == 0:
                _turn_off()

    def counters(self) -> dict:
        return {"host_syncs": (None if self.syncs is None
                               else len(self.syncs))}

    def records(self) -> list[dict]:
        counted = self.syncs is not None
        return [{"name": s.name, "id": s.id, "parent": s.parent,
                 "root": s.root, "start_ns": s.start_ns,
                 "end_ns": s.end_ns,
                 "host_syncs": s.host_syncs if counted else None}
                for s in self.spans]

    def write(self, path: str) -> None:
        """The records, the counters and the per-name summary as JSON."""
        with open(path, "w") as fh:
            json.dump({"spans": self.records(), "counters": self.counters(),
                       "summary": StageTimers(self.spans).summary()}, fh,
                      indent=1)
        log.info("spans written to %s", path)


def enable() -> Tracing:
    """Turn tracing on (it stays on until every handle is restored)."""
    global _users
    with _switch:
        if _users == 0:
            _turn_on()
        _users += 1
        return Tracing()


@contextlib.contextmanager
def tracing() -> Iterator[Tracing]:
    """Tracing on inside the block; the handle holds its records after."""
    handle = enable()
    try:
        yield handle
    finally:
        handle.restore()


class StageTimers:
    """Per-name totals over recorded spans (a :class:`Tracing` handle's
    ``spans``): the count, the total seconds and the self seconds, a
    span's time less its children's. Spans still open are left out."""

    def __init__(self, spans) -> None:
        done = [s for s in spans if s.end_ns is not None]
        inner: dict[int, int] = {}
        for s in done:
            if s.parent is not None:
                inner[s.parent] = (inner.get(s.parent, 0)
                                   + s.end_ns - s.start_ns)
        self.counts: dict[str, int] = {}
        self.totals: dict[str, float] = {}
        self.selfs: dict[str, float] = {}
        for s in done:
            ns = s.end_ns - s.start_ns
            self.counts[s.name] = self.counts.get(s.name, 0) + 1
            self.totals[s.name] = self.totals.get(s.name, 0.0) + ns / 1e9
            self.selfs[s.name] = (self.selfs.get(s.name, 0.0)
                                  + (ns - inner.get(s.id, 0)) / 1e9)

    def summary(self) -> dict[str, dict[str, float]]:
        return {k: {"count": self.counts[k], "total_s": v,
                    "self_s": self.selfs[k], "mean_s": v / self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        lines = [f"{k:<16s} {v['total_s']:>9.3f}s  self {v['self_s']:>9.3f}s"
                 f"  x{v['count']:<6d} ({v['mean_s'] * 1e3:.3f} ms/call)"
                 for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace everything inside the block with ``torch.profiler`` (CPU, and
    CUDA when a card is present) and write ``logdir/trace.json``, a Chrome
    trace (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
