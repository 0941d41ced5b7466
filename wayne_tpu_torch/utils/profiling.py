"""Tracing and profiling helpers (port of the JAX package's
``utils/profiling``): per-stage wall-clock timers that can wait for the
card, and a thin wrapper over ``torch.profiler`` that writes a Chrome
trace."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Iterator

import torch

log = logging.getLogger("wayne_tpu_torch.profiling")


class _StageHandle:
    """Mutable per-stage handle: set ``.sync`` to a tensor inside the
    ``with`` block to wait for its device when the stage closes."""

    __slots__ = ("sync",)

    def __init__(self) -> None:
        self.sync: torch.Tensor | None = None


class StageTimers:
    """Named wall-clock accumulators (host-side, asynchronous-launch
    aware)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[_StageHandle]:
        """Time a stage. To include the device time of work launched
        asynchronously on the card, synchronise inside the block yourself
        or set ``handle.sync = <tensor>`` on the yielded handle: the stage
        then synchronises that tensor's device before it closes."""
        handle = _StageHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            t = handle.sync
            if t is not None and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 5)}
                for k, v in sorted(self.totals.items())}

    def report(self) -> str:
        lines = [f"{k:<28s} {v['total_s']:>9.3f}s  x{v['count']:<5d} "
                 f"({v['mean_s'] * 1e3:.2f} ms/call)"
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
