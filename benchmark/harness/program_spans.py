"""The program's own spans in a traced window: the tracer of
``wayne_tpu_torch.utils.profiling``, turned on by a reader's ``install``
for the whole traced window and read in its plain phase, where the
benchmark's own spans (``frames.py``) are off.

A program without that tracer leaves nothing to read: ``install`` returns
None and the readers return None.
"""

from __future__ import annotations

from bisect import bisect_right


def install():
    """Turn the program's tracer on; the handle's ``restore()`` turns it
    off and keeps its records (``spans``, ``syncs``). None where the
    program has no tracer."""
    try:
        from wayne_tpu_torch.utils import profiling
    except ImportError:
        return None
    enable = getattr(profiling, "enable", None)
    return None if enable is None else enable()


def plain_spans(trace, metric: str, name: str) -> list:
    """The closed spans called ``name`` that lie wholly in the plain phase,
    from the handle ``metric``'s reader installed."""
    spans = getattr(trace.installed.get(metric), "spans", None) or []
    p = trace.plain
    return [s for s in spans if s.name == name and s.end_ns is not None
            and s.start_ns >= p.start_ns and s.end_ns <= p.end_ns]


def seconds(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def plain_syncs(trace, metric: str) -> list | None:
    """The host syncs the program counted in the plain phase; None where
    it counted none (no card, or no tracer)."""
    syncs = getattr(trace.installed.get(metric), "syncs", None)
    if syncs is None:
        return None
    p = trace.plain
    return [s for s in syncs if p.start_ns <= s[0] <= p.end_ns]


def busy_inside(kernels, device: int, spans) -> float:
    """Seconds in which some activity ran on ``device`` inside ``spans``:
    the union of its kernel, copy and fill intervals, clipped to each
    span and summed over the spans."""
    merged: list[list[int]] = []
    for s, e in sorted((k.start_ns, k.end_ns) for k in kernels
                       if k.device == device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ends = [e for _, e in merged]
    busy = 0
    for sp in spans:
        i = bisect_right(ends, sp.start_ns)
        while i < len(merged) and merged[i][0] < sp.end_ns:
            busy += (min(merged[i][1], sp.end_ns)
                     - max(merged[i][0], sp.start_ns))
            i += 1
    return busy / 1e9
