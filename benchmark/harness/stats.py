"""The end-to-end arithmetic: rates over the whole window, a tail over
every request. The yardstick: later changes to the program do not touch
it."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of ``values``, linear between the
    two nearest ranks (numpy's default, ``method="linear"``)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(work: float, window_s: float) -> float:
    """All the work completed in the window over the window's whole time."""
    if window_s <= 0.0:
        raise ValueError("a window of no time")
    return work / window_s


def request_walls(spans) -> list[float]:
    """Each request's wall time from its (start, end) pair."""
    return [end - start for start, end in spans]
