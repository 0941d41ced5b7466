"""The device's busy time and idle share over the traced window's plain
phase, for the run's ``device`` fields and the ``device_idle.*``
readers."""

from benchmark.harness.trace import busy_s


def mean_busy_s(trace) -> float:
    """Busy seconds of the plain phase, the mean over the cards used."""
    p = trace.plain
    busy = [busy_s(trace.kernels, d, p.start_ns, p.end_ns)
            for d in trace.devices]
    return sum(busy) / max(len(busy), 1)


def idle_percent(trace):
    """100 (1 - busy / window) over the plain phase, the mean over the
    cards the run used; None where nothing ran."""
    if not trace.devices or trace.plain.seconds <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - mean_busy_s(trace) / trace.plain.seconds)
