"""fits_per_s: visits fitted (white ramp fit, detrending and channel
depths) over the window's whole time."""

from benchmark.harness.stats import window_rate


def read(window):
    if not window.work.get("fits"):
        return None
    return window_rate(window.work["fits"], window.seconds)
