"""device_idle.fit: the share of the traced window in which no kernel,
copy or fill ran on the card, in the fitting cells."""

from benchmark.harness.idle import idle_percent


def read(trace):
    return idle_percent(trace)
