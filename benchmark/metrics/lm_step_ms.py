"""lm_step_ms: the median duration of the program's ``lm.step`` spans (one
step of ``reduction._lm_minimize``, on the host's clock) in the traced
window's plain phase."""

import statistics

from benchmark.harness import program_spans

NAME = "lm_step_ms"


def install(state):
    return program_spans.install()


def read(trace):
    steps = program_spans.plain_spans(trace, NAME, "lm.step")
    if not steps:
        return None
    return statistics.median((s.end_ns - s.start_ns) / 1e6 for s in steps)
