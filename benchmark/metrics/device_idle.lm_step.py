"""device_idle.lm_step: the share of the program's ``lm.step`` spans in the
traced window's plain phase in which no kernel, copy or fill ran on the
card: 100 (1 - busy inside the steps / their summed duration), the mean
over the cards used."""

from benchmark.harness import program_spans

NAME = "device_idle.lm_step"


def install(state):
    return program_spans.install()


def read(trace):
    steps = program_spans.plain_spans(trace, NAME, "lm.step")
    total = program_spans.seconds(steps)
    if not steps or not trace.devices or not trace.kernels or total <= 0:
        return None
    busy = [program_spans.busy_inside(trace.kernels, d, steps)
            for d in trace.devices]
    return 100.0 * (1.0 - sum(busy) / len(busy) / total)
