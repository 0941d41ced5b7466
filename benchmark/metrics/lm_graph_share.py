"""lm_graph_share: the share of the Levenberg-Marquardt steps in the traced
window's plain phase that the program replayed from a CUDA graph:
100 x its ``lm.replay`` spans / (those + its ``lm.step`` spans, the steps
run eagerly). None where it left neither."""

from benchmark.harness import program_spans

NAME = "lm_graph_share"


def install(state):
    return program_spans.install()


def read(trace):
    replays = len(program_spans.plain_spans(trace, NAME, "lm.replay"))
    steps = len(program_spans.plain_spans(trace, NAME, "lm.step"))
    if not replays + steps:
        return None
    return 100.0 * replays / (replays + steps)
