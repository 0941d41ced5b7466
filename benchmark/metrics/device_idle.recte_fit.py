"""device_idle.recte_fit: the share of the program's ``fit.recte`` spans
(``fit_white_recte``) in the traced window's plain phase in which no
kernel, copy or fill ran on the card: 100 (1 - busy inside the spans /
their summed duration), the mean over the cards used."""

from benchmark.harness import program_spans

NAME = "device_idle.recte_fit"


def install(state):
    return program_spans.install()


def read(trace):
    fits = program_spans.plain_spans(trace, NAME, "fit.recte")
    total = program_spans.seconds(fits)
    if not fits or not trace.devices or not trace.kernels or total <= 0:
        return None
    busy = [program_spans.busy_inside(trace.kernels, d, fits)
            for d in trace.devices]
    return 100.0 * (1.0 - sum(busy) / len(busy) / total)
