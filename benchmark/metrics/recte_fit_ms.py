"""recte_fit_ms: the program's ``fit.recte`` spans (``fit_white_recte``,
the white RECTE fit, on the host's clock) in the traced window's plain
phase, milliseconds per visit fitted there."""

from benchmark.harness import program_spans

NAME = "recte_fit_ms"


def install(state):
    return program_spans.install()


def read(trace):
    fits = trace.plain.work.get("fits")
    spans = program_spans.plain_spans(trace, NAME, "fit.recte")
    if not fits or not spans:
        return None
    return 1e3 * program_spans.seconds(spans) / fits
