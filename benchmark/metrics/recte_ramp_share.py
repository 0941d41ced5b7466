"""recte_ramp_share: the share of the host's dispatch of the RECTE fit's
Levenberg-Marquardt steps that the trap loop takes: 100 x the program's
``recte.ramp`` spans opened directly under an ``lm.step`` or
``lm.capture`` span / the summed time of those step spans, in the traced
window's plain phase. Replays run no Python and leave no ``recte.ramp``,
so they are in neither sum. None where the program left no such span."""

from benchmark.harness import program_spans

NAME = "recte_ramp_share"


def install(state):
    return program_spans.install()


def read(trace):
    steps = (program_spans.plain_spans(trace, NAME, "lm.step")
             + program_spans.plain_spans(trace, NAME, "lm.capture"))
    ids = {s.id for s in steps}
    ramps = [s for s in program_spans.plain_spans(trace, NAME, "recte.ramp")
             if s.parent in ids]
    total = program_spans.seconds(steps)
    if not ramps or total <= 0:
        return None
    return 100.0 * program_spans.seconds(ramps) / total
