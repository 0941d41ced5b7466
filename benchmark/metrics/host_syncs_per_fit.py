"""host_syncs_per_fit: the host-device synchronisations the program
counted (its ``host_syncs`` counter, torch's sync debug mode) in the traced
window's plain phase, per visit fitted there; None without a card."""

from benchmark.harness import program_spans

NAME = "host_syncs_per_fit"


def install(state):
    return program_spans.install()


def read(trace):
    fits = trace.plain.work.get("fits")
    syncs = program_spans.plain_syncs(trace, NAME)
    if not fits or syncs is None:
        return None
    return len(syncs) / fits
