"""launches_per_fit: every kernel launched in the traced window's plain
phase (copies and fills left out) per visit fitted there."""


def read(trace):
    fits = trace.plain.work.get("fits")
    n = len(trace.launched(trace.plain))
    if not fits or not n:
        return None
    return n / fits
