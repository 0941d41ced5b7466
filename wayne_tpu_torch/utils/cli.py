"""Shared CLI argument helpers of the port's run_* entry points (a copy of
the JAX package's ``utils.cli``)."""

from __future__ import annotations


def parse_range(spec: str, name: str) -> tuple[int, int]:
    """Parse a ``LO:HI`` pixel-range CLI argument (0-based, half-open).

    The upper bound is checked against the ACTUAL frame size later, once
    the files are read: the YAML's subarray may not match the directory.
    """
    try:
        lo, hi = (int(v) for v in spec.split(":"))
    except ValueError:
        raise SystemExit(f"{name} must look like LO:HI, got {spec!r}")
    if not 0 <= lo < hi:
        raise SystemExit(f"{name} {spec!r} is not an increasing "
                         "0-based range")
    return lo, hi
