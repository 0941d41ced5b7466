"""Numerical guards (port of the JAX package's ``utils/guards``): NaN/Inf
and physical-range checks on simulation outputs.

Host-side validation of a chunk's outputs (NumPy arrays, or anything with
``reads_dn``, ``ideal_e`` and ``saturated_frac`` that ``np.asarray``
takes); cheap (summary statistics, no per-pixel Python loops) and used by
``Observation.generate`` when ``debug=True``.
"""

from __future__ import annotations

import numpy as np


class SimulationError(RuntimeError):
    pass


def check_exposure_result(res, *, context: str = "",
                          sat_limit: float = 0.05) -> dict:
    """Validate a (possibly batched) ExposureResult; returns summary stats.

    Raises SimulationError on NaN/Inf reads, negative ideal charge, or a
    fully saturated frame (almost always a mis-set magnitude/scan config).
    """
    reads = np.asarray(res.reads_dn)
    ideal = np.asarray(res.ideal_e)
    sat = np.asarray(res.saturated_frac)
    prefix = f"{context}: " if context else ""
    if not np.isfinite(reads).all():
        bad = (~np.isfinite(reads)).sum()
        raise SimulationError(f"{prefix}{bad} non-finite values in reads")
    # NaN in ideal_e/saturated_frac would sail through the range checks
    # below (NaN comparisons are False) — the sanitizer must catch it.
    if not np.isfinite(ideal).all():
        bad = (~np.isfinite(ideal)).sum()
        raise SimulationError(f"{prefix}{bad} non-finite values in ideal_e")
    if not np.isfinite(sat).all():
        raise SimulationError(f"{prefix}non-finite saturated_frac")
    # fp32 erf-difference tails legitimately dip ~-1e-6 of peak; only a
    # physically meaningful negative excursion is an error.
    if ideal.min() < -max(1.0, 1e-5 * float(ideal.max())):
        raise SimulationError(
            f"{prefix}negative ideal charge (min {ideal.min():.3g} e-)")
    # A spectrum footprint is a few % of the frame; saturating more than
    # sat_limit of ALL pixels means the source is flooding the detector.
    if sat.max() > sat_limit:
        raise SimulationError(
            f"{prefix}saturated fraction {sat.max():.3f} exceeds "
            f"{sat_limit} — check stellar magnitude / scan speed / NSAMP")
    return {
        "reads_min_dn": float(reads.min()),
        "reads_max_dn": float(reads.max()),
        "ideal_total_e": float(ideal.sum()),
        "saturated_frac_max": float(sat.max()),
    }
