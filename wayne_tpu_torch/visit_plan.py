"""HST visit planning (reference: wayne/observation_tools.py).

Plans exposure start times across HST orbits: the telescope's ~95.47-min
orbit gives a ~50-min visible window per orbit (the rest lost to Earth
occultation); exposures are spaced by exptime + overhead within each
window. Pure host NumPy — runs once per visit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HST_PERIOD_S = 95.47 * 60.0          # ~5728 s
VISIBILITY_S = 50.0 * 60.0           # usable window per orbit


@dataclass
class VisitPlan:
    """Exposure timing for one visit (times in s from visit start)."""

    exp_start_s: np.ndarray     # (N,)
    orbit_index: np.ndarray     # (N,) int
    orbit_start_s: np.ndarray   # (N,) start of each exposure's orbit
    exptime_s: float
    start_mjd: float

    @property
    def n_exposures(self) -> int:
        return len(self.exp_start_s)

    def exp_start_mjd(self) -> np.ndarray:
        return self.start_mjd + self.exp_start_s / 86400.0


def plan_visit(n_orbits: int, exptime_s: float, overhead_s: float,
               start_mjd: float, exposures_per_orbit: int = 0,
               first_orbit_trim: float = 0.0) -> VisitPlan:
    """Fill each orbit's visibility window with exposures.

    Args:
      exposures_per_orbit: explicit count per orbit; 0 fills the window.
      first_orbit_trim: seconds skipped at the start of orbit 1 (real
        visits spend it on target acquisition + the direct image).
    """
    cadence = exptime_s + overhead_s
    if exposures_per_orbit <= 0:
        # the last exposure needs only exptime (not its trailing
        # overhead) to end inside the window: floor(V/cadence) charged
        # the overhead and under-filled orbits by one whenever an extra
        # exposure would still fit
        exposures_per_orbit = max(
            1, int(np.floor((VISIBILITY_S - exptime_s) / cadence)) + 1)
    starts, orbits, orbit_starts = [], [], []
    for k in range(n_orbits):
        t_orbit = k * HST_PERIOD_S
        t0 = t_orbit + (first_orbit_trim if k == 0 else 0.0)
        for j in range(exposures_per_orbit):
            t = t0 + j * cadence
            if t + exptime_s > t_orbit + VISIBILITY_S:
                break
            starts.append(t)
            orbits.append(k)
            # hook-systematic clock anchor: the orbit's VISIBILITY
            # start (t_orbit) — charge trapping begins when flux first
            # hits the detector after occultation, which includes the
            # acquisition/direct-image trim time BEFORE the first grism
            # exposure. plan_from_start_times cannot know the window
            # start and approximates it with each orbit's first
            # exposure (documented there): explicit-schedule visits
            # carry a slightly fuller first-orbit hook.
            orbit_starts.append(t_orbit)
    return VisitPlan(
        exp_start_s=np.asarray(starts, np.float64),
        orbit_index=np.asarray(orbits, np.int64),
        orbit_start_s=np.asarray(orbit_starts, np.float64),
        exptime_s=exptime_s, start_mjd=start_mjd)


def plan_from_start_times(start_mjd_list, exptime_s: float,
                          orbit_gap_s: float = 0.25 * HST_PERIOD_S
                          ) -> VisitPlan:
    """A VisitPlan from EXPLICIT per-exposure start times (MJD), verbatim.

    Real visits have their exposure starts fixed by HST scheduling
    (reference: the ``exp_start_times`` parameter surface); this builds
    the plan from those times instead of the cadence model, so the ima
    EXPSTART keywords reproduce the list exactly. Orbit membership —
    which drives the hook systematic's per-orbit clock — is inferred
    from gaps: a gap longer than ``orbit_gap_s`` (default a quarter HST
    period, well above any in-orbit cadence and below the ~45-min
    occultation gap) starts a new orbit whose clock begins at that
    exposure's start. NOTE this anchor is an approximation: the cadence
    planner (plan_visit) anchors the clock at the orbit's VISIBILITY
    start, which for orbit 1 precedes the first exposure by the
    acquisition trim — an explicit list carries no window information,
    so its first-orbit hook runs slightly fuller. Real analyses fit (or
    discard) the first orbit anyway.
    """
    t = np.asarray(start_mjd_list, np.float64).ravel()
    if t.size == 0:
        raise ValueError("exp_start_mjd_list is empty")
    if np.any(np.diff(t) <= 0):
        raise ValueError("exposure start times must be strictly increasing")
    gaps_s = np.diff(t) * 86400.0
    if np.any(gaps_s < exptime_s):
        i = int(np.argmin(gaps_s))
        raise ValueError(
            f"exposure start times overlap: exposures {i} -> {i + 1} are "
            f"{gaps_s[i]:.1f} s apart but each exposure lasts "
            f"{exptime_s:.1f} s (one detector cannot expose twice at "
            "once; persistence/hook clocks would be silently wrong)")
    rel = (t - t[0]) * 86400.0
    new_orbit = np.concatenate([[True], np.diff(rel) > orbit_gap_s])
    orbit_index = np.cumsum(new_orbit) - 1
    orbit_start_s = rel[new_orbit][orbit_index]
    return VisitPlan(
        exp_start_s=rel, orbit_index=orbit_index.astype(np.int64),
        orbit_start_s=orbit_start_s, exptime_s=exptime_s,
        start_mjd=float(t[0]))
