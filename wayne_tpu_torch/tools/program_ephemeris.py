"""Recover a program's ephemeris drift from its reduced visits (the port's
counterpart of the repository's ``tools/program_ephemeris.py``).

Each visit's fitted mid-transit time, measured against the ASSUMED linear
ephemeris (the stale YAML t0 the reducer uses), exposes any drift in the
true ephemeris. On a ``run_program`` output:

  1. reduce every visit with the parametric ramp fit and free geometry
     (``run_reduce --detrend ramp --fit-geometry``), which reports the
     fitted ``t0_offset_s`` per visit;
  2. fit a line to t0_offset against the visit index: the slope estimates
     ``program.t0_drift_s_per_visit``, the intercept any constant t0
     error;
  3. set it beside ``program_summary.json``'s per-visit true t0s;
  4. combine the per-visit channel depths into the program's transmission
     spectrum (inverse-variance weighted mean) with a per-channel
     repeatability chi2.

Usage:
  python -m wayne_tpu_torch.tools.program_ephemeris -d prog_out/ \\
      -p pars.yml [--cpu] [--n-chan 4]

The reductions run on the CUDA card; without one it fails unless ``--cpu``
is given. Writes <program dir>/ephemeris.json with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def measure_program_ephemeris(program_dir: str, parameter_file: str,
                              n_chan: int = 4,
                              cpu: bool = False) -> dict:
    """Reduce each visit_NN/ and fit the linear ephemeris residual."""
    from wayne_tpu_torch.run_reduce import main as reduce_main

    with open(os.path.join(program_dir, "program_summary.json")) as fh:
        summary = json.load(fh)
    visits = summary["visits"]
    offsets, chans, chan_sigs, chan_ok = [], [], [], []
    wl_ranges = None
    for v in visits:
        vdir = os.path.join(program_dir, v["dir"])
        red_path = os.path.join(vdir, "reduced_ephemeris.json")
        argv = ["-d", vdir, "-p", parameter_file, "--n-chan", str(n_chan),
                "--detrend", "ramp", "--fit-geometry", "-o", red_path]
        if cpu:
            argv.append("--cpu")
        rc = reduce_main(argv)
        if rc != 0:
            raise RuntimeError(f"run_reduce failed for {vdir} (rc={rc})")
        with open(red_path) as fh:
            red = json.load(fh)
        geo = red["white_ramp_fit"]["fitted_geometry"]
        offsets.append(float(geo["t0_offset_s"]))
        chans.append([c["rp_over_rs"] for c in red["channels"]])
        chan_sigs.append([c["rp_sigma"] for c in red["channels"]])
        chan_ok.append([bool(c.get("constrained", True))
                        for c in red["channels"]])
        wl_ranges = [(c["wl_lo_um"], c["wl_hi_um"])
                     for c in red["channels"]]
    idx = np.arange(len(offsets), dtype=float)
    off = np.array(offsets)
    if len(off) > 1:
        slope, intercept = np.polyfit(idx, off, 1)
    else:
        slope, intercept = 0.0, float(off[0])
    injected = [(v["true_t0_mjd"] - summary["assumed_t0_mjd"]) * 86400.0
                for v in visits]
    # the program's combined spectrum: the inverse-variance weighted mean
    # per channel across visits, with a repeatability chi2 per channel
    # (astrophysical variability or an unmodelled per-visit systematic
    # shows up here first)
    rp = np.asarray(chans, np.float64)            # (n_vis, n_chan)
    sg = np.maximum(np.asarray(chan_sigs, np.float64), 1e-12)
    w = 1.0 / sg**2
    rp_comb = (w * rp).sum(axis=0) / w.sum(axis=0)
    sig_comb = 1.0 / np.sqrt(w.sum(axis=0))
    chi2_rep = (((rp - rp_comb[None, :]) / sg) ** 2).sum(axis=0)
    dof_rep = max(rp.shape[0] - 1, 1)
    out = {
        "per_visit_t0_offset_s": [round(v, 2) for v in offsets],
        "per_visit_injected_offset_s": [round(v, 2) for v in injected],
        "drift_s_per_visit_fitted": round(float(slope), 2),
        "drift_s_per_visit_injected": summary["t0_drift_s_per_visit"],
        "t0_intercept_s": round(float(intercept), 2),
        "combined_spectrum": [
            {"wl_lo_um": wl_ranges[j][0], "wl_hi_um": wl_ranges[j][1],
             "rp_over_rs": round(float(rp_comb[j]), 7),
             "rp_sigma": round(float(sig_comb[j]), 7),
             # a combined channel is trustworthy only if EVERY visit's fit
             # constrained it (the per-visit reduced.json flag)
             "constrained": bool(np.all(np.asarray(chan_ok)[:, j])),
             "repeatability_chi2_per_dof": round(
                 float(chi2_rep[j]) / dof_rep, 3)}
            for j in range(rp.shape[1])],
    }
    with open(os.path.join(program_dir, "ephemeris.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.tools.program_ephemeris")
    parser.add_argument("-d", "--program-dir", required=True)
    parser.add_argument("-p", "--parameter-file", required=True)
    parser.add_argument("--n-chan", type=int, default=4)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    out = measure_program_ephemeris(args.program_dir, args.parameter_file,
                                    n_chan=args.n_chan, cpu=args.cpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
