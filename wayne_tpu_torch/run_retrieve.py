"""Forward-model retrieval from a visit's ima FITS files (counterpart of
``python -m wayne_tpu.run_retrieve``).

The file-level CLI of :mod:`wayne_tpu_torch.retrieval`: the transmission
(or, ``--mode eclipse``, emission) spectrum is fitted directly to the raw
extracted column sums by Levenberg-Marquardt with exact ``jacfwd``
Jacobians through the whole exposure engine. The visit's own parameter
file rebuilds the observing state (plan, drift, trends, calibration,
persistence, RECTE) as the simulator ran it; the model twin runs with the
stochastic noise sources off, so flat, sky, dark, non-linearity and beam
contamination are modelled, never subtracted.

Usage:
    python -m wayne_tpu_torch.run_retrieve -d out_visit/ -p pars.yml \\
        [--n-chan 8] [--mode transit|eclipse] [--estimator cds|ramp]
        [--rows Y0:Y1] [--cols X0:X1] [--fit-ramp] [--fit-scan-offset]
        [--fit-spots] [--n-lm 10] [--chunk 2] [-o retrieved.json] [--cpu]
    python -m wayne_tpu_torch.run_retrieve -d prog_out/ -p prog.yml \\
        --program [--mcmc [N]] ...

Every step after reading the files runs on the CUDA card (without one it
fails unless ``--cpu`` is given). The JSON report carries the JAX
package's keys and rounding. ``--program`` fits one shared spectrum and a
transit-time offset per visit across a ``run_program`` output; ``--mcmc``
adds the joint posterior there, and is refused without ``--program``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import sys

import numpy as np
import torch

from wayne_tpu_torch.utils.cli import parse_range as _range


def raw_column_sums(paths: list[str], estimator: str,
                    y_window: tuple[int, int] | None,
                    device: torch.device | str | None = None):
    """RAW column sums (n_exp, S) in DN and the files' EXPSTART MJDs: no
    gain, no background subtraction, no DQ repair (the forward model
    predicts the raw expectation). ``estimator`` "ramp" takes the
    up-the-ramp slope on ``device`` (None: the CUDA card); "cds" the last
    minus the zeroth read."""
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.reduction import ramp_slope_frame

    device = resolve_device(device)
    spectra, starts = [], []
    for p in paths:
        hdr, reads, times = read_ima(p)
        if str(hdr.get("BUNIT", "COUNTS")).upper().startswith("ELECTRONS"):
            raise SystemExit(
                "forward-model retrieval needs raw-DN (counts) products — "
                "this visit was written as count-rate imas; regenerate "
                "with output_units: counts (or use run_reduce)")
        if estimator == "ramp":
            net = ramp_slope_frame(
                torch.as_tensor(reads, device=device),
                torch.as_tensor(times, dtype=torch.float32,
                                device=device)).cpu().numpy()
        else:
            net = (reads[-1] - reads[0]).astype(np.float64)
        if y_window is not None:
            net = net[y_window[0]: y_window[1]]
        spectra.append(net.sum(axis=0))
        starts.append(float(hdr["EXPSTART"]))
    return np.stack(spectra), np.asarray(starts)


def _match_plan(plan_mjd: np.ndarray, starts_mjd: np.ndarray, what: str):
    """Indices of the planned exposures the files are (by EXPSTART, the
    mapping ``generate()`` used to write the headers); SystemExit when
    they do not match."""
    idx = np.argmin(np.abs(plan_mjd[None, :] - starts_mjd[:, None]), axis=1)
    dt_s = np.abs(plan_mjd[idx] - starts_mjd) * 86400.0
    if len(set(idx.tolist())) != idx.size or dt_s.max() > 1.0:
        raise SystemExit(what.format(worst=dt_s.max()))
    return idx


def _illuminated_cols(tables, scenes, S: int) -> tuple[int, int]:
    """The columns exposure 0's trace covers, padded for the PSF tails."""
    from wayne_tpu_torch.ops.dispersion import trace_params, wl_to_x

    tp0 = trace_params(tables, scenes.x_ref[0], scenes.y_ref[0])
    xs = wl_to_x(tables.wl_edges, tp0).cpu().numpy()
    return (int(max(np.floor(xs.min()) - 3, 0)),
            int(min(np.ceil(xs.max()) + 4, S)))


def _wl_edges(tables, scenes, x_window, n_chan: int) -> np.ndarray:
    from wayne_tpu_torch.ops.dispersion import trace_params, x_to_wl
    from wayne_tpu_torch.reduction import _channel_edges

    tp0 = trace_params(tables, scenes.x_ref[0], scenes.y_ref[0])
    edges = torch.as_tensor(_channel_edges(x_window, n_chan),
                            dtype=torch.float32, device=tables.device)
    return x_to_wl(edges, tp0).cpu().numpy()


def _program_posterior(args, res, scenes_list, tables) -> dict:
    """``--program --mcmc``: the joint Goodman-Weare posterior over (the
    shared spectrum, per-visit t0, per-visit-channel baselines, a noise
    scale) on template-cleaned channel curves: each visit's data divided by
    the forward model at the LM solution (instrument structure the
    analytic model cannot express: persistence afterglow, trends,
    cross-talk) and multiplied by the analytic transit at the same
    solution, seeded from the LM fit."""
    from wayne_tpu_torch.mcmc import sample_program_posterior
    from wayne_tpu_torch.ops.kepler import projected_separation
    from wayne_tpu_torch.ops.transit import transit_depth_curve
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import out_of_transit_mask

    dev = tables.device
    exptime = float(tables.read_times[-1])
    orbit0 = tree_map(lambda x: x[0], scenes_list[0].orbit)
    ld0 = scenes_list[0].ld[0]
    lcs, mids, sigs, n_oots = [], [], [], []
    for v, sc in enumerate(scenes_list):
        mid = sc.exp_start_s + 0.5 * exptime
        orb_v = dataclasses.replace(
            orbit0, t0_s=orbit0.t0_s + float(res.t0_offsets_s[v]))
        z_v, infr_v = projected_separation(mid, orb_v)
        rp = torch.as_tensor(res.rp, dtype=torch.float32, device=dev)
        ana = (1.0 - (1.0 - transit_depth_curve(
            z_v[:, None], rp[None, :], ld0, 32)) * infr_v[:, None])
        ana = ana.cpu().numpy()                             # (n_exp, K)
        lcs.append(res.data_chan[v] / np.maximum(res.model_chan[v], 1e-6)
                   * ana)
        sigs.append(res.sigma_chan[v])
        mids.append(mid.cpu().numpy())
        # the baseline count from the UNSHIFTED orbit, as the JAX package
        # counts it, so that the two packages' posteriors compare
        n_oots.append(float(out_of_transit_mask(mid, orbit0).sum()))
    n_burn = max(0, min(max(args.mcmc // 3, 300), args.mcmc // 2,
                        args.mcmc - 1))
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    post = sample_program_posterior(
        f32(np.stack(lcs)), f32(np.stack(mids)), orbit0, ld0, f32(res.rp),
        f32(res.t0_offsets_s), f32(np.stack(sigs)), f32(n_oots), 20250820,
        n_steps=args.mcmc, n_burn=n_burn)
    pct = lambda m, lo, hi, nd: [
        [round(float(a - b), nd), round(float(a), nd), round(float(a + c), nd)]
        for a, b, c in zip(m.tolist(), lo.tolist(), hi.tolist())]
    out = {
        "n_steps": args.mcmc, "n_burn": n_burn,
        "acceptance": round(float(post.acceptance), 3),
        "rhat_max": round(float(post.rhat.max()), 4),
        "ess_min": round(float(post.ess.min()), 1),
        "t0_offsets_percentiles_16_50_84_s": pct(
            post.t0_median_s, post.t0_minus_s, post.t0_plus_s, 2),
        "rp_percentiles_16_50_84": pct(post.rp_median, post.rp_minus,
                                       post.rp_plus, 6),
    }
    print(f"program posterior: t0 = "
          f"{out['t0_offsets_percentiles_16_50_84_s']} s (acc "
          f"{out['acceptance']:.2f}, R-hat {out['rhat_max']:.3f})")
    return out


def _main_program(args, cfg, dev) -> int:
    """``--program``: the joint retrieval across a run_program output."""
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.program import (
        SECONDS_PER_DAY, Program, visit_config, visit_start_mjds)
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.retrieval import retrieve_transmission_joint

    if args.mcmc and args.mode == "eclipse":
        # refused before the (expensive) joint fit
        raise SystemExit("--mcmc on the program path is wired for "
                         "transit mode")
    summary_path = os.path.join(args.visit_dir, "program_summary.json")
    if not os.path.exists(summary_path):
        raise SystemExit(f"{summary_path} not found — is -d a "
                         "run_program output directory?")
    with open(summary_path) as fh:
        summary = json.load(fh)
    # the MODEL carries the ASSUMED linear ephemeris (drift zeroed): the
    # fitted per-visit t0 offsets are the drift measurement
    cfg_assumed = dataclasses.replace(
        cfg, program=dataclasses.replace(cfg.program,
                                         t0_drift_s_per_visit=0.0))
    starts = visit_start_mjds(cfg_assumed)
    y_window = _range(args.rows, "--rows") if args.rows else None

    spectra_list, scenes_list = [], []
    tables = static = None
    for i, entry in enumerate(summary["visits"]):
        vdir = os.path.join(args.visit_dir, entry["dir"])
        paths = sorted(glob.glob(os.path.join(vdir, "*_ima.fits")))
        if not paths:
            raise SystemExit(f"no *_ima.fits files in {vdir!r}")
        vcfg = visit_config(cfg_assumed, i, starts)
        if (i > 0 and cfg.persistence.enabled
                and cfg.program.carry_persistence):
            # the data opened with visit i-1's afterglow: the model must
            # carry the same prior stimulus
            prev = os.path.join(args.visit_dir,
                                summary["visits"][i - 1]["dir"])
            carry_map = os.path.join(prev, Program.CARRY_FILE)
            meta_path = os.path.join(prev, Program.CARRY_META)
            if not (os.path.exists(carry_map)
                    and os.path.exists(meta_path)):
                raise SystemExit(
                    f"{prev} lacks {Program.CARRY_FILE}: this program "
                    "was generated with carry_persistence but the "
                    "carried-fluence products are missing — re-run "
                    "run_program (resume recomputes them)")
            with open(meta_path) as fh:
                meta = json.load(fh)
            vcfg = dataclasses.replace(
                vcfg, persistence=dataclasses.replace(
                    vcfg.persistence, prior_fluence_file=carry_map,
                    prior_end_s=float(
                        (meta["end_mjd"] - vcfg.start_mjd)
                        * SECONDS_PER_DAY)))
        obs = Observation(vcfg, device=dev)
        obs._ensure_persistence()
        obs._ensure_recte()
        spectra, starts_mjd = raw_column_sums(paths, args.estimator,
                                              y_window, dev)
        idx = _match_plan(
            np.asarray(obs.plan.exp_start_mjd(), np.float64), starts_mjd,
            f"{entry['dir']}: ima EXPSTARTs do not match the visit plan "
            "(worst offset {worst:.1f} s) — wrong YAML?")
        idx_t = torch.as_tensor(idx, device=dev)
        scenes_list.append(tree_map(lambda x: x[idx_t], obs.scenes))
        spectra_list.append(torch.as_tensor(spectra, dtype=torch.float32,
                                            device=dev))
        tables, static = obs.tables, obs.static
    n_exps = {int(s.shape[0]) for s in spectra_list}
    if args.mcmc and len(n_exps) != 1:
        # refused before the joint fit, which the posterior would follow
        raise SystemExit("program posterior needs equal-length "
                         f"visits (got {sorted(n_exps)})")

    S = int(spectra_list[0].shape[1])
    x_window = (_range(args.cols, "--cols") if args.cols
                else _illuminated_cols(tables, scenes_list[0], S))
    n_vis = len(spectra_list)
    eclipse = args.mode == "eclipse"
    label = "Fp/Fs" if eclipse else "Rp/Rs"
    print(f"joint retrieval over {n_vis} visits "
          f"({sum(int(s.shape[0]) for s in spectra_list)} exposures), "
          f"channels over cols {x_window}; shared {label} + per-visit "
          f"t0{' + ramp' if args.fit_ramp else ''}")

    res = retrieve_transmission_joint(
        spectra_list, scenes_list, tables, static,
        x_window=x_window, n_chan=args.n_chan,
        rp_init=(1e-3 if eclipse
                 else float(cfg.planet.rp_over_rs or 0.1)),
        estimator=args.estimator, y_window=y_window,
        fit_t0=True, fit_ramp=args.fit_ramp, mode=args.mode,
        n_lm=args.n_lm, chunk=args.chunk)

    wl_edges = _wl_edges(tables, scenes_list[0], x_window, args.n_chan)
    drift = None
    if n_vis > 1:
        drift = float(np.polyfit(np.arange(n_vis), res.t0_offsets_s, 1)[0])
    prog_post = (_program_posterior(args, res, scenes_list, tables)
                 if args.mcmc else None)
    report = {
        "method": "joint_forward_model_retrieval",
        "mode": args.mode,
        "n_visits": n_vis,
        "chi2": round(res.chi2, 3),
        "n_points": res.n_points,
        "lm_iterations": res.n_iter,
        "t0_offsets_s": [round(float(v), 2) for v in res.t0_offsets_s],
        "t0_offsets_sigma_s": [round(float(v), 2)
                               for v in res.t0_offsets_sigma_s],
        **({"drift_s_per_visit_fitted": round(drift, 2)}
           if drift is not None else {}),
        **({"program_posterior": prog_post}
           if prog_post is not None else {}),
        **({"visit_trend_fits": [
            {"slope_per_day": round(float(r0) * 86400.0, 6),
             "hook_amp": round(float(r1), 6)}
            for r0, r1 in res.ramp]} if res.ramp is not None else {}),
        "channels": [
            {"wl_lo_um": round(float(wl_edges[i]), 4),
             "wl_hi_um": round(float(wl_edges[i + 1]), 4),
             ("fp_over_fs" if eclipse else "rp_over_rs"):
                 round(float(res.rp[i]), 7),
             ("fp_sigma" if eclipse else "rp_sigma"):
                 round(float(res.rp_sigma[i]), 7),
             "constrained": bool(res.constrained[i])}
            for i in range(args.n_chan)],
    }
    out = args.output or os.path.join(args.visit_dir,
                                      "retrieved_joint.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(f"joint {label}: {res.rp.min():.6g}..{res.rp.max():.6g}; "
          f"t0 offsets {report['t0_offsets_s']} s"
          + (f" (drift {report['drift_s_per_visit_fitted']:+.1f} "
             "s/visit)" if drift is not None else "")
          + f" -> {out}")
    return 0


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.run_retrieve",
        description="Fit a visit's transmission spectrum through the "
                    "full differentiable forward model (PyTorch port of "
                    "wayne_tpu).")
    parser.add_argument("-d", "--visit-dir", required=True)
    parser.add_argument("-p", "--parameter-file", required=True,
                        help="the visit's YAML (rebuilds the observing "
                             "state the model twin simulates)")
    parser.add_argument("-o", "--output", default=None,
                        help="JSON report (default <dir>/retrieved.json)")
    parser.add_argument("--n-chan", type=int, default=8)
    parser.add_argument("--mode", choices=("transit", "eclipse"),
                        default="transit",
                        help="transit: retrieve per-channel Rp/Rs; "
                             "eclipse: per-channel Fp/Fs dayside "
                             "emission (secondary-eclipse visits)")
    parser.add_argument("--estimator", choices=("cds", "ramp"),
                        default="cds")
    parser.add_argument("--rows", default=None, metavar="Y0:Y1",
                        help="restrict the column sums (data AND model) "
                             "to these rows")
    parser.add_argument("--cols", default=None, metavar="X0:X1",
                        help="dispersion-column channel window (default: "
                             "the illuminated columns from the trace)")
    parser.add_argument("--fit-ramp", action="store_true",
                        help="jointly fit [visit slope, hook amplitude] "
                             "through the model's visit-trend physics")
    parser.add_argument("--fit-scan-offset", action="store_true",
                        help="jointly fit the reverse-scan flux offset as "
                             "one achromatic nuisance (a forward/reverse "
                             "alternating visit)")
    parser.add_argument("--fit-spots", action="store_true",
                        help="jointly fit one spot-deficit scale through "
                             "the starspot physics (a spots: block)")
    parser.add_argument("--program", action="store_true",
                        help="-d is a run_program output directory: fit "
                             "ONE shared spectrum across all visits with "
                             "a per-visit mid-transit offset (writes "
                             "<dir>/retrieved_joint.json)")
    parser.add_argument("--mcmc", type=int, default=0, nargs="?",
                        const=4000, metavar="N",
                        help="with --program: the joint Goodman-Weare "
                             "posterior over (shared spectrum, per-visit "
                             "t0, baselines, noise scale) seeded from the "
                             "LM fit; N ensemble steps (bare flag: 4000)")
    parser.add_argument("--n-lm", type=int, default=10)
    parser.add_argument("--chunk", type=int, default=2,
                        help="exposures per forward-pass chunk: one readout "
                             "launch each (jacfwd multiplies the working "
                             "set by the number of parameters)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.retrieval import retrieve_transmission

    dev = resolve_device("cpu" if args.cpu else None)
    if args.mcmc and not args.program:
        raise SystemExit("--mcmc samples the joint program posterior and "
                         "needs --program (the single-visit retrieval "
                         "reports curvature errors)")
    cfg = load_yaml(args.parameter_file)
    if args.program:
        return _main_program(args, cfg, dev)
    paths = sorted(glob.glob(os.path.join(args.visit_dir, "*_ima.fits")))
    if not paths:
        raise SystemExit(f"no *_ima.fits files in {args.visit_dir!r}")

    obs = Observation(cfg, device=dev)
    # charge-memory physics the data carried must be in the model too
    obs._ensure_persistence()
    obs._ensure_recte()
    scenes, tables, static = obs.scenes, obs.tables, obs.static

    y_window = _range(args.rows, "--rows") if args.rows else None
    spectra, starts_mjd = raw_column_sums(paths, args.estimator, y_window,
                                          dev)
    S = spectra.shape[1]
    if y_window is not None and y_window[1] > int(tables.sky_frame.shape[0]):
        raise SystemExit(f"--rows {args.rows} outside the {S}^2 frames")
    idx = _match_plan(
        np.asarray(obs.plan.exp_start_mjd(), np.float64), starts_mjd,
        "ima EXPSTARTs do not match the parameter file's visit plan "
        "(worst offset {worst:.1f} s) — wrong YAML for this directory?")
    if idx.size != scenes.n:
        print(f"partial visit: {idx.size} of {scenes.n} planned exposures "
              "on disk — retrieving from those")
    idx_t = torch.as_tensor(idx, device=dev)
    scenes = tree_map(lambda x: x[idx_t], scenes)

    if args.cols:
        x_window = _range(args.cols, "--cols")
        if x_window[1] > S:
            raise SystemExit(f"--cols {args.cols} outside the {S}-px frame")
    else:
        x_window = _illuminated_cols(tables, scenes, S)
    print(f"retrieving {idx.size} exposures, channels over cols "
          f"{x_window}, rows {y_window or ('all',)}; estimator "
          f"{args.estimator}; {args.n_chan} channels")

    if args.mode == "eclipse":
        d0 = float(cfg.planet.eclipse_depth or 1e-3)
    else:
        d0 = float(cfg.planet.rp_over_rs or 0.1)
    res = retrieve_transmission(
        torch.as_tensor(spectra, dtype=torch.float32, device=dev), scenes,
        tables, static, x_window=x_window, n_chan=args.n_chan, rp_init=d0,
        estimator=args.estimator, y_window=y_window, mode=args.mode,
        fit_ramp=args.fit_ramp, fit_scan_offset=args.fit_scan_offset,
        fit_spots=args.fit_spots, n_lm=args.n_lm, chunk=args.chunk)

    wl_edges = _wl_edges(tables, scenes, x_window, args.n_chan)
    dof = max(res.n_points - res.rp.size
              - (2 if args.fit_ramp else 0)
              - (1 if args.fit_scan_offset else 0)
              - (1 if args.fit_spots else 0), 1)
    dkey = "fp_over_fs" if args.mode == "eclipse" else "rp_over_rs"
    skey = "fp_sigma" if args.mode == "eclipse" else "rp_sigma"
    report = {
        "method": "forward_model_retrieval",
        "n_exposures": int(idx.size),
        "grism": cfg.grism,
        "mode": args.mode,
        "estimator": args.estimator,
        "windows": {"rows": (list(y_window) if y_window else None),
                    "cols": list(x_window)},
        "chi2": round(res.chi2, 3),
        "chi2_per_dof": round(res.chi2 / dof, 4),
        "lm_iterations": res.n_iter,
        **({"visit_trend_fit": {
            "slope_per_day": round(float(res.ramp[0]) * 86400.0, 6),
            "slope_sigma_per_day": round(float(res.ramp_sigma[0])
                                         * 86400.0, 6),
            "hook_amp": round(float(res.ramp[1]), 6),
            "hook_amp_sigma": round(float(res.ramp_sigma[1]), 6)}}
           if res.ramp is not None else {}),
        **({"scan_offset_fit": {
            "reverse_flux_offset": round(res.scan_offset, 6),
            "reverse_flux_offset_sigma": round(res.scan_offset_sigma,
                                               6)}}
           if res.scan_offset is not None else {}),
        **({"spot_fit": {
            "spot_deficit_scale": round(res.spot_scale, 4),
            "spot_deficit_scale_sigma": round(res.spot_scale_sigma, 4)}}
           if res.spot_scale is not None else {}),
        "channels": [
            {"wl_lo_um": round(float(wl_edges[i]), 4),
             "wl_hi_um": round(float(wl_edges[i + 1]), 4),
             dkey: round(float(res.rp[i]), 7),
             skey: round(float(res.rp_sigma[i]), 7),
             "constrained": bool(res.constrained[i])}
            for i in range(args.n_chan)],
    }
    out = args.output or os.path.join(args.visit_dir, "retrieved.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    label = "Fp/Fs" if args.mode == "eclipse" else "Rp/Rs"
    print(f"retrieved {label}: {res.rp.min():.6g}..{res.rp.max():.6g} "
          f"(chi2/dof {report['chi2_per_dof']:.3f}, {res.n_iter} LM "
          f"iterations) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
