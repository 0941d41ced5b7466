"""Reduce a generated visit's ima FITS files back to science products
(counterpart of ``python -m wayne_tpu.run_reduce``).

Reads the ima files a visit wrote, repairs DQ-flagged reads, subtracts the
per-read amplifier bias drift of full-frame products off their DQ-128
reference border (calwf3 BLEVCORR), inverts the non-linearity (NLINCORR),
extracts background-subtracted spectra (box or Horne-optimal, CDS or
up-the-ramp, per-column sky rows or the fitted sky components), aligns
dispersion drifts, removes systematics (divide-white, the parametric
Iraclis ramp fit, optionally with a free ephemeris and robust clipping, or
the physical RECTE fit) and fits per-channel science: Rp/Rs (transit),
Fp/Fs (eclipse) or the thermal phase curve (phase).

Usage:
    python -m wayne_tpu_torch.run_reduce -d out_visit/ -p pars.yml \\
        [--n-chan 8] [--mode transit|eclipse|phase]
        [--estimator cds|ramp] [--extract box|optimal] [--align]
        [--detrend divide-white|ramp|recte|none] [--fit-geometry]
        [--clip-sigma K] [--sky-fit] [--mcmc [N]] [--direct-image]
        [--wl-range LO:HI] [--rows Y0:Y1 --cols X0:X1 --bg-rows B0:B1]
        [--save-spectra] [--save-lc] [--plot] [-o reduced.json] [--cpu]
        [--trace DIR]

Files are read on the host; every step after that runs on the CUDA card
(without one it fails unless ``--cpu`` is given). The JSON report carries
the JAX package's keys and rounding. ``--mcmc [N]`` adds the ensemble-MCMC
posteriors of the white curve and of every channel (``mcmc.py``, N steps,
transit and eclipse modes) under the JAX package's report keys.
``--trace DIR`` runs the reduction with the program's spans on and under
``torch.profiler``: ``DIR/trace.json`` is the Chrome trace (the spans
appear in it as ``wt:<name>``), ``DIR/spans.json`` the spans' records
(``reduce.extract``, ``reduce.fit`` and the fits under it), the host-sync
count on a card, and each name's count, total and self seconds.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

import numpy as np
import torch

from wayne_tpu_torch.io.ima import read_ima
from wayne_tpu_torch.reduction import (
    DQ_BAD_BITS, DQ_REF_PIXEL, _median, good_diff_masks_from_dq,
    linearize_reads, ramp_slope_frame, ref_pixel_correct, repair_read_stack,
)
from wayne_tpu_torch.utils import profiling
from wayne_tpu_torch.utils.profiling import span


def collect_visit(visit_dir: str) -> list[str]:
    """The visit's ima files in exposure order (direct image excluded)."""
    paths = sorted(glob.glob(os.path.join(visit_dir, "*_ima.fits")))
    if not paths:
        raise FileNotFoundError(f"no *_ima.fits files in {visit_dir!r}")
    return paths


def centroid_direct_image(path: str) -> tuple[float, float]:
    """Source centroid (x, y) from a visit-opening direct image: the CDS
    frame with DQ-flagged pixels zeroed and its median taken off, the peak
    of its 3x3 box sum (zero-padded, no wrap), and the flux-weighted
    centroid of the 17x17 window around it. Host NumPy, as in the JAX
    package."""
    _, reads, _, dq = read_ima(path, with_dq=True)
    frame = (reads[-1] - reads[0]).astype(np.float64)
    bad = (dq[-1] & DQ_BAD_BITS) != 0
    frame[bad] = 0.0
    frame -= np.median(frame)
    pad = np.pad(frame, 1)
    s = np.zeros_like(frame)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            s += pad[dy:dy + frame.shape[0], dx:dx + frame.shape[1]]
    iy, ix = np.unravel_index(int(np.argmax(s)), s.shape)
    w = 8
    y0, y1 = max(iy - w, 0), min(iy + w + 1, frame.shape[0])
    x0, x1 = max(ix - w, 0), min(ix + w + 1, frame.shape[1])
    sub = np.clip(frame[y0:y1, x0:x1], 0.0, None)
    tot = sub.sum()
    if tot <= 0:
        raise ValueError(f"no source flux in direct image {path!r}")
    ys, xs = np.mgrid[y0:y1, x0:x1]
    return float((sub * xs).sum() / tot), float((sub * ys).sum() / tot)


def _on(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def extract_from_files(paths: list[str], gain: float,
                       estimator: str = "cds", use_dq: bool = True,
                       extract: str = "box", read_noise_e: float = 12.0,
                       windows: tuple | None = None,
                       nlin: dict | None = None,
                       sky_components: dict | None = None,
                       quad_map: torch.Tensor | None = None,
                       device: torch.device | str | None = None):
    """Spectral extraction from ima files: each file read on the host, its
    chain run on ``device`` (None: the CUDA card).

    Per file, in calwf3's order: BLEVCORR (``ref_pixel_correct``) when the
    first read carries DQ-128 reference pixels, NLINCORR
    (``linearize_reads``) when ``nlin`` is given and the header's switch is
    not 'OMIT', the DQ repair (``repair_read_stack``) when any CR,
    saturation or static bit is set, then the CDS net or, with
    ``estimator='ramp'``, the up-the-ramp slope. Count-rate products
    (BUNIT ELECTRONS/S) are turned back into accumulated electrons and
    differenced against the first sampled read.

    ``nlin``: {'coeffs' (3, S, S), 'fw' (e-), 'bias_e' (S, S) or None,
    'gain_map' (S, S) or None} on ``device``. ``windows``: explicit
    (y_window, x_window, bg_rows), else detected from the median net frame
    (rows above 5% of the peak row sum, columns above 10% within them,
    3 px padding; sky rows the larger margin beyond a 12 px gap).
    ``sky_components``: {'names', 'frames' (K, S, S)} fits the background
    (``fit_sky_model``) instead of the per-column median of the sky rows.
    ``quad_map``: (S, S) amplifier quadrants for ``amp_offset_correct``.
    ``extract='optimal'``: Horne extraction with the visit-mean profile.

    Returns (spectra_e (n_exp, S) tensor on ``device``, mid-times (n_exp,)
    NumPy seconds from the first exposure start, (y_window, x_window,
    bg_rows), scan angles (n_exp,) from SCAN_ANG, the sky-fit report or
    None).
    """
    from wayne_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    lin = None
    if nlin is not None:
        def lin(stack, g):
            return linearize_reads(stack, nlin["coeffs"], float(nlin["fw"]),
                                   g, bias_e=nlin.get("bias_e"))

    nets, starts, exptimes, n_reads, scan_angs = [], [], [], [], []
    n_repaired = n_refpix = n_linearized = 0
    for p in paths:
        hdr, reads, times, dq = read_ima(p, with_dq=True)
        flagged = use_dq and bool((dq & DQ_BAD_BITS).any())
        n_repaired += flagged
        ref_mask = ((dq[0] & DQ_REF_PIXEL) != 0) if use_dq else None
        has_ref = use_dq and bool(ref_mask.any())
        n_refpix += has_ref
        # calwf3 switch: 'OMIT' products were simulated without the cubic
        # compression; 'PERFORM' (or absent, like real raw files) means
        # the reads are compressed and are linearized
        do_nlin = (lin is not None and str(hdr.get(
            "NLINCORR", "PERFORM")).upper() != "OMIT")
        if do_nlin and reads.shape[-1] != nlin["coeffs"].shape[-1]:
            print(f"warning: NLINCORR skipped — {reads.shape[-1]}^2 "
                  f"frames vs {nlin['coeffs'].shape[-1]}^2 calibration "
                  "planes (YAML subarray mismatch?)")
            lin = None
            do_nlin = False
        n_linearized += do_nlin

        def refpix(stack):
            return ref_pixel_correct(stack, _on(ref_mask, dev))[0]

        def repair(stack):
            return repair_read_stack(stack, good_diff_masks_from_dq(
                _on(dq, dev)))

        if str(hdr.get("BUNIT", "COUNTS")).upper().startswith("ELECTRONS"):
            if estimator == "ramp":
                raise SystemExit(
                    "--estimator ramp needs raw-DN (counts) products; "
                    "this visit was written as a count-rate ima")
            if len(reads) < 3:
                raise SystemExit(
                    "count-rate product with NSAMP=1: the zeroth read's "
                    "rate plane is empty and the only sampled read IS the "
                    "last read, so no CDS-able signal exists — regenerate "
                    "the visit with nsamp >= 2 or output_units: counts")
            # rate planes back to accumulated electrons; the zeroth read's
            # plane is zero, so difference against the first sampled read
            acc = _on(reads.astype(np.float64)
                      * np.asarray(times, np.float64)[:, None, None],
                      dev).to(torch.float32)
            if has_ref:
                acc = refpix(acc)
            if do_nlin:
                acc = lin(acc, 1.0)      # already gain-converted electrons
            if flagged:
                acc = repair(acc)
            net = acc[-1] - acc[1]
        else:
            stack = _on(reads, dev).to(torch.float32)
            t_reads = _on(np.asarray(times, np.float32), dev)
            if has_ref:
                stack = refpix(stack)
            if do_nlin:
                # NLINCORR converts DN to linearized, bias-subtracted
                # electrons: the estimators below apply no gain
                g = nlin["gain_map"] if nlin.get("gain_map") is not None \
                    else gain
                stack = lin(stack, g)
                if flagged:
                    stack = repair(stack)
                net = (ramp_slope_frame(stack, t_reads) if estimator == "ramp"
                       else stack[-1] - stack[0])
            else:
                if flagged:
                    stack = repair(stack)
                net = (ramp_slope_frame(stack, t_reads) if estimator == "ramp"
                       else stack[-1] - stack[0]) * gain
        nets.append(net)
        starts.append(float(hdr["EXPSTART"]))
        exptimes.append(float(hdr.get("EXPTIME", times[-1])))
        n_reads.append(int(reads.shape[0]))
        scan_angs.append(float(hdr.get("SCAN_ANG", 0.0)))
    if n_repaired:
        print(f"DQ repair: rebuilt flagged reads in {n_repaired}/"
              f"{len(paths)} exposures (CR/saturation/hot bits)")
    if n_refpix:
        print(f"reference pixels: per-read amplifier bias drift "
              f"subtracted in {n_refpix}/{len(paths)} exposures "
              f"(DQ bit 128 border)")
    if n_linearized:
        print(f"NLINCORR: per-pixel cubic non-linearity inverted in "
              f"{n_linearized}/{len(paths)} exposures")
    nets = torch.stack(nets)                   # (n_exp, S, S) electrons
    starts = np.asarray(starts)
    exptimes = np.asarray(exptimes)
    # per-exposure mid-times: a directory may mix EXPTIMEs
    mids = (starts - starts.min()) * 86400.0 + exptimes / 2.0
    if not np.allclose(exptimes, exptimes[0]):
        print(f"warning: mixed EXPTIME across exposures "
              f"({exptimes.min():.1f}..{exptimes.max():.1f} s) — "
              "per-exposure mid-times used; the optimal-extraction "
              "read-noise floor uses the smallest read count")

    S = nets.shape[1]
    if windows is not None:
        y_window, x_window, bg_rows = windows
        for name, (lo, hi) in zip(("--rows", "--cols", "--bg-rows"),
                                  windows):
            if hi > S:
                raise SystemExit(
                    f"{name} {lo}:{hi} outside the {S}^2 frames in this "
                    "directory — does the parameter file's subarray match "
                    "the visit being reduced?")
    else:
        # the median frame on the device (jnp.median's middle pair), the
        # window rules on the host in NumPy, as in the JAX package
        med = _median(nets, 0).cpu().numpy()
        pad = 3
        row_sig = med.sum(axis=1)
        row_sig = row_sig - np.median(row_sig)
        rows = np.where(row_sig > 0.05 * row_sig.max())[0]
        if rows.size == 0:
            raise SystemExit(
                "no signal rows detected — the frames look background-only "
                "(was the spectrum off the detector? the simulator warns "
                "'spectrum lands outside the subarray' at generation time)")
        y_window = (max(int(rows.min()) - pad, 0),
                    min(int(rows.max()) + pad + 1, S))
        col_sig = med[y_window[0]: y_window[1]].sum(axis=0)
        col_sig = col_sig - np.median(col_sig)
        cols = np.where(col_sig > 0.1 * col_sig.max())[0]
        if cols.size == 0:
            raise SystemExit(
                "no illuminated columns detected inside the signal rows — "
                "frames appear to carry no dispersed spectrum")
        x_window = (max(int(cols.min()) - pad, 0),
                    min(int(cols.max()) + pad + 1, S))
        gap = 4 * pad
        top = (min(y_window[1] + gap, S), S)
        bot = (0, max(y_window[0] - gap, 0))
        bg_rows = max(top, bot, key=lambda r: r[1] - r[0])
        if bg_rows[1] - bg_rows[0] < 2:
            raise SystemExit(
                f"no sky-only rows left outside the detected spectrum "
                f"(rows {y_window} of {S}) — the scan fills the frame; "
                "pass explicit --bg-rows (with --rows/--cols)")

    sky_fit = None
    if sky_components is not None:
        from wayne_tpu_torch.reduction import fit_sky_model

        gap = 12
        mask = torch.ones((S, S), dtype=torch.float32, device=dev)
        mask[max(y_window[0] - gap, 0): min(y_window[1] + gap, S), :] = 0.0
        w, model = fit_sky_model(nets, sky_components["frames"], mask)
        nets = nets - model
        w = w.cpu().numpy()
        names = list(sky_components["names"])
        sky_fit = {
            "components": names,
            "mean_weights": [round(float(v), 4) for v in w.mean(axis=0)],
            "weights_per_exposure": {
                n: [round(float(v), 4) for v in w[:, k]]
                for k, n in enumerate(names)},
        }
        print("sky-component fit: " + ", ".join(
            f"{n}={w[:, k].mean():.3g}" for k, n in enumerate(names)))
    else:
        bg = _median(nets[:, bg_rows[0]: bg_rows[1], :], -2)   # per-col sky
        nets = nets - bg[:, None, :]
    if quad_map is not None:
        from wayne_tpu_torch.reduction import amp_offset_correct

        nets = amp_offset_correct(nets, quad_map.to(dev), tuple(y_window),
                                  tuple(x_window))
    if extract == "optimal":
        from wayne_tpu_torch.reduction import (
            optimal_extract, read_noise_var_e2, spatial_profile)

        prof = spatial_profile(nets.mean(dim=0), y_window)
        floor = read_noise_var_e2(read_noise_e, min(n_reads),
                                  ramp=estimator == "ramp")
        spectra = optimal_extract(nets, prof, y_window, floor)
    else:
        spectra = nets[:, y_window[0]: y_window[1], :].sum(dim=1)
    return (spectra, mids, (y_window, x_window, bg_rows),
            np.asarray(scan_angs), sky_fit)


# Nuisance parameters of the white fits, with the rounding unit of their
# report entries. Each fit trades them off along its valley (the hook's tau
# against its amplitude, the two trap fills against each other); the
# systematic template they form is what the channels see.
_NUISANCE_UNITS = {
    "slope_per_day": 1e-6, "hook_amp": 1e-6, "hook_amp_first_orbit": 1e-6,
    "hook_tau_s": 1e-2, "f0_slow": 1e-4, "f0_fast": 1e-4,
    "rate_e_s_supplied": 1e-3, "rate_scale_fitted": 1e-4,
    "t0_offset_s": 1e-2, "sma_over_rs": 1e-4, "inclination_deg": 1e-3,
    "phase_amplitude": 1e-4, "phase_amplitude_sigma": 1e-4,
    "hot_spot_offset_deg": 1e-2, "baseline_slope": 1e-6,
}


def compare_reports(a: dict, b: dict, path: str = "") -> list[str]:
    """Where two run_reduce reports of the same data disagree: every key,
    list length, string, flag and integer must be equal; of the numbers,
    a depth (``rp_over_rs``, ``fp_over_fs``) within max(1e-5, 0.01 sigma)
    of the other (sigma its entry's own), a sigma within 1e-3 relative,
    the light curves within 5e-6, the drifts within 2e-4 px, a sky weight
    within 1e-5 of the largest sky weight of the report (the fit's
    components are near-collinear: a weight's own error scales with the
    total sky, not with itself), and a nuisance parameter of the white fits
    within 1e-2 relative; each bar plus the report's rounding unit. Returns
    one line per disagreement (empty when the reports agree)."""
    out: list[str] = []
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [f"{path}: keys {sorted(a)} vs "
                    f"{sorted(b) if isinstance(b, dict) else b!r}"]
        if path.endswith("/sky_fit"):
            sky = max(abs(v) for w in a["weights_per_exposure"].values()
                      for v in w)
            for x, y, where in (
                    (a["mean_weights"], b["mean_weights"], "mean_weights"),
                    *((a["weights_per_exposure"][n],
                       b["weights_per_exposure"].get(n, []), n)
                      for n in a["weights_per_exposure"])):
                if len(x) != len(y) or any(
                        not abs(u - v) <= 1e-5 * sky + 1.01e-4
                        for u, v in zip(x, y)):
                    out.append(f"{path}/{where}: {x} vs {y}")
            a = {k: v for k, v in a.items() if k not in (
                "mean_weights", "weights_per_exposure")}
            b = {k: v for k, v in b.items() if k not in (
                "mean_weights", "weights_per_exposure")}
        for k in a:
            if isinstance(a[k], float) and isinstance(b[k], float):
                key = k
                if k in ("rp_over_rs", "fp_over_fs"):
                    sig = a.get(k.split("_")[0] + "_sigma", 0.0)
                    bar = max(1e-5, 0.01 * abs(sig)) + 1e-6
                elif k in _NUISANCE_UNITS:
                    bar = 1e-2 * abs(a[k]) + 1.01 * _NUISANCE_UNITS[k]
                elif "sigma" in k:
                    bar = 1e-3 * abs(a[k]) + 1e-6
                else:
                    key = None
                if key is not None:
                    if not abs(a[k] - b[k]) <= bar:
                        out.append(f"{path}/{k}: {a[k]!r} vs {b[k]!r} "
                                   f"(bar {bar:.3g})")
                    continue
            out += compare_reports(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list):
        if not isinstance(b, list) or len(a) != len(b):
            return [f"{path}: length {len(a)} vs {b!r:.40}"]
        for x, y in zip(a, b):
            out += compare_reports(x, y, path + "[]")
        return out
    if isinstance(a, float) and isinstance(b, float):
        if "_lc" in path:
            bar = 5e-6
        elif "x_shifts_px" in path:
            bar = 2e-4
        else:
            bar = 1e-6 * abs(a) + 1e-6
        if not abs(a - b) <= bar:      # NaN against a number fails
            out.append(f"{path}: {a!r} vs {b!r} (bar {bar:.3g})")
        return out
    if a != b or type(a) is not type(b):
        if not (a != a and b != b):    # NaN == NaN as a report value
            out.append(f"{path}: {a!r} vs {b!r}")
    return out


def _posteriors(args, white, chan, t, orbit, ld, ld_chan, rp0, rp_hat,
                depth_weights, t0_ref_shift_s):
    """``--mcmc``: the white curve's joint posterior and every channel's
    depth posterior (one ensemble batch), seeded as the JAX package seeds
    them. Returns (the report's ``white_posterior`` block, the channel
    posteriors)."""
    from wayne_tpu_torch.mcmc import (
        sample_channel_posteriors, sample_white_posterior)

    eclipse = args.mode == "eclipse"
    # keep at least half the chain after burn-in for short runs
    n_burn = max(0, min(max(args.mcmc // 4, 100), args.mcmc // 2,
                        args.mcmc - 1))
    wpost = sample_white_posterior(
        white, t, orbit, ld, rp0, 20250817, n_steps=args.mcmc,
        n_burn=n_burn, fit_geometry=args.fit_geometry, eclipse=eclipse,
        weights=depth_weights)
    chan_post = sample_channel_posteriors(
        chan, t, orbit, ld_chan, rp_hat if eclipse else rp0, 43,
        n_steps=args.mcmc, n_burn=n_burn, eclipse=eclipse, rp_geom=rp0,
        weights=depth_weights)
    dkey = "fp_over_fs" if eclipse else "rp_over_rs"
    report = {
        "n_steps": args.mcmc, "n_burn": n_burn,
        f"{dkey}_median": round(float(wpost.rp_median), 7),
        "depth_plus": round(float(wpost.rp_plus), 7),
        "depth_minus": round(float(wpost.rp_minus), 7),
        "acceptance": round(float(wpost.acceptance), 3),
        # convergence: the worst split R-hat and the smallest ESS over
        # every sampled dimension
        "rhat_max": round(float(wpost.rhat.max()), 4),
        "ess_min": round(float(wpost.ess.min()), 1),
    }
    if args.fit_geometry:
        samp = wpost.samples.cpu().numpy()
        q = lambda v: [round(float(x), 4) for x in
                       np.percentile(v, [16, 50, 84])]
        report["geometry_percentiles_16_50_84"] = {
            "t0_offset_s": q(samp[:, 6] + t0_ref_shift_s),
            "sma_over_rs": q(samp[:, 7]),
            "inclination_deg": q(np.rad2deg(np.arccos(
                np.clip(samp[:, 8], 0.0, 0.6)))),
        }
    print(f"white posterior: depth = {report[dkey + '_median']:.6f} "
          f"+{report['depth_plus']:.6f} -{report['depth_minus']:.6f} "
          f"(acc {report['acceptance']:.2f}; the channel posteriors "
          "sampled as one ensemble batch)")
    return report, chan_post


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.run_reduce",
        description="Reduce a simulated WFC3 visit from its ima files "
                    "(PyTorch port of wayne_tpu).")
    parser.add_argument("-d", "--visit-dir", required=True,
                        help="directory of *_ima.fits files")
    parser.add_argument("-p", "--parameter-file", required=True,
                        help="the visit's YAML (system model for the fit)")
    parser.add_argument("-o", "--output", default=None,
                        help="JSON report path (default <dir>/reduced.json)")
    parser.add_argument("--n-chan", type=int, default=8)
    parser.add_argument("--mode", choices=("transit", "eclipse", "phase"),
                        default="transit",
                        help="transit: per-channel Rp/Rs; eclipse: "
                             "per-channel Fp/Fs; phase: closed-form thermal "
                             "phase-curve fit per channel")
    parser.add_argument("--estimator", choices=("cds", "ramp"),
                        default="cds",
                        help="per-pixel charge estimator: CDS or the "
                             "up-the-ramp least-squares slope")
    parser.add_argument("--extract", choices=("box", "optimal"),
                        default="box",
                        help="column extraction: box sum or Horne (1986) "
                             "profile weighting")
    parser.add_argument("--align", action="store_true",
                        help="fit per-exposure dispersion drifts and "
                             "decorrelate the light curves against them")
    parser.add_argument("--no-divide-white", action="store_true",
                        help="skip the white common-mode correction")
    parser.add_argument("--detrend",
                        choices=("divide-white", "ramp", "recte", "none"),
                        default=None,
                        help="systematics removal before the channel fits "
                             "(default divide-white; ramp: joint Iraclis "
                             "white fit, reports the absolute white Rp/Rs; "
                             "recte: the physical two-trap ramp, transit "
                             "mode only). Overrides --no-divide-white.")
    parser.add_argument("--fit-geometry", action="store_true",
                        help="with --detrend ramp: free t0, a/Rs and the "
                             "inclination in the white fit and hold the "
                             "fitted ephemeris for the channels")
    parser.add_argument("--clip-sigma", type=float, default=None,
                        metavar="K",
                        help="robust white fit (--detrend ramp, transit or "
                             "eclipse): clip residual outliers at K robust "
                             "sigmas and refit; the channel fits skip them "
                             "too")
    parser.add_argument("--sky-fit", action="store_true",
                        help="fit per-exposure weights of the sky "
                             "component frames off the trace instead of the "
                             "per-column row median")
    parser.add_argument("--mcmc", type=int, nargs="?", const=1500,
                        default=0, metavar="N_STEPS",
                        help="also sample the white and per-channel "
                             "depth posteriors (Goodman-Weare ensemble "
                             "MCMC, N steps; bare flag: 1500)")
    parser.add_argument("--no-dq", action="store_true",
                        help="ignore the DQ planes (no read repair)")
    parser.add_argument("--no-nlincorr", action="store_true",
                        help="skip the NLINCORR non-linearity inversion")
    parser.add_argument("--no-amp-offset", action="store_true",
                        help="skip the per-exposure per-amplifier offset "
                             "removal")
    parser.add_argument("--rows", default=None, metavar="Y0:Y1",
                        help="extraction rows (with --cols and --bg-rows)")
    parser.add_argument("--wl-range", default=None, metavar="LO:HI",
                        help="clip the channel band to this wavelength "
                             "range in microns")
    parser.add_argument("--cols", default=None, metavar="X0:X1",
                        help="dispersion columns carrying signal")
    parser.add_argument("--bg-rows", default=None, metavar="B0:B1",
                        help="sky-only rows for background subtraction")
    parser.add_argument("--direct-image", action="store_true",
                        help="anchor the wavelength solution at the "
                             "centroid of the visit's *_direct.fits")
    parser.add_argument("--save-spectra", action="store_true",
                        help="also write spectra.fits (SPECTRA, WAVELENGTH, "
                             "TIME extensions)")
    parser.add_argument("--save-lc", action="store_true",
                        help="include the detrended channel light curves "
                             "in the JSON report")
    parser.add_argument("--plot", action="store_true",
                        help="also write a quicklook PNG (needs matplotlib)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write DIR/trace.json (torch.profiler) and "
                             "DIR/spans.json (the program's spans, the "
                             "host-sync count and per-span totals)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.trace is None:
        return _reduce(args)
    with profiling.tracing() as spans, profiling.device_trace(args.trace):
        rc = _reduce(args)
    spans.write(os.path.join(args.trace, "spans.json"))
    print(profiling.StageTimers(spans.spans).report())
    return rc


def _reduce(args: argparse.Namespace) -> int:
    from wayne_tpu_torch.calibration import (
        quadrant_map, sequence_tables_scope)
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.models.grism import make_calibrated_grism
    from wayne_tpu_torch.models.planet import Planet
    from wayne_tpu_torch.ops.dispersion import wl_to_x, x_to_wl
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import (
        _channel_edges, common_mode_correct, constrained_mask, fit_depths,
        out_of_transit_mask)

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = load_yaml(args.parameter_file)
    paths = collect_visit(args.visit_dir)
    hdr0, _, _ = read_ima(paths[0])
    # the simulator's calibration, including any loaded STScI products
    with sequence_tables_scope(cfg.calibration.sequence_file):
        grism = make_calibrated_grism(cfg, dev)
    tables = grism.tables
    gain = float(tables.gain)
    print(f"reducing {len(paths)} exposures from {args.visit_dir} "
          f"({hdr0.get('FILTER')}, SUBARRAY {cfg.subarray}) on {dev}")

    windows = None
    given = [args.rows, args.cols, args.bg_rows]
    if any(v is not None for v in given):
        if not all(v is not None for v in given):
            raise SystemExit("--rows, --cols and --bg-rows must be "
                             "given together (or none, for "
                             "auto-detection)")
        from wayne_tpu_torch.utils.cli import parse_range as _rng

        windows = (_rng(args.rows, "--rows"), _rng(args.cols, "--cols"),
                   _rng(args.bg_rows, "--bg-rows"))
    # NLINCORR reference data when the products' header switch (or, for
    # files without it, the YAML) says the detector compressed them
    nlin = None
    if not args.no_nlincorr:
        hdr_switch = str(hdr0.get(
            "NLINCORR",
            "PERFORM" if cfg.noise.non_linearity else "OMIT")).upper()
        if hdr_switch != "OMIT":
            nlin = {"coeffs": tables.nonlin_coeffs,
                    "fw": tables.readout_consts[1],
                    "bias_e": tables.bias_map if cfg.noise.bias else None,
                    "gain_map": (tables.gain_map
                                 if cfg.noise.gain_variations else None)}
    sky_components = None
    if args.sky_fit:
        # structure components fitted MEAN-REMOVED (frame - 1), so that
        # "constant" is the total mean background and each structure
        # weight that component's level x exptime
        names = ["constant", "master_sky"]
        frames = [torch.ones((cfg.subarray, cfg.subarray),
                             dtype=torch.float32, device=dev),
                  tables.sky_frame.to(torch.float32) - 1.0]
        if tables.sky_he_frame is not None:
            names.append("he_airglow")
            frames.append(tables.sky_he_frame.to(torch.float32) - 1.0)
        names.append("dark")
        frames.append(tables.dark_map.to(torch.float32))
        sky_components = {"names": names, "frames": torch.stack(frames)}
    qmap = (None if args.no_amp_offset else quadrant_map(
        cfg.subarray, tables.subarray_corner.tolist(), device=dev))
    with span("reduce.extract"):
        spectra, mids, (yw, xw, bg), scan_angs, sky_fit = extract_from_files(
            paths, gain, args.estimator, use_dq=not args.no_dq,
            extract=args.extract, read_noise_e=tables.readout_consts[0],
            windows=windows, nlin=nlin, sky_components=sky_components,
            quad_map=qmap, device=dev)
    label = "explicit" if windows is not None else "auto"
    print(f"{label} windows: rows {yw}, cols {xw}, background rows {bg}")

    # the system model on the visit clock (first exposure start = 0)
    planet = Planet(cfg.planet, visit_start_mjd=float(hdr0["EXPSTART"]))
    orbit = tree_map(lambda x: x.to(dev), planet.orbit_params())
    wl_centers = tables.wl_centers.cpu().numpy()
    ld_grid = np.asarray(planet.ld_on_grid(wl_centers), np.float32)
    # broadband coefficients: the band mean of a chromatic table (rebuilt
    # from the in-band rows once the channel edges are known)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ld = f32(ld_grid.mean(axis=0) if ld_grid.ndim == 2 else ld_grid)

    t = f32(mids)
    oot = out_of_transit_mask(t, orbit)
    if int(oot.sum()) < 2:
        raise SystemExit("not enough out-of-transit exposures to normalise")
    oot_np = oot.cpu().numpy()

    # upstream/downstream: each scan direction normalised by its own
    # out-of-transit baseline before any decorrelation or fit
    scan_dir_offsets = None
    uniq_angs = np.unique(scan_angs)
    if uniq_angs.size > 1:
        if any(((scan_angs == a) & oot_np).sum() < 2 for a in uniq_angs):
            print("warning: a scan direction has <2 out-of-transit "
                  "exposures — skipping per-direction normalisation "
                  "(the upstream/downstream offset, if any, remains)")
        else:
            white_all = spectra.sum(dim=1)
            ref_ang = uniq_angs[0]
            base = white_all[_on((scan_angs == ref_ang) & oot_np,
                                 dev)].mean()
            scan_dir_offsets = {}
            for a in uniq_angs[1:]:
                sel = _on(scan_angs == a, dev)
                fac = white_all[sel & oot].mean() / base
                spectra = torch.where(sel[:, None], spectra / fac, spectra)
                scan_dir_offsets[f"{a:g}"] = round(float(fac - 1.0), 6)
            offs = ", ".join(f"SCAN_ANG {a}: {o * 100:+.3f}%"
                             for a, o in scan_dir_offsets.items())
            print(f"scan-direction normalisation vs SCAN_ANG "
                  f"{ref_ang:g}: {offs} (upstream/downstream offset "
                  "removed)")

    def normalise(flux):
        return flux / flux[oot].mean(dim=0)

    shifts = None
    if args.align:
        from wayne_tpu_torch.reduction import spectral_shifts

        shifts = spectral_shifts(spectra, xw).cpu().numpy()
        print(f"dispersion drift: {shifts.min():+.4f}..{shifts.max():+.4f} "
              f"px, decorrelating the light curves")

    if args.n_chan < 1:
        raise SystemExit(f"--n-chan must be >= 1, got {args.n_chan}")
    n_cols = xw[1] - xw[0]
    if args.n_chan > n_cols:
        print(f"only {n_cols} illuminated columns: clamping --n-chan "
              f"{args.n_chan} -> {n_cols}")
        args.n_chan = n_cols
    edges = _channel_edges(xw, args.n_chan)
    xref_used, yref_used, wl_source = cfg.x_ref, cfg.y_ref, "yaml"
    if args.direct_image:
        dpaths = sorted(glob.glob(
            os.path.join(args.visit_dir, "*_direct.fits")))
        if not dpaths:
            raise SystemExit(
                f"--direct-image: no *_direct.fits in {args.visit_dir!r} "
                "(Observation.generate() writes one at visit start)")
        xref_used, yref_used = centroid_direct_image(dpaths[0])
        wl_source = "direct_image"
        print(f"direct-image centroid: x_ref={xref_used:.3f}, "
              f"y_ref={yref_used:.3f} (YAML: {cfg.x_ref:.3f}, "
              f"{cfg.y_ref:.3f}) — anchoring the wavelength solution")
    tp = grism.get_trace(xref_used, yref_used)

    if args.wl_range:
        try:
            lo_um, hi_um = sorted(float(v)
                                  for v in args.wl_range.split(":"))
        except ValueError:
            raise SystemExit("--wl-range must look like LO:HI in "
                             f"microns, got {args.wl_range!r}")
        if not 0.0 < lo_um < hi_um:
            raise SystemExit(f"--wl-range {args.wl_range!r} is not an "
                             "increasing positive range")
        xs = wl_to_x(f32([lo_um, hi_um]), tp).cpu().numpy()
        clip = (int(np.floor(xs.min())), int(np.ceil(xs.max())) + 1)
        new_xw = (max(xw[0], clip[0]), min(xw[1], clip[1]))
        if new_xw[1] - new_xw[0] < max(args.n_chan, 2):
            raise SystemExit(
                f"--wl-range {args.wl_range} um maps to columns {clip} "
                f"— fewer than {max(args.n_chan, 2)} columns overlap "
                f"the illuminated window {xw}")
        if new_xw != xw:
            print(f"wavelength clip {lo_um:.3f}-{hi_um:.3f} um: columns "
                  f"{xw} -> {new_xw}")
            xw = new_xw
            edges = _channel_edges(xw, args.n_chan)
    wl_edges = x_to_wl(f32(edges), tp).cpu().numpy()

    # white-light limb darkening from the in-band rows of a chromatic
    # table; per-channel rows from each channel's wavelength range
    ld_chan = ld
    if ld_grid.ndim == 2:
        lo_w = float(min(wl_edges[0], wl_edges[-1]))
        hi_w = float(max(wl_edges[0], wl_edges[-1]))
        in_band = (wl_centers >= lo_w) & (wl_centers < hi_w)
        if in_band.any():
            ld = f32(ld_grid[in_band].mean(axis=0))
        rows = []
        for lo_um, hi_um in zip(wl_edges[:-1], wl_edges[1:]):
            lo_um, hi_um = min(lo_um, hi_um), max(lo_um, hi_um)
            sel = (wl_centers >= lo_um) & (wl_centers < hi_um)
            rows.append(ld_grid[sel].mean(axis=0) if sel.any()
                        else ld_grid[np.argmin(np.abs(
                            wl_centers - 0.5 * (lo_um + hi_um)))])
        ld_chan = f32(np.stack(rows))
        print("chromatic limb darkening: per-channel coefficients "
              "from the configured ld table")

    white_flux = spectra[:, xw[0]: xw[1]].sum(dim=1)
    chan_flux = torch.stack([spectra[:, lo:hi].sum(dim=1)
                             for lo, hi in zip(edges[:-1], edges[1:])], dim=1)
    rp0 = f32(cfg.planet.rp_over_rs or 0.1)
    if shifts is not None:
        # linear decorrelation against the transit-cleaned dispersion
        # centroid, fitted out of transit
        from wayne_tpu_torch.reduction import (
            clean_drift_regressor, dispersion_centroid, drift_regressor,
            shift_detrend, transit_drift_basis)

        if args.mode == "transit":
            basis = transit_drift_basis(t, orbit, ld, rp0)
            reg = clean_drift_regressor(dispersion_centroid(spectra, xw),
                                        basis, t)
        else:     # eclipse dips are achromatic to the fp level
            reg = drift_regressor(spectra, xw, white_flux, oot)
        white_flux = shift_detrend(white_flux, reg, oot)
        chan_flux = shift_detrend(chan_flux, reg, oot)
    white = normalise(white_flux)
    chan = normalise(chan_flux)

    detrend = args.detrend or ("none" if args.no_divide_white
                               else "divide-white")
    depth_weights = None       # robust-clip keep mask (--clip-sigma)
    if args.clip_sigma is not None and (detrend != "ramp"
                                        or args.mode == "phase"):
        raise SystemExit("--clip-sigma requires --detrend ramp in "
                         "--mode transit or eclipse (the robust clip "
                         "lives in the white ramp fit and its mask "
                         "feeds the channel depth fits)")
    if args.clip_sigma is not None and args.clip_sigma <= 1.0:
        raise SystemExit(f"--clip-sigma {args.clip_sigma} would clip "
                         "most of the data; use K > 1 (typically 3-5)")
    if args.fit_geometry and (detrend != "ramp"
                              or args.mode != "transit"):
        raise SystemExit("--fit-geometry requires --mode transit with "
                         "--detrend ramp (the ephemeris is fitted "
                         "jointly with the white transit+ramp model; "
                         "eclipse/phase visits cannot constrain it)")

    def clipped_list(wfit):
        return np.flatnonzero(wfit.weights.cpu().numpy() == 0.0).tolist()

    def note_clips(wfit):
        clipped = clipped_list(wfit)
        if clipped:
            print(f"robust white fit clipped {len(clipped)} "
                  f"exposure(s) at {args.clip_sigma} sigma: {clipped}")

    white_fit_report = None
    t0_ref_shift_s = 0.0   # fitted-ephemeris offset vs the YAML zero point
    phase_extra = None
    rp_sig_rel = None          # divide-white shape-error component
    sigma_white_dw = None      # divide-white common-mode (white-fit) sigma
    with span("reduce.fit"):
        if args.mode in ("eclipse", "phase"):
            from wayne_tpu_torch.ops.kepler import projected_separation
            from wayne_tpu_torch.ops.transit import eclipse_visibility

            z_t, infr_t = projected_separation(t, orbit)
            vis = eclipse_visibility(z_t, infr_t, rp0)
            no_cover = float(vis.max() - vis.min()) < 0.1
        if args.mode == "eclipse":
            from wayne_tpu_torch.reduction import fit_eclipse_depths

            # without occultation coverage the design matrix is singular
            if no_cover:
                raise SystemExit(
                    "no secondary-eclipse coverage in this visit (planet "
                    "visibility barely changes) — check start_mjd/t0/period "
                    "or use --mode transit")
            if detrend == "recte":
                raise SystemExit("--detrend recte is wired for --mode "
                                 "transit only; use ramp (it has an "
                                 "eclipse=True white model) or divide-white")
            if detrend == "ramp":
                from wayne_tpu_torch.reduction import fit_white_ramp

                wfit = fit_white_ramp(white, t, orbit, ld, rp0, eclipse=True,
                                      clip_sigma=args.clip_sigma)
                if args.clip_sigma is not None:
                    depth_weights = wfit.weights
                    note_clips(wfit)
                # fit_eclipse_depths absorbs any per-channel baseline
                chan = chan / wfit.template[:, None]
                white_fit_report = {
                    "fp_over_fs": round(float(wfit.rp), 7),
                    "fp_sigma": round(float(wfit.rp_sigma), 7),
                    "slope_per_day": round(float(wfit.slope_per_day), 6),
                    "hook_amp": round(float(wfit.hook_amp), 6),
                    "hook_amp_first_orbit": round(
                        float(wfit.hook_amp_first), 6),
                    "hook_tau_s": round(float(wfit.hook_tau_s), 2),
                    **({"clip_sigma": args.clip_sigma,
                        "clipped_exposures": clipped_list(wfit)}
                       if args.clip_sigma is not None else {}),
                }
                print(f"white eclipse ramp fit: fp = "
                      f"{white_fit_report['fp_over_fs']:.6f} +- "
                      f"{white_fit_report['fp_sigma']:.6f}")
            elif detrend == "divide-white":
                # eclipse-aware common mode against the fitted white ECLIPSE
                # model; its Fp/Fs error shifts every channel coherently
                fp_w, fp_w_sig = fit_eclipse_depths(white[:, None], t, orbit,
                                                    rp0)
                sigma_white_dw = fp_w_sig[0]
                chan = chan / (white / (1.0 + fp_w[0] * vis))[:, None]
            rp_hat, rp_sig = fit_eclipse_depths(chan, t, orbit, rp0,
                                                weights=depth_weights)
            if sigma_white_dw is not None:
                rp_sig_rel = rp_sig
                rp_sig = torch.sqrt(rp_sig ** 2 + sigma_white_dw ** 2)
            value_key, sigma_key = "fp_over_fs", "fp_sigma"
        elif args.mode == "phase":
            from wayne_tpu_torch.ops.kepler import orbital_phase_angle
            from wayne_tpu_torch.reduction import fit_phase_curve

            if detrend in ("ramp", "recte"):
                raise SystemExit(f"--detrend {detrend} is not wired for "
                                 "--mode phase; use divide-white or none")
            if no_cover:
                raise SystemExit(
                    "no secondary-eclipse coverage in this visit (planet "
                    "visibility barely changes), so Fp/Fs cannot be "
                    "separated from the baseline — cover the eclipse (an "
                    "explicit exp_start_times schedule helps) or use "
                    "--mode transit")
            phi = orbital_phase_angle(t, orbit)
            wfit = fit_phase_curve(white, t, orbit, rp0)
            white_fit_report = {
                "fp_over_fs": round(float(wfit.fp), 7),
                "fp_sigma": round(float(wfit.fp_sigma), 7),
                "phase_amplitude": round(float(wfit.amp), 4),
                "phase_amplitude_sigma": round(float(wfit.amp_sigma), 4),
                "hot_spot_offset_deg": round(
                    float(np.rad2deg(float(wfit.offset_rad))), 2),
                "baseline_slope": round(float(wfit.slope), 6),
            }
            print(f"white phase fit: fp = {white_fit_report['fp_over_fs']:.6f}"
                  f" +- {white_fit_report['fp_sigma']:.6f}, A = "
                  f"{white_fit_report['phase_amplitude']:.3f}, offset "
                  f"{white_fit_report['hot_spot_offset_deg']:.1f} deg")
            if detrend == "divide-white":
                # phase-aware common mode: white over the white MODEL, so the
                # template carries only the instrument systematics
                mod_w = 1.0 - wfit.amp * 0.5 * (
                    1.0 - torch.cos(phi + wfit.offset_rad))
                model_w = 1.0 + wfit.fp * mod_w * vis
                chan = chan / (white / model_w)[:, None]
            pf = fit_phase_curve(chan, t, orbit, rp0)
            rp_hat, rp_sig = pf.fp, pf.fp_sigma
            offs_deg = np.rad2deg(pf.offset_rad.cpu().numpy())
            phase_extra = [
                {"phase_amplitude": round(float(pf.amp[i]), 4),
                 "phase_amplitude_sigma": round(float(pf.amp_sigma[i]), 4),
                 "hot_spot_offset_deg": round(float(offs_deg[i]), 2)}
                for i in range(int(pf.fp.shape[0]))]
            value_key, sigma_key = "fp_over_fs", "fp_sigma"
        else:
            if detrend == "divide-white":
                # keep the white fit's depth sigma: the template's error
                # shifts every channel depth coherently
                chan, sigma_white_dw = common_mode_correct(
                    white, chan, t, orbit, ld, rp0, return_white_sigma=True)
            elif detrend == "ramp":
                from wayne_tpu_torch.reduction import (
                    fit_white_ramp, ramp_detrend)

                wfit = fit_white_ramp(white, t, orbit, ld, rp0,
                                      fit_geometry=args.fit_geometry,
                                      clip_sigma=args.clip_sigma)
                if args.clip_sigma is not None:
                    depth_weights = wfit.weights
                    note_clips(wfit)
                if args.fit_geometry:
                    dt0 = abs(float(wfit.t0_offset_s))
                    if dt0 > 600.0:
                        print(f"warning: fitted t0 is {dt0:.0f} s from the "
                              "parameter file's — the alignment/"
                              "normalisation above used the stale ephemeris; "
                              "re-run with the fitted t0 in the YAML for "
                              "clean channels")
                    orbit = wfit.orbit        # held for the channel fits
                    # the posteriors sample around this fitted ephemeris;
                    # their t0 offsets are shifted back to the YAML's zero
                    # point
                    t0_ref_shift_s = float(wfit.t0_offset_s)
                chan = ramp_detrend(chan, wfit, t, orbit)
                white_fit_report = {
                    "rp_over_rs": round(float(wfit.rp), 6),
                    "rp_sigma": round(float(wfit.rp_sigma), 6),
                    "slope_per_day": round(float(wfit.slope_per_day), 6),
                    "hook_amp": round(float(wfit.hook_amp), 6),
                    "hook_amp_first_orbit": round(
                        float(wfit.hook_amp_first), 6),
                    "hook_tau_s": round(float(wfit.hook_tau_s), 2),
                    **({"fitted_geometry": {
                        "t0_offset_s": round(float(wfit.t0_offset_s), 2),
                        "sma_over_rs": round(float(wfit.orbit.sma_rs), 4),
                        "inclination_deg": round(float(
                            np.rad2deg(float(wfit.orbit.inc_rad))), 3)}}
                       if args.fit_geometry else {}),
                    **({"clip_sigma": args.clip_sigma,
                        "clipped_exposures": clipped_list(wfit)}
                       if args.clip_sigma is not None else {}),
                }
                ratio = float(wfit.hook_amp_first) / max(float(wfit.hook_amp),
                                                         1e-9)
                print(f"white ramp fit: rp="
                      f"{white_fit_report['rp_over_rs']:.5f}"
                      f" +- {white_fit_report['rp_sigma']:.5f}, slope "
                      f"{white_fit_report['slope_per_day']:+.5f}/day, hook "
                      f"{white_fit_report['hook_amp']:.5f} (x{ratio:.2f} "
                      f"orbit 1), tau {white_fit_report['hook_tau_s']:.0f} s")
            elif detrend == "recte":
                from wayne_tpu_torch.reduction import (
                    fit_white_recte, ramp_detrend)

                # the white aperture's effective illuminated-pixel rate; the
                # fitted rate scale calibrates the bright/faint mix
                exptime = float(hdr0.get("EXPTIME", mids[0] * 2.0))
                n_ap = max((yw[1] - yw[0]) * (xw[1] - xw[0]), 1)
                rate0 = float(white_flux[oot].mean()) / n_ap / exptime
                wfit = fit_white_recte(white, t, orbit, ld, rp0,
                                       rate_e_s=rate0, exptime_s=exptime)
                chan = ramp_detrend(chan, wfit, t, orbit)
                white_fit_report = {
                    "rp_over_rs": round(float(wfit.rp), 6),
                    "rp_sigma": round(float(wfit.rp_sigma), 6),
                    "slope_per_day": round(float(wfit.slope_per_day), 6),
                    "f0_slow": round(float(wfit.f0_s), 4),
                    "f0_fast": round(float(wfit.f0_f), 4),
                    "rate_e_s_supplied": round(rate0, 3),
                    "rate_scale_fitted": round(float(wfit.rate_scale), 4),
                }
                print(f"white RECTE fit: rp="
                      f"{white_fit_report['rp_over_rs']:.5f} +- "
                      f"{white_fit_report['rp_sigma']:.5f}, trap fill "
                      f"f0_s={white_fit_report['f0_slow']:.3f} "
                      f"f0_f={white_fit_report['f0_fast']:.3f}, rate "
                      f"{rate0:.1f} e-/s x "
                      f"{white_fit_report['rate_scale_fitted']:.2f}")
            rp_hat, rp_sig = fit_depths(chan, t, orbit, ld_chan, rp0,
                                        weights=depth_weights)
            if sigma_white_dw is not None:
                # sigma_rel is the channel-to-channel shape error; the
                # quadrature total the absolute one
                rp_sig_rel = rp_sig
                rp_sig = torch.sqrt(rp_sig ** 2 + sigma_white_dw ** 2)
            value_key, sigma_key = "rp_over_rs", "rp_sigma"

        white_post_report, chan_post = None, None
        if args.mcmc and args.mode == "phase":
            raise SystemExit("--mcmc is not wired for --mode phase (the "
                             "closed-form fit already returns sigmas)")
        if args.mcmc:
            white_post_report, chan_post = _posteriors(
                args, white, chan, t, orbit, ld, ld_chan, rp0, rp_hat,
                depth_weights, t0_ref_shift_s)
    mcmc_prefix = "fp" if args.mode == "eclipse" else "rp"

    # a dead channel is MARKED unusable, not left to an absurd sigma
    if args.mode == "transit":
        constrained = constrained_mask(rp_hat, rp_sig)
    else:   # Fp/Fs contrasts: smaller scale, linear (unclipped) fits
        constrained = constrained_mask(rp_hat, rp_sig, sigma_floor=0.02,
                                       bounds=None)
    constrained = constrained.cpu().numpy()
    if not constrained.all():
        bad = np.flatnonzero(~constrained).tolist()
        print(f"warning: channel(s) {bad} are unconstrained (no "
              "in-window flux or sigma above the floor) — flagged "
              "constrained: false; consider --wl-range to clip the "
              "band edges")
    host = lambda x: x.detach().cpu().numpy()
    rp_hat, rp_sig, white_np = host(rp_hat), host(rp_sig), host(white)
    rp_sig_rel = host(rp_sig_rel) if rp_sig_rel is not None else None
    chan_np = host(chan) if args.save_lc else None
    report = {
        "n_exposures": len(paths),
        "grism": cfg.grism,
        "mode": args.mode,
        "estimator": args.estimator,
        "extraction": args.extract,
        "windows": {"rows": list(yw), "cols": list(xw),
                    "background_rows": list(bg)},
        "detrend": detrend,
        "divide_white": detrend == "divide-white",
        "wavelength_zero_point": {
            "source": wl_source, "x_ref": round(float(xref_used), 3),
            "y_ref": round(float(yref_used), 3)},
        **({("white_phase_fit" if args.mode == "phase"
             else "white_recte_fit" if detrend == "recte"
             else "white_ramp_fit"): white_fit_report}
           if white_fit_report is not None else {}),
        "dq_repair": not args.no_dq,
        "nlincorr": nlin is not None,
        **({"scan_direction_offsets": scan_dir_offsets}
           if scan_dir_offsets is not None else {}),
        **({"sky_fit": sky_fit} if sky_fit is not None else {}),
        "aligned": bool(args.align),
        **({"x_shifts_px": [round(float(s), 4) for s in shifts]}
           if shifts is not None else {}),
        **({"white_posterior": white_post_report}
           if white_post_report is not None else {}),
        **({f"{sigma_key}_common": round(float(sigma_white_dw), 6)}
           if sigma_white_dw is not None else {}),
        "channels": [
            {"wl_lo_um": round(float(wl_edges[i]), 4),
             "wl_hi_um": round(float(wl_edges[i + 1]), 4),
             value_key: round(float(rp_hat[i]), 6),
             sigma_key: round(float(rp_sig[i]), 6),
             **({f"{sigma_key}_rel": round(float(rp_sig_rel[i]), 6)}
                if rp_sig_rel is not None else {}),
             "constrained": bool(constrained[i]),
             **(phase_extra[i] if phase_extra is not None else {}),
             **({f"{mcmc_prefix}_mcmc_median":
                     round(float(chan_post.rp_median[i]), 7),
                 f"{mcmc_prefix}_mcmc_plus":
                     round(float(chan_post.rp_plus[i]), 7),
                 f"{mcmc_prefix}_mcmc_minus":
                     round(float(chan_post.rp_minus[i]), 7),
                 f"{mcmc_prefix}_mcmc_rhat":
                     round(float(chan_post.rhat[i]), 4),
                 f"{mcmc_prefix}_mcmc_ess":
                     round(float(chan_post.ess[i]), 1)}
                if chan_post is not None else {})}
            for i in range(args.n_chan)],
        "white_lc": [round(float(v), 6) for v in white_np],
        **({"channel_lc": [[round(float(chan_np[i, j]), 6)
                            for j in range(args.n_chan)]
                           for i in range(len(mids))]}
           if args.save_lc else {}),
        "mid_times_s": [round(float(v), 2) for v in mids],
    }
    out = args.output or os.path.join(args.visit_dir, "reduced.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    if args.save_spectra:
        from wayne_tpu_torch.io.fits import FitsHDU, write_fits

        wl_cols = x_to_wl(torch.arange(spectra.shape[1], dtype=torch.float32,
                                       device=dev), tp).cpu().numpy()
        spath = os.path.join(args.visit_dir, "spectra.fits")
        write_fits(spath, [
            FitsHDU(header={"PRODUCT": "wayne_tpu extracted spectra",
                            "WLSRC": wl_source}),
            FitsHDU(name="SPECTRA",
                    data=host(spectra).astype(np.float32),
                    header={"BUNIT": "ELECTRONS"}),
            FitsHDU(name="WAVELENGTH", data=wl_cols.astype(np.float32),
                    header={"BUNIT": "MICRONS"}),
            FitsHDU(name="TIME", data=np.asarray(mids, np.float64),
                    header={"BUNIT": "SECONDS"}),
        ])
        print(f"extracted spectra -> {spath}")
    rp = [c[value_key] for c in report["channels"]]
    label = "Rp/Rs" if args.mode == "transit" else "Fp/Fs"
    print(f"channel {label}: {min(rp):.6g}..{max(rp):.6g} -> {out}")
    if args.plot:
        from wayne_tpu_torch.diagnostics import quicklook_reduction

        png = quicklook_reduction(report, out.rsplit(".", 1)[0] + ".png")
        print(f"quicklook -> {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
