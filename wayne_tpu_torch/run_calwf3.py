"""calwf3-equivalent CLI: calibrate a visit's raw ima files to FLT
(counterpart of ``python -m wayne_tpu.run_calwf3``).

Usage:
    python -m wayne_tpu_torch.run_calwf3 -d visit_dir -p pars.yml [--cpu] \\
        [-o out]

For every ``*_ima.fits`` in the visit directory an ``*_flt.fits`` sibling
is written: one SCI plane in e-/s with ERR, collapsed DQ and per-pixel
SAMP/TIME, after BLEVCORR / NLINCORR / DARKCORR / CRCORR in calwf3's order
(see :mod:`wayne_tpu_torch.calwf3`). The parameter file supplies the same
calibration tables the simulation used. Runs on the CUDA card; without one
it fails unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.run_calwf3",
        description="calibrate simulated raw ima products to flt "
                    "(PyTorch port of wayne_tpu)")
    parser.add_argument("-d", "--visit-dir", required=True)
    parser.add_argument("-p", "--parameter-file", required=True)
    parser.add_argument("-o", "--outdir", default=None,
                        help="output directory (default: next to the "
                             "input files)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    args = parser.parse_args(argv)

    from wayne_tpu_torch.calibration import sequence_tables_scope
    from wayne_tpu_torch.calwf3 import calibrate_ima, write_flt
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.models.grism import make_calibrated_grism

    device = resolve_device("cpu" if args.cpu else None)
    cfg = load_yaml(args.parameter_file)
    with sequence_tables_scope(cfg.calibration.sequence_file):
        grism = make_calibrated_grism(cfg, device)
    paths = sorted(glob.glob(os.path.join(args.visit_dir, "*_ima.fits")))
    direct = sorted(glob.glob(os.path.join(args.visit_dir,
                                           "*_direct.fits")))
    if not paths:
        raise SystemExit(f"no *_ima.fits files in {args.visit_dir!r}")
    outdir = args.outdir or args.visit_dir
    os.makedirs(outdir, exist_ok=True)
    n = 0
    for p in paths:
        out = os.path.join(
            outdir, os.path.basename(p).replace("_ima.fits", "_flt.fits"))
        flt = calibrate_ima(p, grism.tables, cfg.noise)
        write_flt(out, flt)
        n += 1
        print(f"flt {n}/{len(paths)}: {os.path.basename(out)}",
              file=sys.stderr, flush=True)
    if direct:
        print(f"note: {len(direct)} direct image(s) skipped — imaging-"
              "filter exposures calibrate against imaging tables "
              "(Observation.simulate_direct_image keeps them raw)",
              file=sys.stderr)
    print(f"calwf3: {n} flt products -> {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
