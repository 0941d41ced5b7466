"""Command-line entry point of the PyTorch/CUDA port (counterpart of
``python -m wayne_tpu.run_visit``).

Usage:
    python -m wayne_tpu_torch.run_visit -p pars.yml [-o outdir] [--chunk N]
    python -m wayne_tpu_torch.run_visit -p pars.yml --cpu   # plain CPU path
    python -m wayne_tpu_torch.run_visit --example > example_pars.yml

Runs on the CUDA card; without one it fails unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys

EXAMPLE_YAML = """\
# wayne_tpu_torch parameter file (reference-compatible keys accepted)
observation:
  grism: G141
  subarray: 512
  NSAMP: 15
  SAMPSEQ: SPARS10
  scan: true
  scan_speed: 1.0          # pixels / s
  x_ref: 180.0
  y_ref: 100.0
  num_orbits: 4
  start_mjd: 55999.86
  seed: 0
  sky_level: 1.2           # e-/s/px
  outdir: wayne_out
target:
  name: WASP-43
  star_temperature: 4520.0
  mag_J: 9.995
planet:
  planet_name: WASP-43 b
  period: 0.813475         # days
  t0: 56000.0              # MJD of mid-transit
  sma_over_rs: 4.855
  inclination: 82.1
  rp_over_rs: 0.1595
  ld_coeffs: [0.65, -0.25, 0.45, -0.2]
  # eclipse_depth: 5.0e-4  # dayside Fp/Fs -> secondary-eclipse visits
  # phase_amplitude: 0.9   # day-night thermal phase-curve contrast
noise:
  read_noise: true
  dark: true
  sky: true
  flat: true
  non_linearity: true
  cosmic_rays: true
  ssv: true
  visit_trend: true
  pointing_drift: true
# calibration:                 # optional real STScI products (else synthetic)
#   axe_conf: WFC3.IR.G141.V2.5.conf
#   sensitivity_file: G141.sens.txt
#   flat_file: G141.flat.fits
#   sky_file: G141.sky.fits
#   nonlin_file: nlin.fits
#   sequence_file: sequences.json
"""


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch",
        description="Simulate an HST WFC3 IR grism transit visit on a "
                    "CUDA GPU (PyTorch port of wayne_tpu).")
    parser.add_argument("-p", "--parameter-file", help="YAML parameter file")
    parser.add_argument("-o", "--outdir", help="override output directory")
    parser.add_argument("--chunk", type=int, default=8,
                        help="exposures computed per readout launch")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    parser.add_argument("--no-resume", action="store_true",
                        help="rewrite exposures even if files exist")
    parser.add_argument("--example", action="store_true",
                        help="print an example parameter file and exit")
    args = parser.parse_args(argv)

    if args.example:
        print(EXAMPLE_YAML, end="")
        return 0
    if not args.parameter_file:
        parser.error("-p parameter_file.yml is required (or --example)")

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation

    cfg = load_yaml(args.parameter_file)
    if args.outdir:
        cfg.outdir = args.outdir
    obs = Observation(cfg, device="cpu" if args.cpu else None)
    print(f"{cfg.grism} {'scan' if cfg.scan else 'staring'} visit on "
          f"{obs.device}: {obs.plan.n_exposures} exposures x "
          f"NSAMP={cfg.nsamp} ({obs.detector_exptime:.1f}s each) over "
          f"{cfg.n_orbits} orbits")
    paths = obs.generate(cfg.outdir, chunk=args.chunk, progress=print,
                         resume=not args.no_resume)
    print(f"wrote {len(paths)} exposures to {cfg.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
