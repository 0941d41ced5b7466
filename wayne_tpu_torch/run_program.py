"""Multi-visit program runner (counterpart of ``python -m
wayne_tpu.run_program``; see :mod:`wayne_tpu_torch.program`).

Usage:
    python -m wayne_tpu_torch.run_program -p pars.yml -o prog_out/ [--cpu]

The YAML is an ordinary visit parameter file plus a ``program:`` block
(``num_visits``, ``visit_spacing_days``, ``carry_persistence``,
``t0_drift_s_per_visit``). Each visit lands in ``visit_00/ visit_01/ ...``
as ima products; the carried fluence maps and ``program_summary.json``
record the cross-visit state.

Runs on the CUDA card; without one it fails unless ``--cpu`` is given.
``--debug`` runs each visit's ``generate(debug=True)``: the NaN and range
guards and a ``visit_summary.json`` per visit directory.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.run_program",
        description="Simulate a multi-visit HST WFC3 observing program "
                    "(PyTorch port of wayne_tpu).")
    parser.add_argument("-p", "--parameter-file", required=True)
    parser.add_argument("-o", "--outdir", help="program output directory "
                                               "(default: YAML outdir)")
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--debug", action="store_true",
                        help="NaN/range guards and a visit_summary.json "
                             "per visit")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.program import Program

    cfg = load_yaml(args.parameter_file)
    outdir = args.outdir or cfg.outdir
    prog = Program(cfg, device="cpu" if args.cpu else None)
    print(f"{cfg.program.num_visits}-visit program on {prog.device} "
          f"(MJD {prog.starts[0]:.3f} .. {prog.starts[-1]:.3f}; "
          f"persistence carry: {'on' if prog.carry else 'off'}; "
          f"t0 drift {cfg.program.t0_drift_s_per_visit:+.1f} s/visit)")
    all_paths = prog.generate(outdir, chunk=args.chunk, progress=print,
                              resume=not args.no_resume, debug=args.debug)
    total = sum(len(p) for p in all_paths)
    print(f"wrote {total} exposures over {len(all_paths)} visits "
          f"to {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
