"""Command-line entry point for Monte-Carlo dataset generation (counterpart
of ``python -m wayne_tpu.run_dataset``).

Usage:
    python -m wayne_tpu_torch.run_dataset -p pars.yml -o dataset_dir \\
        --n-mc 1000 [--chunk-mc 16] [--rp-sigma 0.002] [--seed 0] [--cpu]

Each realisation reuses the planned visit (pointing drift, transit timing)
with independent noise; ``--rp-sigma`` also sweeps the continuum Rp/Rs per
realisation (Gaussian around the configured value) and stores it as a
label; ``--fp-sigma`` sweeps the eclipse depth Fp/Fs the same way (label
``fp``, the band mean). Persistence and RECTE, when the YAML enables them,
are computed once from the visit's noise-free stimulus and shared by every
realisation. ``--recover N_CHAN`` also reduces every chunk on the device
and stores recovered depth labels (transit visits only). Output:
``chunk_XXXX.npz`` files of extracted spectra and labels and a
``manifest.json``; a re-run resumes at the first missing chunk.

Runs on the CUDA card; without one it fails unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.run_dataset",
        description="Generate a labelled Monte-Carlo spectral dataset "
                    "(PyTorch port of wayne_tpu).")
    parser.add_argument("-p", "--parameter-file", required=True)
    parser.add_argument("-o", "--outdir", required=True)
    parser.add_argument("--n-mc", type=int, required=True,
                        help="number of Monte-Carlo visit realisations")
    parser.add_argument("--chunk-mc", type=int, default=16,
                        help="realisations per device chunk / output file")
    parser.add_argument("--rp-sigma", type=float, default=0.0,
                        help="per-realisation Gaussian sweep of Rp/Rs")
    parser.add_argument("--fp-sigma", type=float, default=0.0,
                        help="per-realisation Gaussian sweep of the eclipse "
                             "depth Fp/Fs (requires planet eclipse_depth)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--raw-cr", action="store_true",
                        help="keep simulated cosmic rays IN the spectra "
                             "(training-realism datasets) instead of the "
                             "default DQ-aware repair at extraction")
    parser.add_argument("--recover", type=int, nargs="?", const=8,
                        default=None, metavar="N_CHAN",
                        help="also reduce every chunk on the device and "
                             "store recovered_rp/_sigma labels (N_CHAN "
                             "channels, default 8) — exposes the "
                             "reduction-systematic structure that injected "
                             "labels alone hide (transit datasets only)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch path on the CPU")
    args = parser.parse_args(argv)

    if args.n_mc % args.chunk_mc:
        parser.error("--n-mc must be a multiple of --chunk-mc")
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import numpy as np

    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.parallel.dataset import generate_dataset

    cfg = load_yaml(args.parameter_file)
    obs = Observation(cfg, device="cpu" if args.cpu else None)
    print(f"{cfg.grism} dataset on {obs.device}: {args.n_mc} realisations x "
          f"{obs.plan.n_exposures} exposures ({cfg.subarray}^2, "
          f"NSAMP={cfg.nsamp})")

    overrides: dict = {}
    labels = {}
    if args.rp_sigma > 0.0:
        rng = np.random.RandomState(args.seed)
        rp = (cfg.planet.rp_over_rs
              + args.rp_sigma * rng.standard_normal(args.n_mc)
              ).astype(np.float32)
        overrides["rp_over_rs"] = np.broadcast_to(
            rp[:, None], (args.n_mc, cfg.n_lambda)).copy()
        labels["rp"] = rp
    if args.fp_sigma > 0.0:
        if not obs.static.eclipse:
            parser.error("--fp-sigma requires planet eclipse_depth or "
                         "eclipse_file in the parameter file")
        rng = np.random.RandomState(args.seed + 1)
        # an additive shift of the configured contrast spectrum, clipped
        # so every channel stays physical
        fp_grid = obs.planet.fp_on_grid(
            obs.tables.wl_centers.cpu().numpy())                 # (NL,)
        delta = (args.fp_sigma
                 * rng.standard_normal(args.n_mc)).astype(np.float32)
        fp_mc = np.clip(fp_grid[None, :] + delta[:, None], 0.0, None
                        ).astype(np.float32)                     # (n_mc, NL)
        overrides["fp_over_fs"] = fp_mc
        labels["fp"] = fp_mc.mean(axis=1)

    recover = None
    if args.recover is not None:
        if args.recover < 1:
            parser.error("--recover needs at least 1 channel")
        if obs.static.eclipse:
            parser.error("--recover fits transit depths; eclipse/"
                         "phase-curve datasets are not supported")
        import torch

        from wayne_tpu_torch.ops.dispersion import trace_params, wl_to_x
        from wayne_tpu_torch.pytree import tree_map

        # the dispersed trace's columns: the recovered channels span them
        tp = trace_params(obs.tables, obs.scenes.x_ref[0],
                          obs.scenes.y_ref[0])
        xc = wl_to_x(obs.tables.wl_centers, tp).cpu().numpy()
        x_lo = int(max(np.floor(xc.min()), 0))
        x_hi = int(min(np.ceil(xc.max()) + 1, cfg.subarray))
        if x_hi - x_lo < args.recover:
            parser.error("--recover: dispersed trace covers "
                         f"{x_hi - x_lo} columns < {args.recover} "
                         "channels")
        ld = obs.scenes.ld[0].to(torch.float32)
        if ld.dim() == 2:
            ld = ld.mean(dim=0)
        exptime = float(obs.tables.read_times[-1])
        recover = {
            "exp_mid_s": (obs.scenes.exp_start_s.cpu().numpy()
                          + exptime / 2.0).astype(np.float32),
            "orbit": tree_map(lambda x: x[0], obs.scenes.orbit),
            "ld": ld, "rp0": float(cfg.planet.rp_over_rs or 0.15),
            "x_window": (x_lo, x_hi), "n_chan": args.recover,
        }
        # forward/reverse alternation: per-direction baselines remove the
        # upstream/downstream offset from the recovered labels
        rev = obs.scenes.scan_speed.cpu().numpy() < 0
        if rev.any():
            recover["scan_dir"] = rev.astype(np.float32)
        print(f"recovered labels: {args.recover} channels over columns "
              f"[{x_lo}, {x_hi})")

    # one persistence and trap solution, from the noise-free stimulus,
    # shared by every realisation
    obs._ensure_persistence()
    obs._ensure_recte()

    manifest = generate_dataset(
        obs.scenes, obs.tables, obs.static, args.outdir,
        n_mc=args.n_mc, chunk_mc=args.chunk_mc, seed=args.seed,
        overrides=overrides or None, labels=labels or None, progress=print,
        dq_aware=not args.raw_cr, recover=recover, device=obs.device)
    print(f"dataset complete: {len(manifest['chunks'])} chunks in "
          f"{args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
