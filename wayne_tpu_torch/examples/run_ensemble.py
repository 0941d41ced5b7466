"""Example: generate a Monte-Carlo transit-visit dataset on the card (the
port's counterpart of the repository's ``examples/run_ensemble.py``).

Simulates N realisations of a WASP-43b-like G141 scan visit with the
transmission spectrum scaled per realisation, reduces each exposure to an
extracted spectrum ON THE DEVICE, and writes a labelled, resumable dataset
(the JAX example's layout and ``rp_scale`` labels; read it back with
``wayne_tpu_torch.parallel.dataset.load_dataset``).

    python -m wayne_tpu_torch.examples.run_ensemble --n-mc 64 \
        --outdir /tmp/wayne_ds

Runs on the CUDA card unless ``--cpu`` is given (without a card it
raises).
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.examples.run_ensemble")
    parser.add_argument("--n-mc", type=int, default=64)
    parser.add_argument("--chunk-mc", type=int, default=16)
    parser.add_argument("--n-exp", type=int, default=76)
    parser.add_argument("--outdir", default="wayne_dataset")
    parser.add_argument("--subarray", type=int, default=512)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from wayne_tpu_torch.calibration import synthetic_tables
    from wayne_tpu_torch.config import ObservationConfig
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.parallel.dataset import generate_dataset
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.scene import example_scene

    dev = resolve_device("cpu" if args.cpu else None)
    S = args.subarray
    obs = ObservationConfig(subarray=S, nsamp=15, samp_seq="SPARS10",
                            scan=True, n_lambda=S)
    cfg = obs.exposure_static()
    tables = synthetic_tables("G141", subarray=S, n_lambda=S,
                              samp_seq="SPARS10", nsamp=15, device=dev)

    base = example_scene(S, scan_speed=1.0, device=dev)
    starts = np.linspace(0.0, 4 * 3600.0, args.n_exp)
    visit = tree_map(lambda x: x[None].expand((args.n_exp,) + x.shape), base)
    visit = dataclasses.replace(
        visit, exp_start_s=torch.as_tensor(starts, dtype=torch.float32,
                                           device=dev))

    # label: per-realisation transmission-spectrum scale (the quantity an
    # ML retrieval would learn to recover)
    rng = np.random.RandomState(0)
    scale = rng.uniform(0.95, 1.05, args.n_mc)
    rp = base.rp_over_rs.cpu().numpy()[None, :] * scale[:, None]

    manifest = generate_dataset(
        visit, tables, cfg, args.outdir, n_mc=args.n_mc,
        chunk_mc=args.chunk_mc,
        overrides={"rp_over_rs": rp.astype(np.float32)},
        labels={"rp_scale": scale},
        progress=print, device=dev)
    print(f"dataset complete: {manifest['n_mc']} visits x "
          f"{manifest['n_exp']} exposures -> {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
