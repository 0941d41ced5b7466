"""A Monte-Carlo dataset at scale on one card, with resume after a kill ->
DATASET_SCALE_TORCH.json (the port's counterpart of the repository's
``tools/dataset_scale.py``).

Runs ``parallel.dataset.generate_dataset`` on a one-device mesh for a
chunked G141 then G102 ensemble (``n_per_grism`` realisations each,
76-exposure scan visits at 512^2, NSAMP 15 SPARS10, the full noise chain,
on-device spectral extraction), each realisation's continuum Rp/Rs drawn
as its label (``RandomState(42).uniform(0.08, 0.17)``, ``seed=3``).
Per grism:

- phase 1 writes the first 10 chunks, then returns, as a killed run would;
- phase 2 runs the whole dataset into the same directory and must skip
  exactly those chunks ("exists, skipping"); its new realisations give
  the sustained visits/s and exposures/s, host npz writes included;
- the output size.

``n_per_grism`` is truncated to a multiple of the chunk and raised to 11
chunks, so that phase 2 generates something. The dataset goes to a
scratch directory that is deleted afterwards (the record is the
measurement).

Usage: python -m wayne_tpu_torch.tools.dataset_scale [n_per_grism] [--cpu]
       [--out PATH]

Runs on the CUDA card unless ``--cpu`` is given (without a card it
raises). The record has the JAX record's keys plus ``card`` (the name and
power limit ``nvidia-smi`` reports); ``device`` is the torch device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from wayne_tpu_torch.tools import REPO, card_name

RECORD = os.path.join(REPO, "DATASET_SCALE_TORCH.json")
GRISMS = ("G141", "G102")
PHASE1_CHUNKS = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def effective_n(n_per_grism: int, chunk_mc: int) -> int:
    """Truncated to a multiple of ``chunk_mc``, then at least 11 chunks
    (phase 2 must generate chunks beyond phase 1's)."""
    if n_per_grism % chunk_mc:
        n_per_grism -= n_per_grism % chunk_mc
        log(f"n_per_grism truncated to the chunk multiple {n_per_grism}")
    return max(n_per_grism, (PHASE1_CHUNKS + 1) * chunk_mc)


# the JAX tool's configuration (tools/dataset_scale.py:54-64)
SIZES = dict(S=512, NL=512, N_EXP=76, nsamp=15, samp_seq="SPARS10", n_sub=8,
             band_px=32, max_cr_per_read=160)


def scale_inputs(dev, n_per_grism: int, *, S: int, NL: int, N_EXP: int,
                 nsamp: int, samp_seq: str, n_sub: int, band_px: int,
                 max_cr_per_read: int) -> tuple:
    """(cfg, the batched visit, {grism: (tables, per-realisation Rp/Rs
    labels (n_per_grism,))}): the labels drawn G141 first from
    ``RandomState(42).uniform(0.08, 0.17)``, as the JAX tool draws them."""
    from wayne_tpu_torch.calibration import synthetic_tables
    from wayne_tpu_torch.config import ExposureStatic
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.scene import example_scene

    cfg = ExposureStatic(subarray=S, n_lambda=NL, n_sub=n_sub, nsamp=nsamp,
                         samp_seq=samp_seq, scan=True, band_px=band_px,
                         max_cr_per_read=max_cr_per_read)
    base = example_scene(NL, scan_speed=1.0, device=dev)
    # generate_dataset keys every exposure by the seed and its global index
    scenes = tree_map(lambda a: a[None].expand((N_EXP,) + a.shape), base)
    rng = np.random.RandomState(42)
    grisms = {}
    for grism in GRISMS:
        tables = synthetic_tables(grism, subarray=S, n_lambda=NL,
                                  samp_seq=samp_seq, nsamp=nsamp, device=dev)
        grisms[grism] = (tables, rng.uniform(0.08, 0.17, n_per_grism
                                             ).astype(np.float32))
    return cfg, scenes, grisms


def run_scale(n_per_grism: int = 5000, device=None, out: str = RECORD,
              *, chunk_mc: int = 20, scratch: str | None = None,
              **sizes) -> dict:
    """The JAX tool's run (``tools/dataset_scale.py:54-136``) on ``device``
    (None = the CUDA card, raises without one). ``sizes`` replace entries
    of ``SIZES``. Writes the record to ``out``.
    ``scratch``: write the datasets to ``scratch/<grism>`` and keep them
    (default: a temporary directory, deleted)."""
    import torch

    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.parallel.dataset import generate_dataset
    from wayne_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sizes = dict(SIZES, **sizes)
    n_per_grism = effective_n(n_per_grism, chunk_mc)
    cfg, scenes, grisms = scale_inputs(dev, n_per_grism, **sizes)
    mesh = make_mesh([dev])
    n_phase1 = min(PHASE1_CHUNKS * chunk_mc, n_per_grism)
    N_EXP = sizes["N_EXP"]

    record: dict = {"backend": dev.type, "device": str(dev),
                    "n_per_grism": n_per_grism, "n_exp": N_EXP,
                    "subarray": sizes["S"], "chunk_mc": chunk_mc,
                    "grisms": {}}
    root = scratch or tempfile.mkdtemp(prefix="wayne_dataset_")
    total_visits = 0
    total_wall = 0.0
    try:
        for grism, (tables, rp) in grisms.items():
            overrides = {"rp_over_rs": np.broadcast_to(
                rp[:, None], (n_per_grism, sizes["NL"])).copy()}
            outdir = os.path.join(root, grism)

            # phase 1: a partial run, then the "kill" (it returns)
            generate_dataset(scenes, tables, cfg, outdir, n_mc=n_phase1,
                             chunk_mc=chunk_mc, seed=3,
                             overrides={k: v[:n_phase1]
                                        for k, v in overrides.items()},
                             labels={"rp": rp[:n_phase1]}, mesh=mesh)
            pre = set(os.listdir(outdir))
            log(f"[{grism}] phase 1 (pre-kill): {len(pre) - 1} chunks")

            # phase 2: the whole run must skip exactly phase 1's chunks
            skipped = []
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.time()
            manifest = generate_dataset(
                scenes, tables, cfg, outdir, n_mc=n_per_grism,
                chunk_mc=chunk_mc, seed=3, overrides=overrides,
                labels={"rp": rp}, mesh=mesh,
                progress=lambda s: skipped.append(s) if "skip" in s else None)
            wall = time.time() - t0
            size = sum(os.path.getsize(os.path.join(outdir, f))
                       for f in os.listdir(outdir))
            new_visits = n_per_grism - n_phase1
            record["grisms"][grism] = {
                "n_mc": n_per_grism,
                "chunks": len(manifest["chunks"]),
                "resume_skipped_chunks": len(skipped),
                "resume_ok": len(skipped) == n_phase1 // chunk_mc,
                "phase2_wallclock_s": round(wall, 1),
                "sustained_visits_per_s_per_chip": round(new_visits / wall,
                                                         2),
                "exposures_per_s": round(new_visits * N_EXP / wall, 1),
                "output_bytes": size,
            }
            total_visits += new_visits
            total_wall += wall
            log(f"[{grism}] {new_visits} visits in {wall:.1f}s "
                f"({new_visits / wall:.2f} visits/s/chip, "
                f"{size / 1e6:.0f} MB), resume skipped {len(skipped)}")

        record["total_visits_generated"] = total_visits + 2 * n_phase1
        record["sustained_visits_per_s_per_chip"] = round(
            total_visits / total_wall, 2)
        record["projected_10k_visits_minutes"] = round(
            10000 / (total_visits / total_wall) / 60.0, 1)
    finally:
        if scratch is None:
            shutil.rmtree(root, ignore_errors=True)
    record["card"] = card_name(dev)
    with open(out, "w") as fh:
        json.dump(record, fh, indent=2)
    return record


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="wayne_tpu_torch.tools.dataset_scale")
    parser.add_argument("n_per_grism", nargs="?", type=int, default=5000)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--out", default=RECORD)
    args = parser.parse_args(argv)
    record = run_scale(args.n_per_grism, "cpu" if args.cpu else None,
                       args.out)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
