"""Multi-visit observing programs (port of the JAX package's ``program``).

A :class:`Program` drives N visits of one target with the cross-visit
physics a single visit cannot carry:

- **persistence carried across visits**: each visit's per-pixel maximum
  noise-free fluence (what filled the traps) becomes the next visit's
  prior-fluence map (``PersistenceConfig.prior_fluence_file``), stamped
  with its end time on the next visit's clock;
- **per-visit ephemeris drift**: the true transit times walk away from
  the assumed linear ephemeris by ``t0_drift_s_per_visit`` per visit.

Each visit is an ordinary :class:`~wayne_tpu_torch.observation.Observation`
in its own subdirectory (``visit_00/ visit_01/ ...``), on the Program's
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable

import numpy as np
import torch

from wayne_tpu_torch.config import ObservationConfig
from wayne_tpu_torch.device import resolve_device

SECONDS_PER_DAY = 86400.0


def visit_start_mjds(cfg: ObservationConfig) -> list[float]:
    """The program's visit start epochs: explicit ``visit_start_mjds``, or
    every ``visit_spacing_days`` (0: the nearest whole number of planet
    periods at least one day long)."""
    prog = cfg.program
    if prog.visit_start_mjds is not None:
        starts = [float(v) for v in prog.visit_start_mjds]
        if len(starts) != prog.num_visits:
            raise ValueError(
                f"program.visit_start_mjds has {len(starts)} entries "
                f"for num_visits={prog.num_visits}")
        return starts
    spacing = float(prog.visit_spacing_days)
    if spacing <= 0.0:
        period = float(cfg.planet.period_days)
        spacing = period * max(1, int(np.ceil(1.0 / period)))
    return [cfg.start_mjd + i * spacing for i in range(prog.num_visits)]


def visit_config(cfg: ObservationConfig, index: int,
                 starts: list[float] | None = None) -> ObservationConfig:
    """The i-th visit's single-visit config: ``start_mjd`` at the visit
    epoch (an explicit exposure schedule shifted with it), the planet's
    true t0 drifted by ``t0_drift_s_per_visit * index``, its own seed."""
    starts = visit_start_mjds(cfg) if starts is None else starts
    new_start = starts[index]
    planet = cfg.planet
    drift_d = cfg.program.t0_drift_s_per_visit * index / SECONDS_PER_DAY
    if drift_d:
        planet = dataclasses.replace(planet, t0_mjd=planet.t0_mjd + drift_d)
    explicit = cfg.exp_start_mjd_list
    if explicit is not None:
        off = new_start - cfg.start_mjd
        explicit = tuple(t + off for t in explicit)
    return dataclasses.replace(
        cfg, start_mjd=new_start, exp_start_mjd_list=explicit,
        planet=planet, seed=cfg.seed + 104729 * index,
        program=dataclasses.replace(cfg.program, num_visits=1))


class Program:
    """Drive a multi-visit observing program (``program:`` YAML block).

    ``device``: None (the default) runs every visit on the CUDA card and
    raises when there is none; ``"cpu"`` runs the plain PyTorch path.
    """

    CARRY_FILE = "carry_fluence.npy"
    CARRY_META = "carry_fluence.json"

    def __init__(self, cfg: ObservationConfig,
                 device: torch.device | str | None = None):
        if cfg.program.num_visits < 1:
            raise ValueError("program.num_visits must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.starts = visit_start_mjds(cfg)
        self.carry = (cfg.program.carry_persistence
                      and cfg.persistence.enabled
                      and cfg.program.num_visits > 1)

    def visit_dirs(self, outdir: str) -> list[str]:
        return [os.path.join(outdir, f"visit_{i:02d}")
                for i in range(self.cfg.program.num_visits)]

    def generate(self, outdir: str, chunk: int = 8,
                 progress: Callable[[str], None] | None = None,
                 resume: bool = True,
                 debug: bool = False) -> list[list[str]]:
        """Simulate every visit; returns the paths each visit wrote.
        ``debug``: each visit's ``generate(debug=True)`` (guards and its
        ``visit_summary.json``)."""
        from wayne_tpu_torch.observation import Observation

        say = progress if progress is not None else (lambda s: None)
        os.makedirs(outdir, exist_ok=True)
        all_paths: list[list[str]] = []
        summary: dict = {"visits": []}
        vdirs = self.visit_dirs(outdir)
        for i, vdir in enumerate(vdirs):
            vcfg = visit_config(self.cfg, i, self.starts)
            if self.carry and i > 0:
                prev = vdirs[i - 1]
                with open(os.path.join(prev, self.CARRY_META)) as fh:
                    meta = json.load(fh)
                # the prior end on THIS visit's clock (negative: before it)
                prior_end_s = ((meta["end_mjd"] - vcfg.start_mjd)
                               * SECONDS_PER_DAY)
                if prior_end_s >= 0.0:
                    raise ValueError(
                        f"visit {i} starts (MJD {vcfg.start_mjd}) before "
                        f"visit {i - 1} ended (MJD {meta['end_mjd']})")
                vcfg = dataclasses.replace(
                    vcfg, persistence=dataclasses.replace(
                        vcfg.persistence,
                        prior_fluence_file=os.path.join(prev,
                                                        self.CARRY_FILE),
                        prior_end_s=float(prior_end_s)))
            say(f"visit {i + 1}/{self.cfg.program.num_visits} "
                f"(MJD {vcfg.start_mjd:.4f})")
            obs = Observation(vcfg, device=self.device)
            paths = obs.generate(vdir, chunk=chunk, resume=resume,
                                 progress=progress, debug=debug)
            all_paths.append(paths)
            entry = {"dir": os.path.basename(vdir),
                     "start_mjd": vcfg.start_mjd,
                     "true_t0_mjd": float(vcfg.planet.t0_mjd),
                     "n_written": len(paths)}
            if self.carry:
                entry["carry"] = self._save_carry(
                    obs, vdir, chunk, reuse=resume and len(paths) == 0)
            summary["visits"].append(entry)
        summary["assumed_t0_mjd"] = float(self.cfg.planet.t0_mjd)
        summary["t0_drift_s_per_visit"] = float(
            self.cfg.program.t0_drift_s_per_visit)
        with open(os.path.join(outdir, "program_summary.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
        return all_paths

    def _save_carry(self, obs, vdir: str, chunk: int,
                    reuse: bool = False) -> dict:
        """Write the visit's carried stimulus (per-pixel max of the
        noise-free fluence stack) and its end epoch. ``reuse``: a fully
        resumed visit keeps the carry on disk when its stamped config
        fingerprint matches this visit's config, and recomputes it
        otherwise."""
        # a nested dataclass of scalars, strings and tuples: repr() is a
        # deterministic serialisation
        cfg_sha = hashlib.sha256(repr(obs.cfg).encode()).hexdigest()[:16]
        meta_path = os.path.join(vdir, self.CARRY_META)
        if (reuse and os.path.exists(meta_path)
                and os.path.exists(os.path.join(vdir, self.CARRY_FILE))):
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("config_sha") == cfg_sha:
                return meta

        stack = obs._visit_fluence(chunk)                       # (N, S, S)
        carried = torch.amax(stack, dim=0).cpu().numpy().astype(np.float32)
        exptime = float(obs.tables.read_times[-1])
        end_s = float(obs.scenes.exp_start_s[-1]) + exptime
        end_mjd = obs.cfg.start_mjd + end_s / SECONDS_PER_DAY
        np.save(os.path.join(vdir, self.CARRY_FILE), carried)
        meta = {"end_mjd": end_mjd,
                "peak_fluence_e": float(carried.max()),
                "mean_fluence_e": float(carried.mean()),
                "config_sha": cfg_sha}
        with open(meta_path, "w") as fh:
            json.dump(meta, fh, indent=2)
        return meta
