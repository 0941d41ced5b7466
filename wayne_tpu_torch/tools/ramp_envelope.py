"""Parametric ramp-fit model-mismatch envelope on the card ->
RAMP_ENVELOPE_TORCH.json (the port's counterpart of the repository's
``tools/ramp_envelope.py``).

Sweeps the time-domain systematics through the validation visit with every
other noise source off and reduces each draw through the joint white ramp
fit (``reduction.fit_white_ramp``, ``ramp_detrend``, ``fit_depths``), so
``run_reduce --detrend ramp`` has a validity domain measured on the port's
own fit:

- the orbit hook (0 to 4x its amplitude, 1x and 4x in the first orbit) is
  absorbed by the fit's separate first-orbit amplitude
  (``hook_absorption_max_delta``);
- the sinusoidal SSV is absorbed: its per-exposure mean factor is common
  to the visit, so the out-of-transit normalisation removes it;
- the random-walk SSV is the one source left, a per-visit random error
  linear in its amplitude (``white_bias_draw_std``, ``channel_bias_max``).

The visit is ``validate_recovery``'s (256^2, NSAMP 5 SPARS25, 48
exposures, 8 channels), with the SSV and the visit trend as the only
"noise", reduced without the cosmic-ray repair and without the amplifier
correction. The injected proxy is the same visit with every flag off
through the plain depth fit. Draw d of every grid point keys exposure e
by ``mc_seed_words(123, d, e)``, as the JAX tool folds (123, d) then e:
draw d's walk is the same at every amplitude, so the grid's rows and
columns stay paired. The walk's bits are the port's own.

The grid (4 sinusoid x 3 random-walk amplitudes, 8 draws where the walk is
on), the hook points, the statistics and the four gates are the JAX
tool's: |mean white bias| < 2e-3 at the validation default (sin 0.015, rw
0.005), the channel bias non-decreasing in the walk amplitude, the
sinusoid moving the white bias < 1e-4, the hook delta < 5e-4.

Usage: python -m wayne_tpu_torch.tools.ramp_envelope [--cpu] [--n-draw 8]
       [--out PATH]

Runs on the CUDA card unless ``--cpu`` is given (without a card it
raises); exits 1 when a gate falls. The record has the JAX record's keys
plus ``card`` (the name and power limit ``nvidia-smi`` reports), with
``backend`` the torch device type.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

from wayne_tpu_torch.tools import REPO, card_name
from wayne_tpu_torch.tools import validate_recovery as vr

RECORD = os.path.join(REPO, "RAMP_ENVELOPE_TORCH.json")
SEED = 123
SIN_AMPS = (0.0, 0.0075, 0.015, 0.03)
RW_AMPS = (0.0, 0.005, 0.01)
DEFAULT = (0.015, 0.005)             # the validation visit's (sin, rw)
HOOK = (0.003, 2.0)                  # the default hook and first-orbit scale
# hook absorption: default SSV, hook 0..4x and first-orbit 1x and 4x
HOOK_POINTS = tuple((h, sc) for h in (0.0, 0.003, 0.012) for sc in (1.0, 4.0))
CONFIG = ("validation visit, noise-free (mismatch bias is deterministic per "
          "draw), ramp-fit reduction")


@dataclass
class Envelope:
    """The sweep's visit, its "noise" and its reduction."""

    core: vr.Core
    cfg: object                 # config.ExposureStatic: ssv + visit_trend
    run: vr.Run                 # no amplifier correction, root seed


def build_envelope(device, **core_kw) -> Envelope:
    """The JAX tool's visit on ``device`` (``tools/ramp_envelope.py:80-102``);
    ``core_kw`` resizes it (:func:`validate_recovery.build_core`)."""
    core = vr.build_core(device, **core_kw)
    return Envelope(core=core,
                    cfg=vr.noise_off(core.cfg, ssv=True, visit_trend=True),
                    run=vr.scan_run(core, SEED, quad=None))


def run_point(env: Envelope, sin_amp: float, rw_amp: float, hook_amp: float,
              orbit1_scale: float, draw: int) -> tuple[float, np.ndarray]:
    """One draw of one grid point: (white Rp/Rs of the joint ramp fit, the
    ramp-detrended channel Rp/Rs (n_chan,))."""
    from wayne_tpu_torch.reduction import (fit_depths, fit_white_ramp,
                                           ramp_detrend)

    core = env.core
    visit = vr.with_trends(core.visit, ssv_amp=sin_amp, ssv_rw_amp=rw_amp,
                           hook_amp=hook_amp, hook_orbit1_scale=orbit1_scale)
    red = vr.reduced(core, dataclasses.replace(env.run, visit=visit),
                     env.cfg, draw)
    orbit, ld = core.base.orbit, core.base.ld
    wfit = fit_white_ramp(red.white_lc, core.mid, orbit, ld, vr.RP0)
    chan = ramp_detrend(red.channel_lc, wfit, core.mid, orbit)
    rp_hat, _ = fit_depths(chan, core.mid, orbit, ld, vr.RP0)
    return float(wfit.rp), rp_hat.detach().cpu().numpy().astype(np.float64)


def run_clean(env: Envelope) -> np.ndarray:
    """The injected proxy: every flag off, the plain depth fit."""
    return vr.noise_free(env.core, env.run, env.cfg, "depths")["rp"]


def point(env: Envelope, sin_amp: float, rw_amp: float,
          rp_clean: np.ndarray, n_draw: int) -> dict:
    """One grid point's statistics over its draws (``n_draw`` where the
    walk is on, else 1), rounded as the JAX tool rounds them."""
    n = n_draw if rw_amp > 0 else 1
    ws, chs = [], []
    for d in range(n):
        w, ch = run_point(env, sin_amp, rw_amp, *HOOK, d)
        ws.append(w)
        chs.append(ch)
    ws = np.array(ws)
    rp_true = float(rp_clean.mean())
    ch_bias = np.stack(chs).mean(axis=0) - rp_clean
    return {
        "ssv_sin_amp": sin_amp, "ssv_rw_amp": rw_amp,
        "n_draw": n,
        "white_bias_mean": round(float(ws.mean() - rp_true), 6),
        "white_bias_sem": round(
            float(ws.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0, 6),
        "white_bias_draw_std": round(
            float(ws.std(ddof=1)) if n > 1 else 0.0, 6),
        "channel_bias_max": round(float(np.abs(ch_bias).max()), 6),
    }


def envelope_gates(grid: list, hook_delta: float) -> dict:
    """The JAX tool's four gates on the grid and the hook delta."""
    default = next(g for g in grid if (g["ssv_sin_amp"], g["ssv_rw_amp"])
                   == DEFAULT)
    # the walk amplitude is the real lever: the channel bias grows with it
    col = [g["channel_bias_max"] for g in grid
           if g["ssv_sin_amp"] == DEFAULT[0]]
    # the sinusoid is absorbed: quadrupling it moves the bias < 1e-4
    sin_rows = [g["white_bias_mean"] for g in grid if g["ssv_rw_amp"] == 0.0]
    return {
        "default_point_white_bias": default["white_bias_mean"],
        "default_white_bias_below_2e-3": bool(
            abs(default["white_bias_mean"]) < 2e-3),
        "channel_bias_monotone_in_rw_amp": bool(
            all(b2 >= b1 - 1e-4 for b1, b2 in zip(col, col[1:]))),
        "sin_ssv_absorbed_below_1e-4": bool(float(np.ptp(sin_rows)) < 1e-4),
        "hook_fully_absorbed_below_5e-4": bool(hook_delta < 5e-4),
    }


def sweep(n_draw: int = 8, device=None, out: str = RECORD,
          core_kw: dict | None = None) -> tuple[dict, bool]:
    """The whole sweep on ``device`` (None = the CUDA card, raises without
    one); writes the record to ``out``. Returns (record, every gate met)."""
    from wayne_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    env = build_envelope(dev, **(core_kw or {}))
    clock = vr._Clock(dev)
    rp_clean = run_clean(env)
    grid = []
    for sa in SIN_AMPS:
        for ra in RW_AMPS:
            grid.append(point(env, sa, ra, rp_clean, n_draw))
            vr._say(f"grid point sin {sa} rw {ra}: {grid[-1]}")
    hook_pts = [run_point(env, DEFAULT[0], 0.0, h, sc, 0)[0]
                for h, sc in HOOK_POINTS]
    hook_delta = float(np.ptp(hook_pts))
    wall = clock.seconds()
    gates = envelope_gates(grid, hook_delta)
    record = {
        "backend": dev.type, "wallclock_s": round(wall, 1),
        "config": CONFIG,
        "injected_proxy_rp": round(float(rp_clean.mean()), 6),
        "grid": grid,
        "hook_absorption_max_delta": round(hook_delta, 6),
        **gates,
        "card": card_name(dev),
    }
    with open(out, "w") as fh:
        json.dump(record, fh, indent=2)
    return record, all(v for k, v in gates.items()
                       if k != "default_point_white_bias")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="wayne_tpu_torch.tools.ramp_envelope")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--n-draw", type=int, default=8)
    parser.add_argument("--out", default=RECORD)
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    record, ok = sweep(args.n_draw, device, args.out)
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
