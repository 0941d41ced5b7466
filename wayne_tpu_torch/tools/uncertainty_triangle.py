"""Three-way uncertainty cross-validation on the card -> UNCERTAINTY_TORCH.json
(the port's counterpart of the repository's ``tools/uncertainty_triangle.py``).

One ensemble ties the pipeline's three depth-uncertainty estimates
together per channel:

  (a) the point-fit delta-method sigma (``reduction.fit_depths``: chi^2
      curvature + out-of-transit baseline term + red-noise beta),
  (b) the MCMC posterior width (``mcmc.sample_channel_posteriors``, a free
      per-channel baseline and noise scale),
  (c) the realised Monte-Carlo scatter of the recovered depths across
      independent noise realisations, which the other two estimate.

The visit is the validation suite's main one (noise chain and CR repair
on, deterministic systematics off). Gates: (a)/(c) and (b)/(c) in
[0.7, 1.5] per channel; the channel means within 30%; the chains
converged (split R-hat < 1.05, ESS > 200 per channel); LM point estimates
and MCMC medians within a fraction of a sigma.

Realisation m's exposure e is keyed by ``mc_seed_words(777, m, e)``. The
MCMC runs every realisation's channels as the ensembles of ONE sampler
call, its ``torch.Generator`` seeded with 888 (the JAX tool keys each
realisation's chain by ``fold_in(PRNGKey(888), m)``): the chains are the
port's own draws.

Usage: python -m wayne_tpu_torch.tools.uncertainty_triangle [--n-mc 64]
       [--cpu]

Runs on the CUDA card unless ``--cpu`` is given (without a card it
raises). The record has the JAX record's keys plus ``card``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from wayne_tpu_torch.tools import REPO, card_name
from wayne_tpu_torch.tools.validate_recovery import (
    RP0, _Clock, _say, build_core, reduced, scan_run,
)

RECORD = os.path.join(REPO, "UNCERTAINTY_TORCH.json")


def triangle_gates(rp, sig_lm, med_mc, width_mc, rhat, ess) -> dict:
    """The gate arithmetic on host arrays (realisations x channels): the
    ratios, the gates and the pulls, by the JAX tool's names."""
    scatter = rp.std(axis=0, ddof=1)            # (c) the ground truth
    scatter_med = med_mc.std(axis=0, ddof=1)    # the MCMC medians' scatter
    a_over_c = sig_lm.mean(axis=0) / scatter
    b_over_c = width_mc.mean(axis=0) / scatter_med
    ok_a = bool(np.all((1 / a_over_c >= 0.7) & (1 / a_over_c <= 1.5)))
    ok_b = bool(np.all((1 / b_over_c >= 0.7) & (1 / b_over_c <= 1.5)))
    ok_mean = bool(abs(float(a_over_c.mean()) - 1.0) < 0.3
                   and abs(float(b_over_c.mean()) - 1.0) < 0.3)
    ok_conv = bool(np.all(rhat < 1.05) and np.all(ess > 200.0))
    # LM point estimates and MCMC medians agree per realisation in units
    # of that CHANNEL's sigma: the max over all pulls at 1.5, the mean at
    # 0.35
    pulls = np.abs(rp - med_mc) / sig_lm.mean(axis=0)[None, :]
    med_agree = float(pulls.max())
    pull_mean = float(pulls.mean())
    ok_agree = med_agree < 1.5 and pull_mean < 0.35
    return {
        "scatter": scatter, "scatter_med": scatter_med,
        "a_over_c": a_over_c, "b_over_c": b_over_c,
        "ok_a": ok_a, "ok_b": ok_b, "ok_mean": ok_mean, "ok_conv": ok_conv,
        "med_agree": med_agree, "pull_mean": pull_mean, "ok_agree": ok_agree,
    }


def run_triangle(n_mc: int = 64, device=None, out: str = RECORD,
                 core_kw: dict | None = None, n_steps: int = 4000,
                 n_burn: int = 1200) -> tuple[dict, bool]:
    """The ensemble on ``device`` (None = the CUDA card; raises without
    one); writes the record to ``out``. ``core_kw`` sizes the visit
    (:func:`validate_recovery.build_core`). Returns (record, all gates
    passed)."""
    from wayne_tpu_torch.device import resolve_device
    from wayne_tpu_torch.mcmc import sample_channel_posteriors
    from wayne_tpu_torch.reduction import fit_depths

    dev = resolve_device(device)
    core = build_core(dev, **(core_kw or {}))
    # the triangle's reduction takes no amplifier-offset correction
    run = scan_run(core, 777, quad=None)
    orbit, ld = core.base.orbit, core.base.ld
    clock = _Clock(dev)
    chans = []
    for m in range(n_mc):
        chans.append(reduced(core, run, core.cfg, m).channel_lc)
        _say(f"triangle realisation {m + 1}/{n_mc}")
    chan = torch.stack(chans)                       # (n_mc, n_exp, n_chan)
    rp_hat, rp_sig = fit_depths(chan, core.mid, orbit, ld, RP0)
    # every realisation's channels as the sampler's ensembles
    n_chan = core.n_chan
    folded = chan.permute(1, 0, 2).reshape(core.n_exp, n_mc * n_chan)
    post = sample_channel_posteriors(folded, core.mid, orbit, ld, RP0, 888,
                                     n_steps=n_steps, n_burn=n_burn)
    width = 0.5 * (post.rp_minus + post.rp_plus)
    host = lambda t: t.detach().cpu().numpy().astype(np.float64)
    per = lambda t: host(t).reshape(n_mc, n_chan)
    rp, sig_lm = host(rp_hat), host(rp_sig)
    med_mc, width_mc = per(post.rp_median), per(width)
    rhat, ess = per(post.rhat), per(post.ess)
    wall = clock.seconds()
    g = triangle_gates(rp, sig_lm, med_mc, width_mc, rhat, ess)
    record = {
        "n_mc": n_mc, "n_chan": n_chan,
        "backend": dev.type, "card": card_name(dev),
        "wallclock_s": round(wall, 3),
        "config": "validation main ensemble (noise chain + CR repair, no "
                  "deterministic systematics)",
        "mc_scatter": [round(float(v), 6) for v in g["scatter"]],
        "lm_sigma_mean": [round(float(v), 6) for v in sig_lm.mean(axis=0)],
        "mcmc_width_mean": [round(float(v), 6)
                            for v in width_mc.mean(axis=0)],
        "mcmc_median_scatter": [round(float(v), 6)
                                for v in g["scatter_med"]],
        "lm_over_scatter": [round(float(v), 3) for v in g["a_over_c"]],
        "mcmc_over_scatter": [round(float(v), 3) for v in g["b_over_c"]],
        "rhat_max": round(float(rhat.max()), 4),
        "ess_min": round(float(ess.min()), 1),
        "lm_vs_mcmc_median_max_pull": round(g["med_agree"], 3),
        "lm_vs_mcmc_median_mean_pull": round(g["pull_mean"], 3),
        "lm_sigma_calibrated_0.7_1.5": g["ok_a"],
        "mcmc_width_calibrated_0.7_1.5": g["ok_b"],
        "means_within_30pct": g["ok_mean"],
        "chains_converged_rhat_1.05_ess_200": g["ok_conv"],
        "point_estimates_agree_sub_sigma": g["ok_agree"],
    }
    with open(out, "w") as fh:
        json.dump(record, fh, indent=2)
    ok = (g["ok_a"] and g["ok_b"] and g["ok_mean"] and g["ok_conv"]
          and g["ok_agree"])
    return record, ok


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.tools.uncertainty_triangle")
    # 64 realisations: the scatter's SE is ~9%, so the two-sided
    # [0.7, 1.5] per-channel gates have margin against estimation noise
    parser.add_argument("--n-mc", type=int, default=64)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    record, ok = run_triangle(n_mc=args.n_mc,
                              device="cpu" if args.cpu else None)
    print(json.dumps(record))
    if not ok:
        print("FAILED: a triangle gate", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
