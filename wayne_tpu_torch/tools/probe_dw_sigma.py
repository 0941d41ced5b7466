"""Which systematic drives the divide-white sigma_rel underreporting, on
the card (the port's counterpart of the repository's
``tools/probe_dw_sigma.py``).

Runs the validation suite's systematics ensemble shape (256^2, 48
exposures, 8 channels; the noise chain with cosmic rays repaired from the
hit lists and NLINCORR) under five flag variants and prints, per variant
and channel, the realised relative-depth scatter over the reported
``sigma_rel`` of ``divide_white_fit_depths``. Each variant's noisy
realisation m is paired with a clean run (no noise but the variant's SSV
and visit trend) on the same seed words ``mc_seed_words(123, m, e)``, so
both share the random walk and their difference is the noise's. The
reduction runs WITHOUT the amplifier correction (``quad_map``): this is
the diagnosis behind ``reduction.amp_offset_correct``, where a background
strip in another amplifier quadrant than the spectrum leaks the per-read
bias drift into the relative depths.

Usage: python -m wayne_tpu_torch.tools.probe_dw_sigma [--n-mc 12] [--cpu]
       [--bg-rows 180:250]

Runs on the CUDA card unless ``--cpu`` is given (without a card it
raises). Prints the lines of the JAX tool; writes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from wayne_tpu_torch.tools import validate_recovery as vr

SEED = 123
# (name, flags on top of the noise chain, random-walk SSV amplitude)
VARIANTS = (
    ("full (ssv+rw+trend+drift)",
     dict(ssv=True, visit_trend=True, bias_drift=True), 0.005),
    ("no bias_drift", dict(ssv=True, visit_trend=True), 0.005),
    ("sin-only ssv (+trend+drift)",
     dict(ssv=True, visit_trend=True, bias_drift=True), 0.0),
    ("no ssv (trend+drift)", dict(visit_trend=True, bias_drift=True), 0.005),
    ("noise only", dict(), 0.005),
)


def parse_bg_rows(text: str) -> tuple[int, ...]:
    """``"180:250"`` -> (180, 250), as the JAX tool parses ``--bg-rows``."""
    return tuple(int(v) for v in text.split(":"))


def rel_ratio(rp_noisy: np.ndarray, rp_clean: np.ndarray,
              sig_rel: np.ndarray, n_chan: int) -> np.ndarray:
    """Per channel: the scatter over realisations of the noise's effect on
    the relative depths (each realisation's channel mean removed, scaled by
    1 / sqrt(1 - 1 / n_chan) for that removal) over the mean reported
    sigma_rel. ``rp_*``: (n_mc, n_chan); ``sig_rel``: (n_chan,)."""
    dev = rp_noisy - rp_clean
    d = dev - dev.mean(axis=1, keepdims=True)
    scat = d.std(axis=0, ddof=1) / np.sqrt(1 - 1 / n_chan)
    return scat / np.maximum(sig_rel, 1e-12)


def variant_cfgs(core: vr.Core, extra_flags: dict):
    """(noisy, clean) configs of a variant: the noise chain plus
    ``extra_flags``, and no noise but the variant's SSV and visit trend."""
    noisy = dataclasses.replace(core.cfg, noise=dataclasses.replace(
        core.flags, **extra_flags))
    clean = vr.noise_off(core.cfg, ssv=extra_flags.get("ssv", False),
                         visit_trend=extra_flags.get("visit_trend", False))
    return noisy, clean


def variant_run(core: vr.Core, rw_amp: float) -> vr.Run:
    """The core visit at walk amplitude ``rw_amp``, reduced without the
    amplifier correction."""
    return vr.scan_run(core, SEED, quad=None,
                       visit=vr.with_trends(core.visit, ssv_rw_amp=rw_amp))


def run_variant(core: vr.Core, extra_flags: dict, rw_amp: float,
                n_mc: int) -> dict:
    """One variant's ensembles: the noisy and clean depths (n_mc, n_chan),
    the mean reported sigma_rel and the ratio per channel."""
    noisy, clean = variant_cfgs(core, extra_flags)
    run = variant_run(core, rw_amp)
    out_n = vr.ensemble(core, run, noisy, "divide-white", n_mc)
    out_c = vr.ensemble(core, run, clean, "divide-white", n_mc)
    sig_rel = out_n["sig_rel"].mean(axis=0)
    return {"rp_noisy": out_n["rp"], "rp_clean": out_c["rp"],
            "sig_rel": sig_rel,
            "ratio": rel_ratio(out_n["rp"], out_c["rp"], sig_rel,
                               core.n_chan)}


def probe(n_mc: int = 12, device=None, bg_rows=(180, 250),
          variants=VARIANTS, core_kw: dict | None = None,
          say=print) -> dict:
    """Every variant on ``device`` (None = the CUDA card, raises without
    one) with the sky from ``bg_rows``; prints the JAX tool's lines through
    ``say`` and returns {name: run_variant's dict}."""
    from wayne_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    core = vr.build_core(dev, **dict(core_kw or {}, bg_rows=tuple(bg_rows)))
    say(f"bg_rows={tuple(bg_rows)}")
    results = {}
    for name, extra, rw_amp in variants:
        clock = vr._Clock(dev)
        res = run_variant(core, extra, rw_amp, n_mc)
        results[name] = res
        say(f"{name:28s} ratio={np.round(res['ratio'], 2).tolist()} "
            f"({clock.seconds():.0f}s)")
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="wayne_tpu_torch.tools.probe_dw_sigma")
    parser.add_argument("--n-mc", type=int, default=12)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--bg-rows", default="180:250")
    args = parser.parse_args(argv)
    probe(args.n_mc, "cpu" if args.cpu else None,
          parse_bg_rows(args.bg_rows), say=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
