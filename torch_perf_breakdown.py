#!/usr/bin/env python3
"""Where the time of a visit of the PyTorch/CUDA port goes on one CUDA card.

    python3 torch_perf_breakdown.py [--out chiprun_out/perf_breakdown.json]

Runs ``Observation.simulate()`` of the headline visit as ``chip_smoke.py``
cuts it (``ORBITS`` orbits, ``CHUNK`` exposures per readout launch): once to
warm up, three times timed with the host clock around a synchronised call,
then once under ``torch.profiler`` for the device time per kernel and the
device's idle share over the call. Then times the readout kernel alone at
the visit's chunk shapes, noise on and off, in two builds taken in turn:
the port's (``--fmad=false``) and one with fused multiply-add on, and holds
the second against the plain version as ``chip_smoke.py`` holds the first.
Prints one JSON object (and writes it to ``--out``) naming the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from chip_smoke import CHUNK, HERE, card_line, cuda_ms, headline_observation


def _busy_ms(events) -> tuple[float, list[tuple[float, float]]]:
    """Union of device-kernel intervals (ms) from profiler events."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3, spans


def _kernel_builds(ro, kin) -> dict:
    """The readout alone in the port's build and with FMA on, alternated
    three times, plus the FMA build against the plain version."""
    fma_flags = ["--fmad=true" if f == "--fmad=false" else f
                 for f in ro.NVCC_FLAGS]
    builds = {"fmad_off": ro._library(), "fmad_on": ro.load(
        ro.build(flags=fma_flags))}
    modes = {"noise_on": dict(poisson=True, read_noise=True),
             "noise_off": dict(poisson=False, read_noise=False)}
    out = {b: {m: [] for m in modes} for b in builds}
    try:
        for _ in range(3):
            for b, lib in builds.items():
                ro._lib = lib
                for m, flags in modes.items():
                    out[b][m].append(cuda_ms(
                        lambda: ro.exposure_readout(*kin, **flags), reps=20,
                        warmup=3))
        ro._lib = builds["fmad_on"]
        check = {}
        for m, flags in modes.items():
            got, _ = ro.exposure_readout(*kin, **flags)
            want, _ = ro.exposure_readout_plain(*kin, **flags)
            diff = (got - want).abs()
            check[m] = {
                "max_rel_err": float((diff / want.abs().clamp_min(1e-30))
                                     .max()),
                "identical_share": float((got == want).float().mean()),
                "max_abs_err_dn": float(diff.max())}
        out["fmad_on_vs_plain"] = check
    finally:
        ro._lib = builds["fmad_off"]
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "perf_breakdown.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_perf_breakdown.py needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from wayne_tpu_torch.ops import readout as ro

    cfg, obs = headline_observation()
    n = obs.plan.n_exposures
    obs.simulate(chunk=CHUNK)                           # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        obs.simulate(chunk=CHUNK)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        obs.simulate(chunk=CHUNK)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.events()
    busy_ms, spans = _busy_ms(events)
    window_ms = ((spans[-1][1] - spans[0][0]) / 1e3) if spans else 0.0
    per_kernel: dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    readout_ms = sum(v for k, v in per_kernel.items()
                     if "exposure_readout_kernel" in k)

    # the kernel alone at the visit's chunk shapes
    st = obs.static
    B, NR, W, S = CHUNK, cfg.nsamp + 1, st.band_px, cfg.subarray
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    kin = (torch.randint(0, 2**31 - 1, (B, 2), generator=g, device=dev,
                         dtype=torch.int32),
           torch.zeros((B, NR), dtype=torch.int32, device=dev) + 64,
           torch.diff(obs.tables.read_times, prepend=obs.tables.read_times[:1]
                      ).expand(B, NR).contiguous(),
           500.0 * torch.rand((B, NR, W, S), generator=g, device=dev),
           1.3 * torch.rand((B, S, S), generator=g, device=dev),
           obs.tables.bias_map, 1.0 / obs.tables.gain_map,
           obs.tables.nonlin_coeffs,
           torch.randint(0, S, (B, NR, 2, st.max_cr_per_read), generator=g,
                         device=dev, dtype=torch.int32),
           torch.zeros((B, NR, st.max_cr_per_read), device=dev),
           obs.tables.readout_consts)

    out = {
        "card": card_line(), "device": torch.cuda.get_device_name(0),
        "visit": f"wasp43b_g141_scan, {cfg.n_orbits} orbit(s), {n} "
                 f"exposures, chunk {CHUNK}",
        "simulate_wall_s": walls, "simulate_exp_per_s": [n / w for w in walls],
        "profiled_wall_s": prof_wall,
        "device_busy_ms": busy_ms, "device_window_ms": window_ms,
        "device_idle_share_of_wall": 1.0 - busy_ms / (prof_wall * 1e3),
        # the profiler slows the host: the same busy time against the
        # fastest unprofiled call
        "device_idle_share_of_unprofiled_wall":
            1.0 - busy_ms / (min(walls) * 1e3),
        "readout_kernel_ms_in_visit": readout_ms,
        "readout_share_of_busy": readout_ms / busy_ms if busy_ms else None,
        "kernels_launched": len(spans),
        "top_kernels_ms": top,
        "readout_alone_ms_per_launch": _kernel_builds(ro, kin),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
