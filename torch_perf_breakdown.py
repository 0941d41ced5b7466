#!/usr/bin/env python3
"""Where the time of a visit of the PyTorch/CUDA port goes on one CUDA card.

    python3 torch_perf_breakdown.py [--out chiprun_out/perf_breakdown.json]
        [--parent DIR] [--rounds N]

Runs ``Observation.simulate()`` of the headline visit as ``chip_smoke.py``
cuts it (``ORBITS`` orbits, ``CHUNK`` exposures per readout launch): once to
warm up, three times timed with the host clock around a synchronised call,
then once under ``torch.profiler`` for the device time per kernel and the
device's idle share over the call. Then times each kernel alone at the
visit's chunk shape — the whole-exposure readout on the inputs the main
path gives its first chunk and on ``chip_smoke.py``'s synthetic ones,
noise on and off, and the per-read steps at read 8 — in the port's build
and the build of another checkout's sources (``--parent``), taken in turn
``--rounds`` times; each build's share of pixels identical to the plain
version beside it. Last, counts the SASS instructions that one Philox
block adds to a kernel (``cuobjdump -sass`` of a probe built with the
port's flags) and fails unless they are ``chip_smoke.COSTS["philox"]``.
Prints one JSON object (and writes it to ``--out``) naming the card and
its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from chip_smoke import (
    CHUNK, COSTS, HERE, NOISE_ON, card_line, cuda_ms, headline_observation,
    readout_inputs, recorded_readout, step_args, step_reads,
)


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


def _build_from(ro, csrc: str) -> str:
    """The port's build of the kernel sources in ``csrc`` (those of another
    checkout, e.g. the parent commit unpacked with ``git archive``)."""
    saved = ro._CSRC
    ro._CSRC = csrc
    try:
        return ro.build(verbose=True)
    finally:
        ro._CSRC = saved


def _kernel_builds(ro, inputs: dict, steps: dict, parent: str | None,
                   rounds: int) -> dict:
    """Each kernel alone in the port's build and the ``parent`` sources'
    build, taken in turn ``rounds`` times: the whole-exposure readout on
    each of ``inputs`` (name -> (args, flags)) with the noise on and off,
    and the per-read steps on ``steps`` (name -> (wrapper, kwargs)); then
    each build's share of pixels identical to the plain version."""
    builds = {"port": ro._library()}
    if parent:
        print(f"build parent: {parent}")
        builds["parent"] = ro.load(_build_from(ro, parent))
    modes = {"noise_on": {}, "noise_off": dict(poisson=False,
                                               read_noise=False)}
    out = {b: {} for b in builds}
    try:
        for _ in range(rounds):
            for b, lib in builds.items():
                ro._lib = lib
                for i, (args, flags) in inputs.items():
                    for m, extra in modes.items():
                        kw = dict(flags, **extra)
                        out[b].setdefault(f"{i}/{m}", []).append(cuda_ms(
                            lambda: ro.exposure_readout(*args, **kw),
                            reps=20, warmup=3))
                for name, (step, kw) in steps.items():
                    out[b].setdefault(name, []).append(cuda_ms(
                        lambda: step(**kw), reps=50, warmup=3))
        for b, lib in builds.items():
            ro._lib = lib
            check = {}
            for i, (args, flags) in inputs.items():
                for m, extra in modes.items():
                    kw = dict(flags, **extra)
                    got, _ = ro.exposure_readout(*args, **kw)
                    want, _ = ro.exposure_readout_plain(*args, **kw)
                    check[f"{i}/{m}"] = {
                        "identical_share": float((got == want).float().mean()),
                        "max_abs_err_dn": float((got - want).abs().max())}
            out[f"{b}_vs_plain"] = check
    finally:
        ro._lib = builds["port"]
    return out


_PHILOX_PROBE = r"""
#include "detector.cuh"
// one Philox4x32-10 block, and two in a chain, keyed as the readout keys
// them (seed words from device memory)
extern "C" __global__ void philox_1(const int* seed, unsigned* w) {
  const unsigned t = threadIdx.x;
  unsigned c[4] = {w[4 * t], t, 0u, 0u};
  philox4x32_10(seed[0], seed[1], c);
  for (int i = 0; i < 4; ++i) w[4 * t + i] = c[i];
}
extern "C" __global__ void philox_2(const int* seed, unsigned* w) {
  const unsigned t = threadIdx.x;
  unsigned c[4] = {w[4 * t], t, 0u, 0u};
  philox4x32_10(seed[0], seed[1], c);
  philox4x32_10(seed[0], seed[1], c);
  for (int i = 0; i < 4; ++i) w[4 * t + i] = c[i];
}
"""


def opcode_counts(listing: str) -> dict:
    """Per function of a ``cuobjdump -sass`` listing, a Counter of its
    instructions' base opcodes (``IMAD`` for ``IMAD.WIDE.U32``), NOPs
    left out."""
    import re
    from collections import Counter

    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
    out, fn = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = Counter()
        elif fn and (m := op.search(line)) and m.group(1) != "NOP":
            out[fn][m.group(1).split(".")[0]] += 1
    return out


def philox_sass(ro) -> dict:
    """The SASS instructions one Philox4x32-10 block adds to a kernel, as
    the port's nvcc flags compile ``csrc/detector.cuh``: the probe's
    two-block kernel less its one-block kernel (the key schedule is
    shared), in all, IMAD (the FMA-heavy pipe) and LOP3 (the ALU pipe);
    ``costs`` is (IMAD, LOP3, the rest) as ``chip_smoke.COSTS`` counts
    it."""
    import shutil
    import subprocess
    import tempfile

    nvcc = ro._nvcc()
    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        cubin = os.path.join(tmp, "probe.cubin")
        with open(src, "w") as fh:
            fh.write(_PHILOX_PROBE)
        subprocess.run([nvcc, *ro.NVCC_FLAGS, "-cubin", "-I", ro._CSRC,
                        "-o", cubin, src], check=True)
        ops = opcode_counts(subprocess.run(
            [dump, "-sass", cubin], check=True, capture_output=True,
            text=True).stdout)
    delta = ops["philox_2"]
    delta.subtract(ops["philox_1"])
    total = sum(delta.values())
    costs = (delta["IMAD"], delta["LOP3"],
             total - delta["IMAD"] - delta["LOP3"])
    return {"per_block": total, "by_opcode": dict(+delta),
            "costs": list(costs), "matches_costs": costs == COSTS["philox"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "perf_breakdown.json"))
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of timing every build in turn")
    ap.add_argument("--parent", default=None,
                    help="kernel sources (csrc/) of another checkout to time "
                    "in turns with the port's, e.g. the parent commit's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_perf_breakdown.py needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from wayne_tpu_torch.calibration import sample_sequence_times
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

    # the kernel alone at the visit's chunk shape, on the main path's
    # inputs and on chip_smoke.py's synthetic ones
    st = obs.static
    B, NR, W, S = CHUNK, cfg.nsamp + 1, st.band_px, cfg.subarray
    inputs = {
        "main_path": recorded_readout(lambda: obs.simulate(chunk=CHUNK))[1],
        "synthetic": (readout_inputs(B, NR, W, S, st.max_cr_per_read,
                                     sample_sequence_times(
                                         cfg.samp_seq, cfg.nsamp, S)),
                      NOISE_ON)}
    # the per-read steps at read 8 of the synthetic chunk, noise on
    syn, k = inputs["synthetic"][0], NR // 2
    _, cums = step_reads(ro.read_step_banded, None, syn, False, NOISE_ON)
    step_on = {f: v for f, v in NOISE_ON.items()
               if f not in ("with_cr", "ipc")}
    steps = {
        "read_step_banded": (ro.read_step_banded, dict(step_args(
            syn, k, cums[:, k - 1].contiguous(), False, True), **NOISE_ON)),
        "read_step": (ro.read_step, dict(step_args(
            syn, k, cums[:, k - 1].contiguous(), True, True), **step_on))}

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
        "kernels_alone_ms_per_launch": _kernel_builds(
            ro, inputs, steps, args.parent, args.rounds),
        "philox_sass": philox_sass(ro),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    if not out["philox_sass"]["matches_costs"]:
        print(f"a Philox block compiles to {out['philox_sass']['costs']} "
              f"(IMAD, LOP3, other), chip_smoke.COSTS counts "
              f"{COSTS['philox']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
