#!/usr/bin/env python3
"""Where the time of a visit of the PyTorch/CUDA port goes on one CUDA card.

    python3 torch_perf_breakdown.py [--out chiprun_out/perf_breakdown.json]
        [--parent DIR] [--rounds N]

Runs ``Observation.simulate()`` of the headline visit as ``chip_smoke.py``
cuts it (``ORBITS`` orbits, ``CHUNK`` exposures per readout launch) on both
readout routes, the whole-exposure one and the per-read one
(``fused_reads=False``): once to warm up, three times timed with the host
clock around a synchronised call, then once under ``torch.profiler`` for
the device time per kernel, the kernels per chunk and the device's idle
share over the call. It profiles the Monte-Carlo ensemble
(``simulate_ensemble_spectra``, two realisations of the uncut visit) the
same way, and again with the extraction replaced by zeros, for the
extraction's share of the step. With ``--parent DIR`` (another checkout,
e.g. the parent commit unpacked with ``git archive``) it profiles that
checkout's per-read route too, in a process of its own. Then times each
kernel alone at the visit's chunk shape, L2-warm and L2-cold
(``chip_smoke.device_ms``) — the whole-exposure readout on the inputs the
main path gives its first chunk and on ``chip_smoke.py``'s synthetic ones,
noise on and off, and the per-read steps at read 8 — in the port's build
and the build of DIR's sources, taken in turn ``--rounds`` times; each
build's share of pixels identical to the plain version beside it, and
each build's registers and spills (``ptxas -v``). Both builds' banded steps
take the expected band and draw it themselves (a parent whose banded step
takes a sampled band instead is not comparable). Last, counts the SASS
instructions that one Philox block adds to a kernel (``cuobjdump -sass``
of a probe built with the port's flags) and fails unless they are
``chip_smoke.COSTS["philox"]``. Prints one JSON object (and writes it to
``--out``) naming the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from chip_smoke import (
    CHUNK, COSTS, HEADLINE, HERE, NOISE_ON, banded_reference, card_line,
    cuda_ms, device_ms, headline_observation, readout_inputs,
    recorded_readout, step_args, step_reads,
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


def _per_kernel_ms(events) -> dict[str, float]:
    """Device time (ms) of each kernel name in profiler events."""
    out: dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return out


def _top(per_kernel: dict[str, float], n: int = 12) -> list:
    return sorted(per_kernel.items(), key=lambda kv: -kv[1])[:n]


def _csrc_of(tree: str) -> str:
    return os.path.join(tree, "wayne_tpu_torch", "csrc")


def _build_from(ro, csrc: str, flags: list[str]) -> str:
    """The port's build of the kernel sources in ``csrc`` (the port's own or
    another checkout's) with nvcc ``flags``."""
    saved = ro._CSRC
    ro._CSRC = csrc
    try:
        return ro.build(verbose=True, flags=flags)
    finally:
        ro._CSRC = saved


def ptxas_usage(ro, csrc: str, flags: list[str]) -> dict:
    """Registers and spill bytes of each readout kernel of the sources in
    ``csrc`` built with ``flags`` (``nvcc -Xptxas -v``)."""
    usage = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ro.SOURCES:
            proc = subprocess.run(
                [ro._nvcc(), *flags, "-Xptxas=-v", "-cubin", "-o",
                 os.path.join(tmp, name + ".cubin"),
                 os.path.join(csrc, name)],
                check=True, capture_output=True, text=True)
            usage.update(parse_ptxas(proc.stderr))
    return usage


_KERNELS = ("exposure_readout_kernel", "read_step_banded_kernel",
            "read_step_kernel")


def parse_ptxas(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} for the
    readout kernels named in a ``ptxas -v`` log; a kernel's exact_poisson
    instantiation is its own entry."""
    out, fn = {}, None
    for line in log.splitlines():
        # a device function's properties (an out-of-line call) follow its
        # kernel's: they belong to no kernel
        if m := (re.search(r"Compiling entry function '(\S+)'", line)
                 or re.search(r"Function properties for (\S+)", line)):
            fn = next((k for k in _KERNELS if k in m.group(1)), None)
            if fn and "ILb1E" in m.group(1):   # template <bool EXACT = true>
                fn += " (exact_poisson)"
        elif fn and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                          spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def _kernel_builds(ro, inputs: dict, steps: dict, parent: str | None,
                   rounds: int) -> dict:
    """Each kernel alone in the port's build and the ``parent`` checkout's
    build, taken in turn ``rounds`` times, L2-
    warm and L2-cold: the whole-exposure readout on each of ``inputs``
    (name -> (args, flags)) with the noise on and off, and the per-read
    steps on ``steps`` (name -> (wrapper, kwargs, plain reference on the
    same kwargs)); then each build's
    share of pixels identical to the plain version and its registers and
    spills."""
    sources = {"port": (ro._CSRC, ro.NVCC_FLAGS)}
    if parent:
        sources["parent"] = (_csrc_of(parent), ro.NVCC_FLAGS)
    builds = {}
    for b, (csrc, flags) in sources.items():
        print(f"build {b}: {csrc} {' '.join(flags)}")
        builds[b] = ro.load(_build_from(ro, csrc, flags))
    modes = {"noise_on": {}, "noise_off": dict(poisson=False,
                                               read_noise=False)}
    out = {b: {} for b in builds}

    def timed(b, name, fn, reps):
        for temp in ("warm", "cold"):
            out[b].setdefault(f"{name}/{temp}", []).append(
                device_ms(fn, reps, cold=temp == "cold"))

    try:
        for r in range(rounds):
            for b, lib in builds.items():
                print(f"round {r}: timing {b}", flush=True)
                ro._lib = lib
                for i, (args, flags) in inputs.items():
                    for m, extra in modes.items():
                        kw = dict(flags, **extra)
                        timed(b, f"{i}/{m}",
                              lambda: ro.exposure_readout(*args, **kw), 20)
                for name, (step, kw, _) in steps.items():
                    timed(b, name, lambda: step(**kw), 50)
        for b, lib in builds.items():
            print(f"checking {b} against the plain versions")
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
            for name, (step, kw, plain) in steps.items():
                cum, got = step(**kw)
                cum_w, want = plain(**kw)
                check[name] = {
                    "identical_share": float((got == want).float().mean()),
                    "max_abs_err_dn": float((got - want).abs().max()),
                    "charge_identical": bool(torch.equal(cum, cum_w))}
            out[f"{b}_vs_plain"] = check
            out[f"{b}_ptxas"] = ptxas_usage(ro, *sources[b])
    finally:
        ro._lib = builds["port"]
    return out


def profile_route(obs, fused: bool) -> dict:
    """``simulate()`` on one readout route (``fused``: the whole-exposure
    kernel, else the per-read steps): a warm-up, three host-clock walls
    around a synchronised call, then one call under ``torch.profiler`` for
    the device's busy time and idle share, the kernels per chunk and the
    top kernels by device time."""
    import math

    from torch.profiler import ProfilerActivity, profile

    obs.static = dataclasses.replace(obs.static, fused_reads=fused)
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
    per_kernel = _per_kernel_ms(events)
    readout_ms = sum(v for k, v in per_kernel.items()
                     if any(name in k for name in _KERNELS))
    return {
        "simulate_wall_s": walls, "simulate_exp_per_s": [n / w for w in walls],
        "profiled_wall_s": prof_wall,
        "device_busy_ms": busy_ms,
        "device_window_ms": ((spans[-1][1] - spans[0][0]) / 1e3
                             if spans else 0.0),
        "device_idle_share_of_wall": 1.0 - busy_ms / (prof_wall * 1e3),
        # the profiler slows the host: the same busy time against the
        # fastest unprofiled call
        "device_idle_share_of_unprofiled_wall":
            1.0 - busy_ms / (min(walls) * 1e3),
        "readout_kernel_ms_in_visit": readout_ms,
        "readout_share_of_busy": readout_ms / busy_ms if busy_ms else None,
        "kernels_launched": len(spans),
        "kernels_per_chunk": len(spans) / math.ceil(n / CHUNK),
        "top_kernels_ms": _top(per_kernel),
    }


def profile_ensemble(n_mc: int = 2) -> dict:
    """``simulate_ensemble_spectra`` of ``n_mc`` realisations of the whole
    headline visit (every planned exposure, as ``run_dataset`` runs it):
    a warm-up, three host-clock walls around a synchronised call, then one
    call under ``torch.profiler``; the same with the extraction replaced
    by zeros (the simulation alone), whose difference is the extraction's
    share of the step, on the host's clock and in device busy time."""
    from torch.profiler import ProfilerActivity, profile

    import wayne_tpu_torch.parallel.ensemble as ensemble
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.parallel.dataset import sweep_scenes

    obs = Observation(load_yaml(HEADLINE))
    n_exp = obs.plan.n_exposures
    ens = sweep_scenes(obs.scenes, n_mc)
    batches = n_mc * -(-n_exp // CHUNK)

    def run():
        return ensemble.simulate_ensemble_spectra(ens, obs.tables,
                                                  obs.static, chunk=CHUNK)

    def measure() -> dict:
        run()                                           # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        events = prof.events()
        busy_ms, spans = _busy_ms(events)
        return {"wall_s": walls,
                "top_kernels_ms": _top(_per_kernel_ms(events)),
                "exp_per_s": [n_mc * n_exp / w for w in walls],
                "visits_per_s": [n_mc / w for w in walls],
                "profiled_wall_s": prof_wall, "device_busy_ms": busy_ms,
                "device_idle_share_of_unprofiled_wall":
                    1.0 - busy_ms / (min(walls) * 1e3),
                "kernels_per_exposure_batch": len(spans) / batches}

    full = measure()
    reduce = ensemble._reduce
    ensemble._reduce = lambda res, tables, cfg, *rest: torch.zeros(
        res.reads_dn.shape[0], cfg.subarray, device=res.reads_dn.device)
    try:
        sim = measure()
    finally:
        ensemble._reduce = reduce
    return {
        "visit": f"{os.path.basename(HEADLINE)}, {n_exp} exposures, "
                 f"{n_mc} realisations, chunk {CHUNK}",
        "ensemble": full, "simulation_only": sim,
        "extraction_share_of_wall":
            1.0 - min(sim["wall_s"]) / min(full["wall_s"]),
        "extraction_share_of_device_busy":
            1.0 - sim["device_busy_ms"] / full["device_busy_ms"],
    }


def _profile_other(tree: str) -> dict:
    """``profile_route`` of the per-read route of the package in checkout
    ``tree``, run in a process of its own (``--per-read-of``)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--per-read-of", tree],
        check=True, capture_output=True, text=True, timeout=600)
    return json.loads(proc.stdout.strip().splitlines()[-1])


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
                    help="another checkout (e.g. the parent commit's) whose "
                    "kernels are timed in turns with the port's and whose "
                    "per-read route is profiled")
    ap.add_argument("--per-read-of", default=None, metavar="DIR",
                    help="only profile the per-read route of checkout DIR's "
                    "package and print it as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_perf_breakdown.py needs a CUDA card")
    sys.stdout.reconfigure(line_buffering=True)
    if args.per_read_of:
        sys.path.insert(0, os.path.abspath(args.per_read_of))
        print(json.dumps(profile_route(headline_observation()[1], False)))
        return 0

    from wayne_tpu_torch.calibration import sample_sequence_times
    from wayne_tpu_torch.ops import readout as ro

    cfg, obs = headline_observation()
    n = obs.plan.n_exposures
    print("profiling both routes")
    routes = {"whole_exposure": profile_route(obs, True),
              "per_read": profile_route(obs, False)}
    obs.static = dataclasses.replace(obs.static, fused_reads=True)
    print("profiling the Monte-Carlo ensemble")
    routes["ensemble"] = profile_ensemble()
    if args.parent:
        print(f"profiling the per-read route of {args.parent}")
        routes["parent_per_read"] = _profile_other(args.parent)

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
    # the per-read steps at read 8 of the synthetic chunk, noise on; the
    # banded step also with IPC on, and without hits or with a zero band,
    # which splits its time
    syn, k = inputs["synthetic"][0], NR // 2
    _, cums = step_reads(ro.read_step_banded, None, syn, False, NOISE_ON)
    step_on = {f: v for f, v in NOISE_ON.items()
               if f not in ("with_cr", "ipc")}
    banded = dict(step_args(syn, k, cums[:, k - 1].contiguous(), False,
                            True), **NOISE_ON)
    full = dict(step_args(syn, k, cums[:, k - 1].contiguous(), True, True),
                **step_on)
    steps = {
        "read_step_banded": (ro.read_step_banded, banded, banded_reference),
        "read_step_banded/ipc": (ro.read_step_banded, dict(banded, ipc=True),
                                 banded_reference),
        "read_step_banded/no_cr": (ro.read_step_banded,
                                   dict(banded, with_cr=False),
                                   banded_reference),
        "read_step_banded/zero_band": (
            ro.read_step_banded,
            dict(banded, band=torch.zeros_like(banded["band"])),
            banded_reference),
        "read_step": (ro.read_step, full, ro.read_step_plain)}

    out = {
        "card": card_line(), "device": torch.cuda.get_device_name(0),
        "visit": f"wasp43b_g141_scan, {cfg.n_orbits} orbit(s), {n} "
                 f"exposures, chunk {CHUNK}",
        **routes,
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
