#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wayne_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the readout kernels from ``wayne_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, in parallel, linked into one library) and then:

1. holds the whole-exposure kernel against its plain PyTorch version on
   the card at both shapes the main path launches it at: a chunk of the
   visit (S = 512, 16 reads, the auto band, the config's MAX_CR, 8
   exposures) on synthetic inputs, and the direct image (1 exposure,
   direct_image_nsamp + 1 reads, the full-frame window W = S, on the main
   path's inputs): noise off with IPC off and on, and noise on with the
   same Philox draws, each bit for bit (100% of pixels identical, a second
   run too); then the Poisson regimes' moments and the read-noise sigma;
2. drives the main path at full width: ``examples/wasp43b_g141_scan.yml``
   (512^2, NSAMP 15, n_lambda 512, the default noise chain), cut to one
   orbit: ``Observation.simulate()`` and ``Observation.generate()`` for
   the direct image and the first chunk, read back with ``read_ima``. The
   readout's launch counter, zeroed just before, shows the path went
   through the kernel. The arguments of the first ``simulate()`` chunk's
   readout call are recorded on the way, and the kernel is then held
   against its plain version on them as in 1, and timed;
3. holds the per-read kernels against their plain versions, read by read
   over the chunk's 16 reads: the banded step at W = 32 on the expected
   band (its plain reference samples the band with ``sample_band`` first)
   and the full-frame step at W = S, with the bars of phase 1;
4. drives the per-read path (``fused_reads=False``) of the same visit:
   ``simulate()`` through the banded step (16 launches per chunk, none of
   the whole-exposure kernel), its reads against the whole-exposure
   route's, then one chunk with ``band_px: 0`` through the full-frame step
   (16 launches), each beside the whole-exposure route's rate;
5. drives the Monte-Carlo dataset path at full width: ``python -m
   wayne_tpu_torch.run_dataset`` on the whole headline visit (every
   planned exposure) for 4 realisations in 2 chunk files, Rp/Rs swept.
   B1 launches once per exposure batch (no per-read step), the npz files
   and the manifest are the JAX package's, B1 is held against its plain
   version bit for bit on the first ensemble batch's recorded arguments,
   and that batch's ``extract_spectra_cr`` on the card against the CPU at
   rtol 1e-5; a second run gives exposures/s and visits/s. B1's launch
   count in the JSON line adds this phase's to the main path's.

Throughout, it times each kernel L2-warm and L2-cold (``device_ms``; the
JSON line takes the cold time), its plain version and ``simulate()`` on
both routes, and prints each kernel's bound (the bytes over the memory
rate against the operations over the rates of their pipes, see
``_bound``) beside the yardstick of the port's first slices.

Prints the card's name and power limit first, a JSON line with the
kernels' numbers before the last line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. It
needs a CUDA card and the repository around it, and fails without either.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "examples", "wasp43b_g141_scan.yml")
ORBITS = 1                  # the headline visit cut to one orbit
CHUNK = 8                   # exposures per readout launch
H100_BYTES_S = 3.35e12      # HBM3 rate (NVIDIA data sheet, H100 SXM)
H100_SMS, H100_CLOCK_HZ = 132, 1.98e9
FLUSH_BYTES = 128 << 20     # read before each L2-cold launch (L2: 50 MB)
# Lanes per clock per SM for compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 32-bit integer add, multiply,
# shift and logic at 64; fp32 add and multiply at 128, which is also the
# issue rate (4 schedulers x 32 lanes). The integer work splits over two
# pipes of 64 lanes each: IMAD issues on the FMA-heavy pipe, LOP3, IADD3,
# shifts and compares on the ALU pipe. No FMA: the kernels build with
# --fmad=false.
IMAD_OPS_S = 64 * H100_SMS * H100_CLOCK_HZ      # 16.7e12
ALU_OPS_S = 64 * H100_SMS * H100_CLOCK_HZ       # 16.7e12
ISSUE_OPS_S = 128 * H100_SMS * H100_CLOCK_HZ    # 33.5e12
# (IMAD, ALU, other) operations of each piece of a pixel's read. A
# Philox4x32-10 block after the first of a kernel adds 42 SASS
# instructions: 20 IMAD.WIDE.U32 and an IMAD.SHL, 20 LOP3.LUT, one more
# (the key schedule moves to the uniform datapath; torch_perf_breakdown.py,
# "philox_sass", on an H100). Each transcendental (log, sqrt, sin, cos,
# exp) counts as one operation, a floor: without fast math each compiles
# to a sequence.
COSTS = {
    "philox": (21, 20, 1),
    "box_muller": (0, 2, 14),  # 2 x (shift; convert, scale, floor); log,
    #                            x -2, sqrt, x 2 pi, sin, cos, 2 products
    "sampler": (0, 0, 12),     # lam > 0, < 3, < 100; skew z z - 1, / 6;
    #                            sqrt, x z, 2 adds, round, max
    "small_lam": (0, 1, 64),   # the uniform (shift; convert, scale,
    #                            floor), exp, 12 x (add, compare, add, 2
    #                            products)
    "readout": (0, 0, 16),     # accumulate, nonlin, bias, noise, gain
    "cr": (0, 0, 1),           # one deposit
}
# The yardstick of the first two slices, printed beside the new bound:
# every operation at the 67 T/s fp32 rate with FMA counted as two
OLD_OPS_S = 67e12
OLD_OPS = {"philox": 98, "box_muller": 10, "sampler": 10, "small_lam": 40,
           "readout": 16, "cr": 1}
# the default noise chain's readout flags (IPC off)
NOISE_ON = dict(poisson=True, read_noise=True, non_linearity=True, bias=True,
                scalar_gain=False, with_cr=True, bg_poisson=True, ipc=False)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 2, windows: int = 1) -> float:
    """Time per call of ``fn`` on the card (CUDA events around ``reps``
    calls, enqueued by the host as it goes), the median of ``windows`` such
    windows. Where the host takes longer to enqueue a call than the card
    to run it, this is the host's time: see ``kernel_times``."""
    import statistics

    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int, cold: bool) -> float:
    """Median time of one launch of ``fn`` on the card: each launch between
    its own pair of CUDA events, all enqueued behind a sleeping kernel so
    that the host's launch overhead never paces the card (the sleep grows
    until the host has enqueued every launch before the card wakes).
    L2-warm: the launches back to back on the same tensors; L2-cold
    (``cold``): each launch after a read of FLUSH_BYTES, which evicts its
    inputs from the card's 50 MB L2 and leaves no dirty lines behind.
    Fails if the host cannot get ahead of a sleep of a billion cycles."""
    import statistics

    import torch
    flush = torch.zeros(FLUSH_BYTES // 4, device="cuda") if cold else None
    fn()
    for cycles in (10**7, 10**8, 10**9):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        awake = torch.cuda.Event()
        awake.record()
        events = []
        for _ in range(reps):
            if cold:
                flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        ahead = not awake.query()
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(s.elapsed_time(e) for s, e in events)
    raise RuntimeError(f"the host did not enqueue {reps} launches ahead of "
                       f"a sleep of {cycles} cycles")


def kernel_times(fn, reps: int) -> dict:
    """``fn``'s time per launch L2-warm and L2-cold (``device_ms``), beside
    the earlier slices' host-paced figure (``cuda_ms``, 5 windows) and the
    host's time to enqueue one call."""
    import torch
    warm = device_ms(fn, reps, cold=False)
    cold = device_ms(fn, reps, cold=True)
    paced = cuda_ms(fn, reps, windows=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dict(warm_ms=warm, cold_ms=cold, paced_ms=paced, host_ms=host,
                ms=cold)


def times_line(t: dict) -> str:
    return (f"L2-warm {t['warm_ms']:.4f} ms/launch, L2-cold "
            f"{t['cold_ms']:.4f} ms/launch (host-paced {t['paced_ms']:.4f}, "
            f"host enqueue {t['host_ms']:.4f} ms/call)")


# ---------------------------------------------------------------------------
# Phase 1: the kernel against its plain version
# ---------------------------------------------------------------------------

def readout_inputs(B, NR, W, S, n_cr, read_times, seed=0, dev="cuda"):
    """Headline-shaped readout inputs made on the card from a seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    dts = torch.diff(torch.as_tensor(read_times, dtype=torch.float32,
                                     device=dev), prepend=torch.zeros(
                                         1, device=dev)).expand(B, NR)
    bands = 2000.0 * u(B, NR, W, S)
    bands[:, 0] = 0.0
    y0s = (torch.randint(0, (S - W) // 8 + 1, (B, NR), generator=g,
                         device=dev) * 8).to(torch.int32)
    y0s[:, 0] = 0
    bg = 2.0 * u(B, S, S)
    bg[:, :, :5] = 0.0                      # zero-rate class: exactly 0
    bg[:, :, 5:40] *= 0.5                   # dark-like small-lambda class
    cr_pos = torch.randint(0, S, (B, NR, 2, n_cr), generator=g,
                           device=dev).to(torch.int32)
    cr_q = 1000.0 * -torch.log(u(B, NR, n_cr).clamp_min(1e-7))
    cr_q[:, :, n_cr // 2:] = 0.0            # beyond the hit count
    cr_q[:, 0] = 0.0
    tabs = dict(
        bias=2500.0 + 12.0 * torch.randn((S, S), generator=g, device=dev),
        inv_gain=1.0 / (2.5 * (1 + 0.003 * torch.randn(
            (S, S), generator=g, device=dev))),
        nl=torch.tensor([0.012, 0.012, 0.016], device=dev)[:, None, None]
        * (1 + 0.03 * torch.randn((3, S, S), generator=g, device=dev)))
    seed_w = torch.randint(-2**31, 2**31 - 1, (B, 2), generator=g,
                           device=dev).to(torch.int32)
    consts = (20.0, 78000.0, 2.5, 0.015)
    return (seed_w, y0s, dts.contiguous(), bands, bg, tabs["bias"],
            tabs["inv_gain"], tabs["nl"], cr_pos, cr_q, consts)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: int, work: dict) -> dict:
    """The least time (ms) for moving ``nbytes`` and doing ``work`` (how
    many of each piece of COSTS): the largest of the bytes over the memory
    rate, the IMAD and the ALU operations over their pipes' rates and all
    operations over the issue rate, and which of them binds
    (``bound_term``); beside it the first two slices' yardstick
    (``old_*``)."""
    n_imad, n_alu, n_other = (sum(n * COSTS[p][i] for p, n in work.items())
                              for i in range(3))
    t = dict(bytes_ms=nbytes / H100_BYTES_S * 1e3,
             imad_ms=n_imad / IMAD_OPS_S * 1e3,
             alu_ms=n_alu / ALU_OPS_S * 1e3,
             issue_ms=(n_imad + n_alu + n_other) / ISSUE_OPS_S * 1e3)
    t["ops_ms"] = max(t["imad_ms"], t["alu_ms"], t["issue_ms"])
    t["bound_term"] = max(("bytes", "imad", "alu", "issue"),
                          key=lambda term: t[term + "_ms"])
    old_ops_ms = sum(n * OLD_OPS[p] for p, n in work.items()) / OLD_OPS_S * 1e3
    for key, ops_ms in (("", t["ops_ms"]), ("old_", old_ops_ms)):
        t[key + "bound_ms"] = max(t["bytes_ms"], ops_ms)
        t[key + "bound_by"] = ("bytes" if t["bytes_ms"] >= ops_ms
                               else "operations")
    return t


def _read_work(lam, px_reads: int, cr_q, flags) -> dict:
    """How many of each piece of COSTS the background sampler, the normals
    and the readout chain of ``px_reads`` pixel-reads with background
    ``lam`` need, and ``cr_q``'s deposits."""
    work = dict(readout=px_reads, philox=0, box_muller=0, sampler=0,
                small_lam=0, cr=0 if cr_q is None else int((cr_q != 0).sum()))
    n_normal = px_reads if flags["read_noise"] else 0
    if flags["poisson"] and flags.get("bg_poisson", True):
        # what these inputs need: a normal where lambda >= 3, a uniform and
        # the exact sum where 0 < lambda < 3, nothing where lambda = 0
        gauss = int((lam >= 3).sum())
        small = int(((lam > 0) & (lam < 3)).sum())
        if not flags["read_noise"]:
            n_normal = gauss
        work["sampler"] += gauss
        work["philox"] += small
        work["small_lam"] += small
    work["philox"] += n_normal
    work["box_muller"] += n_normal
    return work


def bound_of(args, flags) -> dict:
    """Least time for the whole-exposure readout on these inputs: bytes
    each input and output moves once, and the operations this run's data
    needs (see _bound)."""
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, _ = args
    B, NR, W, S = bands.shape
    nbytes = _nbytes(seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos,
                     cr_q) + (B * NR * S * S + B * S * S) * 4  # reads + cum
    work = _read_work(bg[:, None] * dts[:, :, None, None], B * NR * S * S,
                      cr_q if flags.get("with_cr", True) else None, flags)
    if flags["poisson"]:
        _add_band_work(work, bands)
    return _bound(nbytes, work)


def _add_band_work(work: dict, bands) -> None:
    """Adds to ``work`` the in-kernel Poisson draw of the expected
    ``bands``: a Philox block, Box-Muller and the sampler where lambda >= 3,
    a Philox block and the exact sum where 0 < lambda < 3, nothing where
    lambda = 0."""
    gauss = int((bands >= 3).sum())
    small = int(((bands > 0) & (bands < 3)).sum())
    for piece in ("philox", "box_muller", "sampler"):
        work[piece] += gauss
    work["philox"] += small
    work["small_lam"] += small


def step_bound_of(kw, flags) -> dict:
    """Least time for one per-read step on its keyword arguments ``kw``:
    the banded step (``kw`` has a band) draws its band in-kernel when
    ``poisson``; the full-frame step's add frame comes sampled."""
    import torch
    tensors = [v for v in kw.values() if isinstance(v, torch.Tensor)]
    B, S, _ = kw["cum"].shape
    nbytes = _nbytes(*tensors) + 2 * B * S * S * 4          # cum out + dn
    cr_q = kw.get("cr_q") if flags.get("with_cr", True) else None
    work = _read_work(kw["bg_rate"] * kw["dt"][:, None, None], B * S * S,
                      cr_q, flags)
    if "band" in kw and flags["poisson"]:
        _add_band_work(work, kw["band"])
    return _bound(nbytes, work)


def bound_line(b: dict) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
            f"{b['bound_term']} binds (bytes {b['bytes_ms']:.4f} ms, IMAD "
            f"pipe {b['imad_ms']:.4f} ms, ALU pipe {b['alu_ms']:.4f} ms, "
            f"issue {b['issue_ms']:.4f} ms); the first slices' yardstick "
            f"{b['old_bound_ms']:.4f} ms by {b['old_bound_by']}")


def small_lambda_warp_share(args) -> float:
    """Share of the warp-reads (32 neighbouring pixels of one row, one
    read) of the whole-exposure readout on ``args`` in which some pixel
    takes the exact small-lambda branch (0 < lambda < 3), of the background
    or of the band."""
    import torch
    _, y0s, dts, bands, bg = args[:5]
    B, NR, W, S = bands.shape
    small = lambda lam: (lam > 0) & (lam < 3)
    hit = small(bg[:, None] * dts[:, :, None, None])          # (B, NR, S, S)
    rows = (y0s.long()[..., None] + torch.arange(W, device=bands.device)
            )[..., None].expand(B, NR, W, S)
    hit.scatter_(2, rows, torch.gather(hit, 2, rows) | small(bands))
    pad = -S % 32
    hit = torch.nn.functional.pad(hit, (0, pad)) if pad else hit
    return float(hit.view(B, NR, S, -1, 32).any(-1).float().mean())


def first_call(module, name: str, run) -> tuple:
    """``run()``'s result and the arguments, by name, of the first call of
    ``module.name`` during ``run()``."""
    import inspect

    real, seen = getattr(module, name), []

    def record(*args, **kw):
        if not seen:
            seen.append(inspect.signature(real).bind(*args, **kw).arguments)
        return real(*args, **kw)

    setattr(module, name, record)
    try:
        result = run()
    finally:
        setattr(module, name, real)
    call, = seen
    return result, call


def recorded_readout(run) -> tuple:
    """``run()``'s result and the readout's arguments and flags exactly as
    the main path gives them, recorded from the first ``exposure_readout``
    call of ``run()``: (result, (the eleven array and scalar arguments in
    order, the keyword flags))."""
    import inspect

    import wayne_tpu_torch.ops.exposure as ex
    result, call = first_call(ex, "exposure_readout", run)
    names = [p.name for p in inspect.signature(
        ex.exposure_readout).parameters.values()
        if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    return result, (tuple(call[n] for n in names),
                    {k: v for k, v in call.items() if k not in names})


def hold_against_plain(kernel, plain, on: dict, label: str,
                       variants=({"ipc": False}, {"ipc": True})
                       ) -> list[float]:
    """Kernel against plain version on the same inputs: ``kernel(flags)``
    and ``plain(flags)`` return (reads, cum). Both outputs must be
    bit-identical: noise off with each of ``variants``, then ``on`` (noise
    on, the same Philox draws), whose second run must repeat the first.
    Returns the max abs errors (DN)."""
    import torch
    errs = []
    for name, flags in [(f"noise off {extra}",
                         dict(on, poisson=False, read_noise=False, **extra))
                        for extra in variants] + [("noise on", on)]:
        got, cum = kernel(flags)
        want, cum_w = plain(flags)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        same = float((got == want).float().mean())
        check(torch.equal(got, want) and torch.equal(cum, cum_w),
              f"{label}, {name}: max abs err {errs[-1]:.3g} DN, "
              f"{same * 100:.4f}% of pixels identical to the plain version "
              "(100%), the charge identical")
    again, _ = kernel(on)
    check(torch.equal(got, again),
          f"{label}, noise on: a second run is bit-identical")
    return errs


def time_readout(ro, args, flags, label: str, card: str) -> dict:
    """The whole-exposure kernel's and its plain version's time on
    ``args``, beside its bound and the share of warps in the exact
    small-lambda branch."""
    B = args[3].shape[0]
    t = kernel_times(lambda: ro.exposure_readout(*args, **flags), reps=20)
    plain_ms = cuda_ms(lambda: ro.exposure_readout_plain(*args, **flags),
                       reps=2, warmup=1)
    b = bound_of(args, flags)
    ms = t["ms"]
    print(f"timing [{card}]: readout kernel on {label} {times_line(t)} "
          f"({ms / B:.4f} ms/exposure L2-cold, B={B}), plain version "
          f"{plain_ms:.3f} ms, {bound_line(b)}; {b['bound_ms'] / ms:.1%} of "
          f"the bound L2-cold ({b['old_bound_ms'] / ms:.1%} of the old); "
          f"{small_lambda_warp_share(args):.2%} of warp-reads take the "
          "exact small-lambda branch")
    return dict(b, **t, plain_ms=plain_ms)


def phase_kernel(cfg, obs, card: str) -> tuple[dict, tuple]:
    from wayne_tpu_torch.calibration import sample_sequence_times
    from wayne_tpu_torch.ops import readout as ro

    S, NR = cfg.subarray, cfg.nsamp + 1
    st = obs.static
    W, n_cr, B = st.band_px, st.max_cr_per_read, CHUNK
    times = sample_sequence_times(cfg.samp_seq, cfg.nsamp, S)
    args = readout_inputs(B, NR, W, S, n_cr, times)
    print(f"phase 1: kernel vs plain, chunk B={B} NR={NR} S={S} W={W} "
          f"MAX_CR={n_cr}, synthetic inputs")
    errs = hold_against_plain(
        lambda f: ro.exposure_readout(*args, **f),
        lambda f: ro.exposure_readout_plain(*args, **f), NOISE_ON, "chunk")
    _, direct = recorded_readout(obs.simulate_direct_image)
    errs += hold_recorded(ro, direct, "phase 1", "direct image")
    moments(ro, S, W, B)

    # timings at the chunk's shape with the noise on
    whole = time_readout(ro, args, NOISE_ON, "the synthetic chunk", card)
    return dict(whole, max_abs_err=max(errs)), args


def hold_recorded(ro, recorded, phase: str, label: str) -> list[float]:
    """The kernel against its plain version on ``recorded`` arguments and
    flags (``recorded_readout``); returns the max abs errors (DN)."""
    rec_args, rec_flags = recorded
    print(f"{phase}: kernel vs plain, {label} (B, NR, W, S) = "
          f"{tuple(rec_args[3].shape)}, the main path's inputs and flags "
          f"{rec_flags}")
    return hold_against_plain(
        lambda f: ro.exposure_readout(*rec_args, **f),
        lambda f: ro.exposure_readout_plain(*rec_args, **f), rec_flags,
        label)


def moments(ro, S, W, B) -> None:
    """Per-regime Poisson moments and the read-noise sigma of the kernel.
    bg columns: lambda = 0, 0.5, 12, 500 per read (dt = 1 s); the band
    rows [0, W) carry lambda = 2 (the band's exact branch) where bg = 0."""
    import torch
    dev = "cuda"
    NR = 16
    q = S // 4
    bg = torch.zeros((B, S, S), device=dev)
    for j, lam in enumerate((0.0, 0.5, 12.0, 500.0)):
        bg[:, :, j * q:(j + 1) * q] = lam
    dts = torch.ones((B, NR), device=dev)
    dts[:, 0] = 0.0
    bands = torch.full((B, NR, W, S), 2.0, device=dev)
    bands[:, 0] = 0.0
    y0s = torch.zeros((B, NR), dtype=torch.int32, device=dev)
    ones = torch.ones((S, S), device=dev)
    zeros = torch.zeros((S, S), device=dev)
    seed = torch.arange(2 * B, dtype=torch.int32, device=dev).view(B, 2)
    cr_pos = torch.zeros((B, NR, 2, 8), dtype=torch.int32, device=dev)
    cr_q = torch.zeros((B, NR, 8), device=dev)
    nl = torch.zeros((3, S, S), device=dev)
    flags = dict(non_linearity=False, bias=False, scalar_gain=False,
                 with_cr=False, bg_poisson=True)
    reads, _ = ro.exposure_readout(
        seed, y0s, dts, bands, bg, zeros, ones, nl, cr_pos, cr_q,
        (0.0, 78000.0, 1.0, 0.0), poisson=True,
        read_noise=False, **flags)
    inc = torch.diff(reads, dim=1).double()           # per-read samples
    body = inc[:, :, W:]                              # rows outside the band
    cls = [body[..., j * q:(j + 1) * q] for j in range(4)]
    check(bool((cls[0] == 0).all()), "lambda = 0: exactly 0")
    for lam, c, dm, dv in ((0.5, cls[1], 0.01, 0.01),
                           (12.0, cls[2], 0.05, 0.25),
                           (500.0, cls[3], 0.5, 5.0)):
        m, v = float(c.mean()), float(c.var())
        check(abs(m - lam) < dm and abs(v - lam) < dv,
              f"lambda = {lam}: mean {m:.4f}, var {v:.4f}")
    check(bool((cls[1] == torch.round(cls[1])).all())
          and float(cls[1].min()) == 0.0, "lambda = 0.5: integer counts >= 0")
    band = inc[:, :, :W, :q]
    m, v = float(band.mean()), float(band.var())
    check(abs(m - 2.0) < 0.01 and abs(v - 2.0) < 0.02,
          f"band lambda = 2: mean {m:.4f}, var {v:.4f}")
    reads, _ = ro.exposure_readout(
        seed, y0s, dts, torch.zeros_like(bands), torch.zeros_like(bg),
        zeros, ones, nl, cr_pos, cr_q,
        (20.0, 78000.0, 1.0, 0.0), poisson=False,
        read_noise=True, **flags)
    sd, mu = float(reads.double().std()), float(reads.double().mean())
    check(abs(sd - 20.0) < 0.5 and abs(mu) < 0.1,
          f"read noise: sigma {sd:.4f} e- (20), mean {mu:.4f}")


# ---------------------------------------------------------------------------
# Phase 2: the main path at full width
# ---------------------------------------------------------------------------

def headline_observation():
    """(config, Observation) of the headline visit cut to ORBITS orbits, on
    the card."""
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation

    cfg = load_yaml(HEADLINE)
    print(f"{os.path.relpath(HEADLINE, HERE)} cut from num_orbits="
          f"{cfg.n_orbits} to num_orbits={ORBITS} (512^2, NSAMP={cfg.nsamp}, "
          f"n_lambda={cfg.n_lambda})")
    cfg.n_orbits = ORBITS
    return cfg, Observation(cfg)


def phase_main_path(cfg, obs, card: str) -> tuple[int, list[float]]:
    import dataclasses

    import numpy as np
    import torch

    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.ops.readout import exposure_readout

    print("phase 2: the main path")
    chunk = CHUNK
    n = obs.plan.n_exposures
    n_chunks = math.ceil(n / chunk)

    exposure_readout.launches = 0
    t0 = time.time()
    res, recorded = recorded_readout(lambda: obs.simulate(chunk=chunk))
    torch.cuda.synchronize()
    t_first = time.time() - t0
    sim_launches = exposure_readout.launches
    reads = res.reads_dn
    check(tuple(reads.shape) == (n, cfg.nsamp + 1, 512, 512),
          f"simulate(): reads_dn {tuple(reads.shape)}")
    check(bool(torch.isfinite(reads).all()), "simulate(): reads finite")
    ramp = reads.double().sum(dim=(-2, -1))
    check(bool((torch.diff(ramp, dim=1) > 0).all()),
          "simulate(): every exposure's frame-sum ramp is monotone")
    check(sim_launches == n_chunks,
          f"simulate(): {sim_launches} kernel launches == {n_chunks} chunks "
          f"of {chunk} ({n} exposures)")

    with tempfile.TemporaryDirectory() as out:
        one_chunk = dataclasses.replace(cfg, exposures_per_orbit=chunk)
        gen = Observation(one_chunk)
        paths = gen.generate(out, chunk=chunk, progress=lambda s: None)
        launches = exposure_readout.launches
        direct = os.path.join(out, f"{cfg.star.name}_direct.fits")
        check(len(paths) == chunk and os.path.exists(direct),
              f"generate(): {len(paths)} ima files + the direct image")
        for p in (paths[0], paths[-1], direct):
            hdr, r, times = read_ima(p)
            check(hdr["NSAMP"] == (cfg.nsamp + 1 if p != direct
                                   else cfg.direct_image_nsamp + 1)
                  and hdr["INSTRUME"] == "WFC3" and "EXPSTART" in hdr
                  and np.isfinite(r).all(),
                  f"{os.path.basename(p)}: NSAMP={hdr['NSAMP']}, "
                  f"FILTER={hdr['FILTER']}, {r.shape} finite")
        hdr, _, _ = read_ima(paths[0])
        check(hdr["SAMP_SEQ"] == cfg.samp_seq and hdr["SUBTYPE"] == "SQ512SUB"
              and hdr["TARGNAME"] == cfg.star.name,
              "ima header keys (SAMP_SEQ, SUBTYPE, TARGNAME)")
    check(launches == sim_launches + 2,
          f"main path: {launches} launches (simulate {sim_launches}, "
          "generate: direct image + 1 chunk)")

    t0 = time.time()
    obs.simulate(chunk=chunk)
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"timing [{card}]: simulate() {n} exposures in {wall:.3f} s = "
          f"{n / wall:.2f} exposures/s (first call {t_first:.3f} s)")

    errs = hold_recorded(ro, recorded, "phase 2", "main-path chunk")
    time_readout(ro, *recorded, "the main path's chunk", card)
    return launches, errs


# ---------------------------------------------------------------------------
# Phase 3: the per-read kernels against their plain versions
# ---------------------------------------------------------------------------

def step_args(args, k: int, cum, full_frame: bool, poisson: bool) -> dict:
    """A per-read step's arguments for read k of the phase-1 chunk inputs,
    built as the per-read path builds them: the banded step takes the
    expected band at its row (it samples the band itself); the full-frame
    step takes the band placed in a zero frame and sampled when
    ``poisson``, plus the read's hits in list order."""
    import torch

    from wayne_tpu_torch.ops.readout import add_hits, sample_band

    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, consts = args
    B, _, W, S = bands.shape
    kw = dict(seed=seed, read=k, dt=dts[:, k].contiguous(), cum=cum,
              bg_rate=bg, bias_map=bias, inv_gain=inv_gain, nl_coeffs=nl,
              consts=consts)
    y0, band = y0s[:, k].contiguous(), bands[:, k]
    if not full_frame:
        return dict(kw, y0=y0, band=band.contiguous(),
                    cr_pos=cr_pos[:, k].contiguous(),
                    cr_q=cr_q[:, k].contiguous())
    rows = y0.long()[:, None] + torch.arange(W, device=y0.device)
    frame = torch.zeros_like(cum).scatter(
        1, rows[:, :, None].expand(B, W, S), band)
    if poisson:
        frame = sample_band(seed, k, torch.zeros_like(y0), frame)
    return dict(kw, add=add_hits(frame, cr_pos[:, k], cr_q[:, k]))


def banded_reference(**kw):
    """The banded step's plain reference: the expected band sampled
    (``sample_band``) when ``poisson``, then ``read_step_banded_plain``."""
    from wayne_tpu_torch.ops.readout import (
        read_step_banded_plain, sample_band,
    )
    if kw["poisson"]:
        kw = dict(kw, band=sample_band(kw["seed"], kw["read"], kw["y0"],
                                       kw["band"]))
    return read_step_banded_plain(**kw)


def step_reads(step, plain, args, full_frame: bool, flags: dict):
    """The chunk's reads through the per-read kernel ``step``, one launch
    per read from zero charge; with ``plain``, each read's outputs come
    from the plain version instead, on the kernel's charge and the same
    inputs. Returns (dn, cum after each read), (B, NR, S, S) each."""
    import torch
    B, NR, _, S = args[3].shape
    cum = torch.zeros((B, S, S), device=args[3].device)
    dns, cums = [], []
    for k in range(NR):
        kw = step_args(args, k, cum, full_frame, flags["poisson"])
        cum, dn = step(**kw, **flags)
        if plain is None:
            cums.append(cum)
        else:
            cum_p, dn = plain(**kw, **flags)
            cums.append(cum_p)
        dns.append(dn)
    return torch.stack(dns, 1), torch.stack(cums, 1)


def phase_steps(args, card: str) -> dict:
    from wayne_tpu_torch.ops import readout as ro

    B, NR, W, S = args[3].shape
    step_on = {k: v for k, v in NOISE_ON.items()
               if k not in ("with_cr", "ipc")}
    out = {}
    for name, step, plain, full_frame, on, variants in (
            ("read_step_banded", ro.read_step_banded,
             banded_reference, False, NOISE_ON,
             ({"ipc": False}, {"ipc": True})),
            ("read_step", ro.read_step, ro.read_step_plain, True, step_on,
             ({},))):
        print(f"phase 3: {name} vs plain, chunk B={B}, {NR} reads, S={S}, "
              f"W={S if full_frame else W}")
        errs = hold_against_plain(
            lambda f: step_reads(step, None, args, full_frame, f),
            lambda f: step_reads(step, plain, args, full_frame, f),
            on, name, variants)
        # one launch in the middle of the ramp, noise on
        k = NR // 2
        _, cums = step_reads(step, None, args, full_frame, on)
        kw = step_args(args, k, cums[:, k - 1].contiguous(), full_frame, True)
        for extra in variants[1:]:             # IPC on: timed, not listed
            f = dict(on, **extra)
            t = kernel_times(lambda: step(**kw, **f), reps=50)
            print(f"timing [{card}]: {name} kernel with {extra} "
                  f"{times_line(t)}; {bound_line(step_bound_of(kw, f))}")
        t = kernel_times(lambda: step(**kw, **on), reps=50)
        plain_ms = cuda_ms(lambda: plain(**kw, **on), reps=2, warmup=1)
        b = step_bound_of(kw, on)
        print(f"timing [{card}]: {name} kernel {times_line(t)} (B={B}, "
              f"read {k}), plain version {plain_ms:.3f} ms, {bound_line(b)}; "
              f"{b['bound_ms'] / t['cold_ms']:.1%} of the bound L2-cold, "
              f"{b['bound_ms'] / t['warm_ms']:.1%} L2-warm")
        out[name] = dict(b, **t, max_abs_err=max(errs), plain_ms=plain_ms)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the per-read path at full width
# ---------------------------------------------------------------------------

def phase_per_read(cfg, obs, card: str) -> dict:
    import dataclasses

    import torch

    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro

    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    nr = cfg.nsamp + 1

    def drive(o):
        """simulate() with every launch count zeroed just before and read
        just after."""
        for f in kernels:
            f.launches = 0
        t0 = time.time()
        res = o.simulate(chunk=CHUNK)
        torch.cuda.synchronize()
        return res.reads_dn, time.time() - t0, [f.launches for f in kernels]

    def ramp_ok(reads, n, label):
        S = cfg.subarray
        check(tuple(reads.shape) == (n, nr, S, S)
              and bool(torch.isfinite(reads).all()),
              f"{label}: reads_dn {tuple(reads.shape)} finite")
        ramp = reads.double().sum(dim=(-2, -1))
        check(bool((torch.diff(ramp, dim=1) > 0).all()),
              f"{label}: every exposure's frame-sum ramp is monotone")

    def same_as_fused(o, reads, label):
        """The reads against the whole-exposure route's; returns that
        route's time for the same simulate()."""
        static = o.static
        o.static = dataclasses.replace(static, fused_reads=True)
        try:
            fused, wall, _ = drive(o)
        finally:
            o.static = static
        same = float((reads == fused).float().mean())
        check(same >= 0.999, f"{label}: {same * 100:.4f}% of pixels "
              "identical to the whole-exposure route's (>= 99.9%)")
        return wall

    print("phase 4: the per-read path (fused_reads=False)")
    n = obs.plan.n_exposures
    n_chunks = math.ceil(n / CHUNK)
    fused_static = obs.static
    obs.static = dataclasses.replace(fused_static, fused_reads=False)
    try:
        reads, t_first, (b1, b2, b3) = drive(obs)
        ramp_ok(reads, n, "simulate(), per-read")
        check(b2 == nr * n_chunks and b1 == 0 and b3 == 0,
              f"simulate(), per-read: {b2} banded-step launches == {nr} "
              f"reads x {n_chunks} chunks; {b1} whole-exposure and {b3} "
              "full-frame launches")
        banded_launches = b2
        _, wall, _ = drive(obs)
        wall_f = same_as_fused(obs, reads, "simulate(), per-read")
    finally:
        obs.static = fused_static
    del reads

    one = Observation(dataclasses.replace(cfg, exposures_per_orbit=CHUNK,
                                          band_px=0))
    one.static = dataclasses.replace(one.static, fused_reads=False)
    check(one.static.band_px == 0 and not one.static.noise.ipc,
          "one chunk with band_px: 0 and IPC off (the full-frame route)")
    reads0, t0_first, (b1, b2, b3) = drive(one)
    ramp_ok(reads0, one.plan.n_exposures, "band off, per-read")
    check(b3 == nr and b1 == 0 and b2 == 0,
          f"band off, per-read: {b3} full-frame-step launches == {nr} "
          f"reads x 1 chunk; {b1} whole-exposure and {b2} banded-step "
          "launches")
    _, wall0, _ = drive(one)
    wall0_f = same_as_fused(one, reads0, "band off, per-read")
    n0 = one.plan.n_exposures
    print(f"timing [{card}]: simulate() per-read {n} exposures in "
          f"{wall:.3f} s = {n / wall:.2f} exposures/s (first call "
          f"{t_first:.3f} s), whole-exposure {n / wall_f:.2f} exposures/s; "
          f"band off, per-read {n0} exposures in {wall0:.3f} s = "
          f"{n0 / wall0:.2f} exposures/s (first call {t0_first:.3f} s), "
          f"whole-exposure {n0 / wall0_f:.2f} exposures/s")
    return dict(read_step_banded=banded_launches, read_step=b3)


# ---------------------------------------------------------------------------
# Phase 5: the Monte-Carlo dataset path at full width
# ---------------------------------------------------------------------------

N_MC, CHUNK_MC = 4, 2       # realisations; realisations per chunk file


def phase_dataset(card: str) -> tuple[int, list[float]]:
    """``run_dataset`` on the whole headline visit (every planned exposure)
    for N_MC realisations in chunks of CHUNK_MC, the Rp/Rs swept: B1's
    launches, the files, B1 against its plain version on the first
    ensemble batch's recorded arguments, that batch's extraction on the
    card against the CPU, and the rate of a second run. Returns (B1's
    launches in the first run, B1's max abs errors)."""
    import numpy as np
    import torch

    import wayne_tpu_torch.parallel.dataset as dataset
    import wayne_tpu_torch.parallel.ensemble as ensemble
    from wayne_tpu_torch import run_dataset
    from wayne_tpu_torch.ops import readout as ro

    t_phase = time.time()
    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    print(f"phase 5: the Monte-Carlo dataset path, "
          f"{os.path.relpath(HEADLINE, HERE)} uncut, {N_MC} realisations "
          f"in chunks of {CHUNK_MC}")

    def cli(out: str) -> int:
        return run_dataset.main(
            ["-p", HEADLINE, "-o", out, "--n-mc", str(N_MC), "--chunk-mc",
             str(CHUNK_MC), "--rp-sigma", "0.002"])

    with tempfile.TemporaryDirectory() as out:
        for f in kernels:
            f.launches = 0
        t0 = time.time()
        (rc, extract), recorded = recorded_readout(lambda: first_call(
            ensemble, "extract_spectra_cr", lambda: cli(out)))
        wall_first = time.time() - t0
        b1, b2, b3 = (f.launches for f in kernels)
        with open(os.path.join(out, "manifest.json")) as fh:
            manifest = json.load(fh)
        n_exp = manifest["n_exp"]
        batches = N_MC * math.ceil(n_exp / CHUNK)
        check(rc == 0 and b1 == batches and b2 == 0 and b3 == 0,
              f"run_dataset: {b1} whole-exposure launches == {N_MC} "
              f"realisations x {math.ceil(n_exp / CHUNK)} batches of "
              f"{CHUNK} ({n_exp} exposures); {b2} banded-step and {b3} "
              "full-frame launches")
        files = sorted(n for n in os.listdir(out) if n.endswith(".npz"))
        check(files == manifest["chunks"] == ["chunk_0000.npz",
                                              "chunk_0001.npz"]
              and manifest["n_mc"] == N_MC
              and manifest["chunk_mc"] == CHUNK_MC
              and manifest["labels"] == ["rp"] and manifest["nlincorr"]
              and manifest["dq_aware"] and manifest["subarray"] == 512,
              f"two chunk files and the manifest {sorted(manifest)}")
        for name in files:
            with np.load(os.path.join(out, name)) as z:
                check(set(z.files) == {"spectra_e", "label_rp"}
                      and z["spectra_e"].shape == (CHUNK_MC, n_exp, 512)
                      and np.isfinite(z["spectra_e"]).all(),
                      f"{name}: spectra_e {z['spectra_e'].shape} finite, "
                      "label_rp")
        data = dataset.load_dataset(out)
        spectra = data["spectra_e"]
        check(spectra.shape == (N_MC, n_exp, 512)
              and data["label_rp"].shape == (N_MC,)
              and float(np.median(spectra.max(axis=-1)))
              > 3.0 * float(np.median(spectra)),
              f"load_dataset: spectra {spectra.shape}, the trace above the "
              f"sky (median column {np.median(spectra):.4g} e-, median "
              f"peak {np.median(spectra.max(axis=-1)):.4g} e-)")

    errs = hold_recorded(ro, recorded, "phase 5", "first ensemble batch")
    on_card = ensemble.extract_spectra_cr(**extract)
    on_cpu = ensemble.extract_spectra_cr(**{
        k: v.cpu() if isinstance(v, torch.Tensor) else v
        for k, v in extract.items()})
    diff = float((on_card.cpu() - on_cpu).abs().max())
    scale = float(on_cpu.abs().max())
    check(torch.allclose(on_card.cpu(), on_cpu, rtol=1e-5,
                         atol=1e-5 * scale),
          f"extract_spectra_cr of the first batch {tuple(on_cpu.shape)}, "
          f"card against CPU: max abs diff {diff:.4g} e- (rtol 1e-5, floor "
          f"1e-5 of the largest column, {scale:.4g} e-)")

    # a second run, its generate_dataset timed (it returns once the last
    # chunk, copied from the card, is on disk)
    real, spent = dataset.generate_dataset, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        result = real(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return result

    dataset.generate_dataset = timed
    try:
        with tempfile.TemporaryDirectory() as out:
            cli(out)
    finally:
        dataset.generate_dataset = real
    wall, = spent
    n = N_MC * n_exp
    print(f"timing [{card}]: run_dataset {N_MC} visits x {n_exp} exposures "
          f"in {wall:.3f} s = {n / wall:.2f} exposures/s, "
          f"{N_MC / wall:.3f} visits/s (generate_dataset; first run "
          f"{wall_first:.3f} s with the CLI's set-up); phase 5 took "
          f"{time.time() - t_phase:.1f} s")
    return b1, errs


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "wayne_tpu_torch")):
        print("chip_smoke.py: the wayne_tpu_torch package is not beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from wayne_tpu_torch.ops import readout as ro

    t0 = time.time()
    ro.build(verbose=True)
    print(f"built {os.path.relpath(ro.library_path(), HERE)} in "
          f"{time.time() - t0:.1f} s")
    cfg, obs = headline_observation()
    whole, args = phase_kernel(cfg, obs, card)
    launches, errs = phase_main_path(cfg, obs, card)
    whole["max_abs_err"] = max(whole["max_abs_err"], *errs)
    steps = phase_steps(args, card)
    del args
    per_read = phase_per_read(cfg, obs, card)
    del obs
    ds_launches, ds_errs = phase_dataset(card)
    launches += ds_launches
    whole["max_abs_err"] = max(whole["max_abs_err"], *ds_errs)
    check("jax" not in sys.modules and not any(
        m == "wayne_tpu" or m.startswith("wayne_tpu.") for m in sys.modules),
          "neither jax nor wayne_tpu was imported")
    rows = [("exposure_readout", "readout.cu", 416, launches, whole)]
    rows += [(name, "read_step.cu", line, per_read[name], steps[name])
             for name, line in (("read_step_banded", 598),
                                ("read_step", 546))]
    for name, _, _, _, k in rows:
        print(f"bound [{card}] {name}: {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']} ({k['bound_term']}), the first slices' "
              f"yardstick {k['old_bound_ms']:.4f} ms by "
              f"{k['old_bound_by']}; kernel L2-warm {k['warm_ms']:.4f}, "
              f"L2-cold {k['ms']:.4f} ms/launch, "
              f"{k['bound_ms'] / k['ms']:.1%} of the bound L2-cold")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"wayne_tpu_torch/csrc/{src}",
        "replaces": f"wayne_tpu/ops/pallas_readout.py:{line}",
        "launches": n, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}
        for name, src, line, n, k in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
