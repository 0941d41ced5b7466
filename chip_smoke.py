#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wayne_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the readout kernels from ``wayne_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, in parallel, linked into one library) and the RECTE
kernel into a library of its own, and then:

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
   rtol 1e-5; a second run gives exposures/s and visits/s;
6. drives the full-systematics visit at its own size:
   ``examples/wasp43b_full_systematics.yml`` (512^2, NSAMP 15, 4 orbits,
   persistence with the direct image, RECTE, a companion, starspots,
   unstable pixels, IPC, bias drift): the noise-free fluence pass and the
   persistence and RECTE set-up timed, ``simulate()`` (B1 once per chunk,
   its exposures/s), B1 held against its plain version on the first
   chunk's recorded arguments (a background that carries the persistence,
   bands thinned by the traps, both checked), B2 against its plain version
   on one read of that chunk through ``fused_reads=False``, the kernels per
   chunk beside the headline visit's (``torch.profiler``), and
   ``generate()`` end to end on a fresh Observation, its ima files read
   back with NSAMP + 1 reads and DQ 32 on exactly the unstable pixels;
7. ``simulate()`` of ``examples/wasp43b_g141_eclipse.yml`` (against the
   same visit without planet light: bit-identical reads in exactly the
   exposures the planet spends behind the star, more charge in every
   other) and of ``examples/wasp43b_g141_phase_curve.yml`` (13 orbits),
   then ``python -m wayne_tpu_torch.run_program`` (in process) on
   ``examples/wasp43b_three_visit_program.yml`` to a temporary directory:
   three visits, visit 1's ``carry_fluence.npy`` loaded as visit 2's prior
   stimulus and visit 2's as visit 3's, B1 launches as planned;
8. the rest of the forward simulator: (a) ``exact_poisson``: B1, B2 and B3
   = their plain versions bit for bit on phase 1's chunk (noise on, IPC
   off and on, a second run identical), the exact law on the card (B1's
   background sampler at lambda 0 to 1e4: mean, variance, the pmf's
   chi-square at 5 and 20, which the default sampler fails at the same
   size), ``simulate()`` of the headline visit with ``exact_poisson``
   beside the default in turns, and each kernel's exact-mode time against
   its bound; (b) the headline visit with a ``calibration:`` block (aXe
   conf, sensitivity, flat cube, sky, He sky, non-linearity cube, QE
   DQ-bit plane, written at 1024^2 to a temporary directory) through
   ``run_visit --debug``: B1 launches, ``visit_summary.json``, ima files
   read back; (c) the native ima writer against the Python writer on
   phase 6's first chunk (bytes, seconds per file, the host's share split
   into DQ, ERR and bytes) and ``generate()`` of the full-systematics visit
   on each writer; (d) ``ExposureGenerator.scanning_frame`` at 512^2
   through B1.
9. the closed reduction loop: ``generate()`` of the headline visit's
   first orbit, ``run_calwf3`` on the card against ``--cpu``,
   ``reduce_visit`` card against CPU, and ``run_dataset --recover 8`` on
   the uncut visit (see ``phase_reduction``);
10. the reduction CLIs at full width: (a) ``etc.predict`` of the headline
   YAML (one B1 launch, the noise flags off, held against its plain
   version; the report card = CPU); (b) the uncut headline visit through
   ``run_visit --quicklook`` (the PNGs where matplotlib is installed, else
   the quicklook's read-back and reduction without them), then
   ``run_reduce`` three times (divide-white with optimal extraction, the
   sky fit and the light curves; the ramp fit with a free ephemeris and
   robust clipping; the RECTE fit), each timed in parts, its depths within
   max(6 sigma, 0.01) of the injected, its fits held against the same fits
   on the CPU on the spectra the card extracted, and ``fit_white_ramp`` /
   ``fit_white_recte`` timed with their kernel launches counted; (c) the
   eclipse visit through ``run_reduce --mode eclipse --detrend ramp``
   (Fp/Fs within 6 sigma) and ``fit_phase_curve`` on phase 7's
   phase-curve curves (fp, A and the offset within 6 sigma);
11. inference at full width (see ``phase_inference``): (a) ``run_reduce
   --mcmc 1000`` on phase 10's uncut visit, divide-white and with ``--detrend
   ramp --fit-geometry``: posterior medians within max(6 sigma, 0.01) of the
   injected Rp/Rs and within the LM depth's 1 sigma, R-hat and ESS printed,
   the card's samplers against the same calls on the CPU by their law, and
   the launch calls per ensemble step; (b) ``run_retrieve --n-chan 8
   --chunk 8 --n-lm 4`` on the same files: B1 launched once per chunk and
   residual pass through its autograd Function, B1 = plain bit for bit on
   the model twin's chunk that holds mid-transit (recorded from a
   residual-only pass) and timed there, the tangent pass of that chunk
   timed (and beside it the same tangents by ``torch.func.jvp`` of the
   plain version), its depth Jacobian at ``run_retrieve``'s flat start card
   against CPU and against central finite differences on the card (every
   column nonzero), the
   retrieved Rp/Rs within max(6 sigma, 0.01), the run's seconds split into
   set-up, reading, LM and covariance, the launch calls of one LM pass;
   (c) ``run_retrieve --program --mcmc 1000`` on phase 7's program: the t0
   offsets' drift within 6 sigma of the injected, the posterior printed.
12. the (mc, exp) mesh (see ``phase_mesh``): the card count and
   ``make_mesh()``'s shape; ``generate(mesh=make_mesh(["cuda:0"] * 4))`` of
   the headline visit's first orbit against the one-device files, byte for
   byte; ``generate_dataset`` of the uncut visit x 4 realisations with
   recovered labels on a (2, 2) mesh of cuda:0 against ``mesh=None``, bit
   for bit, B1 held on the first sharded batch, both rates in turns; with
   more than one card, the same over ``make_mesh()``; ``run_visit
   --all-devices`` on a 128^2 copy of the headline YAML.
13. the science tools (see ``phase_validation``): (a)
   ``validate_recovery``'s main section at its full size (256^2, 48
   exposures, 8 channels) and 32 realisations on the card: every gate (a
   gate logged in ROADMAP Queue C must reproduce the committed
   ``VALIDATION_TORCH.json``), B1 once per realisation, B1 = plain on the
   first realisation's batch, the noise-free recovery card against CPU at
   atol 1e-5; (b) ``program_ephemeris`` on the JAX package's drift program
   (``tests/test_program.py``), written by the port's ``Program``: the
   drift criteria of that test, and the card's result against ``--cpu``
   on the same files.
14. the repository's last three tools (see ``phase_tools``): (a)
   ``ramp_envelope``'s walk-off and hook points and the validation default
   at 2 draws at the tool's size, card against CPU (their gaps to
   ``RAMP_ENVELOPE.json`` printed), B1 = plain on one realisation's batch;
   (b) ``probe_dw_sigma``'s "full" variant at 2 realisations: its clean run
   card against CPU, the ratios finite, B1 = plain on the first noisy
   batch; (c) ``dataset_scale`` at its full width (512^2, 76 exposures,
   G141 and G102) at chunks of 4 and its 11-chunk minimum: the resume after
   the kill skips exactly the 10 chunks written, the resumed dataset
   equals a fresh one-shot run bit for bit, B1 = plain on the first
   sharded batch.
15. the RECTE white-ramp kernel (R1, ``csrc/recte_ramp.cu``; see
   ``phase_recte``) at the fit's shapes, on the fitted visit's 86 exposure
   starts: the value of one row and ``jacfwd``'s six tangent rows, each
   equal to its plain version (``ops.recte.white_ramp_plain``, the loop
   and ``torch.func.jvp`` of it) bit for bit, the value to the loop's
   (N,)-rate route too; one launch a call in ``white_ramp.launches``;
   both launches and both plain versions timed, beside the bound of the
   recurrence's dependent chain (``recte_chain_bound``). Phase 10 reads
   ``white_ramp.launches`` on the main path: the host's R1 launches in
   ``run_reduce --detrend recte``'s fit equal those of 2, 4 and 6 steps,
   and the ramp fits launch none.
   ``python3 chip_smoke.py --phases 9,10,11,12,13,14,15`` runs those phases
   alone (phase 11 without 10 writes its visit and program itself) and
   prints no result lines.

The JSON line's launch counts add up every phase's.

Throughout, it times each kernel L2-warm and L2-cold (``device_ms``; the
JSON line takes the cold time), its plain version and ``simulate()`` on
both routes, and prints each kernel's bound (the bytes over the memory
rate against the operations over the rates of their pipes, see
``_bound``) beside the yardstick of the port's first slices.

Prints the card's name and power limit first, a JSON line with the
kernels' numbers (with ``exact_ms``, each kernel's exact-mode time, and
its bound; B1's row also with ``twin_ms`` and ``tangent_ms``, its time on
phase 11's model-twin chunk and that chunk's tangent pass; R1's with its
tangent launch's time, plain version and bound) before the last
line, and last ``{"ok": true, "device":
{...}}`` with the one card the run used. Any failed check exits non-zero. It
needs a CUDA card and the repository around it, and fails without either.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "examples", "wasp43b_g141_scan.yml")
FULL = os.path.join(HERE, "examples", "wasp43b_full_systematics.yml")
ECLIPSE = os.path.join(HERE, "examples", "wasp43b_g141_eclipse.yml")
PHASE = os.path.join(HERE, "examples", "wasp43b_g141_phase_curve.yml")
PROGRAM = os.path.join(HERE, "examples", "wasp43b_three_visit_program.yml")
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
    # the exact sampler (exact_poisson): per Knuth uniform the shift;
    # convert, scale, floor, log, add, compare, count; per PTRS attempt
    # two uniforms (shifts; 6), its set-up (sqrt, log, 2 divisions, 6),
    # the candidate (abs, 2 subs, a division, 3 products and sums, floor)
    # and the test (4 compares, a log, 2 divisions, 2 products, sums, log
    # k!'s table or series ~12)
    "knuth": (0, 1, 7),
    "ptrs": (0, 2, 44),
}
# The yardstick of the first two slices, printed beside the new bound:
# every operation at the 67 T/s fp32 rate with FMA counted as two
OLD_OPS_S = 67e12
OLD_OPS = {"philox": 98, "box_muller": 10, "sampler": 10, "small_lam": 40,
           "readout": 16, "cr": 1, "knuth": 8, "ptrs": 46}
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
                small_lam=0, knuth=0, ptrs=0,
                cr=0 if cr_q is None else int((cr_q != 0).sum()))
    n_normal = px_reads if flags["read_noise"] else 0
    if (flags["poisson"] and flags.get("bg_poisson", True)
            and flags.get("exact_poisson")):
        _add_exact_work(work, lam)
    elif flags["poisson"] and flags.get("bg_poisson", True):
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
        _add_band_work(work, bands, flags.get("exact_poisson", False))
    return _bound(nbytes, work)


def _add_exact_work(work: dict, lam) -> None:
    """Adds to ``work`` the least work of the exact sampler on ``lam``, by
    its code: below 10, Knuth's lam + 1 uniforms (expected) in
    max(1, (lam + 1) / 4) Philox blocks (a lower bound of the expected
    ceil((K + 1) / 4)); from 10, one PTRS attempt (most accept at the
    first) and its block; nothing where lambda = 0."""
    knuth = lam[(lam > 0) & (lam < 10)].double()
    n_ptrs = int((lam >= 10).sum())
    work["philox"] += float(((knuth + 1) / 4).clamp_min(1).sum()) + n_ptrs
    work["knuth"] += float((knuth + 1).sum())
    work["ptrs"] += n_ptrs


def _add_band_work(work: dict, bands, exact: bool = False) -> None:
    """Adds to ``work`` the in-kernel Poisson draw of the expected
    ``bands``: a Philox block, Box-Muller and the sampler where lambda >= 3,
    a Philox block and the exact sum where 0 < lambda < 3, nothing where
    lambda = 0; with ``exact`` the exact sampler's (``_add_exact_work``)."""
    if exact:
        _add_exact_work(work, bands)
        return
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
        _add_band_work(work, kw["band"], flags.get("exact_poisson", False))
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


def first_call(module, name: str, run, index: int = 0) -> tuple:
    """``run()``'s result and the arguments, by name, of the call number
    ``index`` (the first by default) of ``module.name`` during ``run()``."""
    import inspect
    import threading

    real, seen, calls = getattr(module, name), [], [0]
    lock = threading.Lock()     # a mesh's worker threads call it too

    def record(*args, **kw):
        with lock:
            if calls[0] == index:
                seen.append(
                    inspect.signature(real).bind(*args, **kw).arguments)
            calls[0] += 1
        return real(*args, **kw)

    setattr(module, name, record)
    try:
        result = run()
    finally:
        setattr(module, name, real)
    call, = seen
    return result, call


def recorded_readout(run, index: int = 0) -> tuple:
    """``run()``'s result and the readout's arguments and flags exactly as
    the main path gives them, recorded from the ``exposure_readout`` call
    number ``index`` (the first by default) of ``run()``: (result, (the
    eleven array and scalar arguments in order, the keyword flags))."""
    import inspect

    import wayne_tpu_torch.ops.exposure as ex
    result, call = first_call(ex, "exposure_readout", run, index)
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


def phase_main_path(cfg, obs, card: str) -> tuple[int, list[float], tuple]:
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
    return launches, errs, recorded


# ---------------------------------------------------------------------------
# Phase 3: the per-read kernels against their plain versions
# ---------------------------------------------------------------------------

def step_args(args, k: int, cum, full_frame: bool, poisson: bool,
              exact: bool = False) -> dict:
    """A per-read step's arguments for read k of the phase-1 chunk inputs,
    built as the per-read path builds them: the banded step takes the
    expected band at its row (it samples the band itself); the full-frame
    step takes the band placed in a zero frame and sampled when
    ``poisson`` (from the exact law with ``exact``), plus the read's hits
    in list order."""
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
        frame = sample_band(seed, k, torch.zeros_like(y0), frame, exact)
    return dict(kw, add=add_hits(frame, cr_pos[:, k], cr_q[:, k]))


def banded_reference(**kw):
    """The banded step's plain reference: the expected band sampled
    (``sample_band``) when ``poisson``, then ``read_step_banded_plain``."""
    from wayne_tpu_torch.ops.readout import (
        read_step_banded_plain, sample_band,
    )
    if kw["poisson"]:
        kw = dict(kw, band=sample_band(kw["seed"], kw["read"], kw["y0"],
                                       kw["band"],
                                       kw.get("exact_poisson", False)))
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
        kw = step_args(args, k, cum, full_frame, flags["poisson"],
                       flags.get("exact_poisson", False))
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


# ---------------------------------------------------------------------------
# Phase 6: the full-systematics visit at its own size
# ---------------------------------------------------------------------------

_STEP_FLAGS = ("poisson", "read_noise", "non_linearity", "bias",
               "scalar_gain", "with_cr", "bg_poisson", "ipc", "exact_poisson")


def kernels_in(fn, records: bool = False, warmup: bool = True):
    """The CUDA kernels ``fn()`` launches, counted as the host's launch
    calls (``cudaLaunchKernel`` and kin) in a ``torch.profiler`` trace.
    CUPTI drops a few of the device's kernel records in a trace of
    ~16 000 kernels (1-3 a trace on the H100), never a launch call; with
    ``records`` also the kernel records the trace kept. ``warmup``: one
    untraced call first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    calls = sum(1 for e in events
                if re.match(r"cu(da)?Launch\w*Kernel", e.name()))
    if not records:
        return calls
    kept = sum(1 for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not re.match(r"(Memcpy|Memset)", e.name()))
    return calls, kept


def _synced(fn):
    """(fn()'s result, its seconds on the host clock up to a synchronise)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_full_systematics(card: str) -> tuple:
    """The full-systematics visit: set-up, simulate(), B1 and B2 held
    against their plain versions on its first chunk, the kernels per chunk
    and generate(). Returns (B1 launches, B2 launches, max abs errors,
    (the generating Observation, its first ``_write_chunk`` call's
    arguments, generate()'s seconds))."""
    import dataclasses

    import numpy as np
    import torch

    import wayne_tpu_torch.ops.exposure as ex
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.pytree import tree_map

    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    cfg = load_yaml(FULL)
    S, nr = cfg.subarray, cfg.nsamp + 1
    print(f"phase 6: {os.path.relpath(FULL, HERE)} at its own size "
          f"({S}^2, NSAMP={cfg.nsamp}, {cfg.n_orbits} orbits)")
    obs = Observation(cfg)
    n = obs.plan.n_exposures
    n_chunks = math.ceil(n / CHUNK)
    st = obs.static
    check(st.noise.ipc and st.band_px > 0 and cfg.persistence.enabled
          and cfg.recte.enabled and obs.scenes.companions is not None
          and obs.scenes.spots is not None and obs.tables.rts_amp is not None,
          f"{n} exposures, band W={st.band_px}, IPC, persistence, RECTE, "
          f"{obs.scenes.companions.dx_px.shape[1]} companion, "
          f"{obs.scenes.spots.radius.shape[1]} spots, "
          f"{int((obs.tables.rts_amp > 0).sum())} unstable pixels")

    for f in kernels:
        f.launches = 0
    _, t_fluence = _synced(lambda: obs._visit_fluence(CHUNK))
    _, t_persist = _synced(lambda: obs._ensure_persistence(CHUNK))
    _, t_recte = _synced(lambda: obs._ensure_recte(CHUNK))
    setup = ro.exposure_readout.launches
    persist, trap = obs.scenes.persist_rate, obs.scenes.trap_mult
    check(setup == n_chunks + 1 and ro.read_step_banded.launches == 0,
          f"set-up: {setup} B1 launches == {n_chunks} chunks of the "
          "noise-free fluence pass + the ideal direct image")
    check(tuple(persist.shape) == (n, S, S)
          and bool(torch.isfinite(persist).all())
          and float(persist.max()) > 0.0 and float(trap.min()) > 0.0
          and float(trap.max()) <= 1.0 and float(trap.min()) < 1.0,
          f"persist_rate {tuple(persist.shape)} up to "
          f"{float(persist.max()):.4g} e-/s, trap_mult in "
          f"[{float(trap.min()):.6f}, {float(trap.max()):.6f}]")

    for f in kernels:
        f.launches = 0
    (res, recorded), t_first = _synced(
        lambda: recorded_readout(lambda: obs.simulate(chunk=CHUNK)))
    sim = ro.exposure_readout.launches
    reads = res.reads_dn
    check(tuple(reads.shape) == (n, nr, S, S)
          and bool(torch.isfinite(reads).all())
          and bool((reads[:, -1].double().sum((-2, -1))
                    > reads[:, 0].double().sum((-2, -1))).all()),
          f"simulate(): reads_dn {tuple(reads.shape)} finite, every "
          "exposure's last read above its first")
    check(sim == n_chunks and ro.read_step_banded.launches == 0,
          f"simulate(): {sim} B1 launches == {n_chunks} chunks")
    del res, reads
    _, wall = _synced(lambda: obs.simulate(chunk=CHUNK))

    # the first chunk's readout inputs carry the new physics
    args, _ = recorded
    sl = tree_map(lambda x: x[:CHUNK], obs.scenes)
    t = obs.tables
    want_bg = t.dark_map + (sl.sky_level[:, None, None] * t.sky_frame
                            + sl.sky_he_level[:, None, None] * t.sky_he_frame)
    want_bg = (want_bg * sl.trap_mult + sl.persist_rate) * t.active_mask
    check(torch.allclose(args[4], want_bg, rtol=1e-6, atol=0),
          "the first chunk's bg_rate is (sky + He + dark) x trap_mult + "
          "persist_rate")
    _, (no_trap, _) = recorded_readout(lambda: ex.simulate_exposure(
        dataclasses.replace(sl, trap_mult=None), t, st))
    bands, y0s = args[3][:, 1:], args[1][:, 1:]
    rows = y0s.long()[..., None] + torch.arange(bands.shape[2],
                                                device=bands.device)
    check(torch.equal(bands, no_trap[3][:, 1:] * ex._gather_rows(
        sl.trap_mult, rows)), "its bands are the trap-free bands x the "
          "trap_mult rows, bit for bit")
    errs = hold_recorded(ro, recorded, "phase 6", "full-systematics chunk")

    # B2 on one read of the same chunk through the per-read route
    per_read = dataclasses.replace(st, fused_reads=False)
    ro.read_step_banded.launches = 0
    _, call = first_call(ex, "read_step_banded",
                         lambda: ex.simulate_exposure(sl, t, per_read),
                         index=nr // 2)
    b2 = ro.read_step_banded.launches
    check(b2 == nr and call["read"] == nr // 2,
          f"per-read chunk: {b2} B2 launches == {nr} reads")
    arrays = {k: v for k, v in call.items() if k not in _STEP_FLAGS}
    on = {k: v for k, v in call.items() if k in _STEP_FLAGS}
    print(f"phase 6: B2 vs plain, read {call['read']} of the chunk, "
          f"band {tuple(arrays['band'].shape)}, flags {on}")
    errs += hold_against_plain(
        lambda f: ro.read_step_banded(**arrays, **f)[::-1],
        lambda f: banded_reference(**arrays, **f)[::-1], on,
        "full-systematics read")
    time_readout(ro, *recorded, "the full-systematics chunk", card)
    print(f"timing [{card}]: read_step_banded kernel on read "
          f"{call['read']} of the full-systematics chunk "
          f"{times_line(kernel_times(lambda: ro.read_step_banded(**call), 50))}")

    n_full = kernels_in(lambda: ex.simulate_exposure(sl, t, st))
    head = headline_observation()[1]
    n_head = kernels_in(lambda: ex.simulate_exposure(
        tree_map(lambda x: x[:CHUNK], head.scenes), head.tables,
        head.static))
    del head
    print(f"timing [{card}]: full systematics set-up: fluence pass "
          f"{t_fluence:.3f} s, _ensure_persistence {t_persist:.3f} s, "
          f"_ensure_recte {t_recte:.3f} s; simulate() {n} exposures in "
          f"{wall:.3f} s = {n / wall:.2f} exposures/s (first call "
          f"{t_first:.3f} s); {n_full} kernels per chunk of {CHUNK} "
          f"(headline visit: {n_head})")

    gen = Observation(cfg)
    rts = ((gen.tables.rts_amp > 0) & (gen.tables.active_mask > 0)
           ).cpu().numpy()
    for f in kernels:
        f.launches = 0
    with tempfile.TemporaryDirectory() as out:
        # the first chunk's host outputs are recorded for phase 8's writer
        (paths, t_gen), written = first_call(gen, "_write_chunk", lambda: (
            _synced(lambda: gen.generate(out, chunk=CHUNK,
                                         progress=lambda s: None))))
        gen_launches = ro.exposure_readout.launches
        check(len(paths) == n and gen_launches == 2 * n_chunks + 2,
              f"generate(): {len(paths)} ima files, {gen_launches} B1 "
              f"launches == 2 x {n_chunks} chunks + 2 direct images")
        for p in (paths[0], paths[-1]):
            hdr, r, _, dq = read_ima(p, with_dq=True)
            check(hdr["NSAMP"] == nr and r.shape == (nr, S, S)
                  and np.isfinite(r).all()
                  and all(np.array_equal((d & 32) != 0, rts) for d in dq),
                  f"{os.path.basename(p)}: NSAMP={hdr['NSAMP']}, DQ 32 on "
                  f"exactly the {int(rts.sum())} unstable pixels of every "
                  "read")
    print(f"timing [{card}]: generate() of the full-systematics visit "
          f"({n} exposures, set-up and FITS writes included, the native "
          f"writer) {t_gen:.3f} s = {n / t_gen:.2f} exposures/s")
    return setup + sim + gen_launches, nr, errs, (gen, written, t_gen)


# ---------------------------------------------------------------------------
# Phase 7: eclipse, phase curve and the three-visit program
# ---------------------------------------------------------------------------

def phase_eclipse_and_program(card: str, out: str) -> int:
    """simulate() of the eclipse visit (against the same visit without
    planet light) and of the phase-curve visit (its reads reduced for
    phase 10c), then ``run_program`` on the three-visit program into
    ``out`` (kept for phase 11c). Returns (B1's launches, the phase-curve
    visit's curves)."""
    import dataclasses

    import numpy as np
    import torch

    import wayne_tpu_torch.observation as observation
    from wayne_tpu_torch import run_program
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.ops.kepler import projected_separation
    from wayne_tpu_torch.ops.transit import eclipse_visibility

    launches = 0

    def simulate(cfg, label):
        nonlocal launches
        obs = Observation(cfg)
        n = obs.plan.n_exposures
        ro.exposure_readout.launches = 0
        res, wall = _synced(lambda: obs.simulate(chunk=CHUNK))
        b1 = ro.exposure_readout.launches
        launches += b1
        check(tuple(res.reads_dn.shape)[:2] == (n, cfg.nsamp + 1)
              and bool(torch.isfinite(res.reads_dn).all())
              and b1 == math.ceil(n / CHUNK),
              f"{label}: simulate() reads_dn {tuple(res.reads_dn.shape)} "
              f"finite, {b1} B1 launches; {n / wall:.2f} exposures/s "
              f"[{card}] (first call, {wall:.3f} s)")
        white = (res.reads_dn[:, -1] - res.reads_dn[:, 0]).double().sum(
            (-2, -1))
        return obs, white, res

    cfg = load_yaml(ECLIPSE)
    print(f"phase 7: {os.path.relpath(ECLIPSE, HERE)}, "
          f"{os.path.relpath(PHASE, HERE)} and "
          f"{os.path.relpath(PROGRAM, HERE)}")
    obs, lit, _ = simulate(cfg, "eclipse visit")
    _, dark, _ = simulate(dataclasses.replace(cfg, planet=dataclasses.replace(
        cfg.planet, eclipse_depth=0.0)), "eclipse visit without planet light")
    sc = obs.scenes
    ends = sc.exp_start_s[:, None] + torch.tensor(
        [0.0, obs.detector_exptime], device=sc.exp_start_s.device)
    z, front = projected_separation(ends, sc.orbit)
    hidden = (eclipse_visibility(z, front, sc.rp_over_rs[:, :1]) == 0.0
              ).all(dim=1)
    same = lit == dark
    check(bool((same == hidden).all())
          and bool((lit[~hidden] > dark[~hidden]).all())
          and 0 < int(hidden.sum()) < len(hidden),
          f"eclipse: the {int(hidden.sum())} exposures behind the star are "
          f"bit-identical to the visit without planet light, the other "
          f"{int((~hidden).sum())} hold more charge")
    del obs, sc
    obs, _, res = simulate(load_yaml(PHASE), "phase-curve visit")
    curves = phase_curve_curves(obs, res, card)
    del obs, res

    loaded = []
    real = observation._load_fluence_map

    def record(path):
        loaded.append(path)
        return real(path)

    observation._load_fluence_map = record
    ro.exposure_readout.launches = 0
    said = io.StringIO()
    try:
        with contextlib.redirect_stdout(said):
            rc, wall = _synced(lambda: run_program.main(
                ["-p", PROGRAM, "-o", out, "--chunk", str(CHUNK)]))
        lines = said.getvalue().splitlines()
        print(f"  run_program: {lines[0]} ... {lines[-1]}")
        with open(os.path.join(out, "program_summary.json")) as fh:
            summary = json.load(fh)
        carries = [os.path.join(out, f"visit_{i:02d}",
                                "carry_fluence.npy") for i in range(3)]
        n_files = [len([f for f in os.listdir(os.path.join(
            out, v["dir"])) if f.endswith("_ima.fits")])
            for v in summary["visits"]]
        carry_ok = all(os.path.exists(c) for c in carries) and float(
            np.load(carries[0]).max()) > 0.0
    finally:
        observation._load_fluence_map = real
    cfg = load_yaml(PROGRAM)
    n = Observation(cfg).plan.n_exposures
    per_visit = 2 * math.ceil(n / CHUNK) + 2
    b1 = ro.exposure_readout.launches
    launches += b1
    check(rc == 0 and len(summary["visits"]) == 3 and n_files == [n] * 3
          and all("carry" in v for v in summary["visits"]) and carry_ok,
          f"run_program: 3 visits of {n} exposures, each with its carry")
    check(loaded == carries[:2],
          "visit 1's carry_fluence.npy fed visit 2's persistence and visit "
          "2's fed visit 3's")
    check(b1 == 3 * per_visit,
          f"run_program: {b1} B1 launches == 3 visits x ({per_visit}: "
          "fluence pass, visit, two direct images)")
    print(f"timing [{card}]: run_program 3 visits x {n} exposures "
          f"({cfg.subarray}^2, NSAMP={cfg.nsamp}) in {wall:.3f} s")
    return launches, curves


# ---------------------------------------------------------------------------
# Phase 8: exact Poisson, real calibration products, the native writer and
# the compat surface
# ---------------------------------------------------------------------------

# background lambdas per read (dt = 1 s) of the law's chunk, one group of
# columns each
LAW_LAMS = (0.0, 0.5, 2.9, 3.1, 5.0, 9.9, 10.1, 20.0, 50.0, 150.0, 1e4)


def chi2_p(hist, lam: float) -> float:
    """p-value of Pearson's chi-square of a histogram of samples (hist[k]
    = how many are k) against the Poisson(lam) pmf: one bin per k whose
    expected count is >= 5, and the two tails."""
    import numpy as np
    from scipy.stats import chi2, poisson
    n = float(hist.sum())
    k = np.arange(int(poisson.ppf(1 - 1e-12, lam)) + 2)
    keep = k[n * poisson.pmf(k, lam) >= 5]
    lo, hi = int(keep[0]), int(keep[-1])
    h = np.concatenate([hist, np.zeros(max(0, hi + 1 - len(hist)))])
    obs = np.concatenate([[h[:lo].sum()], h[lo:hi + 1],
                          [h[hi + 1:].sum()]])
    exp = n * np.concatenate([[poisson.cdf(lo - 1, lam)],
                              poisson.pmf(np.arange(lo, hi + 1), lam),
                              [poisson.sf(hi, lam)]])
    m = exp > 0
    return float(chi2.sf(((obs[m] - exp[m]) ** 2 / exp[m]).sum(),
                         int(m.sum()) - 1))


def law_samples(ro, exact: bool, dev) -> dict:
    """Draws of the whole-exposure kernel's background sampler, exact or
    default, at each of LAW_LAMS: a chunk (B = 8, 16 reads, S = 512) whose
    column groups carry the lambdas (dt = 1 s), no band, no read noise,
    gain 1, so every read's increment is one draw. {lam: draws}."""
    import torch
    B, NR, W, S = CHUNK, 16, 32, 512
    q = S // len(LAW_LAMS)
    bg = torch.zeros((B, S, S), device=dev)
    for j, lam in enumerate(LAW_LAMS):
        bg[:, :, j * q:(j + 1) * q] = lam
    dts = torch.ones((B, NR), device=dev)
    dts[:, 0] = 0.0
    reads, _ = ro.exposure_readout(
        torch.arange(2 * B, dtype=torch.int32, device=dev).view(B, 2) + 7,
        torch.zeros((B, NR), dtype=torch.int32, device=dev), dts,
        torch.zeros((B, NR, W, S), device=dev), bg,
        torch.zeros((S, S), device=dev), torch.ones((S, S), device=dev),
        torch.zeros((3, S, S), device=dev),
        torch.zeros((B, NR, 2, 8), dtype=torch.int32, device=dev),
        torch.zeros((B, NR, 8), device=dev), (0.0, 78000.0, 1.0, 0.0),
        poisson=True, read_noise=False, non_linearity=False, bias=False,
        with_cr=False, bg_poisson=True, exact_poisson=exact)
    inc = torch.diff(reads, dim=1)
    return {lam: inc[..., j * q:(j + 1) * q].reshape(-1)
            for j, lam in enumerate(LAW_LAMS)}


def phase_exact(args, recorded, card: str) -> tuple[dict, dict]:
    """exact_poisson: B1, B2 and B3 = their plain versions bit for bit on
    phase 1's synthetic chunk, the law on the card, simulate() of the
    headline visit and the kernels' exact-mode times. Returns ({kernel:
    (exact-mode L2-cold ms, its bound)}, the simulate() launches)."""
    import dataclasses

    import numpy as np
    import torch

    from wayne_tpu_torch.ops import readout as ro

    B, NR, W, S = args[3].shape
    print(f"phase 8a: exact_poisson, B1/B2/B3 vs plain on phase 1's chunk "
          f"(B={B}, NR={NR}, S={S}, W={W})")
    on = dict(NOISE_ON, exact_poisson=True)
    for ipc in (False, True):
        f = dict(on, ipc=ipc)
        hold_against_plain(lambda g: ro.exposure_readout(*args, **g),
                           lambda g: ro.exposure_readout_plain(*args, **g),
                           f, f"B1 exact, IPC {ipc}", variants=())
        hold_against_plain(
            lambda g: step_reads(ro.read_step_banded, None, args, False, g),
            lambda g: step_reads(ro.read_step_banded, banded_reference,
                                 args, False, g),
            f, f"B2 exact, IPC {ipc}", variants=())
    step_on = {k: v for k, v in on.items() if k not in ("with_cr", "ipc")}
    hold_against_plain(
        lambda g: step_reads(ro.read_step, None, args, True, g),
        lambda g: step_reads(ro.read_step, ro.read_step_plain, args, True,
                             g), step_on, "B3 exact", variants=())

    print("phase 8a: the exact law on the card (B1's background sampler, "
          f"{CHUNK} x 15 x 512 x {512 // len(LAW_LAMS)} draws per lambda)")
    exact = law_samples(ro, True, args[3].device)
    default = law_samples(ro, False, args[3].device)
    for lam, x in exact.items():
        x = x.double()
        n = x.numel()
        if lam == 0.0:
            check(bool((x == 0).all()), "lambda = 0: exactly 0")
            continue
        m, v = float(x.mean()), float(x.var())
        se_m, se_v = math.sqrt(lam / n), math.sqrt((lam + 2 * lam * lam) / n)
        check(bool((x == torch.round(x)).all()) and float(x.min()) >= 0
              and abs(m - lam) < 5 * se_m and abs(v - lam) < 5 * se_v,
              f"exact lambda = {lam}: mean {m:.5f}, var {v:.5f} (5 sigma: "
              f"{5 * se_m:.5f}, {5 * se_v:.5f}), integer counts >= 0")
    for lam in (5.0, 20.0):
        hist = torch.bincount(exact[lam].long()).cpu().numpy()
        p = chi2_p(hist, lam)
        check(p > 1e-3, f"exact lambda = {lam}: pmf chi-square p = {p:.3g} "
              f"over {int(hist.sum())} draws (> 1e-3)")
    p5 = chi2_p(torch.bincount(default[5.0].long()).cpu().numpy(), 5.0)
    check(p5 < 1e-6, f"default sampler at lambda = 5: chi-square p = "
          f"{p5:.3g} at the same size (< 1e-6: the test can tell)")
    del exact, default

    print("phase 8a: simulate() of the headline visit with exact_poisson")
    cfg, obs = headline_observation()
    n = obs.plan.n_exposures
    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    default_static = obs.static
    exact_static = dataclasses.replace(default_static, exact_poisson=True)
    walls = {}
    for label, static in (("default", default_static),
                          ("exact", exact_static),
                          ("exact", exact_static),
                          ("default", default_static)):
        obs.static = static
        for f in kernels:
            f.launches = 0
        res, wall = _synced(lambda: obs.simulate(chunk=CHUNK))
        walls.setdefault(label, []).append(wall)
        if label == "exact" and len(walls[label]) == 1:
            exact_launches = [f.launches for f in kernels]
            reads = res.reads_dn
            ramp = reads.double().sum(dim=(-2, -1))
            check(tuple(reads.shape) == (n, cfg.nsamp + 1, 512, 512)
                  and bool(torch.isfinite(reads).all())
                  and bool((torch.diff(ramp, dim=1) > 0).all())
                  and exact_launches == [math.ceil(n / CHUNK), 0, 0],
                  f"simulate(), exact_poisson: reads {tuple(reads.shape)} "
                  f"finite, monotone ramps, B1/B2/B3 launches "
                  f"{exact_launches}")
        del res
    obs.static = default_static
    print(f"timing [{card}]: simulate() {n} exposures, exact_poisson "
          f"{', '.join(f'{n / w:.2f}' for w in walls['exact'])} "
          f"exposures/s against the default sampler's "
          f"{', '.join(f'{n / w:.2f}' for w in walls['default'])} in turns "
          f"(default, exact, exact, default)")

    out = {}
    rec_args, rec_flags = recorded
    for label, a, flags in (("the synthetic chunk", args, NOISE_ON),
                            ("the main path's chunk", rec_args, rec_flags)):
        t_d = kernel_times(lambda: ro.exposure_readout(*a, **flags), 20)
        ex = dict(flags, exact_poisson=True)
        t_e = kernel_times(lambda: ro.exposure_readout(*a, **ex), 20)
        b = bound_of(a, ex)
        print(f"timing [{card}]: B1 on {label}: exact mode "
              f"{times_line(t_e)}; default mode {times_line(t_d)}; exact "
              f"mode's {bound_line(b)}; {b['bound_ms'] / t_e['ms']:.1%} of "
              "it L2-cold")
        out.setdefault("exposure_readout", (t_e["ms"], b["bound_ms"]))
    k = NR // 2
    for name, step, full_frame in (("read_step_banded", ro.read_step_banded,
                                    False),
                                   ("read_step", ro.read_step, True)):
        f = on if not full_frame else step_on
        _, cums = step_reads(step, None, args, full_frame, f)
        kw = step_args(args, k, cums[:, k - 1].contiguous(), full_frame,
                       True, exact=True)
        t = kernel_times(lambda: step(**kw, **f), reps=50)
        b = step_bound_of(kw, f)
        print(f"timing [{card}]: {name} exact mode {times_line(t)} (read "
              f"{k}); {bound_line(b)}; {b['bound_ms'] / t['ms']:.1%} of it "
              "L2-cold")
        out[name] = (t["ms"], b["bound_ms"])
    return out, dict(zip(("exposure_readout", "read_step_banded",
                          "read_step"), exact_launches))


def write_products(d: str) -> dict:
    """A full set of STScI-format calibration products for the headline
    visit, written to ``d`` from a seed: an aXe conf (the G141 trace and
    dispersion), a sensitivity table (Angstrom), and full-frame 1024^2
    FITS planes cut to the 512^2 subarray by the loaders: a flat cube, a
    master and a helium sky, a non-linearity cube and a QE DQ-bit plane
    (dead pixels, one blob)."""
    import numpy as np

    from wayne_tpu_torch.io.fits import FitsHDU, write_fits
    rng = np.random.RandomState(43)
    n = 1024
    plane = lambda loc, sc: (loc + sc * rng.standard_normal((n, n))
                             ).astype(np.float32)
    p = {k: os.path.join(d, name) for k, name in (
        ("axe_conf", "WFC3.IR.G141.conf"), ("sensitivity_file", "sens.txt"),
        ("flat_file", "flat.fits"), ("sky_file", "sky.fits"),
        ("sky_he_file", "sky_he.fits"), ("nonlin_file", "nlin.fits"),
        ("qe_file", "bpix.fits"))}
    with open(p["axe_conf"], "w") as fh:
        fh.write("BEAMA -10 150\n"
                 "DYDX_A_0 1.96882 9.09159e-5 -1.93260e-3\n"
                 "DYDX_A_1 1.04275e-2 -7.96978e-6 -2.49607e-6\n"
                 "DLDP_A_0 8949.513 8.6331e-4 2.17086e-2\n"
                 "DLDP_A_1 44.66487 4.4568e-6 -9.3373e-4\n")
    wl = np.linspace(10000.0, 18000.0, 400)
    np.savetxt(p["sensitivity_file"], np.stack(
        [wl, 1.4e16 * np.exp(-0.5 * ((wl - 13900.0) / 2900.0) ** 4)], 1))
    write_fits(p["flat_file"], [FitsHDU(data=np.stack(
        [plane(1.0, 0.008), plane(0.0, 0.002), plane(0.0, 5e-4),
         plane(0.0, 2e-4)]))])
    write_fits(p["sky_file"], [FitsHDU(data=plane(1.0, 0.02))])
    write_fits(p["sky_he_file"], [FitsHDU(data=plane(1.0, 0.05))])
    write_fits(p["nonlin_file"], [FitsHDU(data=np.stack(
        [plane(0.012, 4e-4), plane(0.012, 4e-4), plane(0.016, 5e-4)]))])
    bits = np.zeros((n, n), np.int16)
    bits[rng.rand(n, n) < 1e-3] = 4
    bits[500:530, 600:640] |= 512
    write_fits(p["qe_file"], [FitsHDU(data=bits)])
    return p


def phase_calibration_visit(card: str) -> int:
    """The headline visit cut to ORBITS orbits with a ``calibration:``
    block whose products are written to a temporary directory, through
    ``python -m wayne_tpu_torch.run_visit --debug`` in process. Returns
    B1's launches."""
    import numpy as np

    from wayne_tpu_torch import run_visit
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro

    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    with tempfile.TemporaryDirectory() as d:
        products = write_products(d)
        with open(HEADLINE) as fh:
            text = fh.read()
        cut = f"num_orbits: {ORBITS}\n"
        text = text.replace("num_orbits: 4\n", cut)
        text += "trends:\n  he_airglow_level: 0.3\ncalibration:\n" + "".join(
            f"  {k}: {v}\n" for k, v in products.items())
        yml = os.path.join(d, "calibrated.yml")
        with open(yml, "w") as fh:
            fh.write(text)
        cfg = load_yaml(yml)
        check(cut in text and cfg.n_orbits == ORBITS
              and cfg.calibration.qe_file == products["qe_file"],
              f"phase 8b: {os.path.relpath(HEADLINE, HERE)} cut to "
              f"{ORBITS} orbit with a calibration: block of "
              f"{len(products)} products (512^2 from 1024^2 planes)")
        n = Observation(cfg).plan.n_exposures
        out = os.path.join(d, "out")
        said = io.StringIO()
        for f in kernels:
            f.launches = 0
        with contextlib.redirect_stdout(said):
            rc, wall = _synced(lambda: run_visit.main(
                ["-p", yml, "-o", out, "--debug", "--chunk", str(CHUNK)]))
        b1 = ro.exposure_readout.launches
        lines = said.getvalue().splitlines()
        print(f"  run_visit --debug: {lines[0]} ... {lines[-1]}")
        n_chunks = math.ceil(n / CHUNK)
        check(rc == 0 and b1 == n_chunks + 1
              and ro.read_step_banded.launches == 0,
              f"run_visit --debug: {b1} B1 launches == {n_chunks} chunks + "
              "the direct image")
        with open(os.path.join(out, "visit_summary.json")) as fh:
            summary = json.load(fh)
        check(summary["n_exposures"] == n
              and [e["chunk"] for e in summary["exposures"]]
              == list(range(0, n, CHUNK))
              and all(np.isfinite(e["reads_max_dn"])
                      for e in summary["exposures"]),
              f"visit_summary.json: {len(summary['exposures'])} chunks, "
              f"keys {sorted(summary)}")
        paths = sorted(f for f in os.listdir(out) if f.endswith("_ima.fits"))
        for name in (paths[0], paths[-1]):
            hdr, r, _, dq = read_ima(os.path.join(out, name), with_dq=True)
            check(len(paths) == n and hdr["NSAMP"] == cfg.nsamp + 1
                  and r.shape == (cfg.nsamp + 1, 512, 512)
                  and np.isfinite(r).all() and bool(((dq & 512) != 0).any()),
                  f"{name}: NSAMP={hdr['NSAMP']}, reads {r.shape} finite, "
                  "the loaded blob in DQ 512")
    print(f"timing [{card}]: run_visit --debug of the calibrated visit "
          f"({n} exposures) {wall:.3f} s")
    return b1


def phase_writer(full, card: str) -> None:
    """The native ima writer against the Python writer on phase 6's first
    full-systematics chunk: bytes, seconds per file, the host's share of a
    file split into its DQ planes, its ERR planes and its bytes; then
    generate() of the full-systematics visit on the Python writer beside
    phase 6's (native) figure."""
    import functools

    import numpy as np

    import wayne_tpu_torch.observation as observation
    from wayne_tpu_torch.io.fits import read_fits
    from wayne_tpu_torch.io.ima import (
        default_primary_header, write_ima,
    )

    gen, call, t_native_gen = full
    res, read_times = call["res"], call["read_times"]
    gain, rn = call["gain"], call["rn"]
    _, bias_ped, gain_map, bias_e_map = gen._detector_planes()
    cfg = gen.cfg
    n_files = res.reads_dn.shape[0]
    print(f"phase 8c: the native ima writer against the Python writer on "
          f"{n_files} files of the full-systematics chunk "
          f"{tuple(res.reads_dn.shape)}")
    t = dict(dq=0.0, err=0.0, native=0.0, python=0.0, disk=0.0)
    with tempfile.TemporaryDirectory() as d:
        for j in range(n_files):
            reads = res.reads_dn[j]
            t0 = time.perf_counter()
            dq = gen._exposure_dq(reads, gain, res.cr_pos[j],
                                  res.cr_count[j], gen.tables)
            t["dq"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            g = gain_map if gain_map is not None else gain
            be = bias_e_map if bias_e_map is not None else bias_ped
            _ = np.sqrt(np.maximum(reads * g - be, 0.0) + rn ** 2) / g
            t["err"] += time.perf_counter() - t0
            hdr = default_primary_header(
                targname=cfg.star.name, grism=cfg.grism, nsamp=cfg.nsamp,
                samp_seq=cfg.samp_seq, subarray=cfg.subarray,
                expstart_mjd=56000.0, exptime_s=gen.detector_exptime,
                scan=cfg.scan, scan_rate_pix_s=1.0, extra={"EXPINDEX": j})
            kw = dict(gain=gain, read_noise_e=rn, dq=dq,
                      bias_pedestal_e=bias_ped, gain_map=gain_map,
                      bias_e_map=bias_e_map)
            paths = [os.path.join(d, f"{w}_{j}.fits")
                     for w in ("native", "python")]
            for path, native in zip(paths, (True, False)):
                t0 = time.perf_counter()
                write_ima(path, reads, read_times, hdr, use_native=native,
                          **kw)
                t["native" if native else "python"] += (
                    time.perf_counter() - t0)
            with open(paths[0], "rb") as fh:
                raw = fh.read()
            t0 = time.perf_counter()
            with open(os.path.join(d, "raw.bin"), "wb") as fh:
                fh.write(raw)
            t["disk"] += time.perf_counter() - t0
            a, b = read_fits(paths[0]), read_fits(paths[1])
            same = len(a) == len(b) and all(
                ha == hb and ((da is None and db is None)
                              or (ha.get("EXTNAME") == "ERR"
                                  and np.allclose(da, db, rtol=1e-6, atol=0))
                              or (da.dtype == db.dtype
                                  and np.array_equal(da, db)))
                for (ha, da), (hb, db) in zip(a, b))
            check(same and len(raw) == os.path.getsize(paths[1]),
                  f"file {j}: every non-ERR HDU identical, ERR within rtol "
                  f"1e-6, {len(raw)} bytes each")
    per = {k: v / n_files for k, v in t.items()}
    print(f"timing [{card}]: ima writer, seconds per file ({len(raw)} "
          f"bytes): native {per['native']:.4f}, Python {per['python']:.4f}; "
          f"the host's share of a file: DQ planes (_exposure_dq) "
          f"{per['dq']:.4f}, ERR planes in NumPy {per['err']:.4f}, writing "
          f"its bytes {per['disk']:.4f}")

    real = observation.write_ima
    observation.write_ima = functools.partial(real, use_native=False)
    try:
        python_gen = observation.Observation(cfg)
        with tempfile.TemporaryDirectory() as out:
            paths, t_python_gen = _synced(lambda: python_gen.generate(
                out, chunk=CHUNK, progress=lambda s: None))
    finally:
        observation.write_ima = real
    n = len(paths)
    print(f"timing [{card}]: generate() of the full-systematics visit ({n} "
          f"exposures): native writer {t_native_gen:.3f} s (phase 6), "
          f"Python writer {t_python_gen:.3f} s")


def phase_compat(card: str) -> int:
    """``ExposureGenerator.scanning_frame`` at its default 512^2 on the
    card. Returns B1's launches."""
    import torch

    from wayne_tpu_torch.compat import ExposureGenerator
    from wayne_tpu_torch.ops import readout as ro

    gen = ExposureGenerator("G141")
    kernels = (ro.exposure_readout, ro.read_step_banded, ro.read_step)
    for f in kernels:
        f.launches = 0
    res, wall = _synced(lambda: gen.scanning_frame(128.0, 100.0, seed=1))
    again = gen.scanning_frame(128.0, 100.0, seed=1).reads_dn
    b1, b2, b3 = (f.launches for f in kernels)
    reads = res.reads_dn
    ramp = reads.double().sum(dim=(-2, -1))
    check((b1, b2, b3) == (2, 0, 0) and tuple(reads.shape) == (16, 512, 512)
          and reads.device.type == "cuda" and bool(torch.isfinite(reads).all())
          and bool((torch.diff(ramp) > 0).all()) and torch.equal(reads, again),
          f"phase 8d: ExposureGenerator.scanning_frame (512^2, NSAMP 15) "
          f"twice with seed 1: {b1} B1 launches, reads "
          f"{tuple(reads.shape)} finite, monotone ramp, the second frame "
          f"bit-identical; first frame {wall:.3f} s [{card}]")
    return b1


# ---------------------------------------------------------------------------
# Phase 9: the closed reduction loop
# ---------------------------------------------------------------------------

RECOVER_CHAN = 8            # run_dataset --recover's channels


def _flt_planes(path: str) -> dict:
    """An flt file's extensions by name (the port's FITS reader)."""
    from wayne_tpu_torch.io.fits import read_fits
    return {h.get("EXTNAME"): d for h, d in read_fits(path)[1:]}


def _auto_windows(nets) -> tuple:
    """(y_window, x_window, bg_rows) of a visit from its median net frame
    (n_exp, S, S), by the JAX package's run_reduce rule: rows above 5% of
    the peak row sum, columns above 10% within them, 3 px of padding; sky
    rows the larger margin beyond a 12-px gap."""
    import torch
    med = torch.median(nets, dim=0).values.cpu().double()
    S, pad = med.shape[-1], 3
    row = med.sum(dim=1)
    row = row - row.median()
    rows = torch.nonzero(row > 0.05 * row.max()).flatten()
    y = (max(int(rows.min()) - pad, 0), min(int(rows.max()) + pad + 1, S))
    col = med[y[0]: y[1]].sum(dim=0)
    col = col - col.median()
    cols = torch.nonzero(col > 0.1 * col.max()).flatten()
    x = (max(int(cols.min()) - pad, 0), min(int(cols.max()) + pad + 1, S))
    gap = 4 * pad
    bg = max((min(y[1] + gap, S), S), (0, max(y[0] - gap, 0)),
             key=lambda r: r[1] - r[0])
    return y, x, bg


def phase_reduction(card: str) -> int:
    """The closed loop on the card: (a) ``generate()`` of the headline
    visit's first orbit (B1 against its plain version on its first chunk);
    (b) ``run_calwf3`` on its ima files on the card and with ``--cpu``
    (SCI / ERR within rtol 1e-5 and 1e-3 e-/s, DQ, SAMP and TIME exact),
    ``reduce_visit`` of the files' reads on the card and on the CPU (light
    curves within 5e-6) and ``divide_white_fit_depths`` on the card's
    curves; (c) ``run_dataset --recover 8`` on the whole headline visit
    (B1 against its plain version on the first batch; recovered depths
    within max(6 sigma, 0.01) of the injected ones; the card's labels
    against a CPU ``spectra_to_depths`` of the stored spectra; the
    launches of one ``spectra_to_depths`` the same at 4 and 8 channels),
    each timed. Returns B1's launches."""
    import numpy as np
    import torch

    import wayne_tpu_torch.parallel.dataset as dataset
    from wayne_tpu_torch import reduction as red
    from wayne_tpu_torch import run_calwf3, run_dataset
    from wayne_tpu_torch.calibration import quadrant_map
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.pytree import tree_map

    launches = 0
    print(f"phase 9: the closed reduction loop, "
          f"{os.path.relpath(HEADLINE, HERE)}")
    with tempfile.TemporaryDirectory() as d:
        with open(HEADLINE) as fh:
            text = fh.read()
        cut = f"num_orbits: {ORBITS}\n"
        yml = os.path.join(d, "orbit.yml")
        with open(yml, "w") as fh:
            fh.write(text.replace("num_orbits: 4\n", cut))
        cfg = load_yaml(yml)
        obs = Observation(cfg)
        n = obs.plan.n_exposures
        visit = os.path.join(d, "visit")
        ro.exposure_readout.launches = 0
        (paths, t_gen), recorded = recorded_readout(lambda: _synced(
            lambda: obs.generate(visit, chunk=CHUNK,
                                 progress=lambda s: None)))
        b1 = ro.exposure_readout.launches
        launches += b1
        check(cfg.n_orbits == ORBITS and len(paths) == n
              and b1 == math.ceil(n / CHUNK) + 1,
              f"phase 9a: generate() of the first orbit: {len(paths)} ima "
              f"files, {b1} B1 launches ({math.ceil(n / CHUNK)} chunks + "
              f"the direct image) in {t_gen:.3f} s [{card}]")
        hold_recorded(ro, recorded, "phase 9a", "generate()'s first chunk")
        del recorded

        # (b) calwf3 on the card and on the CPU
        flt = {}
        for where, extra in (("card", []), ("cpu", ["--cpu"])):
            flt[where] = os.path.join(d, f"flt_{where}")
            said = io.StringIO()
            with contextlib.redirect_stderr(said):
                rc, wall = _synced(lambda: run_calwf3.main(
                    ["-d", visit, "-p", yml, "-o", flt[where]] + extra))
            check(rc == 0 and len(os.listdir(flt[where])) == n,
                  f"run_calwf3 {' '.join(extra) or 'on the card'}: {n} flt "
                  f"files")
            print(f"timing [{card}]: run_calwf3 ({where}) "
                  f"{wall / n:.4f} s per file ({n} files, {wall:.3f} s)")
        names = sorted(os.listdir(flt["card"]))
        gap, within, differ = {"SCI": 0.0, "ERR": 0.0}, True, set()
        for name in names:
            a = _flt_planes(os.path.join(flt["card"], name))
            b = _flt_planes(os.path.join(flt["cpu"], name))
            for ext in gap:
                within &= np.allclose(a[ext], b[ext], rtol=1e-5, atol=1e-3)
                gap[ext] = max(gap[ext], float(np.abs(a[ext] - b[ext]).max()))
            differ |= {e for e in ("DQ", "SAMP", "TIME")
                       if not np.array_equal(a[e], b[e])}
        same = not differ
        sci = _flt_planes(os.path.join(flt["card"], names[0]))["SCI"]
        check(within and same and np.isfinite(sci).all()
              and sci.shape == (cfg.subarray,) * 2 and float(sci.max()) > 10.0,
              f"run_calwf3: every file's SCI and ERR card = CPU within rtol "
              f"1e-5, atol 1e-3 e-/s (largest gaps {gap['SCI']:.3g} and "
              f"{gap['ERR']:.3g} e-/s), DQ, SAMP and TIME identical "
              f"(differing: {sorted(differ) or 'none'}); SCI finite, peak "
              f"{float(sci.max()):.1f} e-/s")

        # reduce_visit of the files' reads, card and CPU
        reads, dqs = [], []
        for p in paths:
            _, r, _, q = read_ima(p, with_dq=True)
            reads.append(r)
            dqs.append(q)
        reads = torch.from_numpy(np.stack(reads).astype(np.float32))
        dqs = torch.from_numpy(np.stack(dqs))
        sc = obs.scenes
        mid = sc.exp_start_s + float(obs.tables.read_times[-1]) / 2.0
        orbit = tree_map(lambda x: x[0], sc.orbit)
        ld = sc.ld[0] if sc.ld.dim() == 2 else sc.ld[0].mean(dim=0)
        y_win, x_win, bg_rows = _auto_windows(
            (reads[:, -1] - reads[:, 0]).to("cuda"))
        print(f"  windows from the median net frame: rows {y_win}, columns "
              f"{x_win}, sky rows {bg_rows}")
        curves = {}
        # no align: the first orbit holds no transit, and without one the
        # drift regressor's contamination solve has no signal to fit
        # (tests/test_torch_cuda.py holds align on a visit with a transit)
        for opts in ("box", "optimal"):
            for where in ("cuda", "cpu"):
                dev = torch.device(where)
                kw = dict(y_window=y_win, x_window=x_win, bg_rows=bg_rows,
                          n_chan=RECOVER_CHAN,
                          good_diffs=red.good_diff_masks_from_dq(
                              dqs.to(dev)),
                          quad_map=quadrant_map(
                              cfg.subarray,
                              obs.tables.subarray_corner.tolist(),
                              device=dev))
                if opts == "optimal":
                    kw.update(optimal=True,
                              read_noise_e=obs.tables.readout_consts[0])
                rv, wall = _synced(lambda: red.reduce_visit(
                    reads.to(dev), obs.tables.gain.to(dev), mid.to(dev),
                    tree_map(lambda x: x.to(dev), orbit), **kw))
                curves[opts, where] = rv
                if where == "cuda":
                    print(f"timing [{card}]: reduce_visit ({opts}) {n} "
                          f"exposures of {cfg.subarray}^2 x {reads.shape[1]} "
                          f"reads "
                          f"{wall:.3f} s")
            a, b = curves[opts, "cuda"], curves[opts, "cpu"]
            dw = float((a.white_lc.cpu() - b.white_lc).abs().max())
            dc = float((a.channel_lc.cpu() - b.channel_lc).abs().max())
            ds = float((a.x_shifts.cpu() - b.x_shifts).abs().max())
            check(dw <= 5e-6 and dc <= 5e-6 and ds <= 1e-4
                  and bool(torch.isfinite(a.channel_lc).all()),
                  f"reduce_visit ({opts}, good_diffs, quad_map) "
                  f"card = CPU: white {dw:.3g}, channels {dc:.3g} (bar "
                  f"5e-6), x_shifts {ds:.3g} px (bar 1e-4)")
        a = curves["box", "cuda"]
        del curves, reads, dqs
        out, wall = _synced(lambda: red.divide_white_fit_depths(
            a.white_lc, a.channel_lc, mid, orbit, ld, 0.155,
            return_components=True))
        check(all(bool(torch.isfinite(o).all()) for o in out)
              and tuple(out[0].shape) == (RECOVER_CHAN,),
              f"divide_white_fit_depths on the card's curves: rp "
              f"{[round(v, 4) for v in out[0].tolist()]}, constrained "
              f"{red.constrained_mask(out[0], out[1]).tolist()} (the first "
              f"orbit holds no transit) in {wall * 1e3:.1f} ms [{card}]")
        del obs

    # (c) run_dataset --recover on the whole headline visit
    def cli(out: str, recover: bool) -> int:
        return run_dataset.main(
            ["-p", HEADLINE, "-o", out, "--n-mc", str(N_MC), "--chunk-mc",
             str(CHUNK_MC), "--rp-sigma", "0.002"]
            + (["--recover", str(RECOVER_CHAN)] if recover else []))

    with tempfile.TemporaryDirectory() as out:
        ro.exposure_readout.launches = 0
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            (rc, rec_call), recorded = recorded_readout(lambda: first_call(
                dataset, "spectra_to_depths", lambda: cli(out, True)))
        b1 = ro.exposure_readout.launches
        launches += b1
        with open(os.path.join(out, "manifest.json")) as fh:
            manifest = json.load(fh)
        n_exp = manifest["n_exp"]
        check(rc == 0 and b1 == N_MC * math.ceil(n_exp / CHUNK)
              and manifest["recovered"]
              and manifest["recover"]["n_chan"] == RECOVER_CHAN,
              f"phase 9c: run_dataset --recover {RECOVER_CHAN}: {b1} B1 "
              f"launches ({N_MC} realisations x {n_exp} exposures), "
              f"manifest recover {manifest['recover']}")
        print("  " + [ln for ln in said.getvalue().splitlines()
                      if ln.startswith("recovered labels")][0])
        data = dataset.load_dataset(out)
        err = np.abs(data["recovered_rp"] - data["label_rp"][:, None])
        tol = np.maximum(6.0 * data["recovered_rp_sigma"], 0.01)
        check(data["recovered_rp"].shape == (N_MC, RECOVER_CHAN)
              and bool(np.all(err < tol)),
              f"recovered depths within max(6 sigma, 0.01) of the injected: "
              f"largest |err| / tol {float((err / tol).max()):.3f}; "
              f"injected {np.round(data['label_rp'], 4).tolist()}, "
              f"recovered channel means "
              f"{np.round(data['recovered_rp'].mean(1), 4).tolist()}, "
              f"median sigma "
              f"{float(np.median(data['recovered_rp_sigma'])):.4g}")
        cpu = {k: tree_map(lambda x: x.cpu(), v) if k == "orbit" else
               (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in rec_call.items() if k != "spectra_e"}
        for c, name in enumerate(manifest["chunks"]):
            with np.load(os.path.join(out, name)) as z:
                got = {k: z[k] for k in z.files}
            want = [w.numpy() for w in red.spectra_to_depths(
                torch.from_numpy(got["spectra_e"]), **cpu)]
            d_rp = float(np.abs(got["recovered_rp"] - want[0]).max())
            d_sig = max(float(np.max(np.abs(got[k] - w) / np.abs(w)))
                        for k, w in zip(("recovered_rp_sigma",
                                         "recovered_rp_sigma_rel",
                                         "recovered_rp_sigma_common"),
                                        want[1:]))
            check(d_rp <= 1e-5 and d_sig <= 1e-3 and np.array_equal(
                got["recovered_constrained"],
                red.constrained_mask(want[0], want[1])),
                  f"{name}: the card's recovered labels = a CPU "
                  f"spectra_to_depths of the stored spectra: rp "
                  f"{d_rp:.3g} (bar 1e-5), sigmas {d_sig:.3g} relative "
                  f"(bar 1e-3), constrained flags identical")
    hold_recorded(ro, recorded, "phase 9c", "first ensemble batch")
    del recorded

    sp = rec_call["spectra_e"]
    args = {k: v for k, v in rec_call.items() if k != "spectra_e"}
    # the torch operators dispatched are counted too
    def operators(fn) -> int:
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            n = 0

            def __torch_dispatch__(self, func, types, a=(), kw=None):
                Count.n += 1
                return func(*a, **(kw or {}))

        with Count():
            fn()
        return Count.n

    counts, kept, ops = {}, {}, {}
    for k in (4, RECOVER_CHAN):
        call = lambda: red.spectra_to_depths(sp, **dict(args, n_chan=k))
        counts[k], kept[k] = kernels_in(call, records=True)
        ops[k] = operators(call)
    check(counts[4] == counts[RECOVER_CHAN] and ops[4] == ops[RECOVER_CHAN]
          and all(kept[k] <= counts[k] for k in counts),
          f"spectra_to_depths launches {counts[4]} kernels ({ops[4]} torch "
          f"operators) at 4 channels and {counts[RECOVER_CHAN]} "
          f"({ops[RECOVER_CHAN]}) at {RECOVER_CHAN}; the traces kept "
          f"{kept[4]} and {kept[RECOVER_CHAN]} kernel records")
    ms = cuda_ms(lambda: red.spectra_to_depths(sp, **args), reps=3,
                 warmup=1)
    print(f"timing [{card}]: spectra_to_depths {ms:.2f} ms and "
          f"{counts[RECOVER_CHAN]} kernels per chunk ({tuple(sp.shape)}, "
          f"{RECOVER_CHAN} channels)")

    # the dataset's rate with and without --recover, in turns
    real, spent = dataset.generate_dataset, {}

    def timed(*a, **kw):
        t0 = time.perf_counter()
        result = real(*a, **kw)
        spent.setdefault(kw.get("recover") is not None, []).append(
            time.perf_counter() - t0)
        return result

    dataset.generate_dataset = timed
    try:
        for recover in (False, True, True, False):
            with tempfile.TemporaryDirectory() as out, \
                    contextlib.redirect_stdout(io.StringIO()):
                cli(out, recover)
    finally:
        dataset.generate_dataset = real
    n = N_MC * n_exp
    for recover in (False, True):
        rates = ", ".join(f"{n / w:.2f}" for w in spent[recover])
        print(f"timing [{card}]: run_dataset {N_MC} visits x {n_exp} "
              f"exposures {'with' if recover else 'without'} --recover "
              f"{RECOVER_CHAN}: {rates} exposures/s (generate_dataset)")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the reduction CLIs at full width
# ---------------------------------------------------------------------------

RP_INJECTED = 0.1595        # the headline YAML's rp_over_rs (no spectrum)
FP_INJECTED = 5.0e-4        # the eclipse and phase-curve YAMLs' Fp/Fs
AMP_INJECTED, OFFSET_INJECTED_DEG = 0.9, 12.0    # the phase-curve YAML's
REDUCE_RUNS = (             # run_reduce on the uncut headline visit
    ("divide-white", ["--extract", "optimal", "--sky-fit", "--save-lc"]),
    ("ramp", ["--detrend", "ramp", "--fit-geometry", "--clip-sigma", "5"]),
    ("recte", ["--detrend", "recte"]),
)


def phase_curve_curves(obs, res, card: str) -> dict:
    """``reduce_visit`` of the phase-curve visit's reads on the card (CDS,
    the intervals its cosmic rays hit repaired from the simulator's hit
    lists, RECOVER_CHAN channels over the auto windows): the white and
    channel curves, the mid-times and the orbit, on the CPU, for phase
    10c."""
    from wayne_tpu_torch import reduction as red
    from wayne_tpu_torch.pytree import tree_map

    reads = res.reads_dn
    y_win, x_win, bg_rows = _auto_windows(reads[:, -1] - reads[:, 0])
    good = ~red.cr_bad_diff_masks(res.cr_pos, res.cr_count, reads.shape[-1])
    sc = obs.scenes
    mid = sc.exp_start_s + obs.detector_exptime / 2.0
    orbit = tree_map(lambda x: x[0], sc.orbit)
    rv, wall = _synced(lambda: red.reduce_visit(
        reads, obs.tables.gain, mid, orbit, y_window=y_win, x_window=x_win,
        bg_rows=bg_rows, n_chan=RECOVER_CHAN, good_diffs=good))
    print(f"timing [{card}]: reduce_visit of the phase-curve visit "
          f"({tuple(reads.shape)}, CR intervals repaired) {wall:.3f} s; "
          f"windows rows {y_win}, columns {x_win}, sky rows {bg_rows}")
    del good
    return dict(white=rv.white_lc.cpu(), chan=rv.channel_lc.cpu(),
                mid=mid.cpu(), orbit=tree_map(lambda x: x.cpu(), orbit),
                rp=float(sc.rp_over_rs[0].mean()))


def _reduce_cli(args: list, label: str, card: str) -> tuple:
    """``run_reduce.main(args)`` with its output captured, timed in four
    parts: the set-up before the extraction (the YAML, the calibration
    tables on the card, the first header), reading the files
    (``read_ima`` inside the extraction), the rest of the extraction, and
    everything after it (the fits and the report). Returns (the report,
    the extraction's return value, the seconds)."""
    import torch

    from wayne_tpu_torch import run_reduce

    real_read, real_extract = run_reduce.read_ima, run_reduce.extract_from_files
    spent = {"read": 0.0}
    got = {}

    def read(*a, **kw):
        t0 = time.perf_counter()
        out = real_read(*a, **kw)
        spent["read"] += time.perf_counter() - t0
        return out

    def extract(*a, **kw):
        torch.cuda.synchronize()
        spent["setup"] = time.perf_counter() - t_main
        spent["read"] = 0.0           # the header read before it is not
        out, wall = _synced(lambda: real_extract(*a, **kw))
        spent["extract"] = wall
        got["extracted"] = out
        return out

    run_reduce.read_ima, run_reduce.extract_from_files = read, extract
    said = io.StringIO()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    try:
        with contextlib.redirect_stdout(said):
            rc, wall = _synced(lambda: run_reduce.main(args))
    finally:
        run_reduce.read_ima, run_reduce.extract_from_files = (
            real_read, real_extract)
    out = args[args.index("-o") + 1]
    with open(out) as fh:
        report = json.load(fh)
    secs = dict(setup=spent["setup"], read=spent["read"],
                extract=spent["extract"] - spent["read"],
                fits=wall - spent["setup"] - spent["extract"], total=wall)
    check(rc == 0, f"run_reduce {label}: rc 0; "
          + "; ".join(ln for ln in said.getvalue().splitlines()
                      if ln.startswith(("white", "channel", "robust",
                                        "auto windows")))[:600])
    print(f"timing [{card}]: run_reduce {label}: {secs['total']:.3f} s = "
          f"set-up {secs['setup']:.3f} s + reading files "
          f"{secs['read']:.3f} s + extraction {secs['extract']:.3f} s + "
          f"fits and report {secs['fits']:.3f} s")
    return report, got["extracted"], secs


def _replay_on_cpu(args: list, extracted, label: str) -> dict:
    """The same ``run_reduce`` flags on the CPU, fed the spectra the card
    extracted (read back from ``spectra.fits``) and the card's windows,
    mid-times, scan angles and sky fit in place of the extraction: the
    fits alone, card against CPU. Returns the CPU's report."""
    import torch

    from wayne_tpu_torch import run_reduce
    from wayne_tpu_torch.io.fits import read_fits

    visit = args[args.index("-d") + 1]
    planes = {h.get("EXTNAME"): d
              for h, d in read_fits(os.path.join(visit, "spectra.fits"))[1:]}
    spectra = torch.from_numpy(planes["SPECTRA"].astype("float32"))
    _, mids, windows, angs, sky = extracted
    check(set(planes) == {"SPECTRA", "WAVELENGTH", "TIME"}
          and torch.equal(spectra, extracted[0].cpu())
          and (planes["TIME"] == mids).all(),
          f"spectra.fits ({label}): SPECTRA {tuple(spectra.shape)}, "
          "WAVELENGTH and TIME, the card's extracted spectra exactly")
    real = run_reduce.extract_from_files
    run_reduce.extract_from_files = (
        lambda *a, **kw: (spectra, mids, windows, angs, sky))
    out = args[args.index("-o") + 1].replace(".json", "_cpu.json")
    cpu_args = [a for a in args if a not in ("--plot", "--save-spectra")]
    cpu_args[cpu_args.index("-o") + 1] = out
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, wall = _synced(lambda: run_reduce.main(cpu_args + ["--cpu"]))
    finally:
        run_reduce.extract_from_files = real
    print(f"  the fits of run_reduce {label} on the CPU: {wall:.3f} s")
    with open(out) as fh:
        return json.load(fh)


def _within_6_sigma(report: dict, label: str) -> None:
    """White Rp/Rs (when fitted) and every channel depth of a transit
    report within max(6 sigma, 0.01) of the injected Rp/Rs."""
    rows = [(f"channel {i}", c["rp_over_rs"], c["rp_sigma"])
            for i, c in enumerate(report["channels"])]
    for key in ("white_ramp_fit", "white_recte_fit"):
        if key in report:
            rows.insert(0, ("white", report[key]["rp_over_rs"],
                            report[key]["rp_sigma"]))
    worst = max(abs(v - RP_INJECTED) / max(6.0 * sg, 0.01)
                for _, v, sg in rows)
    check(worst < 1.0,
          f"run_reduce {label}: recovered depths within max(6 sigma, 0.01) "
          f"of the injected {RP_INJECTED} (largest |err| / bar "
          f"{worst:.3f}): "
          + ", ".join(f"{n} {v:.5f} +- {sg:.5f}" for n, v, sg in rows))


def _phase_curve_fits(pc: dict, card: str) -> None:
    """``fit_phase_curve`` of the phase-curve visit's white and channel
    curves (``phase_curve_curves``) on the card and on the CPU: card =
    CPU, and fp, A and the offset within 6 sigma of the injected values
    on the white curve and on the interior channels: the pointing drift
    moves the spectrum's two ends through the window's edge channels, a
    systematic this unaligned reduction leaves in them."""
    import torch

    import wayne_tpu_torch.reduction as red
    from wayne_tpu_torch.pytree import tree_map

    fits = {}
    for k, where in enumerate(("cuda", "cpu")):
        on = lambda x: x.to(torch.device(where))
        orbit = tree_map(on, pc["orbit"])
        for label, lc in (("white", pc["white"]), ("channels", pc["chan"])):
            fits[label, k], wall = _synced(lambda: red.fit_phase_curve(
                on(lc), on(pc["mid"]), orbit, pc["rp"]))
            if k == 0:
                print(f"timing [{card}]: fit_phase_curve ({label}, "
                      f"{tuple(lc.shape)}) {wall * 1e3:.2f} ms")
    for label in ("white", "channels"):
        a, b = fits[label, 0], fits[label, 1]
        # the CPU tests' bars (tests/test_torch_sky_phase_fits.py): fp, A
        # and the offset within 0.1 of their sigmas or the harmonic
        # coefficients' float32 floor, fp_sigma rtol 1e-3, amp_sigma within
        # 1e-3 + 0.2 sigma_fp / |fp| relative
        fp = b.fp.abs()
        s_off = b.amp_sigma / b.amp.clamp_min(1e-9)
        amp_of_bar = float(((a.amp_sigma.cpu() / b.amp_sigma - 1.0).abs()
                            / (1e-3 + 0.2 * b.fp_sigma / fp)).max())
        gap = {k: float(((getattr(a, k).cpu() - getattr(b, k)).abs()
                         / bar).max())
               for k, bar in (
                   ("fp", torch.clamp_min(0.1 * b.fp_sigma, 1e-5)),
                   ("amp", torch.maximum(0.1 * b.amp_sigma, 3e-5 / fp)),
                   ("offset_rad", torch.maximum(0.1 * s_off,
                                                2e-5 / (b.amp * fp))))}
        gap.update({k: float(((getattr(a, k).cpu() - getattr(b, k)).abs()
                              / getattr(b, k)).max())
                    for k in ("fp_sigma", "amp_sigma")})
        check(max(gap["fp"], gap["amp"], gap["offset_rad"]) <= 1.0
              and gap["fp_sigma"] <= 1e-3 and amp_of_bar <= 1.0,
              f"fit_phase_curve ({label}) card = CPU: fp, A and the offset "
              f"{gap['fp']:.3g}, {gap['amp']:.3g} and {gap['offset_rad']:.3g}"
              f" of their bars apart (0.1 sigma or the float32 floor), "
              f"fp_sigma "
              f"{gap['fp_sigma']:.3g} relative (bar 1e-3), amp_sigma "
              f"{gap['amp_sigma']:.3g} relative, {amp_of_bar:.3g} of its bar "
              f"1e-3 + 0.2 sigma_fp / |fp|")
        # the offset's sigma: the harmonic vector's tangential error, its
        # radial one (amp_sigma / amp) for an isotropic covariance
        keep = torch.ones(b.fp.numel(), dtype=torch.bool)
        if label != "white":
            keep[[0, -1]] = False
        fp, amp, off = (b.fp.reshape(-1)[keep], b.amp.reshape(-1)[keep],
                        torch.rad2deg(b.offset_rad.reshape(-1)[keep]))
        s_fp = b.fp_sigma.reshape(-1)[keep]
        s_amp = b.amp_sigma.reshape(-1)[keep]
        s_off = torch.rad2deg(s_amp / amp.clamp_min(1e-9))
        worst = float(torch.stack([
            (fp - FP_INJECTED).abs() / (6 * s_fp),
            (amp - AMP_INJECTED).abs() / (6 * s_amp),
            (off - OFFSET_INJECTED_DEG).abs() / (6 * s_off)]).max())
        check(worst <= 1.0,
              f"phase curve ({label}"
              + ("" if label == "white" else
                 f", the {int(keep.sum())} interior ones") + "): fp, A and "
              "the offset within 6 sigma "
              f"of {FP_INJECTED}, {AMP_INJECTED}, {OFFSET_INJECTED_DEG} deg "
              f"(largest |err| / 6 sigma {worst:.3f}): fp "
              f"{[round(v, 6) for v in fp.tolist()]} +- "
              f"{[round(v, 6) for v in s_fp.tolist()]}, A "
              f"{[round(v, 3) for v in amp.tolist()]} +- "
              f"{[round(v, 3) for v in s_amp.tolist()]}, offset "
              f"{[round(v, 1) for v in off.tolist()]} deg")


def phase_reduce_cli(card: str, phase_curves: dict, root: str) -> int:
    """The reduction CLIs at full width on the card. (a) ``etc.predict``
    of the headline YAML: B1 once (noise flags off) and held against its
    plain version, the report against the CPU's at rtol 1e-5. (b) The
    uncut headline visit through ``run_visit --quicklook`` (B1 held on its
    first chunk, the PNGs), then ``run_reduce`` three times (REDUCE_RUNS),
    each timed in parts, its depths within max(6 sigma, 0.01) of the
    injected ones, its fits held against the same fits on the CPU on the
    spectra the card extracted (``compare_reports``), and
    ``fit_white_ramp`` / ``fit_white_recte`` timed with their launch calls
    counted. (c) The eclipse visit through ``run_reduce --mode eclipse
    --detrend ramp`` (Fp/Fs within 6 sigma of the injected), and
    ``fit_phase_curve`` on phase 7's phase-curve curves (fp, A and the
    offset within 6 sigma; card against CPU). The uncut visit stays in
    ``root``/visit for phase 11. Returns B1's launches."""
    import dataclasses

    import numpy as np
    import torch

    import importlib.util

    import wayne_tpu_torch.reduction as red
    from wayne_tpu_torch import diagnostics, etc, run_visit
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.ops import recte
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.run_reduce import compare_reports
    from wayne_tpu_torch.utils import profiling

    launches = 0
    print("phase 10: the reduction CLIs at full width")

    # (a) the exposure-time calculator
    cfg = load_yaml(HEADLINE)
    ro.exposure_readout.launches = 0
    (rep, wall), recorded = recorded_readout(
        lambda: _synced(lambda: etc.predict(cfg)))
    b1 = ro.exposure_readout.launches
    launches += b1
    _, again = _synced(lambda: etc.predict(cfg))
    t0 = time.perf_counter()
    cpu = etc.predict(cfg, device="cpu")
    t_cpu = time.perf_counter() - t0
    gaps = {}
    for f in dataclasses.fields(rep):
        a, b = getattr(rep, f.name), getattr(cpu, f.name)
        if isinstance(a, float) or (a and isinstance(a, list)
                                    and isinstance(a[0], float)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            gaps[f.name] = float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-30)))
        else:
            gaps[f.name] = 0.0 if a == b else math.inf
    check(b1 == 1 and max(gaps.values()) <= 1e-5,
          f"phase 10a: etc.predict of {os.path.relpath(HEADLINE, HERE)} "
          f"(512^2, NSAMP {cfg.nsamp}): {b1} B1 launch (noise flags off); "
          f"card = CPU within rtol 1e-5 (largest "
          f"{max(gaps, key=gaps.get)} {max(gaps.values()):.3g}); "
          + rep.summary().replace("\n", "; "))
    print(f"timing [{card}]: etc.predict {wall:.3f} s first call, "
          f"{again:.3f} s second; {t_cpu:.3f} s on the CPU")
    hold_recorded(ro, recorded, "phase 10a", "etc.predict's exposure")
    del recorded

    # (b) the uncut headline visit: run_visit --quicklook, run_reduce x 3.
    # The PNGs need matplotlib; where it is not installed, the quicklook's
    # read-back and reduction run on the card without the drawing.
    plots = importlib.util.find_spec("matplotlib") is not None
    obs = Observation(cfg)
    n_exp = obs.plan.n_exposures
    fit_calls = {}
    with contextlib.nullcontext(root) as d:
        visit = os.path.join(d, "visit")
        ro.exposure_readout.launches = 0
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            (rc, wall), recorded = recorded_readout(lambda: _synced(
                lambda: run_visit.main(
                    ["-p", HEADLINE, "-o", visit, "--chunk", str(CHUNK)]
                    + (["--quicklook"] if plots else []))))
        b1 = ro.exposure_readout.launches
        launches += b1
        n_files = len([f for f in os.listdir(visit)
                       if f.endswith("_ima.fits")])
        check(rc == 0 and n_files == n_exp
              and b1 == math.ceil(n_exp / CHUNK) + 1,
              f"phase 10b: run_visit{' --quicklook' * plots} of the uncut "
              f"visit: {n_files} ima files, {b1} B1 launches "
              f"({math.ceil(n_exp / CHUNK)} chunks + the direct image) in "
              f"{wall:.3f} s")
        if plots:
            pngs = [f for f in ("exposure0.png", "visit_lightcurve.png")
                    if os.path.getsize(os.path.join(visit, f)) > 10_000]
            check(len(pngs) == 2, f"quicklooks {' and '.join(pngs)}")
        else:
            reads, t_read = _synced(lambda: run_visit.read_back(obs, visit))
            (rv, _), t_red = _synced(
                lambda: diagnostics.quicklook_curves(obs, reads))
            check(tuple(reads.shape) == (n_exp, cfg.nsamp + 1, cfg.subarray,
                                         cfg.subarray)
                  and bool(torch.isfinite(rv.white_lc).all())
                  and tuple(rv.channel_lc.shape) == (n_exp, 8),
                  f"matplotlib is not installed here, so no PNG is drawn: "
                  f"the quicklook's read-back ({t_read:.3f} s, "
                  f"{reads.nbytes / 1e9:.2f} GB) and its reduce_visit on "
                  f"the card ({t_red:.3f} s) ran, curves finite")
            del reads, rv
        hold_recorded(ro, recorded, "phase 10b", "generate()'s first chunk")
        del recorded

        real_fits = {k: getattr(red, k)
                     for k in ("fit_white_ramp", "fit_white_recte")}

        def keep(name):    # the card's calls (not the replays'), timed,
            def call(*a, **kw):     # with the R1 launches the host makes
                if not a[0].is_cuda:
                    return real_fits[name](*a, **kw)
                recte.white_ramp.launches = 0
                out, wall = _synced(lambda: real_fits[name](*a, **kw))
                fit_calls[name] = (a, kw, wall, recte.white_ramp.launches)
                return out
            return call

        for name in real_fits:
            setattr(red, name, keep(name))
        try:
            for label, extra in REDUCE_RUNS:
                args = ["-d", visit, "-p", HEADLINE, "-o",
                        os.path.join(d, f"{label}.json"), "--save-spectra",
                        *extra, *(["--plot"] if plots and label ==
                                  "divide-white" else [])]
                report, extracted, _ = _reduce_cli(args, label, card)
                _within_6_sigma(report, label)
                cpu = _replay_on_cpu(args, extracted, label)
                gaps = compare_reports(report, cpu)
                check(not gaps, f"run_reduce {label}: the card's report = "
                      f"the CPU's fits of the same spectra within the "
                      f"CPU tests' bars ({len(gaps)} gaps: {gaps[:4]})")
                if label == "divide-white":
                    check(report["sky_fit"]["components"][0] == "constant"
                          and len(report["channel_lc"]) == n_exp
                          and (not plots or os.path.getsize(os.path.join(
                              d, "divide-white.png")) > 10_000),
                          "the sky fit and the --save-lc curves in the "
                          "report" + (", the --plot quicklook" if plots
                                      else ""))
        finally:
            for name, fn in real_fits.items():
                setattr(red, name, fn)

    # the white fits: the card's time in the CLI runs, the launch calls of
    # the same calls. On a card the first LM step runs eagerly and the rest
    # replay a CUDA graph of one step, so the host's launch calls, R1's
    # among them, are the same at any step count: traces at 2, 4 and 6
    # steps show them so, beside the program's spans (each LM call on the
    # card: 1 eager step, 1 capture, n - 1 replays; the geometry fit's
    # vmapped seed fits run their 25 steps eagerly), in a fraction of a
    # full trace's time.
    a, kw, _, _ = fit_calls["fit_white_ramp"]
    plain = dict(kw, fit_geometry=False, clip_sigma=None)
    recte.white_ramp.launches = 0
    _, t_plain = _synced(lambda: red.fit_white_ramp(*a, **plain))
    fit_calls["fit_white_ramp plain"] = (a, plain, t_plain,
                                         recte.white_ramp.launches)
    for label, name, n_iter in (
            ("fit_white_ramp", "fit_white_ramp plain", 60),
            ("fit_white_ramp (fit_geometry, clip_sigma 5)",
             "fit_white_ramp", 60),
            ("fit_white_recte", "fit_white_recte", 80)):
        fa, fkw, wall, r1 = fit_calls[name]
        fit = red.fit_white_recte if "recte" in name else red.fit_white_ramp
        t0 = time.perf_counter()
        counts, steps, r1_at = [], [], []
        for k in (2, 4, 6):
            recte.white_ramp.launches = 0
            with profiling.tracing() as spans:
                counts.append(kernels_in(
                    lambda: fit(*fa, **dict(fkw, n_iter=k)), warmup=False))
            names = [sp.name for sp in spans.spans]
            steps.append([names.count(n)
                          for n in ("lm.step", "lm.capture", "lm.replay")])
            r1_at.append(recte.white_ramp.launches)
        calls, (eager, graphs, _) = counts[0], steps[0]
        check(counts == [calls] * 3 and calls > 0 and graphs > 0
              and steps == [[eager, graphs, graphs * (k - 1)]
                            for k in (2, 4, 6)],
              f"{label}: launch calls at 2, 4 and 6 steps {counts}, the "
              f"same at any step count; the LM's spans (lm.step, "
              f"lm.capture, lm.replay) {steps}: {graphs} LM call(s) on "
              f"the card, each replaying its step n - 1 times")
        check(r1_at == [r1] * 3 and (r1 > 0) == ("recte" in name),
              f"{label}: the host issued {r1} R1 launches "
              f"(white_ramp.launches) at {n_iter} steps and {r1_at} at 2, "
              f"4 and 6")
        if "recte" in name:
            R1_LAUNCHES["phase 10"] = r1
        print(f"timing [{card}]: {label} on the visit's white curve "
              f"({n_exp} exposures, {n_iter} steps): {wall * 1e3:.1f} ms, "
              f"{calls} kernel launch calls and {graphs * (n_iter - 1)} "
              f"replays of a step's graph (traced in "
              f"{time.perf_counter() - t0:.1f} s)")
    del fit_calls

    # (c) the eclipse visit through run_reduce, the phase curve's fit
    del obs
    ecl = load_yaml(ECLIPSE)
    obs = Observation(ecl)
    with tempfile.TemporaryDirectory() as d:
        visit = os.path.join(d, "visit")
        ro.exposure_readout.launches = 0
        paths, wall = _synced(lambda: obs.generate(
            visit, chunk=CHUNK, progress=lambda s: None))
        b1 = ro.exposure_readout.launches
        launches += b1
        n = obs.plan.n_exposures
        check(len(paths) == n and b1 == math.ceil(n / CHUNK) + 1,
              f"phase 10c: generate() of {os.path.relpath(ECLIPSE, HERE)}: "
              f"{len(paths)} ima files, {b1} B1 launches, {wall:.3f} s")
        del obs
        args = ["-d", visit, "-p", ECLIPSE, "-o",
                os.path.join(d, "eclipse.json"), "--mode", "eclipse",
                "--detrend", "ramp", "--save-spectra"]
        report, extracted, _ = _reduce_cli(args, "--mode eclipse", card)
        w = report["white_ramp_fit"]
        check(abs(w["fp_over_fs"] - FP_INJECTED) <= 6.0 * w["fp_sigma"],
              f"eclipse: white Fp/Fs {w['fp_over_fs']:.6f} +- "
              f"{w['fp_sigma']:.6f} within 6 sigma of the injected "
              f"{FP_INJECTED}; channels "
              + ", ".join(f"{c['fp_over_fs']:.5f}"
                          for c in report["channels"]))
        cpu = _replay_on_cpu(args, extracted, "--mode eclipse")
        gaps = compare_reports(report, cpu)
        check(not gaps, f"run_reduce --mode eclipse: card = CPU fits "
              f"within the bars ({len(gaps)} gaps: {gaps[:4]})")

    _phase_curve_fits(phase_curves, card)
    print(f"phase 10: {launches} B1 launches")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: inference (run_reduce --mcmc, run_retrieve, --program --mcmc)
# ---------------------------------------------------------------------------

MCMC_STEPS = 1000           # run_reduce --mcmc's steps (the CPU tests')
MCMC_RUNS = (               # run_reduce --mcmc on the uncut headline visit
    ("divide-white", []),
    ("ramp --fit-geometry", ["--detrend", "ramp", "--fit-geometry"]),
)
# run_retrieve on the same files: 8 channels, one B1 launch per chunk of
# CHUNK exposures, 4 LM steps
RETRIEVE_ARGS = ["--n-chan", "8", "--chunk", str(CHUNK), "--n-lm", "4"]
PROGRAM_MCMC = 1000         # run_retrieve --program --mcmc's steps


def _same_law(got, want, label: str, bars=(0.25, 0.25)) -> tuple:
    """Two posterior summaries (median, half-width) by their law, at the
    CPU tests' bars: the medians within ``bars[0]`` of the half-width, the
    half-widths within ``bars[1]`` relative. Returns the two gaps."""
    (m_g, w_g), (m_w, w_w) = got, want
    gap = abs(m_g - m_w) / w_w, abs(w_g / w_w - 1.0)
    check(gap[0] <= bars[0] and gap[1] <= bars[1],
          f"{label}: card {m_g:.6g} +- {w_g:.3g}, CPU {m_w:.6g} +- "
          f"{w_w:.3g}: medians {gap[0]:.3f} of the half-width apart (bar "
          f"{bars[0]}), half-widths {gap[1]:.1%} (bar {bars[1]:.0%})")
    return gap


def _pct(x, q=(16.0, 50.0, 84.0)):
    """(median, half-width) of samples from their 16/50/84 percentiles."""
    import numpy as np

    lo, mid, hi = np.percentile(np.asarray(x, np.float64), q)
    return mid, 0.5 * (hi - lo)


def _steps_launches(fn, label: str, card: str) -> float:
    """Kernel launch calls per sampler step: ``fn(k)`` samples k steps;
    traces at 20 and 40 steps (the set-up is the same in both)."""
    a, b = (kernels_in(lambda: fn(k), warmup=False) for k in (20, 40))
    per = (b - a) / 20.0
    print(f"launches [{card}]: {label}: {per:.1f} kernel launch calls per "
          f"ensemble step ({a} at 20 steps, {b} at 40)")
    return per


def _twin_jacobian(dev, k_chunk: int, x_window, n_chan: int,
                   h: float = 2e-3):
    """The model twin's channel sums of the headline visit's chunk
    ``k_chunk`` (CHUNK exposures) at ``run_retrieve``'s own start, every
    one of ``n_chan`` channel depths at the YAML's flat Rp/Rs, on ``dev``:
    their Jacobian by ``torch.func.jacfwd`` and by central finite
    differences with step ``h`` (each perturbed bin then sits on a control
    node of the interpolated light curve), both (CHUNK, n_chan, n_chan),
    and B1's launches in the ``jacfwd`` call."""
    import dataclasses

    import torch

    from wayne_tpu_torch import retrieval as ret
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.pytree import tree_map
    from wayne_tpu_torch.reduction import _channel_edges, _channel_flux

    obs = Observation(load_yaml(HEADLINE), device=dev)
    sc = ret.deterministic_scenes(tree_map(
        lambda x: x[k_chunk * CHUNK: (k_chunk + 1) * CHUNK], obs.scenes))
    twin = ret.deterministic_cfg(obs.static)
    idx, in_win = ret.bin_channel_map(sc, obs.tables, x_window, n_chan)
    idx = torch.as_tensor(idx, device=dev)
    in_win = torch.as_tensor(in_win, dtype=torch.float32, device=dev)
    edges = _channel_edges(x_window, n_chan)
    fixed = sc.rp_over_rs[0]

    def channels(depth):
        rp = in_win * depth[idx] + (1.0 - in_win) * fixed
        s = dataclasses.replace(sc, rp_over_rs=rp[None].expand(sc.n, -1))
        return _channel_flux(ret.forward_spectra(s, obs.tables, twin,
                                                 chunk=CHUNK), edges)

    start = torch.full((n_chan,), RP_INJECTED, device=dev)
    ro.exposure_readout.launches = 0
    J = torch.func.jacfwd(channels)(start)
    n = ro.exposure_readout.launches
    step = h * torch.eye(n_chan, device=dev)
    fd = torch.stack([(channels(start + e) - channels(start - e)) / (2 * h)
                      for e in step], dim=-1)
    return J.cpu(), fd.cpu(), n


def phase_inference(card: str, root: str) -> int:
    """Inference at full width on the card: (a) ``run_reduce --mcmc`` on
    phase 10's uncut headline visit (``root``/visit), divide-white and
    with the ramp and a free ephemeris; (b) ``run_retrieve`` on the same
    files, the model twin's readout B1 through its autograd Function; (c)
    ``run_retrieve --program --mcmc`` on phase 7's three-visit program
    (``root``/program). Returns (B1's launches, B1's numbers on the model
    twin's chunk)."""
    import dataclasses

    import numpy as np
    import torch

    from torch.autograd import forward_ad

    from wayne_tpu_torch import mcmc, retrieval, run_retrieve
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.ops.kepler import projected_separation
    from wayne_tpu_torch.pytree import tree_map

    visit, program = os.path.join(root, "visit"), os.path.join(root, "program")
    launches = 0
    print("phase 11: inference at full width")
    t_phase = time.time()

    # (a) run_reduce --mcmc: the card's samplers recorded, replayed on the
    # CPU on the same curves
    real = {k: getattr(mcmc, k) for k in ("sample_white_posterior",
                                          "sample_channel_posteriors")}
    calls = {}

    def keep(name):
        def call(*a, **kw):
            out, wall = _synced(lambda: real[name](*a, **kw))
            calls[name] = (a, kw, wall, out)
            return out
        return call

    cpu = lambda v: (v.cpu() if isinstance(v, torch.Tensor)
                     else tree_map(lambda x: x.cpu(), v)
                     if dataclasses.is_dataclass(v) else v)
    for i, (label, extra) in enumerate(MCMC_RUNS):
        for name in real:
            setattr(mcmc, name, keep(name))
        ro.exposure_readout.launches = 0
        try:
            report, _, secs = _reduce_cli(
                ["-d", visit, "-p", HEADLINE, "-o",
                 os.path.join(root, f"mcmc{i}.json"), "--mcmc",
                 str(MCMC_STEPS), *extra], f"--mcmc {MCMC_STEPS} {label}",
                card)
        finally:
            for name, fn in real.items():
                setattr(mcmc, name, fn)
        launches += ro.exposure_readout.launches
        wp = report["white_posterior"]
        w_white = 0.5 * (wp["depth_plus"] + wp["depth_minus"])
        rows = [("white", wp["rp_over_rs_median"], w_white, None, None)]
        if "white_ramp_fit" in report:
            lm = report["white_ramp_fit"]
            rows[0] = rows[0][:3] + (lm["rp_over_rs"], lm["rp_sigma"])
        rows += [(f"channel {k}", c["rp_mcmc_median"],
                  0.5 * (c["rp_mcmc_plus"] + c["rp_mcmc_minus"]),
                  c["rp_over_rs"], c["rp_sigma"])
                 for k, c in enumerate(report["channels"])]
        worst = max(abs(m - RP_INJECTED) / max(6.0 * w, 0.01)
                    for _, m, w, _, _ in rows)
        lm_gap = max(abs(m - d) / s for _, m, _, d, s in rows
                     if d is not None)
        check(worst < 1.0 and lm_gap <= 1.0,
              f"run_reduce --mcmc {label}: posterior medians within max(6 "
              f"sigma, 0.01) of the injected {RP_INJECTED} (largest |err| "
              f"/ bar {worst:.3f}) and within the LM depth's 1 sigma "
              f"(largest {lm_gap:.3f} sigma): "
              + ", ".join(f"{n} {m:.5f} +- {w:.5f}"
                          for n, m, w, _, _ in rows))
        print(f"  white posterior: acceptance {wp['acceptance']}, split "
              f"R-hat max {wp['rhat_max']}, ESS min {wp['ess_min']}; "
              f"channels R-hat "
              f"{[c['rp_mcmc_rhat'] for c in report['channels']]}, ESS "
              f"{[c['rp_mcmc_ess'] for c in report['channels']]}")
        # the same samplers on the CPU, on the same curves
        a_w, kw_w, t_white, post_w = calls["sample_white_posterior"]
        a_c, kw_c, t_chan, post_c = calls["sample_channel_posteriors"]
        on_cpu = lambda n, a, kw: _synced(lambda: real[n](
            *[cpu(v) for v in a], **{k: cpu(v) for k, v in kw.items()}))
        cpu_w, t_white_cpu = on_cpu("sample_white_posterior", a_w, kw_w)
        cpu_c, t_chan_cpu = on_cpu("sample_channel_posteriors", a_c, kw_c)
        half = lambda p: float(0.5 * (p.rp_plus + p.rp_minus))
        gaps = [_same_law((float(post_w.rp_median), half(post_w)),
                          (float(cpu_w.rp_median), half(cpu_w)),
                          f"--mcmc {label}: white posterior, card vs CPU")]
        for k in range(post_c.rp_median.shape[0]):
            w_g = float(0.5 * (post_c.rp_plus[k] + post_c.rp_minus[k]))
            w_w = float(0.5 * (cpu_c.rp_plus[k] + cpu_c.rp_minus[k]))
            gaps.append(_same_law((float(post_c.rp_median[k]), w_g),
                                  (float(cpu_c.rp_median[k]), w_w),
                                  f"--mcmc {label}: channel {k}, card vs "
                                  "CPU"))
        if "--fit-geometry" in extra:
            # the free ephemeris's chain does not converge in MCMC_STEPS
            # (split R-hat ~2): the CPU tests' bars for its percentiles
            for j, name in ((6, "t0 offset"), (7, "a/Rs"), (8, "cos i")):
                gaps.append(_same_law(
                    _pct(post_w.samples[:, j].cpu()),
                    _pct(cpu_w.samples[:, j]),
                    f"--mcmc {label}: {name}, card vs CPU", (0.5, 0.35)))
        print(f"timing [{card}]: --mcmc {label}: white posterior "
              f"{t_white:.3f} s on the card, {t_white_cpu:.3f} s on the "
              f"CPU; channel posteriors {t_chan:.3f} s, {t_chan_cpu:.3f} s; "
              f"the run {secs['total']:.3f} s; largest card-CPU gaps "
              f"{max(g[0] for g in gaps):.3f} of a half-width, "
              f"{max(g[1] for g in gaps):.1%} in width")
        if i == 0:
            _steps_launches(lambda k: real["sample_channel_posteriors"](
                *a_c, **dict(kw_c, n_steps=k, n_burn=k // 2)),
                "sample_channel_posteriors (8 ensembles of 16 walkers)",
                card)
            _steps_launches(lambda k: real["sample_white_posterior"](
                *a_w, **dict(kw_w, n_steps=k, n_burn=k // 2)),
                "sample_white_posterior (32 walkers)", card)
        del calls["sample_white_posterior"], calls["sample_channel_posteriors"]

    # (b) run_retrieve on the same files: one noise-off chunk recorded (the
    # chunk holding mid-transit, from a residual-only pass), the LM and the
    # covariance timed
    cfg = load_yaml(HEADLINE)
    obs = Observation(cfg)
    n_exp = obs.plan.n_exposures
    z, _ = projected_separation(
        obs.scenes.exp_start_s + 0.5 * obs.detector_exptime,
        tree_map(lambda x: x[0], obs.scenes.orbit))
    k_chunk = int(torch.argmin(z)) // CHUNK
    n_chunks = math.ceil(n_exp / CHUNK)
    del obs
    import wayne_tpu_torch.ops.exposure as ex
    real_ro, real_read = ex.exposure_readout, run_retrieve.raw_column_sums
    real_lm, real_fit = retrieval._lm, retrieval.retrieve_transmission
    real_vj = retrieval._lm_val_jac
    plain_calls, spent, recorded, vj_calls = [0], {"read": 0.0}, [], []

    def readout(*a, **kw):
        bands = kw["bands"]
        if not (bands.requires_grad or forward_ad.unpack_dual(
                bands).tangent is not None):
            if plain_calls[0] == k_chunk:
                recorded.append(dict(kw))
            plain_calls[0] += 1
        return real_ro(*a, **kw)

    def read(*a, **kw):
        out, wall = _synced(lambda: real_read(*a, **kw))
        spent["read"] += wall
        return out

    def fit(*a, **kw):
        out, wall = _synced(lambda: real_fit(*a, **kw))
        spent["fit"] = wall
        return out

    def lm(*a, **kw):
        out, wall = _synced(lambda: real_lm(*a, **kw))
        spent["lm"] = wall
        return out

    def val_jac(*a, **kw):
        if not vj_calls:
            vj_calls.append((a, kw))
        vj_calls.append(None)
        return real_vj(*a, **kw)

    ex.exposure_readout, run_retrieve.raw_column_sums = readout, read
    retrieval._lm, retrieval.retrieve_transmission = lm, fit
    retrieval._lm_val_jac = val_jac
    out = os.path.join(root, "retrieved.json")
    ro.exposure_readout.launches = 0
    said = io.StringIO()
    try:
        with contextlib.redirect_stdout(said):
            rc, wall = _synced(lambda: run_retrieve.main(
                ["-d", visit, "-p", HEADLINE, "-o", out, *RETRIEVE_ARGS]))
    finally:
        ex.exposure_readout, run_retrieve.raw_column_sums = real_ro, real_read
        retrieval._lm, retrieval.retrieve_transmission = real_lm, real_fit
        retrieval._lm_val_jac = real_vj
    b1 = ro.exposure_readout.launches
    launches += b1
    n_vj = len(vj_calls) - 1
    with open(out) as fh:
        rep = json.load(fh)
    check(rc == 0 and b1 > 0 and b1 == n_vj * n_chunks,
          f"phase 11b: run_retrieve {' '.join(RETRIEVE_ARGS)} of the uncut "
          f"visit ({n_exp} files): {b1} B1 launches = {n_vj} residual "
          f"passes ({rep['lm_iterations']} LM iterations) x {n_chunks} "
          f"chunks; " + said.getvalue().splitlines()[-1])
    rows = [(c["rp_over_rs"], c["rp_sigma"]) for c in rep["channels"]]
    worst = max(abs(v - RP_INJECTED) / max(6.0 * s, 0.01) for v, s in rows)
    check(worst < 1.0,
          f"run_retrieve: retrieved Rp/Rs within max(6 sigma, 0.01) of the "
          f"injected {RP_INJECTED} (largest |err| / bar {worst:.3f}): "
          + ", ".join(f"{v:.5f} +- {s:.5f}" for v, s in rows)
          + f"; chi2/dof {rep['chi2_per_dof']}")
    fit_t, lm_t = spent["fit"], spent["lm"]
    print(f"timing [{card}]: run_retrieve {wall:.3f} s = set-up "
          f"{wall - spent['read'] - fit_t:.3f} s + reading files "
          f"{spent['read']:.3f} s + LM {lm_t:.3f} s + covariance and the "
          f"fit's binning {fit_t - lm_t:.3f} s")
    kw = recorded[0]
    names = ("seed", "y0s", "dts", "bands", "bg_rate", "bias_map",
             "inv_gain", "nl_coeffs", "cr_pos", "cr_q", "consts")
    rec = (tuple(kw[n] for n in names),
           {k: v for k, v in kw.items() if k not in names})
    errs = hold_recorded(ro, rec, "phase 11b",
                         f"the model twin's chunk {k_chunk} (noise off)")
    twin = time_readout(ro, rec[0], rec[1], "the model twin's chunk", card)
    twin["max_abs_err"] = max(errs)
    args, flags = rec
    bands = args[3]
    n_par = 8
    tang = torch.randn((n_par,) + tuple(bands.shape), device=bands.device)
    f = lambda b: ro.exposure_readout(*args[:3], b, *args[4:], **flags)
    tangent_pass = lambda: torch.func.vmap(
        lambda t: torch.func.jvp(f, (bands,), (t,))[1][0])(tang)
    twin["tangent_ms"] = cuda_ms(tangent_pass, reps=5)
    # the same tangents by forward mode through the whole plain version,
    # the alternative to the Function's written-out tangent chain
    plain = lambda b: ro.exposure_readout_plain(*args[:3], b, *args[4:],
                                                **flags)
    plain_ms = cuda_ms(lambda: torch.func.vmap(
        lambda t: torch.func.jvp(plain, (bands,), (t,))[1][0])(tang), reps=5)
    print(f"timing [{card}]: the tangent pass of that chunk ({n_par} "
          f"tangents through the readout's Function, its one B1 launch "
          f"included): {twin['tangent_ms']:.3f} ms; by torch.func.jvp of "
          f"the plain version {plain_ms:.3f} ms; B1 alone "
          f"{twin['ms']:.4f} ms")
    x_window = tuple(rep["windows"]["cols"])
    (J_g, fd_g, n_g), (J_c, _, _) = (_twin_jacobian(d, k_chunk, x_window, 8)
                                     for d in ("cuda", "cpu"))
    col_gap = lambda J, ref: float(((J - ref).abs().amax(dim=(0, 1))
                                    / ref.abs().amax(dim=(0, 1))).max())
    gap, fd_gap = col_gap(J_g, J_c), col_gap(J_g, fd_g)
    check(n_g == 1 and bool((J_g.abs().amax(dim=(0, 1)) > 0).all())
          and gap <= 2e-3 and fd_gap <= 3e-3,
          f"the chunk's depth Jacobian {tuple(J_g.shape)} at run_retrieve's "
          f"flat start, through B1 ({n_g} launch): every column nonzero, "
          f"card = CPU within 2e-3 of each column's largest entry (largest "
          f"{gap:.3g}), and within 3e-3 of central finite differences on "
          f"the card, h = 2e-3 (largest {fd_gap:.3g})")
    a_vj, kw_vj = vj_calls[0]
    for with_jac in (True, False):
        n = kernels_in(lambda: real_vj(*a_vj, **dict(kw_vj,
                                                      with_jac=with_jac)))
        print(f"launches [{card}]: _lm_val_jac with_jac={with_jac}: {n} "
              f"kernel launch calls ({n / n_chunks:.0f} a chunk)")
    del recorded, rec, args, bands, tang, vj_calls, a_vj

    # (c) run_retrieve --program --mcmc on phase 7's program
    out = os.path.join(root, "retrieved_joint.json")
    ro.exposure_readout.launches = 0
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc, wall = _synced(lambda: run_retrieve.main(
            ["-d", program, "-p", PROGRAM, "--program", "-o", out,
             *RETRIEVE_ARGS, "--mcmc", str(PROGRAM_MCMC)]))
    b1 = ro.exposure_readout.launches
    launches += b1
    with open(out) as fh:
        rep = json.load(fh)
    drift_true = load_yaml(PROGRAM).program.t0_drift_s_per_visit
    t0, s0 = np.array(rep["t0_offsets_s"]), np.array(
        rep["t0_offsets_sigma_s"])
    # the least-squares slope over visits 0, 1, 2 and its sigma
    x = np.arange(t0.size) - (t0.size - 1) / 2.0
    s_drift = float(np.sqrt(np.sum((x / np.sum(x * x)) ** 2 * s0 ** 2)))
    drift = rep["drift_s_per_visit_fitted"]
    pp = rep["program_posterior"]
    check(rc == 0 and b1 > 0
          and abs(drift - drift_true) <= 6.0 * s_drift,
          f"phase 11c: run_retrieve --program --mcmc {PROGRAM_MCMC} on "
          f"{os.path.relpath(PROGRAM, HERE)}: {b1} B1 launches; t0 "
          f"offsets {t0.tolist()} +- {s0.tolist()} s, drift {drift} +- "
          f"{s_drift:.2f} s/visit, within 6 sigma of the injected "
          f"{drift_true}")
    print(f"  program posterior: {json.dumps(pp)}")
    print(f"timing [{card}]: run_retrieve --program --mcmc {wall:.3f} s; "
          f"phase 11 took {time.time() - t_phase:.1f} s")
    return launches, twin


# ---------------------------------------------------------------------------
# Phase 12: the (mc, exp) mesh
# ---------------------------------------------------------------------------

MESH_CHUNK = 4              # 12b: exposures per launch on each position
MESH_N_MC = 4               # 12c: realisations, one chunk file


def _same_files(a: list, b: list) -> bool:
    """Every file of ``a`` equals its counterpart in ``b`` byte for byte."""
    def read(p):
        with open(p, "rb") as fh:
            return fh.read()
    return len(a) == len(b) > 0 and all(
        os.path.basename(x) == os.path.basename(y) and read(x) == read(y)
        for x, y in zip(a, b))


def phase_mesh(card: str) -> int:
    """The (mc, exp) mesh on the card: (a) the card count and
    ``make_mesh()``'s shape; (b) ``generate(mesh=make_mesh(["cuda:0"] *
    4), chunk=4)`` of the headline visit's first orbit against
    ``generate(chunk=4)``, every ima file byte for byte, B1's launches of
    both; (c) ``generate_dataset`` of the uncut headline visit x 4
    realisations with ``--recover 8``'s labels on ``make_mesh(["cuda:0"]
    * 4, mc_shards=2)`` against ``mesh=None``, both at chunk 43 (= n_exp /
    d_exp, the same batches): spectra and labels bit for bit, B1 against
    its plain version on the first sharded batch, exposures/s of both in
    turns; (d) with more than one card, (b) and (c) again over
    ``make_mesh()`` against the same one-device output; (e) ``run_visit
    --all-devices`` on a 128^2 copy of the headline YAML. Returns B1's
    launches."""
    import numpy as np
    import torch

    import wayne_tpu_torch.parallel.dataset as dataset
    from wayne_tpu_torch import run_dataset, run_visit
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.parallel import make_mesh

    launches = 0
    t_phase = time.time()
    n_cards = torch.cuda.device_count()
    every = make_mesh()
    print(f"phase 12a: torch.cuda.device_count() = {n_cards}; make_mesh() "
          f"is {every.shape} over {[str(d) for d in every.devices.flat]} "
          f"[{card}]")
    four = make_mesh(["cuda:0"] * 4)
    meshes = [("12b", "4 x cuda:0", four)]
    if n_cards > 1:
        meshes.append(("12d", f"every card ({n_cards})", every))
    else:
        print("phase 12d: one card, so no mesh over more than one card")

    # (b) generate() of the first orbit, one device against each mesh
    cfg = load_yaml(HEADLINE)
    cfg.n_orbits = ORBITS
    obs = Observation(cfg)
    n = obs.plan.n_exposures
    with tempfile.TemporaryDirectory() as root:
        def gen(name, mesh):
            ro.exposure_readout.launches = 0
            paths, wall = _synced(lambda: obs.generate(
                os.path.join(root, name), chunk=MESH_CHUNK, mesh=mesh,
                progress=lambda s: None))
            return paths, ro.exposure_readout.launches, wall

        one, b1_one, wall_one = gen("one", None)
        launches += b1_one
        for label, what, mesh in meshes:
            d = mesh.devices.size
            paths, b1, wall = gen(label, mesh)
            launches += b1
            step = MESH_CHUNK * d
            want = 1 + d * math.ceil(n / step)
            check(_same_files(one, paths) and len(paths) == n
                  and b1 == want and b1_one == 1 + math.ceil(n / MESH_CHUNK),
                  f"phase {label}: generate(mesh={mesh.shape} on {what}, "
                  f"chunk={MESH_CHUNK}) of {os.path.relpath(HEADLINE, HERE)} "
                  f"cut to {ORBITS} orbit: {len(paths)} ima files byte for "
                  f"byte = generate(chunk={MESH_CHUNK}); B1 launches {b1} "
                  f"(direct image + {d} positions x "
                  f"{math.ceil(n / step)} steps) against {b1_one} on one "
                  f"device; {wall:.3f} s against {wall_one:.3f} s [{card}]")
    del obs

    # (c) generate_dataset of the uncut visit: run_dataset's own inputs
    calls = []
    real = dataset.generate_dataset
    dataset.generate_dataset = lambda *a, **kw: calls.append((a, kw)) or {
        "chunks": []}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run_dataset.main(
                ["-p", HEADLINE, "-o", os.devnull, "--n-mc", str(MESH_N_MC),
                 "--chunk-mc", str(MESH_N_MC), "--rp-sigma", "0.002",
                 "--recover", str(RECOVER_CHAN)])
    finally:
        dataset.generate_dataset = real
    (args, kw), = calls
    n_exp = args[0].n
    kw = dict(kw, progress=None, device=None)
    two_by_two = make_mesh(["cuda:0"] * 4, mc_shards=2)
    dmeshes = [("12c", "4 x cuda:0", two_by_two)]
    if n_cards > 1:
        if MESH_N_MC % every.shape["mc"] == 0 and \
                n_exp % every.shape["exp"] == 0:
            dmeshes.append(("12d", f"every card ({n_cards})", every))
        else:
            print(f"phase 12d: make_mesh() {every.shape} does not divide "
                  f"{MESH_N_MC} realisations x {n_exp} exposures: no "
                  "dataset over every card")

    def run(out, mesh, chunk):
        ro.exposure_readout.launches = 0
        _, wall = _synced(lambda: real(
            *args[:3], out, **dict(kw, mesh=mesh, chunk=chunk)))
        return ro.exposure_readout.launches, wall

    def chunk_file(out) -> dict:
        with np.load(os.path.join(out, "chunk_0000.npz")) as z:
            return {k: z[k] for k in z.files}

    with tempfile.TemporaryDirectory() as root:
        ones = {}               # chunk -> the one-device run's arrays, B1
        for label, what, mesh in dmeshes:
            chunk = n_exp // mesh.shape["exp"]     # the same batches
            if chunk not in ones:
                out = os.path.join(root, f"one_{chunk}")
                b1_one, _ = run(out, None, chunk)
                launches += b1_one
                ones[chunk] = chunk_file(out), b1_one
            want, b1_one = ones[chunk]
            out = os.path.join(root, label)
            (b1, _), recorded = recorded_readout(lambda: run(out, mesh,
                                                             chunk))
            launches += b1
            got = chunk_file(out)
            with open(os.path.join(out, "manifest.json")) as fh:
                manifest = json.load(fh)
            check(got.keys() == want.keys() and "recovered_rp" in got
                  and all(np.array_equal(got[k], want[k]) for k in want)
                  and manifest["mesh"] == list(mesh.devices.shape)
                  and b1 == b1_one == MESH_N_MC * mesh.shape["exp"],
                  f"phase {label}: generate_dataset(mesh={mesh.shape} on "
                  f"{what}, chunk={chunk}) of the uncut visit, {MESH_N_MC} "
                  f"realisations x {n_exp} exposures, recover "
                  f"{RECOVER_CHAN} channels: spectra "
                  f"{got['spectra_e'].shape} and every label bit for bit = "
                  f"mesh=None at the same chunk; B1 launches {b1} and "
                  f"{b1_one}; manifest mesh {manifest['mesh']} [{card}]")
            if label == "12c":
                hold_recorded(ro, recorded, "phase 12c",
                              "the first sharded batch")
            del recorded
        # the rates, in turns: the (2, 2) mesh, a (1, 1) mesh (one worker
        # thread: the executor's own cost), no mesh, and back
        chunk = n_exp // two_by_two.shape["exp"]
        one_pos = make_mesh(["cuda:0"])
        runs = {"(2, 2) mesh on 4 x cuda:0": two_by_two,
                "(1, 1) mesh on cuda:0": one_pos, "no mesh": None}
        spent = {}
        for label in [*runs, *reversed(runs)]:
            with tempfile.TemporaryDirectory(dir=root) as out:
                _, wall = run(out, runs[label], chunk)
            spent.setdefault(label, []).append(wall)
        n_tot = MESH_N_MC * n_exp
        for label in runs:
            rates = ", ".join(f"{n_tot / w:.2f}" for w in spent[label])
            print(f"timing [{card}]: generate_dataset with recover "
                  f"{RECOVER_CHAN}, {MESH_N_MC} realisations x {n_exp} "
                  f"exposures at chunk {chunk}, {label}: {rates} "
                  f"exposures/s (in turns)")

    # (e) run_visit --all-devices on a 128^2 copy of the headline YAML, the
    # reference position moved so that the spectrum lands on the frame
    import yaml

    with tempfile.TemporaryDirectory() as d:
        with open(HEADLINE) as fh:
            pars = yaml.safe_load(fh)
        pars["observation"].update(subarray=128, x_ref=-55.0, y_ref=20.0)
        yml = os.path.join(d, "pars128.yml")
        with open(yml, "w") as fh:
            yaml.safe_dump(pars, fh)
        n128 = Observation(load_yaml(yml)).plan.n_exposures
        out = os.path.join(d, "out")
        said = io.StringIO()
        ro.exposure_readout.launches = 0
        with contextlib.redirect_stdout(said):
            rc, wall = _synced(lambda: run_visit.main(
                ["-p", yml, "-o", out, "--all-devices", "--chunk",
                 str(CHUNK)]))
        b1 = ro.exposure_readout.launches
        launches += b1
        lines = said.getvalue().splitlines()
        files = [f for f in os.listdir(out) if f.endswith("_ima.fits")]
        sharding = f"sharding exposures over {n_cards} devices"
        check(rc == 0 and sharding in lines and len(files) == n128
              and b1 == 1 + n_cards * math.ceil(n128 / (CHUNK * n_cards)),
              f"phase 12e: python -m wayne_tpu_torch.run_visit --all-devices "
              f"on a 128^2 copy of the headline YAML: '{sharding}', "
              f"{len(files)} ima files of {n128}, {b1} B1 launches, "
              f"{wall:.3f} s [{card}]")
    print(f"phase 12 took {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the science-validation tools
# ---------------------------------------------------------------------------

VALIDATION_N_MC = 32        # 13a: the main section's realisations (the
#                             tool's default)
REFERENCE_ATOL = 1e-5       # 13a: noise-free Rp/Rs, card against CPU
# 13a: the main section's gates that fall at the JAX tool's seed with the
# port's bits, each logged with its three-seed diagnosis in ROADMAP Queue C
# (entry, the record's numbers behind it): the run must reproduce the
# committed record's numbers for them
LOGGED_GATES = {"main_sigma": ("C15", "sigma_calibration_ratio")}
# 13b: tests/test_program.py's drift program (128^2, 3 visits x 5 orbits x
# 30 exposures, the true ephemeris walked 120 s a visit)
EPHEMERIS_T0 = 56000.0
EPHEMERIS_PROGRAM = {
    "grism": "G141", "subarray": 128, "NSAMP": 4, "SAMPSEQ": "SPARS10",
    "scan": True, "scan_speed": 2.0, "x_ref": 30.0, "y_ref": 40.0,
    "num_orbits": 5, "exposures_per_orbit": 30, "exposure_overhead_s": 60.0,
    "mag_J": 9.5, "n_lambda": 48, "n_sub": 2,
    "start_mjd": EPHEMERIS_T0 - 9700.0 / 86400.0, "t0": EPHEMERIS_T0,
    "period": 0.813475, "sma_over_rs": 4.855, "inclination": 82.1,
    "rp_over_rs": 0.1595, "seed": 11,
    "noise": {"read_noise": True, "sky": True, "dark": True},
    "program": {"num_visits": 3, "visit_spacing_days": 0.0,
                "carry_persistence": False, "t0_drift_s_per_visit": 120.0}}


def phase_validation(card: str) -> int:
    """The science tools on the card: (a) ``validate_recovery``'s main
    section at its full size (256^2, 48 exposures, 8 channels) and
    VALIDATION_N_MC realisations: every gate, B1 once per realisation
    (plus the noise-free reference's), B1 = plain on the first
    realisation's batch, and the noise-free recovery card against the same
    function on the CPU; (b) ``program_ephemeris`` on the JAX package's
    drift program (``tests/test_program.py``), written here by the port's
    ``Program``, held to that test's criteria. Returns B1's launches."""
    import numpy as np
    import torch
    import yaml

    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.program import Program
    from wayne_tpu_torch.tools import validate_recovery as vr
    from wayne_tpu_torch.tools.program_ephemeris import (
        measure_program_ephemeris)

    t_phase = time.time()
    print(f"phase 13a: validate_recovery's main section on the card, "
          f"{VALIDATION_N_MC} realisations")
    t0 = time.time()
    ref_card = vr.main_reference(vr.build_core("cuda"))
    t_ref_card = time.time() - t0
    t0 = time.time()
    ref_cpu = vr.main_reference(vr.build_core("cpu"))
    t_ref_cpu = time.time() - t0
    err = float(np.abs(ref_card - ref_cpu).max())
    check(err <= REFERENCE_ATOL,
          f"noise-free recovery (8 channels), card against CPU: max abs "
          f"diff {err:.3g} in Rp/Rs (atol {REFERENCE_ATOL:g}; card "
          f"{t_ref_card:.2f} s, CPU {t_ref_cpu:.2f} s)")
    ro.exposure_readout.launches = 0
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "VALIDATION_TORCH.json")
        t0 = time.time()
        # call 0 is the section's noise-free reference, call 1 the first
        # realisation's batch
        (record, gates), recorded = recorded_readout(
            lambda: vr.run_sections(["main"], n_mc=VALIDATION_N_MC,
                                    device="cuda", out=out), index=1)
        wall = time.time() - t0
        with open(out) as fh:
            written = json.load(fh)
    launches_a = ro.exposure_readout.launches
    check(launches_a == VALIDATION_N_MC + 1,
          f"main section: {launches_a} whole-exposure launches == "
          f"{VALIDATION_N_MC} realisations + the noise-free reference (48 "
          "exposures a launch)")
    check(written == record and record["backend"] == "cuda"
          and record["card"] == card and record["n_mc"] == VALIDATION_N_MC,
          f"the record written: backend {record['backend']}, card "
          f"{record['card']!r}, n_mc {record['n_mc']}")
    ratio = record["sigma_calibration_ratio"]
    with open(os.path.join(HERE, "VALIDATION_TORCH.json")) as fh:
        committed = json.load(fh)
    for name, ok in gates.items():
        if name in LOGGED_GATES:
            entry, key = LOGGED_GATES[name]
            check(not ok and np.allclose(record[key], committed[key],
                                         atol=2e-3),
                  f"main section gate {name} falls as logged (ROADMAP "
                  f"{entry}): {key} {record[key]}, the committed record's "
                  f"{committed[key]}")
            continue
        check(ok, f"main section gate {name} (noise bias "
                  f"{record['noise_induced_bias']}, reduction systematic "
                  f"{record['reduction_systematic']}, sigma ratios {ratio}, "
                  f"coverage {record['sigma_coverage_1sigma']})")
    check(np.allclose(record["rp_noise_free_recovery"], ref_card,
                      atol=1e-6),
          "the section's noise-free recovery is the reference held above")
    hold_recorded(ro, recorded, "phase 13a", "the first realisation")
    print(f"timing [{card}]: main section, {VALIDATION_N_MC} realisations "
          f"x 48 exposures, {record['wallclock_s']:.3f} s of ensemble "
          f"(run_sections {wall:.3f} s with set-up and reference), "
          f"{launches_a} B1 launches; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print("phase 13b: program_ephemeris on the drift program "
          "(tests/test_program.py), 3 visits x 150 exposures at 128^2")
    ro.exposure_readout.launches = 0
    with tempfile.TemporaryDirectory() as d:
        yml = os.path.join(d, "prog.yml")
        with open(yml, "w") as fh:
            yaml.safe_dump(EPHEMERIS_PROGRAM, fh)
        t0 = time.time()
        Program(load_yaml(yml)).generate(os.path.join(d, "prog"), chunk=CHUNK)
        torch.cuda.synchronize()
        t_gen = time.time() - t0
        launches_b = ro.exposure_readout.launches
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            eph = measure_program_ephemeris(os.path.join(d, "prog"), yml,
                                            n_chan=4)
        t_eph = time.time() - t0
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            eph_cpu = measure_program_ephemeris(os.path.join(d, "prog"), yml,
                                                n_chan=4, cpu=True)
        t_cpu = time.time() - t0
    fitted = np.array(eph["per_visit_t0_offset_s"])
    injected = np.array(eph["per_visit_injected_offset_s"])
    comb = eph["combined_spectrum"]
    rp_c = np.array([c["rp_over_rs"] for c in comb])
    sig_c = np.array([c["rp_sigma"] for c in comb])
    chi2 = np.array([c["repeatability_chi2_per_dof"] for c in comb])
    check(np.allclose(injected, [0.0, 120.0, 240.0], atol=0.5)
          and bool(np.all(np.abs(fitted - injected) < 60.0)),
          f"per-visit t0 offsets {fitted.tolist()} s within 60 s of the "
          f"injected {injected.tolist()}")
    check(abs(eph["drift_s_per_visit_fitted"] - 120.0) < 45.0,
          f"fitted drift {eph['drift_s_per_visit_fitted']} s/visit within "
          "45 of 120")
    check(bool(np.all(np.abs(rp_c - 0.1595)
                      < np.maximum(5 * sig_c, 0.005))),
          f"combined spectrum {rp_c.tolist()} within max(5 sigma, 0.005) "
          f"of 0.1595 (sigma {sig_c.tolist()})")
    # the JAX test's repeatability criterion (chi2/dof < 6) falls on this
    # program with the port's bits, and the JAX tool gives the same on the
    # same files (ROADMAP C14): the card is held to the CPU here instead
    cpu_t0 = np.array(eph_cpu["per_visit_t0_offset_s"])
    comb_cpu = eph_cpu["combined_spectrum"]
    check(bool(np.all(np.abs(fitted - cpu_t0) <= 0.5))
          and abs(eph["drift_s_per_visit_fitted"]
                  - eph_cpu["drift_s_per_visit_fitted"]) <= 0.5
          and all(abs(c["rp_over_rs"] - k["rp_over_rs"])
                  <= 0.05 * k["rp_sigma"]
                  and abs(c["repeatability_chi2_per_dof"]
                          - k["repeatability_chi2_per_dof"])
                  <= 2e-2 * k["repeatability_chi2_per_dof"] + 2e-3
                  and c["constrained"] == k["constrained"]
                  for c, k in zip(comb, comb_cpu)),
          f"card against --cpu on the same files: t0 offsets {fitted.tolist()}"
          f" vs {cpu_t0.tolist()} s (atol 0.5), combined depths within 0.05 "
          f"sigma, repeatability chi2/dof {chi2.tolist()} vs "
          f"{[k['repeatability_chi2_per_dof'] for k in comb_cpu]} (rtol "
          "2e-2)")
    print(f"  the JAX test's repeatability criterion (chi2/dof < 6): "
          f"{chi2.tolist()}, {'met' if np.all(chi2 < 6.0) else 'not met'} "
          "(ROADMAP C14)")
    print(f"timing [{card}]: the program's generate() {t_gen:.3f} s "
          f"({launches_b} B1 launches), program_ephemeris (3 x run_reduce "
          f"--detrend ramp --fit-geometry) {t_eph:.3f} s on the card, "
          f"{t_cpu:.3f} s with --cpu; phase 13 took "
          f"{time.time() - t_phase:.1f} s")
    return launches_a + launches_b


# ---------------------------------------------------------------------------
# Phase 14: the ramp envelope, the divide-white probe and the dataset at scale
# ---------------------------------------------------------------------------

RAMP_ATOL = 2e-5            # 14a: noise-free ramp-fit Rp/Rs, card against CPU
PROBE_N_MC = 2              # 14b: realisations of the probe's "full" variant
PROBE_ATOL = 1e-5           # 14b: its clean run's Rp/Rs, card against CPU
SCALE_N, SCALE_CHUNK = 44, 4    # 14c: the 11-chunk minimum at chunks of 4


def _ramp_gaps(rp_clean, points: list, got: list) -> list[str]:
    """Each walk-off grid point's white bias and channel bias beside the
    JAX record's (``RAMP_ENVELOPE.json``, values only)."""
    import numpy as np

    from wayne_tpu_torch.tools import ramp_envelope as re_

    with open(os.path.join(HERE, "RAMP_ENVELOPE.json")) as fh:
        jax_record = json.load(fh)
    rows = {(g["ssv_sin_amp"], g["ssv_rw_amp"]): g for g in jax_record["grid"]}
    lines = []
    for p, (w, ch) in zip(points, got):
        if p[1] == 0.0 and tuple(p[2:4]) == re_.HOOK:
            g = rows[(p[0], 0.0)]
            wb = w - float(rp_clean.mean())
            cb = float(np.abs(ch - rp_clean).max())
            lines.append(f"sin {p[0]}: white bias {wb:.6f} (JAX "
                         f"{g['white_bias_mean']}, gap "
                         f"{wb - g['white_bias_mean']:.2e}), channel bias max "
                         f"{cb:.6f} (JAX {g['channel_bias_max']})")
    return lines


def phase_tools(card: str) -> int:
    """The repository's last three tools on the card, at their own widths:
    (a) ``ramp_envelope``'s four walk-off points and six hook points and
    the validation default at 2 draws (one B1 launch a point), card
    against CPU, B1 = plain on one realisation's batch; (b)
    ``probe_dw_sigma``'s "full" variant at PROBE_N_MC realisations: the
    clean run card against CPU, the ratios finite, B1 = plain on the first
    noise-on batch; (c) ``dataset_scale`` at its full width (512^2, 76
    exposures, both grisms) at chunks of SCALE_CHUNK and its 11-chunk
    minimum: resume after the kill, the resumed dataset bit for bit
    against a fresh one-shot run, B1 = plain on the first sharded batch.
    Returns B1's launches."""
    import numpy as np
    import torch

    from wayne_tpu_torch.ops import readout as ro
    from wayne_tpu_torch.parallel.dataset import generate_dataset
    from wayne_tpu_torch.tools import dataset_scale as ds
    from wayne_tpu_torch.tools import probe_dw_sigma as pr
    from wayne_tpu_torch.tools import ramp_envelope as re_
    from wayne_tpu_torch.tools import validate_recovery as vr

    t_phase = time.time()
    points = ([(sa, 0.0, *re_.HOOK, 0) for sa in re_.SIN_AMPS]
              + [(re_.DEFAULT[0], 0.0, h, sc, 0) for h, sc in re_.HOOK_POINTS]
              + [(*re_.DEFAULT, *re_.HOOK, d) for d in range(2)])
    print(f"phase 14a: ramp_envelope at its full size (256^2, 48 exposures, "
          f"8 channels), {len(points)} points: the four walk-off grid "
          "points, the six hook points, the default point's 2 draws")
    env, env_cpu = re_.build_envelope("cuda"), re_.build_envelope("cpu")
    ro.exposure_readout.launches = 0
    got, t_card = _synced(lambda: [re_.run_point(env, *p) for p in points])
    launches_a = ro.exposure_readout.launches
    check(launches_a == len(points),
          f"ramp points: {launches_a} whole-exposure launches == "
          f"{len(points)} points (48 exposures a launch)")
    rp_clean = re_.run_clean(env)
    t0 = time.time()
    want = [re_.run_point(env_cpu, *p) for p in points]
    t_cpu = time.time() - t0
    errs = [max(abs(w - wc), float(np.abs(ch - chc).max()))
            for (w, ch), (wc, chc) in zip(got, want)]
    check(all(np.isfinite(w) and np.all(np.isfinite(ch)) for w, ch in got)
          and max(errs) <= RAMP_ATOL,
          f"ramp points card against CPU: white and channel Rp/Rs max abs "
          f"diff {max(errs):.3g} (per point {[f'{e:.2g}' for e in errs]}; "
          f"atol {RAMP_ATOL:g}, the ramp path's valley, ROADMAP C13)")
    hook = [w for w, _ in got[len(re_.SIN_AMPS):][:len(re_.HOOK_POINTS)]]
    for line in _ramp_gaps(rp_clean, points, got):
        print(f"  {line}")
    print(f"  hook absorption max delta {float(np.ptp(hook)):.2e} (JAX "
          "record 6e-06); default point draws 0 and 1: white "
          f"{got[-2][0]:.6f}, {got[-1][0]:.6f}")
    _, recorded = recorded_readout(
        lambda: re_.run_point(env, *re_.DEFAULT, *re_.HOOK, 0))
    hold_recorded(ro, recorded, "phase 14a", "one realisation")
    print(f"timing [{card}]: {len(points)} ramp points {t_card:.3f} s on the "
          f"card ({t_card / len(points):.3f} s a point: one B1 launch, "
          f"reduce_visit, fit_white_ramp, fit_depths), {t_cpu:.3f} s on the "
          "CPU")

    name, extra, rw = pr.VARIANTS[0]
    print(f"phase 14b: probe_dw_sigma's {name!r} variant at its full size, "
          f"{PROBE_N_MC} realisations, bg rows (180, 250)")
    core, core_cpu = vr.build_core("cuda"), vr.build_core("cpu")
    ro.exposure_readout.launches = 0
    t0 = time.time()
    # call 0 is the first noisy realisation's batch
    res, recorded = recorded_readout(
        lambda: pr.run_variant(core, extra, rw, PROBE_N_MC))
    t_probe = time.time() - t0
    launches_b = ro.exposure_readout.launches
    check(launches_b == 2 * PROBE_N_MC,
          f"probe variant: {launches_b} whole-exposure launches == "
          f"{PROBE_N_MC} noisy + {PROBE_N_MC} clean realisations")
    _, clean = pr.variant_cfgs(core_cpu, extra)
    rp_cpu = vr.ensemble(core_cpu, pr.variant_run(core_cpu, rw), clean,
                         "divide-white", PROBE_N_MC)["rp"]
    err = float(np.abs(res["rp_clean"] - rp_cpu).max())
    check(err <= PROBE_ATOL,
          f"probe clean run (SSV + walk + visit trend, no noise) card "
          f"against CPU: max abs diff {err:.3g} in Rp/Rs (atol "
          f"{PROBE_ATOL:g})")
    check(bool(np.all(np.isfinite(res["ratio"])) and np.all(res["ratio"] > 0)),
          f"probe ratios finite: {np.round(res['ratio'], 2).tolist()}")
    hold_recorded(ro, recorded, "phase 14b", "the first noisy realisation")
    print(f"timing [{card}]: probe variant {t_probe:.3f} s "
          f"({2 * PROBE_N_MC} realisations, divide-white fits)")

    print(f"phase 14c: dataset_scale at its full width (512^2, 76 exposures, "
          f"G141 and G102), n_per_grism {SCALE_N}, chunks of {SCALE_CHUNK}")
    ro.exposure_readout.launches = 0
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stderr(io.StringIO()):
            # call 0 is the first sharded batch of G141's first chunk
            (rec, recorded), t_scale = _synced(lambda: recorded_readout(
                lambda: ds.run_scale(
                    SCALE_N, "cuda", os.path.join(d, "scale.json"),
                    chunk_mc=SCALE_CHUNK, scratch=os.path.join(d, "data"))))
        for grism, g in rec["grisms"].items():
            check(g["resume_ok"] and g["resume_skipped_chunks"] == 10
                  and g["chunks"] == SCALE_N // SCALE_CHUNK,
                  f"[{grism}] resume: {g['resume_skipped_chunks']} chunks "
                  f"skipped == 10, {g['chunks']} chunks, "
                  f"{g['sustained_visits_per_s_per_chip']} visits/s")
        cfg, scenes, grisms = ds.scale_inputs(
            torch.device("cuda", torch.cuda.current_device()), SCALE_N,
            **ds.SIZES)
        tables, rp = grisms["G141"]
        fresh = os.path.join(d, "fresh")
        manifest = generate_dataset(
            scenes, tables, cfg, fresh, n_mc=SCALE_N, chunk_mc=SCALE_CHUNK,
            seed=3, overrides={"rp_over_rs": np.broadcast_to(
                rp[:, None], (SCALE_N, ds.SIZES["NL"])).copy()},
            labels={"rp": rp}, device="cuda")
        same = []
        for chunk in manifest["chunks"]:
            with np.load(os.path.join(fresh, chunk)) as a, np.load(
                    os.path.join(d, "data", "G141", chunk)) as b:
                same.append(sorted(a.files) == sorted(b.files) and all(
                    np.array_equal(a[k], b[k]) for k in a.files))
        check(all(same), f"[G141] the resumed dataset's {len(same)} chunks "
                         "equal a fresh one-shot run's bit for bit "
                         f"({sum(same)} equal)")
    launches_c = ro.exposure_readout.launches
    batches = -(-rec["n_exp"] // CHUNK)
    check(launches_c == 3 * SCALE_N * batches,
          f"dataset: {launches_c} whole-exposure launches == (2 grisms + the "
          f"fresh G141 run) x {SCALE_N} realisations x {batches} batches")
    hold_recorded(ro, recorded, "phase 14c", "the first sharded batch")
    print(f"timing [{card}]: dataset_scale {t_scale:.3f} s (phase 2 "
          f"{rec['sustained_visits_per_s_per_chip']} visits/s, "
          f"{[g['exposures_per_s'] for g in rec['grisms'].values()]} "
          f"exposures/s); phase 14 took {time.time() - t_phase:.1f} s")
    return launches_a + launches_b + launches_c


# ---------------------------------------------------------------------------
# Phase 15: the RECTE white-ramp kernel (R1)
# ---------------------------------------------------------------------------

# the fullsys-rectefit cell's visit: its 86 exposure mid-times and exposure
# time (.midtimes.json) and its illuminated rate (.json)
RECTE_VISIT = os.path.join(HERE, "benchmark", "configs",
                           "wasp43b-g141-fullsys")
# cycles before a dependent fp32 add or multiply on sm_90 sees its input
# (as on every card since Volta); R1 builds with --fmad=false, so no FMA
FP32_LATENCY_CYCLES = 4
R1_LAUNCHES = {}        # R1's launches (white_ramp.launches) by phase


def recte_chain_bound(n_exp: int, rows: int, tangent: bool) -> dict:
    """R1's least time (ms) on ``rows`` light curves of ``n_exp``
    exposures: the latency of the recurrence's dependent chain, ``n_exp``
    steps of 4 dependent fp32 operations (the gap's decay, the distance to
    the level, its product with the exposure's decay, the sum), 5 on the
    tangent's chain (``csrc/recte_ramp.cu``), at FP32_LATENCY_CYCLES each,
    against the bytes (the starts, the rates, fills and tangents read
    once, the ramp and its tangent written once) over the memory rate. The
    rows run side by side, a warp each (up to one per SM)."""
    chain_ms = (n_exp * (5 if tangent else 4) * FP32_LATENCY_CYCLES
                / H100_CLOCK_HZ * 1e3)
    n_bytes = 4 * rows * (n_exp * (3 if tangent else 2)
                          + (6 if tangent else 3))
    bytes_ms = n_bytes / H100_BYTES_S * 1e3
    return dict(chain_ms=chain_ms, bytes_ms=bytes_ms,
                bound_ms=max(chain_ms, bytes_ms),
                bound_by="latency" if chain_ms >= bytes_ms else "bytes")


def phase_recte(card: str) -> dict:
    """R1 at the shapes of ``fit_white_recte``'s launches on the
    fullsys-rectefit cell's visit (its 86 exposure starts and illuminated
    rate): the value of one row, (1, 86), and the tangents of ``jacfwd``'s
    six directions of the fit's parameters, (6, 86), at three points of
    them. Each is ``white_ramp_plain`` on the same card tensors bit for
    bit, the value also the loop's (N,)-rate route of ``white_ramp``;
    ``white_ramp.launches`` counts one launch a call. Then both launches
    timed (``kernel_times``), their plain versions host-paced, and an eager
    ``white_ramp`` and its ``jacfwd`` of the fit's parametrisation, beside
    ``recte_chain_bound``. Returns R1's numbers for the JSON line."""
    import torch

    from wayne_tpu_torch.ops import recte

    print("phase 15: the RECTE white-ramp kernel (R1)")
    with open(RECTE_VISIT + ".midtimes.json") as fh:
        frozen = json.load(fh)
    with open(RECTE_VISIT + ".json") as fh:
        rate_e_s = float(json.load(fh)["white_rate_e_s"])
    exptime = float(frozen["exptime_s"])
    dev = torch.device("cuda")
    # fit_white_recte's starts, rate and fills from its parameters theta =
    # (c, rp, slope, logit f0_s, logit f0_f, log rate scale)
    starts = (torch.tensor(frozen["exp_mid_s"], dtype=torch.float32,
                           device=dev) - 0.5 * exptime)
    n = starts.numel()
    rate0 = torch.tensor(rate_e_s, dtype=torch.float32, device=dev)
    P = recte.RecteParams()

    def inputs(th):
        return torch.stack([rate0 * torch.exp(th[5]), torch.sigmoid(th[3]),
                            torch.sigmoid(th[4])])

    def launches(th):
        """The value's rows (1, n), jacfwd's tangent rows (6, n) and their
        tangents of the rate and the fills, as the fit launches them."""
        x, jac = inputs(th), torch.func.jacfwd(inputs)(th)
        value = (starts[None].contiguous(), *(v.reshape(1) for v in x))
        tangent = (starts.expand(6, n).contiguous(),
                   *(v.expand(6).contiguous() for v in x))
        return value, tangent, tuple(j.contiguous() for j in jac)

    def model(th):
        rate, f0_s, f0_f = inputs(th)
        return recte.white_ramp(rate, starts, exptime, P, f0_s=f0_s,
                                f0_f=f0_f)

    thetas = [torch.tensor(th, dtype=torch.float32, device=dev) for th in (
        (1.0, 0.16, 0.0, -1.5, -1.5, 0.0),      # the fit's start
        (0.99, 0.155, 0.003, 0.4, -3.0, 0.3),
        (1.01, 0.165, 0.001, -2.8, 0.4, -0.25))]
    recte.white_ramp.launches = 0
    errs = []
    for th in thetas:
        value, tangent, tangents = launches(th)
        got = recte._white_ramp_value(*value, exptime, P)
        want = recte.white_ramp_plain(*value, exptime, P)
        loop = recte.white_ramp(value[1].expand(n), starts, exptime, P,
                                f0_s=value[2], f0_f=value[3])
        got_t, got_d = recte._white_ramp_value(*tangent, exptime, P,
                                               tangents)
        want_t, want_d = recte.white_ramp_plain(*tangent, exptime, P,
                                                tangents)
        torch.cuda.synchronize()
        errs += [float((got - want).abs().max()),
                 float((got_t - want_t).abs().max()),
                 float((got_d - want_d).abs().max())]
        moved = (got_d.abs().amax(dim=1) > 0).tolist()
        check(torch.equal(got, want) and torch.equal(got[0], loop)
              and torch.equal(got_t, want_t) and torch.equal(got_d, want_d)
              and moved == [False] * 3 + [True] * 3,
              f"R1 at theta {[round(v, 3) for v in th.tolist()]} (rate "
              f"{float(value[1]):.3f} e-/s, fills {float(value[2]):.4f}, "
              f"{float(value[3]):.4f}): the value (1, {n}) = the plain "
              f"version and the loop's (N,)-rate route bit for bit (ramp "
              f"{float(got.min()):.6f}..{float(got.max()):.6f}); the "
              f"tangents (6, {n}) = torch.func.jvp of the loop bit for bit, "
              f"zero in c, rp and the slope, largest |d ramp| "
              f"{float(got_d.abs().max()):.4g}")
    check(recte.white_ramp.launches == 2 * len(thetas),
          f"white_ramp.launches counted {recte.white_ramp.launches} R1 "
          f"launches for {2 * len(thetas)} calls")
    R1_LAUNCHES["phase 15"] = recte.white_ramp.launches

    value, tangent, tangents = launches(thetas[0])
    tv = kernel_times(lambda: recte._white_ramp_value(*value, exptime, P),
                      reps=200)
    tt = kernel_times(lambda: recte._white_ramp_value(*tangent, exptime, P,
                                                      tangents), reps=200)
    plain_v = cuda_ms(lambda: recte.white_ramp_plain(*value, exptime, P),
                      reps=5, warmup=1)
    plain_t = cuda_ms(lambda: recte.white_ramp_plain(*tangent, exptime, P,
                                                     tangents),
                      reps=3, warmup=1)
    eager = cuda_ms(lambda: model(thetas[0]), reps=50)
    jac = cuda_ms(lambda: torch.func.jacfwd(model)(thetas[0]), reps=20)
    bv, bt = recte_chain_bound(n, 1, False), recte_chain_bound(n, 6, True)
    for label, t, plain_ms, b in (("value (1, %d)" % n, tv, plain_v, bv),
                                  ("tangents (6, %d)" % n, tt, plain_t, bt)):
        print(f"timing [{card}]: R1 {label}: {times_line(t)}; plain "
              f"version {plain_ms:.3f} ms host-paced; bound "
              f"{b['bound_ms'] * 1e3:.3f} us by {b['bound_by']} (chain "
              f"{b['chain_ms'] * 1e3:.3f} us, bytes {b['bytes_ms'] * 1e3:.4f}"
              f" us), {b['bound_ms'] / t['ms']:.1%} of it L2-cold")
    print(f"timing [{card}]: white_ramp at a scalar rate {eager:.3f} ms a "
          f"call, its jacfwd in the fit's six parameters {jac:.3f} ms "
          f"(host-paced)")
    return dict(ms=tv["ms"], warm_ms=tv["warm_ms"], plain_ms=plain_v,
                bound_ms=bv["bound_ms"], bound_by=bv["bound_by"],
                tangent_ms=tt["ms"], tangent_warm_ms=tt["warm_ms"],
                tangent_plain_ms=plain_t, tangent_bound_ms=bt["bound_ms"],
                max_abs_err=max(errs))


def partial_run(only: set, card: str) -> int:
    """Phases 9 to 15 alone (``--phases``); phase 10 then simulates
    the phase-curve visit itself, and phase 11 without phase 10 writes the
    uncut headline visit (``run_visit``) and the three-visit program
    (``run_program``) itself. Prints no result lines."""
    import torch

    from wayne_tpu_torch import run_program, run_visit
    from wayne_tpu_torch.config import load_yaml
    from wayne_tpu_torch.observation import Observation

    if 9 in only:
        phase_reduction(card)
    with tempfile.TemporaryDirectory() as root:
        if 10 in only:
            obs = Observation(load_yaml(PHASE))
            res = obs.simulate(chunk=CHUNK)
            torch.cuda.synchronize()
            curves = phase_curve_curves(obs, res, card)
            del obs, res
            phase_reduce_cli(card, curves, root)
        if 11 in only:
            with contextlib.redirect_stdout(io.StringIO()):
                if 10 not in only:
                    run_visit.main(["-p", HEADLINE, "-o", os.path.join(
                        root, "visit"), "--chunk", str(CHUNK)])
                run_program.main(["-p", PROGRAM, "-o", os.path.join(
                    root, "program"), "--chunk", str(CHUNK)])
            phase_inference(card, root)
    if 12 in only:
        phase_mesh(card)
    if 13 in only:
        phase_validation(card)
    if 14 in only:
        phase_tools(card)
    if 15 in only:
        phase_recte(card)
    check("jax" not in sys.modules, "jax was not imported")
    print(f"partial run of phases {sorted(only)}: no result lines")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # ``--phases 9,10`` runs only those phases (and the build), for work on
    # one phase; without it every phase runs and the result lines print
    only = (None if "--phases" not in argv else
            {int(p) for p in argv[argv.index("--phases") + 1].split(",")})
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
    from wayne_tpu_torch.ops import recte

    for lib in (ro, recte):
        t0 = time.time()
        lib.build(verbose=True)
        print(f"built {os.path.relpath(lib.library_path(), HERE)} in "
              f"{time.time() - t0:.1f} s")
    if only is not None:
        return partial_run(only, card)
    cfg, obs = headline_observation()
    whole, args = phase_kernel(cfg, obs, card)
    launches, errs, recorded = phase_main_path(cfg, obs, card)
    whole["max_abs_err"] = max(whole["max_abs_err"], *errs)
    steps = phase_steps(args, card)
    per_read = phase_per_read(cfg, obs, card)
    del obs
    ds_launches, ds_errs = phase_dataset(card)
    launches += ds_launches
    whole["max_abs_err"] = max(whole["max_abs_err"], *ds_errs)
    full_b1, full_b2, full_errs, full = phase_full_systematics(card)
    launches += full_b1
    per_read["read_step_banded"] += full_b2
    whole["max_abs_err"] = max(whole["max_abs_err"], *full_errs)
    # phase 7's program output and phase 10's uncut visit stay on disk for
    # phase 11
    keep = tempfile.TemporaryDirectory()
    b1, phase_curves = phase_eclipse_and_program(
        card, os.path.join(keep.name, "program"))
    launches += b1
    exact, exact_launches = phase_exact(args, recorded, card)
    del args, recorded
    launches += exact_launches["exposure_readout"]
    launches += phase_calibration_visit(card)
    phase_writer(full, card)
    del full
    launches += phase_compat(card)
    launches += phase_reduction(card)
    launches += phase_reduce_cli(card, phase_curves, keep.name)
    b1, twin = phase_inference(card, keep.name)
    launches += b1
    whole["max_abs_err"] = max(whole["max_abs_err"], twin["max_abs_err"])
    keep.cleanup()
    launches += phase_mesh(card)
    launches += phase_validation(card)
    launches += phase_tools(card)
    r1 = phase_recte(card)
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
        "bound_by": k["bound_by"], "library_ms": None,
        "exact_ms": exact[name][0], "exact_bound_ms": exact[name][1],
        **({"twin_ms": twin["ms"], "tangent_ms": twin["tangent_ms"]}
           if name == "exposure_readout" else {})}
        for name, src, line, n, k in rows] + [{
        "name": "recte_white_ramp", "route": "cuda",
        "source": "wayne_tpu_torch/csrc/recte_ramp.cu",
        "replaces": "none (the lax.scan of wayne_tpu/ops/recte.py)",
        "launches": sum(R1_LAUNCHES.values()), "library_ms": None,
        "exact_ms": None, "exact_bound_ms": None, **r1}]}))
    # the run uses one card, cuda:0, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
