#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wayne_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the readout kernels from ``wayne_tpu_torch/csrc`` (nvcc, sm_90a, one
process per source, in parallel, linked into one library) and then:

1. holds the whole-exposure kernel against its plain PyTorch version on
   the card at both shapes the main path launches it at: a chunk of the
   visit (S = 512, 16 reads, the auto band, the config's MAX_CR, 8
   exposures) and the direct image (1 exposure, direct_image_nsamp + 1
   reads, the full-frame window W = S, on the inputs the main path gives
   it): noise off with IPC off and on (rtol 1e-5); noise on with the same
   Philox draws (>= 99.9 % of pixels identical, the rest within a few
   electrons; a second run bit-identical); then the Poisson regimes'
   moments and the read-noise sigma;
2. drives the main path at full width: ``examples/wasp43b_g141_scan.yml``
   (512^2, NSAMP 15, n_lambda 512, the default noise chain), cut to one
   orbit: ``Observation.simulate()`` and ``Observation.generate()`` for
   the direct image and the first chunk, read back with ``read_ima``. The
   readout's launch counter, zeroed just before, shows the path went
   through the kernel;
3. holds the per-read kernels against their plain versions, read by read
   over the chunk's 16 reads: the banded step at W = 32 and the full-frame
   step at W = S, with the bars of phase 1;
4. drives the per-read path (``fused_reads=False``) of the same visit:
   ``simulate()`` through the banded step (16 launches per chunk, none of
   the whole-exposure kernel), its reads against the whole-exposure
   route's, then one chunk with ``band_px: 0`` through the full-frame step
   (16 launches);
5. times each kernel, its plain version and ``simulate()`` on both routes.

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
H100_FP32_OPS_S = 67e12     # non-tensor fp32 rate; integer work counted
#                             at the same rate (a generous lower bound)
PHILOX_OPS = 98             # 10 rounds x (4 multiplies + 4 xors) + 9 x 2
#                             key additions
BOX_MULLER_OPS = 10         # log, sqrt, sin, cos + 6 arithmetic
SAMPLER_OPS = 10            # Cornish-Fisher round(lam + sqrt(lam) z + skew)
SMALL_LAM_OPS = 40          # exp + 12 x (add, compare, add, 2 multiplies)
READOUT_OPS = 16            # accumulate, nonlin, bias, noise, gain, store
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


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def _bound(nbytes: int, ops: int) -> tuple[float, str, float, float]:
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = ops / H100_FP32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def _read_ops(lam, px_reads: int, cr_q, flags) -> int:
    """Operations of the background sampler, the normals and the readout
    chain that ``px_reads`` pixel-reads with background ``lam`` need."""
    ops = READOUT_OPS * px_reads
    if cr_q is not None:
        ops += int((cr_q != 0).sum())                       # CR deposits
    n_normal = px_reads if flags["read_noise"] else 0
    if flags["poisson"]:
        # what these inputs need: a normal where lambda >= 3, a uniform and
        # the exact sum where 0 < lambda < 3, nothing where lambda = 0
        gauss = int((lam >= 3).sum())
        small = int(((lam > 0) & (lam < 3)).sum())
        if not flags["read_noise"]:
            n_normal = gauss
        ops += SAMPLER_OPS * gauss + (PHILOX_OPS + SMALL_LAM_OPS) * small
    return ops + (PHILOX_OPS + BOX_MULLER_OPS) * n_normal


def bound_of(args, flags) -> tuple[float, str, float, float]:
    """Least time for the whole-exposure readout on these inputs: bytes
    each input and output moves once, and the operations this run's data
    needs."""
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, _ = args
    B, NR, W, S = bands.shape
    nbytes = _nbytes(seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos,
                     cr_q) + (B * NR * S * S + B * S * S) * 4  # reads + cum
    ops = _read_ops(bg[:, None] * dts[:, :, None, None], B * NR * S * S,
                    cr_q, flags)
    if flags["poisson"]:                    # the band, sampled in-kernel
        gauss = int((bands >= 3).sum())
        small = int(((bands > 0) & (bands < 3)).sum())
        ops += (PHILOX_OPS + BOX_MULLER_OPS + SAMPLER_OPS) * gauss
        ops += (PHILOX_OPS + SMALL_LAM_OPS) * small
    return _bound(nbytes, ops)


def step_bound_of(kw, flags) -> tuple[float, str, float, float]:
    """Least time for one per-read step on its keyword arguments ``kw``
    (the band or add frame comes sampled: no sampling of it is counted)."""
    import torch
    tensors = [v for v in kw.values() if isinstance(v, torch.Tensor)]
    B, S, _ = kw["cum"].shape
    nbytes = _nbytes(*tensors) + 2 * B * S * S * 4          # cum out + dn
    return _bound(nbytes, _read_ops(kw["bg_rate"] * kw["dt"][:, None, None],
                                    B * S * S, kw.get("cr_q"), flags))


def direct_image_inputs(obs) -> tuple[tuple, dict]:
    """The readout's arguments and flags exactly as the main path gives
    them for the direct image (B = 1, NR = direct_image_nsamp + 1, W = S),
    recorded from one ``Observation.simulate_direct_image()``: (the eleven
    array and scalar arguments in order, the keyword flags)."""
    import inspect

    import wayne_tpu_torch.ops.exposure as ex
    real, seen = ex.exposure_readout, []

    def record(*args, **kw):
        seen.append(inspect.signature(real).bind(*args, **kw).arguments)
        return real(*args, **kw)

    ex.exposure_readout = record
    try:
        obs.simulate_direct_image()
    finally:
        ex.exposure_readout = real
    call, = seen
    names = [p.name for p in inspect.signature(real).parameters.values()
             if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    return (tuple(call[n] for n in names),
            {k: v for k, v in call.items() if k not in names})


def hold_against_plain(kernel, plain, on: dict, gain: float, label: str,
                       variants=({"ipc": False}, {"ipc": True})
                       ) -> list[float]:
    """Kernel against plain version on the same inputs: ``kernel(flags)``
    and ``plain(flags)`` return (reads, cum). Noise off with each of
    ``variants`` to rtol 1e-5, then ``on`` (noise on, the same Philox
    draws). Returns the max abs errors (DN)."""
    import torch
    errs = []
    for extra in variants:
        off = dict(on, poisson=False, read_noise=False, **extra)
        got, cum = kernel(off)
        want, cum_w = plain(off)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        errs.append(err)
        check(rel <= 1e-5 and torch.allclose(cum, cum_w, rtol=1e-5, atol=0),
              f"{label}, noise off {extra}: max abs err {err:.3g} DN, "
              f"max rel err {rel:.3g} <= 1e-5")
    got, _ = kernel(on)
    want, _ = plain(on)
    again, _ = kernel(on)
    torch.cuda.synchronize()
    same = float((got == want).float().mean())
    errs.append(float((got - want).abs().max()))
    worst_e = errs[-1] * gain                       # DN x nominal gain
    check(same >= 0.999, f"{label}, noise on: {same * 100:.4f}% of pixels "
          "identical to the plain version (>= 99.9%)")
    check(worst_e <= 5.0, f"{label}, noise on: the rest within "
          f"{worst_e:.3g} e- (<= 5)")
    check(torch.equal(got, again),
          f"{label}, noise on: a second run is bit-identical")
    return errs


def phase_kernel(cfg, obs, card: str) -> tuple[dict, tuple]:
    from wayne_tpu_torch.calibration import sample_sequence_times
    from wayne_tpu_torch.ops import readout as ro

    S, NR = cfg.subarray, cfg.nsamp + 1
    st = obs.static
    W, n_cr, B = st.band_px, st.max_cr_per_read, CHUNK
    times = sample_sequence_times(cfg.samp_seq, cfg.nsamp, S)
    args = readout_inputs(B, NR, W, S, n_cr, times)
    print(f"phase 1: kernel vs plain, chunk B={B} NR={NR} S={S} W={W} "
          f"MAX_CR={n_cr}")
    errs = hold_against_plain(
        lambda f: ro.exposure_readout(*args, **f),
        lambda f: ro.exposure_readout_plain(*args, **f), NOISE_ON,
        args[10][2], "chunk")
    di_args, di_flags = direct_image_inputs(obs)
    print("phase 1: kernel vs plain, direct image "
          f"(B, NR, W, S) = {tuple(di_args[3].shape)}, the main path's "
          f"inputs and flags {di_flags}")
    errs += hold_against_plain(
        lambda f: ro.exposure_readout(*di_args, **f),
        lambda f: ro.exposure_readout_plain(*di_args, **f), di_flags,
        di_args[10][2], "direct image")
    moments(ro, S, W, B)

    # timings at the chunk's shapes with the noise on
    ms = cuda_ms(lambda: ro.exposure_readout(*args, **NOISE_ON), reps=20)
    plain_ms = cuda_ms(lambda: ro.exposure_readout_plain(*args, **NOISE_ON),
                       reps=2, warmup=1)
    bound_ms, bound_by, t_bytes, t_ops = bound_of(args, NOISE_ON)
    print(f"timing [{card}]: readout kernel {ms:.4f} ms/launch "
          f"({ms / B:.4f} ms/exposure, B={B}), plain version "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by), args


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


def phase_main_path(cfg, obs, card: str) -> tuple[int, float]:
    import dataclasses

    import numpy as np
    import torch

    from wayne_tpu_torch.io.ima import read_ima
    from wayne_tpu_torch.observation import Observation
    from wayne_tpu_torch.ops.readout import exposure_readout

    print("phase 2: the main path")
    chunk = CHUNK
    n = obs.plan.n_exposures
    n_chunks = math.ceil(n / chunk)

    exposure_readout.launches = 0
    t0 = time.time()
    res = obs.simulate(chunk=chunk)
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
    return launches, n / wall


# ---------------------------------------------------------------------------
# Phase 3: the per-read kernels against their plain versions
# ---------------------------------------------------------------------------

def step_args(args, k: int, cum, full_frame: bool, poisson: bool) -> dict:
    """A per-read step's arguments for read k of the phase-1 chunk inputs,
    built as the per-read path builds them: the banded step takes the band
    at its row (sampled when ``poisson``); the full-frame step takes the
    band placed in a zero frame and sampled, plus the read's hits in list
    order."""
    import torch

    from wayne_tpu_torch.ops.readout import add_hits, sample_band

    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, consts = args
    B, _, W, S = bands.shape
    kw = dict(seed=seed, read=k, dt=dts[:, k].contiguous(), cum=cum,
              bg_rate=bg, bias_map=bias, inv_gain=inv_gain, nl_coeffs=nl,
              consts=consts)
    y0, band = y0s[:, k].contiguous(), bands[:, k]
    if not full_frame:
        if poisson:
            band = sample_band(seed, k, y0, band)
        return dict(kw, y0=y0, band=band.contiguous(),
                    cr_pos=cr_pos[:, k].contiguous(),
                    cr_q=cr_q[:, k].contiguous())
    rows = y0.long()[:, None] + torch.arange(W, device=y0.device)
    frame = torch.zeros_like(cum).scatter(
        1, rows[:, :, None].expand(B, W, S), band)
    if poisson:
        frame = sample_band(seed, k, torch.zeros_like(y0), frame)
    return dict(kw, add=add_hits(frame, cr_pos[:, k], cr_q[:, k]))


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
             ro.read_step_banded_plain, False, NOISE_ON,
             ({"ipc": False}, {"ipc": True})),
            ("read_step", ro.read_step, ro.read_step_plain, True, step_on,
             ({},))):
        print(f"phase 3: {name} vs plain, chunk B={B}, {NR} reads, S={S}, "
              f"W={S if full_frame else W}")
        errs = hold_against_plain(
            lambda f: step_reads(step, None, args, full_frame, f),
            lambda f: step_reads(step, plain, args, full_frame, f),
            on, args[10][2], name, variants)
        # one launch in the middle of the ramp, noise on
        k = NR // 2
        _, cums = step_reads(step, None, args, full_frame, on)
        kw = step_args(args, k, cums[:, k - 1].contiguous(), full_frame, True)
        ms = cuda_ms(lambda: step(**kw, **on), reps=50)
        plain_ms = cuda_ms(lambda: plain(**kw, **on), reps=2, warmup=1)
        bound_ms, bound_by, t_bytes, t_ops = step_bound_of(kw, on)
        print(f"timing [{card}]: {name} kernel {ms:.4f} ms/launch (B={B}, "
              f"read {k}), plain version {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} (bytes {t_bytes:.4f} ms, "
              f"operations {t_ops:.4f} ms)")
        out[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
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
        static = o.static
        o.static = dataclasses.replace(static, fused_reads=True)
        try:
            fused = o.simulate(chunk=CHUNK).reads_dn
        finally:
            o.static = static
        same = float((reads == fused).float().mean())
        check(same >= 0.999, f"{label}: {same * 100:.4f}% of pixels "
              "identical to the whole-exposure route's (>= 99.9%)")

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
        same_as_fused(obs, reads, "simulate(), per-read")
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
    same_as_fused(one, reads0, "band off, per-read")
    print(f"timing [{card}]: simulate() per-read {n} exposures in "
          f"{wall:.3f} s = {n / wall:.2f} exposures/s (first call "
          f"{t_first:.3f} s); band off, per-read {one.plan.n_exposures} "
          f"exposures in {wall0:.3f} s = {one.plan.n_exposures / wall0:.2f} "
          f"exposures/s (first call {t0_first:.3f} s)")
    return dict(read_step_banded=banded_launches, read_step=b3)


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
    launches, _ = phase_main_path(cfg, obs, card)
    steps = phase_steps(args, card)
    del args
    per_read = phase_per_read(cfg, obs, card)
    check("jax" not in sys.modules and not any(
        m == "wayne_tpu" or m.startswith("wayne_tpu.") for m in sys.modules),
          "neither jax nor wayne_tpu was imported")
    rows = [("exposure_readout", "readout.cu", 416, launches, whole)]
    rows += [(name, "read_step.cu", line, per_read[name], steps[name])
             for name, line in (("read_step_banded", 598),
                                ("read_step", 546))]
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
