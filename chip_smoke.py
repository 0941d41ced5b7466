#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wayne_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the readout kernel from ``wayne_tpu_torch/csrc/readout.cu`` (nvcc,
sm_90a) and then:

1. holds the kernel against its plain PyTorch version on the card at both
   shapes the main path launches it at: a chunk of the visit (S = 512, 16
   reads, the auto band, the config's MAX_CR, 8 exposures) and the direct
   image (1 exposure, direct_image_nsamp + 1 reads, the full-frame window
   W = S, on the inputs the main path gives it): noise off with IPC off
   and on (rtol 1e-5); noise on with the same Philox draws (>= 99.9 % of
   pixels identical, the rest within a few electrons; a second run
   bit-identical); then the Poisson regimes' moments and the read-noise
   sigma;
2. drives the main path at full width: ``examples/wasp43b_g141_scan.yml``
   (512^2, NSAMP 15, n_lambda 512, the default noise chain), cut to one
   orbit: ``Observation.simulate()`` and ``Observation.generate()`` for
   the direct image and the first chunk, read back with ``read_ima``. The
   readout's launch counter, zeroed just before, shows the path went
   through the kernel;
3. times the kernel, its plain version and ``simulate()``.

Prints the card's name and power limit first, a JSON line with the
kernel's numbers before the last line, and last
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

def readout_inputs(B, NR, W, S, n_cr, read_times, seed=0):
    """Headline-shaped readout inputs made on the card from a seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
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


def bound_of(args, flags) -> tuple[float, str, float, float]:
    """Least time for the readout on these inputs: bytes each input and
    output moves once, and the operations this run's data needs."""
    import torch
    seed, y0s, dts, bands, bg, bias, inv_gain, nl, cr_pos, cr_q, _ = args
    B, NR, W, S = bands.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (seed, y0s, dts, bands, bg, bias, inv_gain, nl,
                           cr_pos, cr_q))
    nbytes += (B * NR * S * S + B * S * S) * 4          # reads + cum out
    px_reads = B * NR * S * S
    ops = READOUT_OPS * px_reads + int((cr_q != 0).sum())   # + CR deposits
    n_normal = px_reads if flags["read_noise"] else 0
    if flags["poisson"]:
        # what these inputs need: a normal where lambda >= 3, a uniform and
        # the exact sum where 0 < lambda < 3, nothing where lambda = 0
        lam = bg[:, None] * dts[:, :, None, None]
        gauss = int((lam >= 3).sum())
        small = int(((lam > 0) & (lam < 3)).sum())
        if not flags["read_noise"]:
            n_normal = gauss
        ops += SAMPLER_OPS * gauss + (PHILOX_OPS + SMALL_LAM_OPS) * small
        gauss = int((bands >= 3).sum())
        small = int(((bands > 0) & (bands < 3)).sum())
        ops += (PHILOX_OPS + BOX_MULLER_OPS + SAMPLER_OPS) * gauss
        ops += (PHILOX_OPS + SMALL_LAM_OPS) * small
    ops += (PHILOX_OPS + BOX_MULLER_OPS) * n_normal
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = ops / H100_FP32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def direct_image_inputs(obs) -> tuple[tuple, dict]:
    """The readout's arguments and flags exactly as the main path gives
    them for the direct image (B = 1, NR = direct_image_nsamp + 1, W = S),
    recorded from one ``Observation.simulate_direct_image()``."""
    import wayne_tpu_torch.ops.exposure as ex
    real, seen = ex.exposure_readout, []

    def record(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    ex.exposure_readout = record
    try:
        obs.simulate_direct_image()
    finally:
        ex.exposure_readout = real
    (args, kw), = seen
    return args, kw


def hold_against_plain(ro, args, on: dict, label: str) -> list[float]:
    """Kernel against plain version on the same inputs: noise off with IPC
    off and on to rtol 1e-5, then ``on`` (noise on, the same Philox
    draws). Returns the max abs errors (DN)."""
    import torch
    errs = []
    for ipc in (False, True):
        off = dict(on, poisson=False, read_noise=False, ipc=ipc)
        got, cum = ro.exposure_readout(*args, **off)
        want, cum_w = ro.exposure_readout_plain(*args, **off)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        errs.append(err)
        check(rel <= 1e-5 and torch.allclose(cum, cum_w, rtol=1e-5, atol=0),
              f"{label}, noise off, ipc={ipc}: max abs err {err:.3g} DN, "
              f"max rel err {rel:.3g} <= 1e-5")
    got, _ = ro.exposure_readout(*args, **on)
    want, _ = ro.exposure_readout_plain(*args, **on)
    again, _ = ro.exposure_readout(*args, **on)
    torch.cuda.synchronize()
    same = float((got == want).float().mean())
    errs.append(float((got - want).abs().max()))
    worst_e = errs[-1] * float(args[10][2])         # DN x nominal gain
    check(same >= 0.999, f"{label}, noise on: {same * 100:.4f}% of pixels "
          "identical to the plain version (>= 99.9%)")
    check(worst_e <= 5.0, f"{label}, noise on: the rest within "
          f"{worst_e:.3g} e- (<= 5)")
    check(torch.equal(got, again),
          f"{label}, noise on: a second run is bit-identical")
    return errs


def phase_kernel(cfg, obs, card: str) -> dict:
    from wayne_tpu_torch.calibration import sample_sequence_times
    from wayne_tpu_torch.ops import readout as ro

    S, NR = cfg.subarray, cfg.nsamp + 1
    st = obs.static
    W, n_cr, B = st.band_px, st.max_cr_per_read, CHUNK
    times = sample_sequence_times(cfg.samp_seq, cfg.nsamp, S)
    args = readout_inputs(B, NR, W, S, n_cr, times)
    print(f"phase 1: kernel vs plain, chunk B={B} NR={NR} S={S} W={W} "
          f"MAX_CR={n_cr}")
    on = dict(poisson=True, read_noise=True, non_linearity=True, bias=True,
              scalar_gain=False, with_cr=True, bg_poisson=True, ipc=False)
    errs = hold_against_plain(ro, args, on, "chunk")
    di_args, di_flags = direct_image_inputs(obs)
    print("phase 1: kernel vs plain, direct image "
          f"(B, NR, W, S) = {tuple(di_args[3].shape)}, the main path's "
          f"inputs and flags {di_flags}")
    errs += hold_against_plain(ro, di_args, di_flags, "direct image")
    moments(ro, S, W, B)

    # timings at the chunk's shapes with the noise on
    ms = cuda_ms(lambda: ro.exposure_readout(*args, **on), reps=20)
    plain_ms = cuda_ms(lambda: ro.exposure_readout_plain(*args, **on),
                       reps=2, warmup=1)
    bound_ms, bound_by, t_bytes, t_ops = bound_of(args, on)
    print(f"timing [{card}]: readout kernel {ms:.4f} ms/launch "
          f"({ms / B:.4f} ms/exposure, B={B}), plain version "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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
    k = phase_kernel(cfg, obs, card)
    launches, _ = phase_main_path(cfg, obs, card)
    check("jax" not in sys.modules and not any(
        m == "wayne_tpu" or m.startswith("wayne_tpu.") for m in sys.modules),
          "neither jax nor wayne_tpu was imported")
    print(json.dumps({"kernels": [{
        "name": "exposure_readout", "route": "cuda",
        "source": "wayne_tpu_torch/csrc/readout.cu",
        "replaces": "wayne_tpu/ops/pallas_readout.py:416",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
