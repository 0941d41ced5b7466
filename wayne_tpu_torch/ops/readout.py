"""Whole-exposure up-the-ramp readout: the CUDA kernel, its plain PyTorch
version and the wrapper that picks between them by device.

Port of the JAX package's Pallas kernel ``fused_exposure_readout``
(``wayne_tpu/ops/pallas_readout.py``, body ``_kernel_exposure``). For every
read k of every exposure in a chunk, with the accumulated charge kept per
pixel across reads:

    cum += Poisson(bg_rate * dt_k)                 (three-regime sampler)
    cum[y0_k : y0_k + W] += Poisson(band_k)        (expected signal band)
    cum[y, x] += q for this read's cosmic-ray hits
    sig = nonlin(min(cum, fw)) -> IPC -> + bias -> + rn * N(0, 1)
    reads_dn[k] = sig * inv_gain                   (reciprocal gain plane)

The charge starts at zero. Read 0 is a read whose interval entries are
zero (dt = 0, zero band, no CR): Poisson(0) = 0 in every regime, so it
emits the bias frame.

Randomness is Philox4x32-10 keyed by the exposure's two seed words, with
counter (k, y * S + x, stream tag, 0) (see
:mod:`wayne_tpu_torch.ops.random`). The kernel and the plain version draw
the same numbers; which pixel a thread owns never changes a draw.

:func:`exposure_readout` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from wayne_tpu_torch.ops.random import (
    T_EXACT, TAG_BAND_NORMAL, TAG_BAND_UNIFORM, TAG_BG_UNIFORM,
    TAG_BOX_MULLER, box_muller, fast_poisson, key_words, philox4x32,
    uniform24,
)

# Reads per launch: NSAMP <= 15 (WFC3) -> at most 16 emitted reads.
MAX_READS_PER_CALL = 16

# flag bits shared with csrc/readout.cu
_F_POISSON, _F_READ_NOISE, _F_NONLIN, _F_BIAS = 1, 2, 4, 8
_F_SCALAR_GAIN, _F_CR, _F_BG_POISSON, _F_IPC = 16, 32, 64, 128


def _small_lambda_uniform(lam, k0, k1, k, pix, tag) -> torch.Tensor:
    """The exact branch's uniform, drawn only when some lam lies in (0, 3),
    as the kernel draws it only in that branch (draws are counter-based:
    skipping one changes no other)."""
    if not bool(((lam > 0.0) & (lam < T_EXACT)).any()):
        return torch.zeros_like(lam)
    return uniform24(philox4x32(k0, k1, k, pix, tag, 0)[0])


def _f32(v) -> np.float32:
    return np.float32(v)


def _scalars(consts) -> tuple[float, float, float, float, float]:
    """(rn, fw, 1/fw, 1/gain, alpha) as float32 values (the reciprocals
    computed in float32, as the kernels do) from the four host scalars
    (read_noise_e, full_well_e, gain, ipc_alpha)."""
    if isinstance(consts, torch.Tensor) and consts.device.type != "cpu":
        raise ValueError("consts are host scalars (a sequence of four floats "
                         f"or a CPU tensor), got a tensor on {consts.device}")
    rn, fw, gain, alpha = np.asarray(consts, np.float32).tolist()
    return (float(_f32(rn)), float(_f32(fw)), float(_f32(1.0) / _f32(fw)),
            float(_f32(1.0) / _f32(gain)), float(_f32(alpha)))


def exposure_readout_plain(
        seed: torch.Tensor, y0s: torch.Tensor, dts: torch.Tensor,
        bands: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor,
        cr_pos: torch.Tensor, cr_q: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True,
        ipc: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the readout kernel (same arguments as
    :func:`exposure_readout`; same arithmetic, same Philox draws)."""
    B, NR, W, S = bands.shape
    dev = bands.device
    rn, fw, inv_fw, inv_gain_s, alpha = _scalars(consts)
    k0, k1 = key_words(seed)
    k0p, k1p = k0[:, None, None], k1[:, None, None]
    pix = torch.arange(S * S, device=dev, dtype=torch.int64).view(1, S, S)
    cum = torch.zeros((B, S, S), dtype=torch.float32, device=dev)
    c1, c2, c3 = nl_coeffs[0], nl_coeffs[1], nl_coeffs[2]
    rows = torch.arange(W, device=dev)
    cols = torch.arange(S, device=dev)
    reads = torch.empty((B, NR, S, S), dtype=torch.float32, device=dev)
    need_bm = (poisson and bg_poisson) or read_noise
    for k in range(NR):
        if need_bm:
            b0, b1, _, _ = philox4x32(k0p, k1p, k, pix, TAG_BOX_MULLER, 0)
            z_bg, z_rn = box_muller(b0, b1)
        lam = bg_rate * dts[:, k, None, None]
        if poisson and bg_poisson:
            cum = cum + fast_poisson(lam, _small_lambda_uniform(
                lam, k0p, k1p, k, pix, TAG_BG_UNIFORM), z_bg)
        else:
            cum = cum + lam
        # the band: rows y0 .. y0 + W of each exposure
        ridx = (y0s[:, k, None].long() + rows)[:, :, None].expand(B, W, S)
        band = bands[:, k]
        if poisson:
            bpix = ridx * S + cols
            n0, n1, _, _ = philox4x32(k0p, k1p, k, bpix, TAG_BAND_NORMAL, 0)
            band = fast_poisson(band, _small_lambda_uniform(
                band, k0p, k1p, k, bpix, TAG_BAND_UNIFORM),
                box_muller(n0, n1)[0])
        cum = cum.scatter(1, ridx, torch.gather(cum, 1, ridx) + band)
        if with_cr:
            base = (torch.arange(B, device=dev) * (S * S))[:, None]
            idx = base + cr_pos[:, k, 0].long() * S + cr_pos[:, k, 1].long()
            cum = cum.reshape(-1).index_add(
                0, idx.reshape(-1), cr_q[:, k].reshape(-1)).view(B, S, S)
        sig = cum
        if non_linearity:
            s = torch.clamp_max(sig, fw)
            q = s * inv_fw
            sig = s * (1.0 - ((c3 * q + c2) * q + c1) * q)
        if ipc:
            z = torch.nn.functional.pad(sig, (1, 1, 1, 1))
            up, down = z[:, :-2, 1:-1], z[:, 2:, 1:-1]
            left, right = z[:, 1:-1, :-2], z[:, 1:-1, 2:]
            one_m4a = float(_f32(1.0) - _f32(4.0) * _f32(alpha))
            sig = sig * one_m4a + alpha * (up + down + left + right)
        if bias:
            sig = sig + bias_map
        if read_noise:
            sig = sig + rn * z_rn
        reads[:, k] = sig * (inv_gain_s if scalar_gain else inv_gain)
    return reads, cum


# ---------------------------------------------------------------------------
# The CUDA kernel: build at first use, bind with ctypes
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "readout.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
# No --use_fast_math; --fmad=false keeps every multiply and add separately
# rounded, as PyTorch's one-op kernels round them, so the kernel and its
# plain version agree to the bit on the card. With FMA on, 0.26% of the
# noise-on pixels differ from the plain version in the last bit, for ~1%
# less kernel time on an H100 80GB HBM3 at 700 W (torch_perf_breakdown.py).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the readout kernel is built "
                           "from csrc/readout.cu at first use on a CUDA "
                           "machine")
    return path


def library_path(flags: list[str] = NVCC_FLAGS) -> str:
    """Where the kernel library for the current source and ``flags`` is
    (or will be)."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
    return os.path.join(_BUILD_DIR, f"libreadout-{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False, flags: list[str] = NVCC_FLAGS) -> str:
    """Compile csrc/readout.cu with ``flags`` into build/ unless that
    source is already built so; returns the library path. Safe against
    concurrent builders (compile to a temporary name, then rename)."""
    out = library_path(flags)
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, _SRC]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load(path: str) -> ctypes.CDLL:
    """Open a built kernel library and declare its launcher's signature."""
    lib = ctypes.CDLL(path)
    fn = lib.wayne_exposure_readout
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 12 + [I] * 5 + [F] * 5 + [I, P]
    fn.restype = I
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def exposure_readout(
        seed: torch.Tensor, y0s: torch.Tensor, dts: torch.Tensor,
        bands: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor,
        cr_pos: torch.Tensor, cr_q: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True,
        ipc: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Every read of a chunk of B exposures in one call.

    Per-read arrays are indexed by EMITTED read (read 0 = zero entries).

    Args:
      seed: (B, 2) int32 exposure seed words (Philox key).
      y0s: (B, NR) int32 band start rows, with y0 + W <= S.
      dts: (B, NR) f32 interval durations ending at each read.
      bands: (B, NR, W, S) f32 EXPECTED signal electrons per interval.
      bg_rate: (B, S, S) f32 expected background electrons per second.
      bias_map: (S, S); inv_gain: (S, S) RECIPROCAL gain plane;
        nl_coeffs: (3, S, S) cubic non-linearity planes (c1, c2, c3).
      cr_pos: (B, NR, 2, MAX_CR) int32 hit rows/cols; cr_q: (B, NR, MAX_CR)
        f32 charges, zero beyond each read's hit count.
      consts: four host scalars (read_noise_e, full_well_e, gain,
        ipc_alpha), a sequence of floats or a CPU tensor, so that a launch
        reads nothing back from the card; the scalar gain is used when
        ``scalar_gain``.

    Returns:
      (reads_dn (B, NR, S, S) in time order, final cum (B, S, S)).
    """
    B, NR, W, S = bands.shape
    if NR > MAX_READS_PER_CALL:
        raise ValueError(f"at most {MAX_READS_PER_CALL} reads per call")
    dev = bands.device
    if dev.type == "cpu":
        return exposure_readout_plain(
            seed, y0s, dts, bands, bg_rate, bias_map, inv_gain,
            nl_coeffs, cr_pos, cr_q, consts, poisson=poisson,
            read_noise=read_noise, non_linearity=non_linearity, bias=bias,
            scalar_gain=scalar_gain, with_cr=with_cr, bg_poisson=bg_poisson,
            ipc=ipc)
    if dev.type != "cuda":
        raise ValueError(f"no readout kernel for device {dev}")
    n_cr = cr_q.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check("seed", seed, (B, 2), i32, dev)
    _check("y0s", y0s, (B, NR), i32, dev)
    _check("dts", dts, (B, NR), f32, dev)
    _check("bands", bands, (B, NR, W, S), f32, dev)
    _check("bg_rate", bg_rate, (B, S, S), f32, dev)
    _check("bias_map", bias_map, (S, S), f32, dev)
    _check("inv_gain", inv_gain, (S, S), f32, dev)
    _check("nl_coeffs", nl_coeffs, (3, S, S), f32, dev)
    _check("cr_pos", cr_pos, (B, NR, 2, n_cr), i32, dev)
    _check("cr_q", cr_q, (B, NR, n_cr), f32, dev)
    if W > S:
        raise ValueError(f"band width {W} exceeds the frame {S}")
    rn, fw, inv_fw, inv_gain_s, alpha = _scalars(consts)
    flags = ((_F_POISSON if poisson else 0)
             | (_F_READ_NOISE if read_noise else 0)
             | (_F_NONLIN if non_linearity else 0) | (_F_BIAS if bias else 0)
             | (_F_SCALAR_GAIN if scalar_gain else 0)
             | (_F_CR if with_cr else 0)
             | (_F_BG_POISSON if bg_poisson else 0) | (_F_IPC if ipc else 0))
    reads = torch.empty((B, NR, S, S), dtype=f32, device=dev)
    cum = torch.empty((B, S, S), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().wayne_exposure_readout(
            seed.data_ptr(), y0s.data_ptr(), dts.data_ptr(),
            bands.data_ptr(), bg_rate.data_ptr(), bias_map.data_ptr(), inv_gain.data_ptr(),
            nl_coeffs.data_ptr(), cr_pos.data_ptr(), cr_q.data_ptr(),
            reads.data_ptr(), cum.data_ptr(),
            B, NR, W, S, n_cr, rn, fw, inv_fw, inv_gain_s,
            alpha, flags, stream)
    if err != 0:
        raise RuntimeError(f"readout kernel launch failed: CUDA error {err}")
    exposure_readout.launches += 1
    return reads, cum


exposure_readout.launches = 0
