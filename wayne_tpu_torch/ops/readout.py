"""Up-the-ramp readout: the CUDA kernels, their plain PyTorch versions and
the wrappers that pick between them by device.

Three kernels, ports of the JAX package's Pallas kernels in
``wayne_tpu/ops/pallas_readout.py``:

* :func:`exposure_readout` (``csrc/readout.cu``, port of
  ``fused_exposure_readout``): every read of a chunk of exposures in one
  launch, the charge kept per pixel across reads. For every read k:

      cum += Poisson(bg_rate * dt_k)                 (three-regime sampler)
      cum[y0_k : y0_k + W] += Poisson(band_k)        (expected signal band)
      cum[y, x] += q for this read's cosmic-ray hits
      sig = nonlin(min(cum, fw)) -> IPC -> + bias -> + rn * N(0, 1)
      reads_dn[k] = sig * inv_gain                   (reciprocal gain plane)

* :func:`read_step_banded` (``csrc/read_step.cu``, port of
  ``fused_read_step_banded``): one read of the same chain, the charge
  passed in and returned, the expected band Poisson-sampled in the kernel
  on the whole-exposure kernel's counters (as :func:`sample_band` samples
  it).
* :func:`read_step` (``csrc/read_step.cu``, port of ``fused_read_step``):
  one read over the full frame, ``cum = (cum + add) + Poisson(bg_rate *
  dt)`` with ``add`` the already sampled band and hits, no IPC.

The charge starts at zero. Read 0 is a read whose interval entries are
zero (dt = 0, zero band, no CR): Poisson(0) = 0 in every regime, so it
emits the bias frame.

Randomness is Philox4x32-10 keyed by the exposure's two seed words, with
counter (k, y * S + x, stream tag, 0) and k the emitted read index (see
:mod:`wayne_tpu_torch.ops.random`). ``exact_poisson=True`` draws the band
and the background from the exact Poisson law instead
(:func:`~wayne_tpu_torch.ops.random.exact_poisson`, counters (k, y * S +
x, tag, n) over the blocks n), the kernels' second instantiation. All
three kernels and their plain versions draw the same numbers, so the
per-read path draws exactly what the whole-exposure path draws; which
pixel a thread owns never changes a draw.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; there is no fallback between them. Each counts
its launches in ``.launches``.
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

from wayne_tpu_torch.ops import random as rnd
from wayne_tpu_torch.ops.random import (
    T_EXACT, TAG_BAND_NORMAL, TAG_BAND_UNIFORM, TAG_BG_UNIFORM,
    TAG_BOX_MULLER, box_muller, fast_poisson, key_words, philox4x32,
    uniform24,
)

# Reads per launch: NSAMP <= 15 (WFC3) -> at most 16 emitted reads.
MAX_READS_PER_CALL = 16

# flag bits shared with csrc/detector.cuh
_F_POISSON, _F_READ_NOISE, _F_NONLIN, _F_BIAS = 1, 2, 4, 8
_F_SCALAR_GAIN, _F_CR, _F_BG_POISSON, _F_IPC = 16, 32, 64, 128
_F_EXACT_POISSON = 256


def _small_lambda_uniform(lam, k0, k1, k, pix, tag) -> torch.Tensor:
    """The exact branch's uniform. The kernels draw it only in that branch,
    and draws are counter-based, so skipping it changes no other draw: a
    CPU tensor skips it when no lam lies in (0, 3). On the card it is
    always drawn, since asking would make the host wait for the card."""
    if lam.device.type == "cpu" and not bool(
            ((lam > 0.0) & (lam < T_EXACT)).any()):
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


def _flag_bits(*, poisson=False, read_noise=False, non_linearity=False,
               bias=False, scalar_gain=False, with_cr=False,
               bg_poisson=False, ipc=False, exact_poisson=False) -> int:
    return ((_F_EXACT_POISSON if exact_poisson else 0)
            | (_F_POISSON if poisson else 0)
            | (_F_READ_NOISE if read_noise else 0)
            | (_F_NONLIN if non_linearity else 0) | (_F_BIAS if bias else 0)
            | (_F_SCALAR_GAIN if scalar_gain else 0)
            | (_F_CR if with_cr else 0)
            | (_F_BG_POISSON if bg_poisson else 0) | (_F_IPC if ipc else 0))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors; on the card only to check a kernel)
# ---------------------------------------------------------------------------

def sample_band(seed: torch.Tensor, read: int, y0: torch.Tensor,
                band: torch.Tensor, exact_poisson: bool = False
                ) -> torch.Tensor:
    """Poisson(band) on the whole-exposure kernel's counters: band element
    (r, x) of exposure b draws at pixel (y0_b + r) * S + x of read
    ``read``, tags TAG_BAND_NORMAL and TAG_BAND_UNIFORM (the exact sampler:
    TAG_BAND_UNIFORM only).

    seed (B, 2) int32, y0 (B,) int32, band (B, W, S) expected electrons.
    """
    B, W, S = band.shape
    dev = band.device
    k0, k1 = key_words(seed)
    k0p, k1p = k0[:, None, None], k1[:, None, None]
    rows = y0.long()[:, None, None] + torch.arange(W, device=dev)[:, None]
    bpix = rows * S + torch.arange(S, device=dev)
    if exact_poisson:
        return rnd.exact_poisson(band, k0p, k1p, read, bpix,
                                 TAG_BAND_UNIFORM)
    n0, n1, _, _ = philox4x32(k0p, k1p, read, bpix, TAG_BAND_NORMAL, 0)
    return fast_poisson(band, _small_lambda_uniform(
        band, k0p, k1p, read, bpix, TAG_BAND_UNIFORM), box_muller(n0, n1)[0])


def hit_ranks(cr_pos: torch.Tensor, cr_q: torch.Tensor) -> torch.Tensor:
    """For each hit of each list, how many earlier hits of its list (with
    a non-zero charge) land on its pixel. cr_pos (..., 2, n) int32, cr_q
    (..., n) -> (..., n) int64."""
    n = cr_q.shape[-1]
    y, x = cr_pos[..., 0, :], cr_pos[..., 1, :]
    same = ((y[..., :, None] == y[..., None, :])
            & (x[..., :, None] == x[..., None, :]))
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=cr_q.device).tril(-1)          # j < i
    return (same & earlier & (cr_q != 0)[..., None, :]).sum(-1)


def add_hits(frame: torch.Tensor, cr_pos: torch.Tensor, cr_q: torch.Tensor,
             ranks: torch.Tensor | None = None,
             n_ranks: int | None = None) -> torch.Tensor:
    """frame (B, S, S) plus one read's cosmic-ray hits (cr_pos (B, 2, n)
    rows/cols, cr_q (B, n)), hits on one pixel added in list order as the
    kernels add them, on any device: one scatter per rank of
    :func:`hit_ranks`, each of which adds at most one non-zero charge to a
    pixel. ``ranks``/``n_ranks`` may be given to spare the host the wait
    for ``ranks.max()``."""
    B, S, _ = frame.shape
    if ranks is None:
        ranks = hit_ranks(cr_pos, cr_q)
    if n_ranks is None:
        n_ranks = int(ranks.max()) + 1 if ranks.numel() else 0
    base = (torch.arange(B, device=frame.device) * (S * S))[:, None]
    idx = (base + cr_pos[:, 0].long() * S + cr_pos[:, 1].long()).reshape(-1)
    flat = frame.reshape(-1).clone()
    for r in range(n_ranks):
        flat.index_put_((idx,), torch.where(ranks == r, cr_q, 0.0).reshape(-1),
                        accumulate=True)
    return flat.view(B, S, S)


def _normals(seed, read, S, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The (background z, read-noise z) pair of every pixel of one read,
    (B, S, S) each."""
    k0, k1 = key_words(seed)
    pix = torch.arange(S * S, device=dev, dtype=torch.int64).view(1, S, S)
    b0, b1, _, _ = philox4x32(k0[:, None, None], k1[:, None, None], read,
                              pix, TAG_BOX_MULLER, 0)
    return box_muller(b0, b1)


def _add_background(cum, lam, sampled, z_bg, seed, read,
                    exact: bool = False) -> torch.Tensor:
    if not sampled:
        return cum + lam
    S = lam.shape[-1]
    k0, k1 = key_words(seed)
    k0p, k1p = k0[:, None, None], k1[:, None, None]
    pix = torch.arange(S * S, device=lam.device,
                       dtype=torch.int64).view(1, S, S)
    if exact:
        return cum + rnd.exact_poisson(lam, k0p, k1p, read, pix,
                                       TAG_BG_UNIFORM)
    return cum + fast_poisson(lam, _small_lambda_uniform(
        lam, k0p, k1p, read, pix, TAG_BG_UNIFORM), z_bg)


def _ipc(sig: torch.Tensor, alpha: float) -> torch.Tensor:
    """Inter-pixel capacitance over the last two axes: (1 - 4 alpha) of a
    pixel stays, alpha goes to each of its four neighbours (zero beyond
    the frame). Symmetric, so it is its own adjoint."""
    z = torch.nn.functional.pad(sig, (1, 1, 1, 1))
    up, down = z[..., :-2, 1:-1], z[..., 2:, 1:-1]
    left, right = z[..., 1:-1, :-2], z[..., 1:-1, 2:]
    one_m4a = float(_f32(1.0) - _f32(4.0) * _f32(alpha))
    return sig * one_m4a + alpha * (up + down + left + right)


def _nonlin(cum, nl_coeffs, fw: float, inv_fw: float) -> torch.Tensor:
    """The cubic non-linearity of the charge clipped at the full well."""
    c1, c2, c3 = nl_coeffs[0], nl_coeffs[1], nl_coeffs[2]
    # minimum, not clamp_max: the same value, and at the full well the
    # derivative 1/2 that jnp.minimum gives (clamp_max gives 1)
    s = torch.minimum(cum, torch.full((), fw, device=cum.device))
    q = s * inv_fw
    return s * (1.0 - ((c3 * q + c2) * q + c1) * q)


def _nonlin_slope(cum, nl_coeffs, fw: float, inv_fw: float) -> torch.Tensor:
    """d :func:`_nonlin` / d cum per pixel: 1 - 2 c1 q - 3 c2 q^2 - 4 c3 q^3
    below the full well, half that at it (``torch.minimum``'s split tie,
    as ``jnp.minimum``'s) and 0 above."""
    c1, c2, c3 = nl_coeffs[0], nl_coeffs[1], nl_coeffs[2]
    q = torch.clamp_max(cum, fw) * inv_fw
    slope = 1.0 - q * (2.0 * c1 + q * (3.0 * c2 + 4.0 * c3 * q))
    return slope * torch.where(cum < fw, 1.0,
                               torch.where(cum == fw, 0.5, 0.0))


def _emit(cum, nl_coeffs, bias_map, inv_gain, z_rn, consts, *,
          non_linearity, ipc, bias, read_noise, scalar_gain) -> torch.Tensor:
    """The readout chain: nonlin(min(cum, fw)) -> IPC -> + bias ->
    + rn * z -> * inv_gain."""
    rn, fw, inv_fw, inv_gain_s, alpha = _scalars(consts)
    sig = _nonlin(cum, nl_coeffs, fw, inv_fw) if non_linearity else cum
    if ipc:
        sig = _ipc(sig, alpha)
    if bias:
        sig = sig + bias_map
    if read_noise:
        sig = sig + rn * z_rn
    return sig * (inv_gain_s if scalar_gain else inv_gain)


def read_step_banded_plain(
        seed: torch.Tensor, read: int, y0: torch.Tensor, dt: torch.Tensor,
        cum: torch.Tensor, band: torch.Tensor, bg_rate: torch.Tensor,
        bias_map: torch.Tensor, inv_gain: torch.Tensor,
        nl_coeffs: torch.Tensor, cr_pos: torch.Tensor, cr_q: torch.Tensor,
        consts, *, poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True, ipc: bool = False,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the banded read step on an ALREADY SAMPLED
    band (:func:`sample_band`; otherwise the same arguments as
    :func:`read_step_banded`, the same arithmetic and Philox draws): the
    counterpart of the Pallas kernel ``fused_read_step_banded``, which
    takes its band sampled."""
    B, W, S = band.shape
    dev = band.device
    sampled = poisson and bg_poisson
    z_bg = z_rn = None
    if sampled or read_noise:
        z_bg, z_rn = _normals(seed, read, S, dev)
    cum = _add_background(cum, bg_rate * dt[:, None, None], sampled, z_bg,
                          seed, read, exact_poisson)
    ridx = (y0.long()[:, None] + torch.arange(W, device=dev)
            )[:, :, None].expand(B, W, S)
    cum = cum.scatter(1, ridx, torch.gather(cum, 1, ridx) + band)
    if with_cr:
        cum = add_hits(cum, cr_pos, cr_q)
    return cum, _emit(cum, nl_coeffs, bias_map, inv_gain, z_rn, consts,
                      non_linearity=non_linearity, ipc=ipc, bias=bias,
                      read_noise=read_noise, scalar_gain=scalar_gain)


def read_step_plain(
        seed: torch.Tensor, read: int, dt: torch.Tensor, cum: torch.Tensor,
        add: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, bg_poisson: bool = True,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the full-frame read step (same arguments
    as :func:`read_step`; same arithmetic, same Philox draws)."""
    sampled = poisson and bg_poisson
    z_bg = z_rn = None
    if sampled or read_noise:
        z_bg, z_rn = _normals(seed, read, add.shape[-1], add.device)
    cum = _add_background(cum + add, bg_rate * dt[:, None, None], sampled,
                          z_bg, seed, read, exact_poisson)
    return cum, _emit(cum, nl_coeffs, bias_map, inv_gain, z_rn, consts,
                      non_linearity=non_linearity, ipc=False, bias=bias,
                      read_noise=read_noise, scalar_gain=scalar_gain)


def exposure_readout_plain(
        seed: torch.Tensor, y0s: torch.Tensor, dts: torch.Tensor,
        bands: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor,
        cr_pos: torch.Tensor, cr_q: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True, ipc: bool = False,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the whole-exposure kernel (same arguments
    as :func:`exposure_readout`; same arithmetic, same Philox draws): the
    banded read step for every read, each band sampled first."""
    B, NR, W, S = bands.shape
    cum = torch.zeros((B, S, S), dtype=torch.float32, device=bands.device)
    reads = []
    for k in range(NR):
        band = bands[:, k]
        if poisson:
            band = sample_band(seed, k, y0s[:, k], band, exact_poisson)
        cum, dn = read_step_banded_plain(
            seed, k, y0s[:, k], dts[:, k], cum, band, bg_rate, bias_map,
            inv_gain, nl_coeffs, cr_pos[:, k], cr_q[:, k], consts,
            poisson=poisson, read_noise=read_noise,
            non_linearity=non_linearity, bias=bias, scalar_gain=scalar_gain,
            with_cr=with_cr, bg_poisson=bg_poisson, ipc=ipc,
            exact_poisson=exact_poisson)
        reads.append(dn)
    # stacked, not written into a buffer: torch.func can then take its
    # derivatives (_ExposureReadout)
    return torch.stack(reads, dim=1), cum


# ---------------------------------------------------------------------------
# The CUDA kernels: build at first use, bind with ctypes
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
SOURCES = ("readout.cu", "read_step.cu")       # one object each, one .so
HEADERS = ("detector.cuh",)
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
# No --use_fast_math; --fmad=false keeps every multiply and add separately
# rounded, as PyTorch's one-op kernels round them, so the kernels and their
# plain versions agree to the bit on the card. With FMA on, 0.26% of the
# noise-on pixels of the whole-exposure kernel differ from the plain
# version in the last bit, for ~1% less kernel time on an H100 80GB HBM3 at
# 700 W (torch_perf_breakdown.py).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]
_lib = None
_lib_lock = threading.Lock()
# the wrappers' launch counts are raised from a mesh's worker threads too
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the readout kernels are built "
                           "from wayne_tpu_torch/csrc at first use on a CUDA "
                           "machine")
    return path


def library_path(flags: list[str] = NVCC_FLAGS) -> str:
    """Where the kernel library for the current sources, headers and
    ``flags`` is (or will be)."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    return os.path.join(_BUILD_DIR, f"libreadout-{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False, flags: list[str] = NVCC_FLAGS) -> str:
    """Compile csrc/*.cu with ``flags`` into build/ unless those sources
    are already built so; returns the library path. The sources compile in
    parallel, one nvcc each, and link into one shared library. Safe against
    concurrent builders (build in a temporary directory, then rename)."""
    out = library_path(flags)
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *flags, "-c", "-o", obj, os.path.join(_CSRC, name)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
            elif verbose and err:
                print(err, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *flags, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return out


def load(path: str) -> ctypes.CDLL:
    """Open a built kernel library and declare its launchers' signatures."""
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in (
            ("wayne_exposure_readout", [P] * 12 + [I] * 5 + [F] * 5 + [I, P]),
            ("wayne_read_step_banded", [P] * 13 + [I] * 5 + [F] * 5 + [I, P]),
            ("wayne_read_step", [P] * 10 + [I] * 3 + [F] * 4 + [I, P])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
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


def _kernel_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"no readout kernel for device {t.device}")
    return t.device


def _count(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel (no update is lost between
    threads)."""
    with _count_lock:
        wrapper.launches += 1


def _launch(fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


_FLAG_NAMES = ("poisson", "read_noise", "non_linearity", "bias",
               "scalar_gain", "with_cr", "bg_poisson", "ipc", "exact_poisson")


def _host_consts(consts) -> tuple[float, float, float, float]:
    """The four readout scalars as host floats (refusing a device tensor,
    which would make the host wait for the card)."""
    if isinstance(consts, torch.Tensor) and consts.device.type != "cpu":
        raise ValueError("consts are host scalars (a sequence of four floats "
                         f"or a CPU tensor), got a tensor on {consts.device}")
    return tuple(float(v) for v in np.asarray(consts, np.float32).tolist())


def _launch_exposure_readout(seed, y0s, dts, bands, bg_rate, bias_map,
                             inv_gain, nl_coeffs, cr_pos, cr_q, consts,
                             flags: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The value of :func:`exposure_readout`: the plain version for CPU
    tensors, the kernel for CUDA tensors (plain tensors only: this runs
    inside :class:`_ExposureReadout`'s forward, which sees primals)."""
    B, NR, W, S = bands.shape
    if bands.device.type == "cpu":
        return exposure_readout_plain(
            seed, y0s, dts, bands, bg_rate, bias_map, inv_gain, nl_coeffs,
            cr_pos, cr_q, consts, **flags)
    dev = _kernel_device(bands)
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
    reads = torch.empty((B, NR, S, S), dtype=f32, device=dev)
    cum = torch.empty((B, S, S), dtype=f32, device=dev)
    _launch(_library().wayne_exposure_readout, dev,
            seed.data_ptr(), y0s.data_ptr(), dts.data_ptr(),
            bands.data_ptr(), bg_rate.data_ptr(), bias_map.data_ptr(),
            inv_gain.data_ptr(), nl_coeffs.data_ptr(), cr_pos.data_ptr(),
            cr_q.data_ptr(), reads.data_ptr(), cum.data_ptr(),
            B, NR, W, S, n_cr, *_scalars(consts), _flag_bits(**flags))
    _count(exposure_readout)
    return reads, cum


_INPUT_NAMES = ("seed", "y0s", "dts", "bands", "bg_rate", "bias_map",
                "inv_gain", "nl_coeffs", "cr_pos", "cr_q")
_DIFFERENTIABLE = (3, 4)                  # bands, bg_rate


def _refuse(derived, flags: dict) -> None:
    """Raise unless only ``bands`` and ``bg_rate`` (input positions 3, 4)
    of ``derived`` (one truth value per input) carry a derivative, and
    then only with the noise off."""
    for i, name in enumerate(_INPUT_NAMES):
        if derived[i] and i not in _DIFFERENTIABLE:
            raise ValueError(f"exposure_readout is differentiable with "
                             f"respect to bands and bg_rate only; {name} "
                             "carries a derivative")
    if any(derived) and (flags["poisson"] or flags["read_noise"]
                         or flags["with_cr"]):
        raise ValueError("the readout has derivatives only with Poisson "
                         "sampling, read noise and cosmic rays off")


def _charge_by_read(y0s, dts, bands, bg_rate, shape) -> list[torch.Tensor]:
    """The charge after each read, (B, S, S) per read, by the plain
    version's sums with the noise off (the expected background and band);
    given the tangents of ``bands`` and ``bg_rate`` instead (None for
    none), their tangents. ``shape``: the bands' (B, NR, W, S)."""
    B, NR, W, S = shape
    cum = torch.zeros((B, S, S), dtype=torch.float32, device=dts.device)
    out = []
    for k in range(NR):
        if bg_rate is not None:
            cum = cum + bg_rate * dts[:, k, None, None]
        if bands is not None:
            rows = (y0s[:, k].long()[:, None]
                    + torch.arange(W, device=cum.device))[:, :, None]
            rows = rows.expand(-1, W, S)
            cum = cum.scatter(1, rows, torch.gather(cum, 1, rows)
                              + bands[:, k])
        out.append(cum)
    return out


class _ExposureReadout(torch.autograd.Function):
    """:func:`exposure_readout` as a differentiable function of ``bands``
    and ``bg_rate``. Its value comes from :func:`_launch_exposure_readout`
    (the kernel on the card, the plain version on the CPU) on primal
    tensors only, so no tangent can reach the kernel's pointers. The
    derivatives exist with the noise off (no Poisson draw, read noise or
    cosmic ray), where the chain is linear in those two inputs up to the
    non-linearity at each read's charge:

        dcum_k = dcum_{k-1} + dbg dt_k + dband_k at rows y0_k
        ddn_k  = inv_gain IPC(nonlin'(cum_k) dcum_k)

    ``jvp`` computes that directly: nonlin' once per read on the primal
    charge (:func:`_nonlin_slope`), then one product, IPC and the gain on
    the tangents. ``torch.func.jvp`` of the whole plain version, which
    carries every step's tangent formula on the tangents, takes longer on
    the retrieval's chunk (``chip_smoke.py`` phase 11b times both).
    ``backward`` is ``torch.func.vjp`` of the plain version. A derivative on any other input raises. ``vmap`` folds a
    mapped axis into the exposure axis: one launch for the whole batch."""

    @staticmethod
    def forward(seed, y0s, dts, bands, bg_rate, bias_map, inv_gain,
                nl_coeffs, cr_pos, cr_q, consts, flags):
        return _launch_exposure_readout(
            seed, y0s, dts, bands, bg_rate, bias_map, inv_gain, nl_coeffs,
            cr_pos, cr_q, consts, dict(zip(_FLAG_NAMES, flags)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.consts = inputs[10]
        ctx.flags = dict(zip(_FLAG_NAMES, inputs[11]))
        _refuse(ctx.needs_input_grad, ctx.flags)
        # an input without a tangent gets None in jvp, not zeros, so that
        # jvp can tell it from one that has
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(*inputs[:10])
        ctx.save_for_backward(*inputs[:10])

    @staticmethod
    def _plain(ctx):
        """The plain version as a function of (bands, bg_rate) at the
        saved inputs, and those two inputs."""
        ins = ctx.saved_tensors

        def plain(bands, bg_rate):
            return exposure_readout_plain(*ins[:3], bands, bg_rate, *ins[5:],
                                          ctx.consts, **ctx.flags)
        return plain, ins[3], ins[4]

    @staticmethod
    def jvp(ctx, *tangents):
        _refuse([t is not None for t in tangents], ctx.flags)
        _, y0s, dts, bands, bg_rate, _, inv_gain, nl_coeffs = \
            ctx.saved_tensors[:8]
        f, consts = ctx.flags, ctx.consts
        _, fw, inv_fw, _, _ = _scalars(consts)
        d_cums = _charge_by_read(y0s, dts, tangents[3], tangents[4],
                                 bands.shape)
        out = []
        for cum, d in zip(_charge_by_read(y0s, dts, bands, bg_rate,
                                          bands.shape), d_cums):
            if f["non_linearity"]:
                d = d * _nonlin_slope(cum, nl_coeffs, fw, inv_fw)
            out.append(_emit(d, None, None, inv_gain, None, consts,
                             non_linearity=False, ipc=f["ipc"], bias=False,
                             read_noise=False,
                             scalar_gain=f["scalar_gain"]))
        return torch.stack(out, dim=1), d_cums[-1]

    @staticmethod
    def backward(ctx, g_reads, g_cum):
        plain, bands, bg_rate = _ExposureReadout._plain(ctx)
        out, pull = torch.func.vjp(plain, bands, bg_rate)
        g = tuple(torch.zeros_like(o) if g is None else g
                  for o, g in zip(out, (g_reads, g_cum)))
        return (None, None, None, *pull(g),
                None, None, None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, seed, y0s, dts, bands, bg_rate, bias_map,
             inv_gain, nl_coeffs, cr_pos, cr_q, consts, flags):
        n = info.batch_size
        if any(d is not None for d in in_dims[5:8]):
            raise ValueError("exposure_readout under vmap: bias_map, "
                             "inv_gain and nl_coeffs are one plane per "
                             "launch and cannot be mapped")

        def fold(t, d):
            t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
            return t.reshape(-1, *t.shape[2:]).contiguous()

        per_exp = [fold(t, d) for t, d in zip(
            (seed, y0s, dts, bands, bg_rate), in_dims[:5])]
        hits = [fold(t, d) for t, d in zip((cr_pos, cr_q), in_dims[8:10])]
        reads, cum = _ExposureReadout.apply(
            *per_exp, bias_map, inv_gain, nl_coeffs, *hits, consts, flags)
        return ((reads.reshape(n, -1, *reads.shape[1:]),
                 cum.reshape(n, -1, *cum.shape[1:])), (0, 0))


def exposure_readout(
        seed: torch.Tensor, y0s: torch.Tensor, dts: torch.Tensor,
        bands: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor,
        cr_pos: torch.Tensor, cr_q: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True, ipc: bool = False,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Every read of a chunk in one call.

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
      exact_poisson: draw the band and the background from the exact
        Poisson law (``ops.random.exact_poisson``; the kernel's second
        instantiation) instead of the three-regime sampler.

    Differentiable with respect to ``bands`` and ``bg_rate`` (autograd,
    ``torch.func.jvp``/``jacfwd``/``jacrev``/``vmap``) when Poisson
    sampling, read noise and cosmic rays are off; a derivative on any
    other input, or with the noise on, raises (:class:`_ExposureReadout`).

    Returns:
      (reads_dn (B, NR, S, S) in time order, final cum (B, S, S)).
    """
    NR = bands.shape[1]
    if NR > MAX_READS_PER_CALL:
        raise ValueError(f"at most {MAX_READS_PER_CALL} reads per call")
    flags = (poisson, read_noise, non_linearity, bias, scalar_gain, with_cr,
             bg_poisson, ipc, exact_poisson)
    return _ExposureReadout.apply(seed, y0s, dts, bands, bg_rate, bias_map,
                                  inv_gain, nl_coeffs, cr_pos, cr_q,
                                  _host_consts(consts), flags)


exposure_readout.launches = 0


def read_step_banded(
        seed: torch.Tensor, read: int, y0: torch.Tensor, dt: torch.Tensor,
        cum: torch.Tensor, band: torch.Tensor, bg_rate: torch.Tensor,
        bias_map: torch.Tensor, inv_gain: torch.Tensor,
        nl_coeffs: torch.Tensor, cr_pos: torch.Tensor, cr_q: torch.Tensor,
        consts, *, poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, with_cr: bool = True,
        bg_poisson: bool = True,
        ipc: bool = False,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One read of a chunk of B exposures: the background Poisson-sampled
    on top of ``cum``, the band Poisson-sampled at its rows (on the
    whole-exposure kernel's counters, :func:`sample_band`), the cosmic-ray
    hits deposited in list order, then the readout chain. One read of
    :func:`exposure_readout`.

    Args:
      seed: (B, 2) int32 exposure seed words; read: the EMITTED read index
        (a host int; the third Philox word beside the two seed words).
      y0: (B,) int32 band start rows (any row, y0 + W <= S); dt: (B,) f32
        interval durations.
      cum: (B, S, S) f32 charge before the interval.
      band: (B, W, S) f32 EXPECTED signal electrons this interval; added
        as given when ``poisson`` is off.
      bg_rate: (B, S, S) expected background electrons per second;
        bias_map, inv_gain (RECIPROCAL gain plane), nl_coeffs: as for
        :func:`exposure_readout`.
      cr_pos: (B, 2, MAX_CR) int32 hit rows/cols; cr_q: (B, MAX_CR) f32
        charges, zero beyond the hit count.
      consts: four host scalars (read_noise_e, full_well_e, gain,
        ipc_alpha).
      The band is sampled when ``poisson``, the background when
      ``poisson`` and ``bg_poisson``; both from the exact law when
      ``exact_poisson``.

    Returns:
      (cum after the read (B, S, S), read DN (B, S, S)).
    """
    B, W, S = band.shape
    flags = dict(poisson=poisson, read_noise=read_noise,
                 non_linearity=non_linearity, bias=bias,
                 scalar_gain=scalar_gain, with_cr=with_cr,
                 bg_poisson=bg_poisson, ipc=ipc, exact_poisson=exact_poisson)
    if band.device.type == "cpu":
        if poisson:
            band = sample_band(seed, read, y0, band, exact_poisson)
        return read_step_banded_plain(
            seed, read, y0, dt, cum, band, bg_rate, bias_map, inv_gain,
            nl_coeffs, cr_pos, cr_q, consts, **flags)
    dev = _kernel_device(band)
    n_cr = cr_q.shape[-1]
    f32, i32 = torch.float32, torch.int32
    _check("seed", seed, (B, 2), i32, dev)
    _check("y0", y0, (B,), i32, dev)
    _check("dt", dt, (B,), f32, dev)
    _check("cum", cum, (B, S, S), f32, dev)
    _check("band", band, (B, W, S), f32, dev)
    _check("bg_rate", bg_rate, (B, S, S), f32, dev)
    _check("bias_map", bias_map, (S, S), f32, dev)
    _check("inv_gain", inv_gain, (S, S), f32, dev)
    _check("nl_coeffs", nl_coeffs, (3, S, S), f32, dev)
    _check("cr_pos", cr_pos, (B, 2, n_cr), i32, dev)
    _check("cr_q", cr_q, (B, n_cr), f32, dev)
    if W > S:
        raise ValueError(f"band width {W} exceeds the frame {S}")
    cum_out = torch.empty((B, S, S), dtype=f32, device=dev)
    dn = torch.empty((B, S, S), dtype=f32, device=dev)
    _launch(_library().wayne_read_step_banded, dev,
            seed.data_ptr(), y0.data_ptr(), dt.data_ptr(), cum.data_ptr(),
            band.data_ptr(), bg_rate.data_ptr(), bias_map.data_ptr(),
            inv_gain.data_ptr(), nl_coeffs.data_ptr(), cr_pos.data_ptr(),
            cr_q.data_ptr(), cum_out.data_ptr(), dn.data_ptr(),
            B, W, S, n_cr, int(read), *_scalars(consts), _flag_bits(**flags))
    _count(read_step_banded)
    return cum_out, dn


read_step_banded.launches = 0


def read_step(
        seed: torch.Tensor, read: int, dt: torch.Tensor, cum: torch.Tensor,
        add: torch.Tensor, bg_rate: torch.Tensor, bias_map: torch.Tensor,
        inv_gain: torch.Tensor, nl_coeffs: torch.Tensor, consts, *,
        poisson: bool = True, read_noise: bool = True,
        non_linearity: bool = True, bias: bool = True,
        scalar_gain: bool = False, bg_poisson: bool = True,
        exact_poisson: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One full-frame read of a chunk of B exposures, without IPC:
    ``cum = (cum + add) + Poisson(bg_rate * dt)``, then the readout chain.

    Args:
      seed, read, dt, bg_rate, bias_map, inv_gain, nl_coeffs, consts: as
        for :func:`read_step_banded`.
      cum: (B, S, S) f32 charge before the interval.
      add: (B, S, S) f32 already sampled signal plus cosmic-ray charges
        of this interval (:func:`sample_band`, :func:`add_hits`).

    Returns:
      (cum after the read (B, S, S), read DN (B, S, S)).
    """
    B, S, _ = add.shape
    flags = dict(poisson=poisson, read_noise=read_noise,
                 non_linearity=non_linearity, bias=bias,
                 scalar_gain=scalar_gain, bg_poisson=bg_poisson,
                 exact_poisson=exact_poisson)
    if add.device.type == "cpu":
        return read_step_plain(seed, read, dt, cum, add, bg_rate, bias_map,
                               inv_gain, nl_coeffs, consts, **flags)
    dev = _kernel_device(add)
    f32 = torch.float32
    _check("seed", seed, (B, 2), torch.int32, dev)
    _check("dt", dt, (B,), f32, dev)
    for name, t in (("cum", cum), ("add", add), ("bg_rate", bg_rate)):
        _check(name, t, (B, S, S), f32, dev)
    _check("bias_map", bias_map, (S, S), f32, dev)
    _check("inv_gain", inv_gain, (S, S), f32, dev)
    _check("nl_coeffs", nl_coeffs, (3, S, S), f32, dev)
    rn, fw, inv_fw, inv_gain_s, _ = _scalars(consts)
    cum_out = torch.empty((B, S, S), dtype=f32, device=dev)
    dn = torch.empty((B, S, S), dtype=f32, device=dev)
    _launch(_library().wayne_read_step, dev,
            seed.data_ptr(), dt.data_ptr(), cum.data_ptr(), add.data_ptr(),
            bg_rate.data_ptr(), bias_map.data_ptr(), inv_gain.data_ptr(),
            nl_coeffs.data_ptr(), cum_out.data_ptr(), dn.data_ptr(),
            B, S, int(read), rn, fw, inv_fw, inv_gain_s, _flag_bits(**flags))
    _count(read_step)
    return cum_out, dn


read_step.launches = 0
