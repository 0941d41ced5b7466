"""Counter-based random numbers and the plain three-regime Poisson sampler.

The port replaces ``jax.random`` keys by explicit seed words: every draw is
Philox4x32-10 of (key = two 32-bit seed words, counter = four 32-bit
words), so a draw depends only on (exposure seed, read, pixel or entry,
stream tag) — never on the device, the batch size or the kernel's tiling.
The readout kernels (``csrc/detector.cuh``) carry the same Philox; this
module's torch version is bit-identical to it (uint32 words carried in
int64 tensors, so products never overflow).

The two packages draw different random bits from the same seed: tests
compare distributions, never bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85

# Stream tags (third counter word). The readout kernel's tags 0..3 are
# mirrored in csrc/detector.cuh; the rest are drawn on the torch side only.
TAG_BOX_MULLER = 0     # background z and read-noise z, one pair per read
TAG_BAND_NORMAL = 1    # the signal band's Box-Muller normal
TAG_BG_UNIFORM = 2     # small-lambda uniform of the background sampler
TAG_BAND_UNIFORM = 3   # small-lambda uniform of the band sampler
TAG_CR_COUNT = 16      # cosmic-ray hit count of a read interval
TAG_CR_HIT = 17        # cosmic-ray positions and charges
TAG_BIAS_DRIFT = 18    # per-read per-amplifier bias drift
TAG_SSV_WALK = 19      # random-walk scan-speed variation steps
TAG_SEED = 20          # exposure seed words from (visit seed, index)
TAG_MC_SEED = 21       # seed words from (root seed, realisation, exposure)
TAG_RTS = 22           # unstable (RTS) pixel state, one per exposure and pixel

T_EXACT = 3.0          # below: exact inverse transform (12 terms)
_T_GAUSS = 100.0       # above: plain Gaussian; between: Cornish-Fisher
# 1/j in float32, as the kernel's constant table kInv holds them
_INV = [float(np.float32(1.0) / np.float32(j)) for j in range(1, 13)]
_TWO_PI = 6.283185307179586


def _mulhilo(m: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * b, with b < 2^32
    carried in int64: split b into 16-bit halves so no partial product
    reaches 2^63."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10. Every argument is an int64 tensor (or int) holding a
    uint32 word; they broadcast. Returns four int64 tensors of uint32."""
    k0 = torch.as_tensor(k0, dtype=torch.int64) & _MASK32
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device) & _MASK32
    dev = k0.device
    c = [torch.as_tensor(v, dtype=torch.int64, device=dev) & _MASK32
         for v in (c0, c1, c2, c3)]
    c0, c1, c2, c3 = torch.broadcast_tensors(*c, k0, k1)[:4]
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """U(0, 1] in float32 from the top 24 bits of a uint32 word, floored
    at 1e-7 so a log never sees 0 (the JAX kernels' ``_uniform``)."""
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp_min(u, 1e-7)


def box_muller(b0: torch.Tensor, b1: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent N(0, 1) float32 draws from two uint32 words."""
    r = torch.sqrt(-2.0 * torch.log(uniform24(b0)))
    theta = _TWO_PI * uniform24(b1)
    return r * torch.cos(theta), r * torch.sin(theta)


def seed_words(seed: int, index: torch.Tensor) -> torch.Tensor:
    """(N, 2) int32 exposure seed words derived from (visit seed, index):
    one Philox block keyed by the visit seed, counter (index, 0, TAG_SEED).
    The port's counterpart of ``fold_in(PRNGKey(seed), index)``."""
    index = torch.as_tensor(index, dtype=torch.int64)
    w0, w1, _, _ = philox4x32(seed & _MASK32, (seed >> 32) & _MASK32,
                              index, 0, TAG_SEED, 0)
    words = torch.stack([w0, w1], dim=-1)
    return _int32(words)


def mc_seed_words(seed: int, m: torch.Tensor, e: torch.Tensor
                  ) -> torch.Tensor:
    """(..., 2) int32 seed words of exposure ``e`` of Monte-Carlo
    realisation ``m`` (GLOBAL index; ``m`` and ``e`` broadcast): one Philox
    block keyed by the root seed, counter (m, e, TAG_MC_SEED). The port's
    counterpart of ``fold_in(fold_in(PRNGKey(seed), m), e)``: realisation m
    draws the same noise however a run is chunked."""
    m = torch.as_tensor(m, dtype=torch.int64)
    w0, w1, _, _ = philox4x32(seed & _MASK32, (seed >> 32) & _MASK32,
                              m, e, TAG_MC_SEED, 0)
    return _int32(torch.stack([w0, w1], dim=-1))


def _int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words carried in int64 -> the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def key_words(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2) int32 seed words -> two int64 tensors of uint32 key words."""
    s = seed.to(torch.int64) & _MASK32
    return s[..., 0], s[..., 1]


def _by(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as one rounded division, as the kernels divide. On CUDA,
    PyTorch's ``t / c`` multiplies by c's float32 reciprocal instead, which
    rounds a third of the quotients by 6 one ulp apart and so moves the
    Cornish-Fisher round() about once in 3e8 draws."""
    return t / torch.full_like(t, c)


def fast_poisson(lam: torch.Tensor, u: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) as float32 from a uniform ``u`` and a normal ``z`` of
    lam's shape: the JAX package's branch-free three-regime sampler, with
    the readout kernels' arithmetic (``csrc/detector.cuh``), so the kernels
    and their plain versions agree to the bit. lam <= 0 gives exactly 0;
    0 < lam < 3 the exact 12-term inverse transform on ``u``; up to 100
    Cornish-Fisher round(lam + sqrt(lam) z + (z^2 - 1)/6); plain Gaussian
    above."""
    zero = torch.zeros_like(lam)
    skew = torch.where(lam < _T_GAUSS, _by(z * z - 1.0, 6.0), zero)
    gauss = torch.clamp_min(torch.round(lam + torch.sqrt(lam) * z + skew), 0.0)
    lam_c = torch.clamp_max(lam, T_EXACT)
    p = torch.exp(-lam_c)
    cum, k = zero, zero
    for inv in _INV:
        cum = cum + p
        k = k + (u > cum).to(lam.dtype)
        p = p * lam_c * inv
    pos = lam > 0.0
    return torch.where(pos & (lam < T_EXACT), k,
                       torch.where(pos, gauss, zero))


# --- the exact sampler (ExposureStatic.exact_poisson) ----------------------
# The same law as jax.random.poisson: Knuth's product of uniforms (as a sum
# of logs) below EXACT_T, Hoermann's PTRS transformed rejection above it.
# Every constant is a float32 value, written the same in csrc/detector.cuh.
EXACT_T = 10.0
KNUTH_BLOCKS = 12      # Philox blocks of the Knuth branch: 48 uniforms
PTRS_BLOCKS = 8        # Philox blocks of the PTRS branch: 16 attempts


def _f(x: float) -> float:
    """x rounded to float32 (a Python float, so torch applies it exactly)."""
    return float(np.float32(x))


LOG_FACTORIAL = tuple(_f(math.lgamma(k + 1.0)) for k in range(16))
_HALF_LOG_2PI = _f(0.5 * math.log(2.0 * math.pi))
_INV12, _INV360 = _f(1.0 / 12.0), _f(1.0 / 360.0)


def log_factorial(k: torch.Tensor) -> torch.Tensor:
    """log k! of float32 integers k >= 0: the table LOG_FACTORIAL below 16,
    else the Stirling series (k + 1/2) log k - k + log(2 pi)/2 + 1/(12 k)
    - 1/(360 k^3), in the kernel's order of operations."""
    table = torch.tensor(LOG_FACTORIAL, dtype=torch.float32, device=k.device)
    small = table[torch.where((k >= 0.0) & (k < 16.0), k, 0.0).long()]
    r = torch.reciprocal(k)
    big = (((k + 0.5) * torch.log(k) - k)
           + (_HALF_LOG_2PI + r * (_INV12 - (r * r) * _INV360)))
    return torch.where(k < 16.0, small, big)


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as one rounded division (Python's ``c / t`` multiplies by
    t's reciprocal)."""
    return torch.full_like(t, c) / t


def exact_poisson(lam: torch.Tensor, k0, k1, read, pix,
                  tag: int) -> torch.Tensor:
    """Poisson(lam) as float32 from the exact law, on the Philox counters
    (read, pix, tag, n) of key (k0, k1), n = 0, 1, ... the block: the plain
    version of csrc/detector.cuh's ``exact_poisson_sample``, with its
    arithmetic, so the two agree to the bit on the card. Arguments after
    ``lam`` broadcast against it as for :func:`philox4x32`.

    lam <= 0 gives exactly 0. 0 < lam < EXACT_T: Knuth's method, K = the
    number of uniforms u_1, u_2, ... whose log-sum stays above -lam (the
    words of blocks 0..KNUTH_BLOCKS-1 in order, so at most 47). lam >=
    EXACT_T: PTRS, attempt i on the pair (words 2 (i % 2), 2 (i % 2) + 1)
    of block i // 2, the first accepted; round(lam) if none of the
    2 PTRS_BLOCKS attempts is (probability ~1e-16).

    The kernel stops at the first accepted draw; here every attempt runs
    on every element (masked), which gives the same values."""
    dev = lam.device
    last = lambda v: v[..., None] if isinstance(v, torch.Tensor) else v

    def uniforms(n_blocks: int) -> torch.Tensor:
        words = philox4x32(last(k0), last(k1), last(read), last(pix), tag,
                           torch.arange(n_blocks, device=dev))
        return uniform24(torch.stack(words, dim=-1)).flatten(-2)

    shape = torch.broadcast_shapes(
        lam.shape, *(v.shape for v in (k0, k1, read, pix)
                     if isinstance(v, torch.Tensor)))
    lam = lam.expand(shape)
    # Knuth: k counts the checks s > -lam before each uniform's log
    logu = torch.log(uniforms(KNUTH_BLOCKS))
    neg = -lam
    s = torch.zeros(shape, dtype=torch.float32, device=dev)
    k = torch.zeros_like(s)
    for i in range(4 * KNUTH_BLOCKS):
        k = k + (s > neg).to(torch.float32)
        s = s + logu[..., i]
    knuth = k - 1.0

    # PTRS
    w = uniforms(PTRS_BLOCKS)
    u, v = w[..., 0::2] - 0.5, w[..., 1::2]
    lam1 = lam[..., None]
    b = _f(0.931) + _f(2.53) * torch.sqrt(lam1)
    a = _f(-0.059) + _f(0.02483) * b
    inv_alpha = _f(1.1239) + _over(_f(1.1328), b - _f(3.4))
    v_r = _f(0.9277) - _over(_f(3.6224), b - 2.0)
    us = 0.5 - torch.abs(u)
    kk = torch.floor((2.0 * a / us + b) * u + lam1 + _f(0.43))
    lhs = torch.log(v * inv_alpha / (a / (us * us) + b))
    rhs = (-lam1 + kk * torch.log(lam1)) - log_factorial(kk)
    reject = (kk < 0.0) | ((us < _f(0.013)) & (v > us))
    accept = ((us >= _f(0.07)) & (v <= v_r)) | (~reject & (lhs <= rhs))
    first = accept.to(torch.int32).argmax(dim=-1, keepdim=True)
    ptrs = torch.where(accept.any(dim=-1), kk.gather(-1, first)[..., 0],
                       torch.round(lam))
    out = torch.where(lam < EXACT_T, knuth, ptrs)
    return torch.where(lam > 0.0, out, torch.zeros_like(out))
