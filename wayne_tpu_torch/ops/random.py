"""Counter-based random numbers and the plain three-regime Poisson sampler.

The port replaces ``jax.random`` keys by explicit seed words: every draw is
Philox4x32-10 of (key = two 32-bit seed words, counter = four 32-bit
words), so a draw depends only on (exposure seed, read, pixel or entry,
stream tag) — never on the device, the batch size or the kernel's tiling.
The readout kernel (``csrc/readout.cu``) carries the same Philox; this
module's torch version is bit-identical to it (uint32 words carried in
int64 tensors, so products never overflow).

The two packages draw different random bits from the same seed: tests
compare distributions, never bits.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85

# Stream tags (third counter word). The readout kernel's tags 0..3 are
# mirrored in csrc/readout.cu; the rest are drawn on the torch side only.
TAG_BOX_MULLER = 0     # background z and read-noise z, one pair per read
TAG_BAND_NORMAL = 1    # the signal band's Box-Muller normal
TAG_BG_UNIFORM = 2     # small-lambda uniform of the background sampler
TAG_BAND_UNIFORM = 3   # small-lambda uniform of the band sampler
TAG_CR_COUNT = 16      # cosmic-ray hit count of a read interval
TAG_CR_HIT = 17        # cosmic-ray positions and charges
TAG_BIAS_DRIFT = 18    # per-read per-amplifier bias drift
TAG_SSV_WALK = 19      # random-walk scan-speed variation steps
TAG_SEED = 20          # exposure seed words from (visit seed, index)

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
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def key_words(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 2) int32 seed words -> two int64 tensors of uint32 key words."""
    s = seed.to(torch.int64) & _MASK32
    return s[..., 0], s[..., 1]


def fast_poisson(lam: torch.Tensor, u: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) as float32 from a uniform ``u`` and a normal ``z`` of
    lam's shape: the JAX package's branch-free three-regime sampler, with
    the readout kernel's arithmetic (``csrc/readout.cu``), so the kernel
    and its plain version agree to the bit. lam <= 0 gives exactly 0;
    0 < lam < 3 the exact 12-term inverse transform on ``u``; up to 100
    Cornish-Fisher round(lam + sqrt(lam) z + (z^2 - 1)/6); plain Gaussian
    above."""
    zero = torch.zeros_like(lam)
    skew = torch.where(lam < _T_GAUSS, (z * z - 1.0) / 6.0, zero)
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
