// Device code shared by the readout kernels for NVIDIA Hopper (sm_90a):
// the whole-exposure kernel (readout.cu) and the per-read kernels
// (read_step.cu). Everything here has internal linkage, so each source
// that includes it keeps its own copy.
//
// The plain PyTorch versions of the same arithmetic are in
// wayne_tpu_torch/ops/random.py (Philox, uniform24, box_muller,
// fast_poisson) and wayne_tpu_torch/ops/readout.py (the readout chain).
// Built with --fmad=false and no fast math, so every multiply and add
// rounds as PyTorch's one-op kernels round it and the two agree to the
// bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads per block along x (one warp)
constexpr int BY = 8;   // threads per block along y

// Flag bits, mirrored in wayne_tpu_torch/ops/readout.py.
enum : int {
  F_POISSON = 1, F_READ_NOISE = 2, F_NONLIN = 4, F_BIAS = 8,
  F_SCALAR_GAIN = 16, F_CR = 32, F_BG_POISSON = 64, F_IPC = 128,
};

// Philox stream tags (third counter word), mirrored in
// wayne_tpu_torch/ops/random.py.
enum : uint32_t {
  TAG_BOX_MULLER = 0, TAG_BAND_NORMAL = 1, TAG_BG_UNIFORM = 2,
  TAG_BAND_UNIFORM = 3,
};

__device__ __forceinline__ void philox4x32_10(uint32_t k0, uint32_t k1,
                                              uint32_t c[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return fmaxf(u, 1e-7f);
}

// Two N(0, 1) from one Philox block's first two words.
__device__ __forceinline__ void box_muller(uint32_t b0, uint32_t b1,
                                           float* z0, float* z1) {
  const float r = sqrtf(-2.0f * logf(uniform24(b0)));
  const float theta = 6.2831853071795862f * uniform24(b1);
  // one range reduction for both; the same bits as cosf and sinf
  float sn, cs;
  sincosf(theta, &sn, &cs);
  *z0 = r * cs;
  *z1 = r * sn;
}

// The (background z, read-noise z) pair of a pixel and read.
__device__ __forceinline__ void normal_pair(uint32_t k0, uint32_t k1,
                                            uint32_t read, uint32_t pix,
                                            float* z_bg, float* z_rn) {
  uint32_t c[4] = {read, pix, TAG_BOX_MULLER, 0u};
  philox4x32_10(k0, k1, c);
  box_muller(c[0], c[1], z_bg, z_rn);
}

__device__ __constant__ float kInv[12] = {
    1.0f / 1.0f, 1.0f / 2.0f, 1.0f / 3.0f, 1.0f / 4.0f, 1.0f / 5.0f,
    1.0f / 6.0f, 1.0f / 7.0f, 1.0f / 8.0f, 1.0f / 9.0f, 1.0f / 10.0f,
    1.0f / 11.0f, 1.0f / 12.0f};

// Three-regime Poisson: lam <= 0 -> 0 exactly; lam < 3 exact 12-term
// inverse transform on its own uniform; lam < 100 Cornish-Fisher; Gaussian.
__device__ __forceinline__ float poisson_sample(float lam, float z,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t read, uint32_t pix,
                                                uint32_t tag) {
  if (!(lam > 0.0f)) return 0.0f;
  if (lam < 3.0f) {
    uint32_t c[4] = {read, pix, tag, 0u};
    philox4x32_10(k0, k1, c);
    const float u = uniform24(c[0]);
    float p = expf(-lam), cum = 0.0f, k = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      cum = cum + p;
      k = k + (u > cum ? 1.0f : 0.0f);
      p = (p * lam) * kInv[j];
    }
    return k;
  }
  const float skew = lam < 100.0f ? (z * z - 1.0f) / 6.0f : 0.0f;
  return fmaxf(rintf(lam + sqrtf(lam) * z + skew), 0.0f);
}

// A read interval's background on top of the charge: Poisson(lam) when
// sampled, else the expectation (zero when dark and sky are off).
__device__ __forceinline__ float add_background(float cum, float lam,
                                                bool sampled, float z_bg,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t read, uint32_t pix) {
  return cum + (sampled ? poisson_sample(lam, z_bg, k0, k1, read, pix,
                                         TAG_BG_UNIFORM)
                        : lam);
}

// Saturation and the per-pixel cubic non-linearity of the sensed charge.
__device__ __forceinline__ float nonlin(float sig, float fw, float inv_fw,
                                        float c1, float c2, float c3) {
  const float s = fminf(sig, fw);
  const float q = s * inv_fw;
  return s * (1.0f - ((c3 * q + c2) * q + c1) * q);
}

}  // namespace
