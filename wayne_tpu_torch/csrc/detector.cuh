// Device code shared by the readout kernels for NVIDIA Hopper (sm_90a):
// the whole-exposure kernel (readout.cu) and the per-read kernels
// (read_step.cu): the Philox generator, the samplers, a pixel's read update
// (background, band), the hit staging and the non-linearity. Everything
// here has internal linkage, so each source that includes it keeps its own
// copy.
//
// The plain PyTorch versions of the same arithmetic are in
// wayne_tpu_torch/ops/random.py (Philox, uniform24, box_muller,
// fast_poisson, exact_poisson) and wayne_tpu_torch/ops/readout.py (the readout chain).
// Built with --fmad=false and no fast math, so every multiply and add
// rounds as PyTorch's one-op kernels round it and the two agree to the
// bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads per block along x (one warp)
constexpr int BY = 8;   // threads per block along y (its warps)

// Flag bits, mirrored in wayne_tpu_torch/ops/readout.py. F_EXACT_POISSON
// selects each kernel's second instantiation (template <bool EXACT>), whose
// samplers draw from the exact Poisson law; the default one is unchanged.
enum : int {
  F_POISSON = 1, F_READ_NOISE = 2, F_NONLIN = 4, F_BIAS = 8,
  F_SCALAR_GAIN = 16, F_CR = 32, F_BG_POISSON = 64, F_IPC = 128,
  F_EXACT_POISSON = 256,
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

// The exact branch of the sampler (0 < lam < 3): a 12-term inverse
// transform on the pixel's own uniform (counter tag `tag`).
__device__ __forceinline__ float small_lambda_sample(float lam, uint32_t k0,
                                                     uint32_t k1,
                                                     uint32_t read,
                                                     uint32_t pix,
                                                     uint32_t tag) {
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

// The sampler for lam >= 3 on the normal z: Cornish-Fisher below 100,
// else Gaussian.
__device__ __forceinline__ float gaussian_sample(float lam, float z) {
  const float skew = lam < 100.0f ? (z * z - 1.0f) / 6.0f : 0.0f;
  return fmaxf(rintf(lam + sqrtf(lam) * z + skew), 0.0f);
}

__device__ __forceinline__ bool is_small_lambda(float lam) {
  return lam > 0.0f && lam < 3.0f;
}

// The exact sampler (F_EXACT_POISSON), the law of jax.random.poisson. Its
// plain version is exact_poisson in wayne_tpu_torch/ops/random.py, with the
// same constants (float32 values) and the same order of operations.
constexpr float EXACT_T = 10.0f;  // below: Knuth; from here: PTRS
constexpr uint32_t KNUTH_BLOCKS = 12;  // 48 uniforms
constexpr uint32_t PTRS_BLOCKS = 8;    // 16 attempts

__device__ __constant__ float kLogFactorial[16] = {
    0.0f,         0.0f,         0.693147182f, 1.79175949f,
    3.17805386f,  4.7874918f,   6.57925129f,  8.52516174f,
    10.6046028f,  12.8018274f,  15.104413f,   17.5023079f,
    19.987215f,   22.5521641f,  25.1912212f,  27.899271f};

// log k! of an integer-valued k >= 0: the table below 16, else the
// Stirling series (k + 1/2) log k - k + log(2 pi)/2 + 1/(12 k) - 1/(360 k^3).
__device__ __forceinline__ float log_factorial(float k) {
  if (k < 16.0f) return kLogFactorial[static_cast<int>(k)];
  const float r = 1.0f / k;
  return ((k + 0.5f) * logf(k) - k) +
         (0.918938518f + r * (0.0833333358f - (r * r) * 0.00277777785f));
}

// Exact Poisson(lam) on the uniforms of Philox counters (read, pix, tag, n),
// n the block (two (u, v) pairs or four uniforms each), so a draw depends
// only on (seed, read, pixel, tag). lam <= 0 -> 0 exactly. 0 < lam < 10:
// Knuth's method, K = the number of uniforms whose log-sum stays above
// -lam, at most 47. lam >= 10: Hoermann's PTRS transformed rejection, the
// first of 16 attempts accepted, round(lam) if none is (~1e-16). Out of
// line: the loops would cost the callers' registers.
__device__ __noinline__ float exact_poisson_sample(float lam, uint32_t k0,
                                                   uint32_t k1,
                                                   uint32_t read,
                                                   uint32_t pix,
                                                   uint32_t tag) {
  if (!(lam > 0.0f)) return 0.0f;
  if (lam < EXACT_T) {
    const float neg = -lam;
    float s = 0.0f, k = 0.0f;
    for (uint32_t n = 0; n < KNUTH_BLOCKS; ++n) {
      uint32_t c[4] = {read, pix, tag, n};
      philox4x32_10(k0, k1, c);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (!(s > neg)) return k - 1.0f;
        k = k + 1.0f;
        s = s + logf(uniform24(c[w]));
      }
    }
    return k - 1.0f;
  }
  const float b = 0.931f + 2.53f * sqrtf(lam);
  const float a = -0.059f + 0.02483f * b;
  const float inv_alpha = 1.1239f + 1.1328f / (b - 3.4f);
  const float v_r = 0.9277f - 3.6224f / (b - 2.0f);
  const float log_lam = logf(lam);
  for (uint32_t n = 0; n < PTRS_BLOCKS; ++n) {
    uint32_t c[4] = {read, pix, tag, n};
    philox4x32_10(k0, k1, c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float u = uniform24(c[2 * h]) - 0.5f;
      const float v = uniform24(c[2 * h + 1]);
      const float us = 0.5f - fabsf(u);
      const float k = floorf((2.0f * a / us + b) * u + lam + 0.43f);
      if (us >= 0.07f && v <= v_r) return k;
      if (k < 0.0f || (us < 0.013f && v > us)) continue;
      const float lhs = logf(v * inv_alpha / (a / (us * us) + b));
      const float rhs = (-lam + k * log_lam) - log_factorial(k);
      if (lhs <= rhs) return k;
    }
  }
  return rintf(lam);
}

// Poisson(lam). Default (EXACT false), three regimes: lam <= 0 -> 0
// exactly; lam < 3 exact 12-term inverse transform on its own uniform; lam <
// 100 Cornish-Fisher on the normal z; Gaussian. EXACT: the exact sampler
// (z unused).
template <bool EXACT>
__device__ __forceinline__ float poisson_sample(float lam, float z,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t read, uint32_t pix,
                                                uint32_t tag) {
  if constexpr (EXACT) {
    return exact_poisson_sample(lam, k0, k1, read, pix, tag);
  } else {
    if (!(lam > 0.0f)) return 0.0f;
    if (lam < 3.0f) return small_lambda_sample(lam, k0, k1, read, pix, tag);
    return gaussian_sample(lam, z);
  }
}

// poisson_sample<EXACT> of a thread's N pixels (lam[j], z[j] at pixel
// pix[j]), called by all 32 lanes of a warp whose lanes share the key
// (k0, k1). The branch that draws more Philox blocks (default: the exact
// small-lambda branch; EXACT: every pixel with lam > 0) runs once over the
// warp's pixels that take it, compacted through `queue` (32 * N slots of
// this warp's shared memory), instead of once per pixel slot wherever any
// lane of the warp takes it; every value is the one poisson_sample returns.
template <int N, bool EXACT>
__device__ __forceinline__ void poisson_sample_warp(
    const float* lam, const float* z, const uint32_t* pix, uint32_t k0,
    uint32_t k1, uint32_t read, uint32_t tag, int lane, float2* queue,
    float* out) {
  int slot[N];
  int n = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool queued = EXACT ? lam[j] > 0.0f : is_small_lambda(lam[j]);
    const unsigned mask = __ballot_sync(0xffffffffu, queued);
    slot[j] = queued ? n + __popc(mask & ((1u << lane) - 1u)) : -1;
    if (queued)
      queue[slot[j]] = make_float2(lam[j], __uint_as_float(pix[j]));
    n += __popc(mask);
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const float2 q = queue[i];
    const uint32_t p = __float_as_uint(q.y);
    if constexpr (EXACT)
      queue[i].x = exact_poisson_sample(q.x, k0, k1, read, p, tag);
    else
      queue[i].x = small_lambda_sample(q.x, k0, k1, read, p, tag);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (EXACT)
      out[j] = slot[j] >= 0 ? queue[slot[j]].x : 0.0f;
    else
      out[j] = slot[j] >= 0 ? queue[slot[j]].x
               : lam[j] > 0.0f ? gaussian_sample(lam[j], z[j]) : 0.0f;
  }
}

// A read interval's background on top of the charge: Poisson(lam) when
// sampled, else the expectation (zero when dark and sky are off).
template <bool EXACT>
__device__ __forceinline__ float add_background(float cum, float lam,
                                                bool sampled, float z_bg,
                                                uint32_t k0, uint32_t k1,
                                                uint32_t read, uint32_t pix) {
  return cum + (sampled ? poisson_sample<EXACT>(lam, z_bg, k0, k1, read, pix,
                                                TAG_BG_UNIFORM)
                        : lam);
}

// The band's interval on top of the charge: Poisson(e) on the band's own
// counters (tags TAG_BAND_NORMAL and TAG_BAND_UNIFORM; EXACT: the latter
// only) when sampled, else e.
template <bool EXACT>
__device__ __forceinline__ float add_band(float cum, float e, bool sampled,
                                          uint32_t k0, uint32_t k1,
                                          uint32_t read, uint32_t pix) {
  if (sampled) {
    if constexpr (EXACT) {
      e = exact_poisson_sample(e, k0, k1, read, pix, TAG_BAND_UNIFORM);
    } else {
      uint32_t c[4] = {read, pix, TAG_BAND_NORMAL, 0u};
      philox4x32_10(k0, k1, c);
      float z, unused;
      box_muller(c[0], c[1], &z, &unused);
      e = poisson_sample<false>(e, z, k0, k1, read, pix, TAG_BAND_UNIFORM);
    }
  }
  return cum + e;
}

// A cosmic-ray hit staged in shared memory.
struct Hit {
  int y, x;
  float q;
};

// Called by all 32 lanes of a warp: compacts entries [i0, i1) of one read's
// hit list (rows py, columns px, charges pq) to the hits with a non-zero
// charge inside rows [oy, oy + th) and columns [ox, ox + BX), in list order
// (a ballot prefix), into dst. Returns how many, in every lane.
__device__ __forceinline__ int compact_hits(const int* py, const int* px,
                                            const float* pq, int i0, int i1,
                                            int ox, int oy, int th, int lane,
                                            Hit* dst) {
  int n = 0;
  for (int base = i0; base < i1; base += 32) {
    const int i = base + lane;
    Hit h{0, 0, 0.0f};
    bool in = false;
    if (i < i1) {
      h = Hit{py[i], px[i], pq[i]};
      in = h.q != 0.0f && h.y >= oy && h.y < oy + th && h.x >= ox &&
           h.x < ox + BX;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (in) dst[n + __popc(mask & ((1u << lane) - 1u))] = h;
    n += __popc(mask);
  }
  return n;
}

// Adds the n staged hits, in order, to those of a thread's PY pixels (rows
// y[j] of column x) that they land on: two hits on one pixel add in list
// order.
template <int PY>
__device__ __forceinline__ void add_staged_hits(const Hit* hits, int n,
                                                const int* y, int x,
                                                const bool* valid,
                                                float* cum) {
  for (int i = 0; i < n; ++i) {
    const Hit hit = hits[i];
#pragma unroll
    for (int j = 0; j < PY; ++j)
      if (valid[j] && hit.y == y[j] && hit.x == x) cum[j] = cum[j] + hit.q;
  }
}

// Saturation and the per-pixel cubic non-linearity of the sensed charge.
__device__ __forceinline__ float nonlin(float sig, float fw, float inv_fw,
                                        float c1, float c2, float c3) {
  const float s = fminf(sig, fw);
  const float q = s * inv_fw;
  return s * (1.0f - ((c3 * q + c2) * q + c1) * q);
}

}  // namespace
