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

constexpr int BX = 32;  // threads per tiled block along x (one warp)
constexpr int BY = 8;   // threads per tiled block along y

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
  *z0 = r * cosf(theta);
  *z1 = r * sinf(theta);
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

// Where a thread of a tiled block sits: tiles of (BX - 2h) x (BY - 2h)
// pixels with an h-pixel halo (h = 1 for IPC, else 0); blockIdx.z is the
// exposure.
struct TiledPixel {
  int ox, oy;        // pixel of thread (0, 0)
  int x, y;
  bool valid;        // inside the frame
  bool interior;     // inside the frame and not halo: owns its outputs
  size_t pidx;       // y * S + x (0 when not valid)
};

__device__ __forceinline__ TiledPixel tiled_pixel(int S, int h) {
  TiledPixel p;
  const int tx = threadIdx.x, ty = threadIdx.y;
  p.ox = blockIdx.x * (BX - 2 * h) - h;
  p.oy = blockIdx.y * (BY - 2 * h) - h;
  p.x = p.ox + tx;
  p.y = p.oy + ty;
  p.valid = p.x >= 0 && p.x < S && p.y >= 0 && p.y < S;
  p.interior = p.valid && tx >= h && tx < BX - h && ty >= h && ty < BY - h;
  p.pidx = p.valid ? static_cast<size_t>(p.y) * S + p.x : 0;
  return p;
}

// Grid of a tiled kernel over a chunk of B exposures.
inline dim3 tiled_grid(int S, int B, int flags) {
  const int h = (flags & F_IPC) ? 1 : 0;
  const int tw = BX - 2 * h, th = BY - 2 * h;
  return dim3((S + tw - 1) / tw, (S + th - 1) / th, B);
}

// Dynamic shared memory of a tiled kernel: the compacted hit list and the
// IPC tile.
inline size_t tiled_smem(int n_cr) {
  return static_cast<size_t>(n_cr) * 12 + BX * BY * 4;
}

// Shared-memory views of a tiled block.
struct TileShared {
  int* hit_y;
  int* hit_x;
  float* hit_q;
  float* tile;       // BX * BY sensed signals (IPC)
};

__device__ __forceinline__ TileShared tile_shared(unsigned char* raw,
                                                  int n_cr) {
  TileShared s;
  s.hit_y = reinterpret_cast<int*>(raw);
  s.hit_x = s.hit_y + n_cr;
  s.hit_q = reinterpret_cast<float*>(s.hit_x + n_cr);
  s.tile = s.hit_q + n_cr;
  return s;
}

// Cosmic-ray hits of one read's list (py, px, pq: n_cr entries, charge 0
// beyond the hit count). Called by every thread of the block: warp 0
// compacts, in list order, the hits inside this block's tile into shared
// memory, then each thread adds the charges whose (y, x) is its pixel, so
// a hit lands exactly once whatever the tiling and two hits on one pixel
// add in list order.
__device__ __forceinline__ float add_cr_hits(float cum, const TiledPixel& p,
                                             const int* py, const int* px,
                                             const float* pq, int n_cr,
                                             const TileShared& s,
                                             int* n_hits) {
  const int tx = threadIdx.x;
  __syncthreads();  // the previous read's hit list is consumed
  if (threadIdx.y == 0) {
    int count = 0;
    for (int base = 0; base < n_cr; base += 32) {
      const int i = base + tx;
      int hy = 0, hx = 0;
      float q = 0.0f;
      bool hit = false;
      if (i < n_cr) {
        hy = py[i]; hx = px[i]; q = pq[i];
        hit = q != 0.0f && hy >= p.oy && hy < p.oy + BY && hx >= p.ox &&
              hx < p.ox + BX;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int slot = count + __popc(mask & ((1u << tx) - 1u));
        s.hit_y[slot] = hy; s.hit_x[slot] = hx; s.hit_q[slot] = q;
      }
      count += __popc(mask);
    }
    if (tx == 0) *n_hits = count;
  }
  __syncthreads();
  if (p.valid) {
    for (int i = 0; i < *n_hits; ++i)
      if (s.hit_y[i] == p.y && s.hit_x[i] == p.x) cum = cum + s.hit_q[i];
  }
  return cum;
}

// Inter-pixel capacitance, kernel [[0,a,0],[a,1-4a,a],[0,a,0]] with a zero
// boundary. Called by every thread of a block with a one-pixel halo: the
// sensed signals meet in shared memory and interior threads couple their
// four neighbours.
__device__ __forceinline__ float ipc_couple(float sig, const TiledPixel& p,
                                            float alpha, float* tile) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  tile[ty * BX + tx] = p.valid ? sig : 0.0f;  // zero outside the frame
  __syncthreads();
  if (p.interior) {
    const float up = tile[(ty - 1) * BX + tx];
    const float down = tile[(ty + 1) * BX + tx];
    const float left = tile[ty * BX + tx - 1];
    const float right = tile[ty * BX + tx + 1];
    const float one_m4a = 1.0f - 4.0f * alpha;
    sig = sig * one_m4a + alpha * (((up + down) + left) + right);
  }
  __syncthreads();  // the tile is rewritten next read
  return sig;
}

}  // namespace
