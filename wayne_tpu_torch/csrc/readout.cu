// Whole-exposure up-the-ramp readout for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `fused_exposure_readout`
// (wayne_tpu/ops/pallas_readout.py, kernel body `_kernel_exposure`). The
// plain PyTorch version of the same function, with the same Philox draws,
// is `exposure_readout_plain` in wayne_tpu_torch/ops/readout.py.
//
// What it computes, for each exposure b of a chunk and each emitted read k:
//   cum += Poisson(bg_rate * dt_k)          three-regime sampler
//   cum += Poisson(band_k[y - y0_k])        rows y0_k <= y < y0_k + W
//   cum += q_i for this read's cosmic-ray hits at (y, x)
//   sig  = nonlin(min(cum, fw)) -> IPC -> + bias -> + rn * z
//   out[b, k] = sig * inv_gain              (reciprocal gain plane)
//
// Design. The TPU kept the charge frame in VMEM scratch across a
// sequential grid over reads. Here each thread owns one pixel of one
// exposure: `cum` lives in a register and the thread loops over all reads,
// so the charge frame never touches device memory between reads, and the
// six per-pixel planes (bg_rate, bias, inv_gain, c1, c2, c3) are read once
// per exposure instead of once per read. The grid is
// (column tiles, row tiles, exposures): one launch serves a whole chunk.
//   * Cosmic rays: each read, warp 0 compacts the read's hit list, in list
//     order, to the hits inside this block's tile (shared memory); each
//     thread then adds the charges whose (y, x) is its own pixel. A hit
//     lands exactly once whatever the tiling.
//   * IPC: the block's tile carries a one-pixel halo. Halo threads
//     recompute their pixel's charge exactly (every random draw is keyed by
//     pixel, not by thread), the sensed signal goes through shared memory
//     once per read, and interior threads couple their 4 neighbours. So IPC
//     works at every frame size (the TPU forbade it when tiled).
//   * RNG: Philox4x32-10, key = the exposure's two seed words, counter =
//     (k, y * S + x, stream tag, 0). Tags: 0 Box-Muller pair
//     (background z, read-noise z), 1 the band's normal, 2 and 3 the
//     small-lambda uniforms of the background and the band. A pixel takes
//     the exact small-lambda branch on its own (the TPU gated a whole tile).
//
// What bounds it on this card. Per 512^2 exposure at 16 reads the least
// traffic is the reads written (16 * 512^2 * 4 B = 16.8 MB), the charge
// written (1 MB), the background plane read (1 MB), the bands (16 * W *
// 512 * 4 B, 1 MB at W = 32) and the CR lists; the five shared planes
// (bias, inv_gain, c1..c3, 5.2 MB) are read once per launch of B
// exposures. At 3.35 TB/s that is ~6.2 us per exposure at B = 8. The
// arithmetic per pixel per read is one Philox block (10 rounds of two
// 32x32->64 products, xors and key additions, ~98 integer operations), a
// log, a sqrt, a sin and a cos (Box-Muller), the Cornish-Fisher sampler
// (~10) and the readout chain (~16): ~135 operations, plus a second
// Philox block and sampler on the band rows and a third where 0 < lambda
// < 3. 262144 pixels x 16 reads x ~135 = 5.7e8 operations per exposure:
// ~8.5 us even at the 67 T/s fp32 lane rate (32-bit integer multiplies
// issue at a lower rate). Operations bind, not bytes. chip_smoke.py
// computes both bounds from each run's inputs.
//
// Built by wayne_tpu_torch/ops/readout.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// No fast math: --fmad=false keeps each multiply and add separately rounded
// like PyTorch's one-op kernels, so the plain version agrees to the bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads per block along x (one warp)
constexpr int BY = 8;   // threads per block along y

enum : int {
  F_POISSON = 1, F_READ_NOISE = 2, F_NONLIN = 4, F_BIAS = 8,
  F_SCALAR_GAIN = 16, F_CR = 32, F_BG_POISSON = 64, F_IPC = 128,
};

enum : uint32_t {
  TAG_BOX_MULLER = 0, TAG_BAND_NORMAL = 1, TAG_BG_UNIFORM = 2,
  TAG_BAND_UNIFORM = 3,
};

struct Args {
  const int* seed;       // (B, 2)
  const int* y0s;        // (B, NR)
  const float* dts;      // (B, NR)
  const float* bands;    // (B, NR, W, S)
  const float* bg_rate;  // (B, S, S)
  const float* bias;     // (S, S)
  const float* inv_gain; // (S, S)
  const float* nl;       // (3, S, S)
  const int* cr_pos;     // (B, NR, 2, n_cr)
  const float* cr_q;     // (B, NR, n_cr)
  float* reads;          // (B, NR, S, S)
  float* cum_out;        // (B, S, S)
  int B, NR, W, S, n_cr;
  float rn, fw, inv_fw, inv_gain_scalar, ipc_alpha;
  int flags;
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

__global__ void __launch_bounds__(BX * BY)
exposure_readout_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  int* hit_y = reinterpret_cast<int*>(smem_raw);
  int* hit_x = hit_y + a.n_cr;
  float* hit_q = reinterpret_cast<float*>(hit_x + a.n_cr);
  float* tile = hit_q + a.n_cr;  // BX * BY sensed signals (IPC)
  __shared__ int n_hits;

  const bool ipc = a.flags & F_IPC;
  const bool poisson = a.flags & F_POISSON;
  const bool bg_poisson = poisson && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const bool with_cr = a.flags & F_CR;
  const int h = ipc ? 1 : 0;
  const int S = a.S, W = a.W, NR = a.NR;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * (BX - 2 * h) - h;  // pixel of thread (0, 0)
  const int oy = blockIdx.y * (BY - 2 * h) - h;
  const int x = ox + tx, y = oy + ty;
  const bool valid = x >= 0 && x < S && y >= 0 && y < S;
  const bool interior = valid && tx >= h && tx < BX - h && ty >= h &&
                        ty < BY - h;
  const size_t plane = static_cast<size_t>(S) * S;
  const size_t pidx = valid ? static_cast<size_t>(y) * S + x : 0;
  const uint32_t pix = static_cast<uint32_t>(pidx);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);

  float cum = 0.0f, bg = 0.0f, bias = 0.0f, gmul = a.inv_gain_scalar;
  float c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  if (valid) {
    bg = a.bg_rate[b * plane + pidx];
    bias = a.bias[pidx];
    if (!(a.flags & F_SCALAR_GAIN)) gmul = a.inv_gain[pidx];
    c1 = a.nl[pidx];
    c2 = a.nl[plane + pidx];
    c3 = a.nl[2 * plane + pidx];
  }

  for (int k = 0; k < NR; ++k) {
    const uint32_t rd = static_cast<uint32_t>(k);
    const int bk = b * NR + k;
    float z_bg = 0.0f, z_rn = 0.0f;
    if (valid && (bg_poisson || read_noise)) {
      uint32_t c[4] = {rd, pix, TAG_BOX_MULLER, 0u};
      philox4x32_10(k0, k1, c);
      box_muller(c[0], c[1], &z_bg, &z_rn);
    }
    if (valid) {
      const float lam = bg * a.dts[bk];
      cum = cum + (bg_poisson ? poisson_sample(lam, z_bg, k0, k1, rd, pix,
                                               TAG_BG_UNIFORM)
                              : lam);
      const int y0 = a.y0s[bk];
      if (y >= y0 && y < y0 + W) {
        float e = a.bands[(static_cast<size_t>(bk) * W + (y - y0)) * S + x];
        if (poisson) {
          uint32_t c[4] = {rd, pix, TAG_BAND_NORMAL, 0u};
          philox4x32_10(k0, k1, c);
          float zb, unused;
          box_muller(c[0], c[1], &zb, &unused);
          e = poisson_sample(e, zb, k0, k1, rd, pix, TAG_BAND_UNIFORM);
        }
        cum = cum + e;
      }
    }
    if (with_cr) {
      __syncthreads();  // the previous read's hit list is consumed
      if (ty == 0) {    // warp 0: order-preserving compaction
        const int* py = a.cr_pos + static_cast<size_t>(bk) * 2 * a.n_cr;
        const int* px = py + a.n_cr;
        const float* pq = a.cr_q + static_cast<size_t>(bk) * a.n_cr;
        int count = 0;
        for (int base = 0; base < a.n_cr; base += 32) {
          const int i = base + tx;
          int hy = 0, hx = 0;
          float q = 0.0f;
          bool hit = false;
          if (i < a.n_cr) {
            hy = py[i]; hx = px[i]; q = pq[i];
            hit = q != 0.0f && hy >= oy && hy < oy + BY && hx >= ox &&
                  hx < ox + BX;
          }
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (hit) {
            const int slot = count + __popc(mask & ((1u << tx) - 1u));
            hit_y[slot] = hy; hit_x[slot] = hx; hit_q[slot] = q;
          }
          count += __popc(mask);
        }
        if (tx == 0) n_hits = count;
      }
      __syncthreads();
      if (valid) {
        for (int i = 0; i < n_hits; ++i)
          if (hit_y[i] == y && hit_x[i] == x) cum = cum + hit_q[i];
      }
    }

    float sig = cum;
    if (a.flags & F_NONLIN) {
      const float s = fminf(sig, a.fw);
      const float q = s * a.inv_fw;
      sig = s * (1.0f - ((c3 * q + c2) * q + c1) * q);
    }
    if (ipc) {
      tile[ty * BX + tx] = valid ? sig : 0.0f;  // zero outside the frame
      __syncthreads();
      if (interior) {
        const float up = tile[(ty - 1) * BX + tx];
        const float down = tile[(ty + 1) * BX + tx];
        const float left = tile[ty * BX + tx - 1];
        const float right = tile[ty * BX + tx + 1];
        const float one_m4a = 1.0f - 4.0f * a.ipc_alpha;
        sig = sig * one_m4a + a.ipc_alpha * (((up + down) + left) + right);
      }
      __syncthreads();  // the tile is rewritten next read
    }
    if (a.flags & F_BIAS) sig = sig + bias;
    if (read_noise) sig = sig + a.rn * z_rn;
    if (interior) a.reads[static_cast<size_t>(bk) * plane + pidx] = sig * gmul;
  }
  if (interior) a.cum_out[b * plane + pidx] = cum;
}

}  // namespace

extern "C" int wayne_exposure_readout(
    const int* seed, const int* y0s, const float* dts, const float* bands,
    const float* bg_rate, const float* bias,
    const float* inv_gain, const float* nl, const int* cr_pos,
    const float* cr_q, float* reads, float* cum_out, int B, int NR, int W,
    int S, int n_cr, float rn, float fw, float inv_fw,
    float inv_gain_scalar, float ipc_alpha, int flags, void* stream) {
  Args a{seed, y0s, dts, bands, bg_rate, bias, inv_gain, nl,
         cr_pos, cr_q, reads, cum_out, B, NR, W, S, n_cr,
         rn, fw, inv_fw, inv_gain_scalar, ipc_alpha, flags};
  const int h = (flags & F_IPC) ? 1 : 0;
  const int tw = BX - 2 * h, th = BY - 2 * h;
  const dim3 grid((S + tw - 1) / tw, (S + th - 1) / th, B);
  const dim3 block(BX, BY);
  const size_t smem = static_cast<size_t>(n_cr) * 12 + BX * BY * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exposure_readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  exposure_readout_kernel<<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
