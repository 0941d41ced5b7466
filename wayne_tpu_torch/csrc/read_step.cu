// Per-read readout kernels for NVIDIA Hopper (sm_90a): one read of every
// exposure of a chunk per launch, the charge frame read from and written
// back to device memory.
//
// read_step_banded_kernel replaces the JAX package's Pallas TPU kernel
// `fused_read_step_banded` (wayne_tpu/ops/pallas_readout.py, kernel body
// `_kernel_banded`); read_step_kernel replaces `fused_read_step` (body
// `_kernel`). Their plain PyTorch versions, with the same Philox draws, are
// `read_step_banded_plain` and `read_step_plain` in
// wayne_tpu_torch/ops/readout.py.
//
// What they compute, for each exposure b of a chunk and one emitted read k:
//   banded (B2):
//     cum  = cum_in + Poisson(bg_rate * dt)
//     cum[y0 : y0 + W] += band                  (band already sampled)
//     cum += q_i for the read's cosmic-ray hits, in list order
//     dn   = (nonlin(min(cum, fw)) -> IPC -> + bias -> + rn * z) * inv_gain
//   full frame (B3):
//     cum  = (cum_in + add) + Poisson(bg_rate * dt)   (add: band + hits)
//     dn   = (nonlin(min(cum, fw)) -> + bias -> + rn * z) * inv_gain
//
// Draws are the whole-exposure kernel's (readout.cu): Philox4x32-10 keyed
// by the exposure's two seed words, counter (k, y * S + x, tag, 0), tag 0
// for the (background z, read-noise z) pair and tag 2 for the background's
// small-lambda uniform, with k the emitted read index. So the per-read
// path draws exactly the numbers the whole-exposure path draws.
//
// Design. B2 is one read of the whole-exposure kernel's chain: one thread
// per pixel, grid (column tiles, row tiles, exposures), the read's hit list
// compacted by warp 0 in list order, IPC through a one-pixel halo whose
// threads recompute their pixel's charge exactly (the tiling helpers
// below). Unlike the whole-exposure kernel the charge enters from and
// leaves to device
// memory, so cum_out must not alias cum_in (a halo thread reads a pixel
// that another block writes). The band may start at any row y0: nothing
// assumes the TPU's 8-row alignment. B3 is a pure per-pixel pass: a flat
// grid over (B, S, S), no shared memory.
//
// What bounds them on this card. Per launch at B = 8 and S = 512 the least
// traffic of B2 is cum in and out, dn and the background plane (4 x 8.4 MB),
// the five shared planes (bias, inv_gain, c1..c3, 5.2 MB) and the band;
// B3 reads the add frame (8.4 MB) instead of the band. ~38-46 MB at
// 3.35 TB/s is ~11-14 us. The operations per pixel are one Philox block
// (32-bit integer work, issued at half the fp32 rate), Box-Muller, the
// sampler and the readout chain. chip_smoke.py computes both bounds from
// each run's inputs, counting each operation at the rate of its pipe.
//
// Built by wayne_tpu_torch/ops/readout.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c    (then linked with readout.cu into one .so)

#include "detector.cuh"

namespace {

constexpr int FLAT_THREADS = 256;  // threads per block of the flat kernel

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

struct StepArgs {
  const int* seed;       // (B, 2)
  const int* y0;         // (B,)            B2
  const float* dt;       // (B,)
  const float* cum_in;   // (B, S, S)
  const float* band;     // (B, W, S)       B2, already sampled
  const float* add;      // (B, S, S)       B3, already sampled
  const float* bg_rate;  // (B, S, S)
  const float* bias;     // (S, S)
  const float* inv_gain; // (S, S)
  const float* nl;       // (3, S, S)
  const int* cr_pos;     // (B, 2, n_cr)    B2
  const float* cr_q;     // (B, n_cr)       B2
  float* cum_out;        // (B, S, S)
  float* dn;             // (B, S, S)
  int B, W, S, n_cr, read;
  float rn, fw, inv_fw, inv_gain_scalar, ipc_alpha;
  int flags;
};

__global__ void __launch_bounds__(BX * BY)
read_step_banded_kernel(StepArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const TileShared sh = tile_shared(smem_raw, a.n_cr);
  __shared__ int n_hits;

  const bool ipc = a.flags & F_IPC;
  const bool bg_poisson = (a.flags & F_POISSON) && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const int S = a.S, W = a.W;
  const int b = blockIdx.z;
  const TiledPixel p = tiled_pixel(S, ipc ? 1 : 0);
  const size_t plane = static_cast<size_t>(S) * S;
  const size_t at = b * plane + p.pidx;
  const uint32_t pix = static_cast<uint32_t>(p.pidx);
  const uint32_t rd = static_cast<uint32_t>(a.read);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);

  float cum = 0.0f, z_bg = 0.0f, z_rn = 0.0f;
  if (p.valid) {
    if (bg_poisson || read_noise) normal_pair(k0, k1, rd, pix, &z_bg, &z_rn);
    cum = add_background(a.cum_in[at], a.bg_rate[at] * a.dt[b], bg_poisson,
                         z_bg, k0, k1, rd, pix);
    const int y0 = a.y0[b];
    if (p.y >= y0 && p.y < y0 + W)
      cum = cum + a.band[(static_cast<size_t>(b) * W + (p.y - y0)) * S + p.x];
  }
  if (a.flags & F_CR) {
    const int* py = a.cr_pos + static_cast<size_t>(b) * 2 * a.n_cr;
    cum = add_cr_hits(cum, p, py, py + a.n_cr,
                      a.cr_q + static_cast<size_t>(b) * a.n_cr, a.n_cr, sh,
                      &n_hits);
  }

  float sig = cum;
  if ((a.flags & F_NONLIN) && p.valid)
    sig = nonlin(sig, a.fw, a.inv_fw, a.nl[p.pidx], a.nl[plane + p.pidx],
                 a.nl[2 * plane + p.pidx]);
  if (ipc) sig = ipc_couple(sig, p, a.ipc_alpha, sh.tile);
  if (!p.interior) return;  // after the last __syncthreads
  if (a.flags & F_BIAS) sig = sig + a.bias[p.pidx];
  if (read_noise) sig = sig + a.rn * z_rn;
  const float gmul =
      (a.flags & F_SCALAR_GAIN) ? a.inv_gain_scalar : a.inv_gain[p.pidx];
  a.dn[at] = sig * gmul;
  a.cum_out[at] = cum;
}

__global__ void __launch_bounds__(FLAT_THREADS)
read_step_kernel(StepArgs a) {
  const size_t plane = static_cast<size_t>(a.S) * a.S;
  const size_t at = static_cast<size_t>(blockIdx.x) * FLAT_THREADS +
                    threadIdx.x;
  if (at >= a.B * plane) return;
  const int b = static_cast<int>(at / plane);
  const size_t pidx = at - b * plane;
  const bool bg_poisson = (a.flags & F_POISSON) && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const uint32_t pix = static_cast<uint32_t>(pidx);
  const uint32_t rd = static_cast<uint32_t>(a.read);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);

  float z_bg = 0.0f, z_rn = 0.0f;
  if (bg_poisson || read_noise) normal_pair(k0, k1, rd, pix, &z_bg, &z_rn);
  const float cum = add_background(a.cum_in[at] + a.add[at],
                                   a.bg_rate[at] * a.dt[b], bg_poisson, z_bg,
                                   k0, k1, rd, pix);
  a.cum_out[at] = cum;
  float sig = cum;
  if (a.flags & F_NONLIN)
    sig = nonlin(sig, a.fw, a.inv_fw, a.nl[pidx], a.nl[plane + pidx],
                 a.nl[2 * plane + pidx]);
  if (a.flags & F_BIAS) sig = sig + a.bias[pidx];
  if (read_noise) sig = sig + a.rn * z_rn;
  a.dn[at] =
      sig * ((a.flags & F_SCALAR_GAIN) ? a.inv_gain_scalar : a.inv_gain[pidx]);
}

}  // namespace

extern "C" int wayne_read_step_banded(
    const int* seed, const int* y0, const float* dt, const float* cum_in,
    const float* band, const float* bg_rate, const float* bias,
    const float* inv_gain, const float* nl, const int* cr_pos,
    const float* cr_q, float* cum_out, float* dn, int B, int W, int S,
    int n_cr, int read, float rn, float fw, float inv_fw,
    float inv_gain_scalar, float ipc_alpha, int flags, void* stream) {
  StepArgs a{seed, y0, dt, cum_in, band, nullptr, bg_rate, bias, inv_gain,
             nl, cr_pos, cr_q, cum_out, dn, B, W, S, n_cr, read,
             rn, fw, inv_fw, inv_gain_scalar, ipc_alpha, flags};
  const size_t smem = tiled_smem(n_cr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        read_step_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  read_step_banded_kernel<<<tiled_grid(S, B, flags), dim3(BX, BY), smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wayne_read_step(
    const int* seed, const float* dt, const float* cum_in, const float* add,
    const float* bg_rate, const float* bias, const float* inv_gain,
    const float* nl, float* cum_out, float* dn, int B, int S, int read,
    float rn, float fw, float inv_fw, float inv_gain_scalar, int flags,
    void* stream) {
  StepArgs a{seed, nullptr, dt, cum_in, nullptr, add, bg_rate, bias,
             inv_gain, nl, nullptr, nullptr, cum_out, dn, B, 0, S, 0, read,
             rn, fw, inv_fw, inv_gain_scalar, 0.0f, flags};
  const size_t n = static_cast<size_t>(B) * S * S;
  const unsigned blocks =
      static_cast<unsigned>((n + FLAT_THREADS - 1) / FLAT_THREADS);
  read_step_kernel<<<blocks, FLAT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
