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
// Design. B2 is one read of the whole-exposure kernel's design: one thread
// per pixel, grid (column tiles, row tiles, exposures), the hit list
// compacted by warp 0 in list order, IPC through a one-pixel halo whose
// threads recompute their pixel's charge exactly (detector.cuh). Unlike
// the whole-exposure kernel the charge enters from and leaves to device
// memory, so cum_out must not alias cum_in (a halo thread reads a pixel
// that another block writes). The band may start at any row y0: nothing
// assumes the TPU's 8-row alignment. B3 is a pure per-pixel pass: a flat
// grid over (B, S, S), no shared memory.
//
// What bounds them on this card. Per launch at B = 8 and S = 512 the least
// traffic of B2 is cum in and out, dn and the background plane (4 x 8.4 MB),
// the five shared planes (bias, inv_gain, c1..c3, 5.2 MB) and the band;
// B3 reads the add frame (8.4 MB) instead of the band. ~38-46 MB at
// 3.35 TB/s is ~11-14 us. The operations per pixel are one Philox block,
// Box-Muller, the sampler and the readout chain (~135, ~8.5 us for the
// chunk at the 67 T/s fp32 lane rate). Bytes bind, narrowly; chip_smoke.py
// computes both bounds from each run's inputs.
//
// Built by wayne_tpu_torch/ops/readout.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c    (then linked with readout.cu into one .so)

#include "detector.cuh"

namespace {

constexpr int FLAT_THREADS = 256;  // threads per block of the flat kernel

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
