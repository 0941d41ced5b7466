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
//     lands exactly once whatever the tiling (add_cr_hits, detector.cuh).
//   * IPC: the block's tile carries a one-pixel halo. Halo threads
//     recompute their pixel's charge exactly (every random draw is keyed by
//     pixel, not by thread), the sensed signal goes through shared memory
//     once per read, and interior threads couple their 4 neighbours. So IPC
//     works at every frame size (the TPU forbade it when tiled).
// The Philox generator, the sampler, the tiling and these two steps are in
// detector.cuh, shared with the per-read kernels (read_step.cu).
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
//        -Xcompiler -fPIC -c    (then linked with read_step.cu into one .so)
// No fast math: --fmad=false keeps each multiply and add separately rounded
// like PyTorch's one-op kernels, so the plain version agrees to the bit.

#include "detector.cuh"

namespace {

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

__global__ void __launch_bounds__(BX * BY)
exposure_readout_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const TileShared sh = tile_shared(smem_raw, a.n_cr);
  __shared__ int n_hits;

  const bool ipc = a.flags & F_IPC;
  const bool poisson = a.flags & F_POISSON;
  const bool bg_poisson = poisson && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const bool with_cr = a.flags & F_CR;
  const int S = a.S, W = a.W, NR = a.NR;
  const int b = blockIdx.z;
  const TiledPixel p = tiled_pixel(S, ipc ? 1 : 0);
  const size_t plane = static_cast<size_t>(S) * S;
  const uint32_t pix = static_cast<uint32_t>(p.pidx);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);

  float cum = 0.0f, bg = 0.0f, bias = 0.0f, gmul = a.inv_gain_scalar;
  float c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
  if (p.valid) {
    bg = a.bg_rate[b * plane + p.pidx];
    bias = a.bias[p.pidx];
    if (!(a.flags & F_SCALAR_GAIN)) gmul = a.inv_gain[p.pidx];
    c1 = a.nl[p.pidx];
    c2 = a.nl[plane + p.pidx];
    c3 = a.nl[2 * plane + p.pidx];
  }

  for (int k = 0; k < NR; ++k) {
    const uint32_t rd = static_cast<uint32_t>(k);
    const int bk = b * NR + k;
    float z_bg = 0.0f, z_rn = 0.0f;
    if (p.valid && (bg_poisson || read_noise))
      normal_pair(k0, k1, rd, pix, &z_bg, &z_rn);
    if (p.valid) {
      cum = add_background(cum, bg * a.dts[bk], bg_poisson, z_bg, k0, k1, rd,
                           pix);
      const int y0 = a.y0s[bk];
      if (p.y >= y0 && p.y < y0 + W) {
        float e =
            a.bands[(static_cast<size_t>(bk) * W + (p.y - y0)) * S + p.x];
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
      const int* py = a.cr_pos + static_cast<size_t>(bk) * 2 * a.n_cr;
      cum = add_cr_hits(cum, p, py, py + a.n_cr,
                        a.cr_q + static_cast<size_t>(bk) * a.n_cr, a.n_cr, sh,
                        &n_hits);
    }

    float sig = cum;
    if (a.flags & F_NONLIN) sig = nonlin(sig, a.fw, a.inv_fw, c1, c2, c3);
    if (ipc) sig = ipc_couple(sig, p, a.ipc_alpha, sh.tile);
    if (a.flags & F_BIAS) sig = sig + bias;
    if (read_noise) sig = sig + a.rn * z_rn;
    if (p.interior)
      a.reads[static_cast<size_t>(bk) * plane + p.pidx] = sig * gmul;
  }
  if (p.interior) a.cum_out[b * plane + p.pidx] = cum;
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
  const size_t smem = tiled_smem(n_cr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exposure_readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  exposure_readout_kernel<<<tiled_grid(S, B, flags), dim3(BX, BY), smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
