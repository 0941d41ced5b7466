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
// sequential grid over reads. Here each thread owns PY pixels of one
// exposure, one column and PY rows BY apart: their charges live in
// registers and the thread loops over all reads, so the charge frame never
// touches device memory between reads, and the six per-pixel planes
// (bg_rate, bias, inv_gain, c1, c2, c3) are read once per exposure instead
// of once per read. A block of BX x BY threads covers a BX x TH tile
// (TH = BY * PY rows); the grid is (column tiles, row tiles, exposures), so
// one launch serves a whole chunk.
//   * Several pixels per thread: PY = 4 rows, measured on an H100 against
//     1, 2 and 8 (8 spills). A warp is one row segment of 32 pixels for
//     each of its PY rows, so every load and store stays coalesced; the
//     reads are written with streaming stores (the kernel never reads them
//     back). The register count decides how many blocks an SM holds, and
//     small code changes move it across 128 (2 blocks of 256 threads, or 1,
//     which ran 1.7x slower), so __launch_bounds__ pins MIN_BLOCKS = 3
//     blocks per SM: 80 registers, at the price of 32 bytes of spill
//     stores. The hit staging is sized so that shared memory holds three
//     blocks too.
//   * Cosmic rays: at the top of the block (and again for each further
//     group of reads when the hit lists outgrow the staging budget), each
//     warp compacts whole reads' hit lists, in list order, to the hits
//     inside this block's tile, into shared memory with a count per read;
//     the read's dt and y0 are staged beside them. The read loop then reads
//     hits and scalars from shared memory, with no barrier when IPC is off.
//     A hit lands exactly once whatever the tiling, and two hits on one
//     pixel add in list order.
//   * IPC: the tile carries a one-pixel halo. Halo pixels recompute their
//     charge exactly (every random draw is keyed by pixel, not by thread),
//     the sensed signals meet in shared memory once per read, and interior
//     pixels couple their 4 neighbours. So IPC works at every frame size
//     (the TPU forbade it when tiled); a tile TH rows tall recomputes fewer
//     halo rows than one BY rows tall.
// The Philox generator, the samplers, the band's draw and the hit staging
// are in detector.cuh, shared with the per-read kernels (read_step.cu);
// Box-Muller takes its sine and cosine from one sincosf (one range
// reduction, the same bits as sinf and cosf).
//   * RNG: Philox4x32-10, key = the exposure's two seed words, counter =
//     (k, y * S + x, stream tag, 0). Tags: 0 Box-Muller pair
//     (background z, read-noise z), 1 the band's normal, 2 and 3 the
//     small-lambda uniforms of the background and the band. A pixel takes
//     the exact small-lambda branch on its own (the TPU gated a whole tile).
//   * Exact Poisson (F_EXACT_POISSON, the JAX package's exact_poisson): a
//     second instantiation of the kernel whose samplers are detector.cuh's
//     exact_poisson_sample (Knuth below lambda = 10, PTRS above, on the
//     blocks (k, y * S + x, tag 2 or 3, n)), out of line, each pixel on its
//     own: the rejection loops diverge. The default instantiation is the
//     code above, unchanged.
//
// What bounds it on this card. Per 512^2 exposure at 16 reads the least
// traffic is the reads written (16 * 512^2 * 4 B = 16.8 MB), the charge
// written (1 MB), the background plane read (1 MB), the bands (16 * W *
// 512 * 4 B, 1 MB at W = 32) and the CR lists; the five shared planes
// (bias, inv_gain, c1..c3, 5.2 MB) are read once per launch of B
// exposures: ~6.2 us per exposure at 3.35 TB/s and B = 8. The work per
// pixel and read is one Philox block (42 SASS instructions: 21 IMAD on the
// FMA-heavy pipe and 20 LOP3 on the ALU pipe, each pipe at half the issue
// rate), a Box-Muller pair (log, sqrt and sincos without fast math), the
// sampler and the readout chain, plus a second Philox block and sampler on
// the band rows and a third where 0 < lambda < 3. Operations bind, by the
// issue rate with the IMAD pipe close behind. chip_smoke.py computes the
// bounds from each run's inputs, counting each operation at the rate of
// its pipe.
//
// Built by wayne_tpu_torch/ops/readout.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c    (then linked with read_step.cu into one .so)
// No fast math: --fmad=false keeps each multiply and add separately rounded
// like PyTorch's one-op kernels, so the plain version agrees to the bit.

#include "detector.cuh"

namespace {

constexpr int PY = 4;            // pixels (rows) per thread
constexpr int MIN_BLOCKS = 3;    // blocks per SM the register count allows
constexpr int TH = BY * PY;      // tile height in rows, halo included
constexpr int WARPS = BX * BY / 32;
// Hit staging per block: at most this many bytes of hit lists at once, so
// that MIN_BLOCKS blocks, each with its IPC tile and per-read scalars, still
// fit in an SM's 228 KB of shared memory; one read's list is staged
// whatever its size.
constexpr size_t STAGE_BYTES = 64 * 1024;

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
  int G;                 // reads whose hits are staged at once
  float rn, fw, inv_fw, inv_gain_scalar, ipc_alpha;
  int flags;
};

// Reads whose hit lists a block stages at once.
inline int stage_reads(int NR, int n_cr, int flags) {
  if (!(flags & F_CR) || n_cr == 0) return NR;
  const size_t g = STAGE_BYTES / (static_cast<size_t>(n_cr) * sizeof(Hit));
  return g < 1 ? 1 : (g < static_cast<size_t>(NR) ? static_cast<int>(g) : NR);
}

// Dynamic shared memory: dt and y0 of every read, then a hit count and a
// list of n_cr slots for each staged read, then the IPC tile.
inline size_t readout_smem(int NR, int n_cr, int G, int flags) {
  size_t bytes = static_cast<size_t>(NR) * 8;
  if (flags & F_CR) bytes += static_cast<size_t>(G) * (4 + n_cr * sizeof(Hit));
  if (flags & F_IPC) bytes += BX * TH * 4;
  return bytes;
}

// Warp `warp` compacts, in list order, the hits of reads g0 + warp,
// g0 + warp + WARPS, ... (below g1) that fall inside the tile at (ox, oy)
// into slots (k - g0) * n_cr of `hits`, and their number into count.
__device__ __forceinline__ void stage_hits(const Args& a, int b, int g0,
                                           int g1, int ox, int oy,
                                           int warp, int lane, Hit* hits,
                                           int* count) {
  const int n_cr = a.n_cr;
  for (int k = g0 + warp; k < g1; k += WARPS) {
    const size_t bk = static_cast<size_t>(b) * a.NR + k;
    const int* py = a.cr_pos + bk * 2 * n_cr;
    const int* px = py + n_cr;
    const float* pq = a.cr_q + bk * n_cr;
    const int n = compact_hits(py, px, pq, 0, n_cr, ox, oy, TH, lane,
                               hits + static_cast<size_t>(k - g0) * n_cr);
    if (lane == 0) count[k - g0] = n;
  }
}

// EXACT: the exact Poisson sampler (F_EXACT_POISSON), a second
// instantiation, so the default one keeps its code and registers.
template <bool EXACT>
__global__ void __launch_bounds__(BX * BY, MIN_BLOCKS)
exposure_readout_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  const int S = a.S, W = a.W, NR = a.NR, G = a.G;
  const bool ipc = a.flags & F_IPC;
  const bool with_cr = a.flags & F_CR;
  float* s_dt = reinterpret_cast<float*>(smem_raw);
  int* s_y0 = reinterpret_cast<int*>(s_dt + NR);
  int* s_count = s_y0 + NR;
  Hit* s_hits = reinterpret_cast<Hit*>(s_count + (with_cr ? G : 0));
  float* s_tile = reinterpret_cast<float*>(
      s_hits + (with_cr ? static_cast<size_t>(G) * a.n_cr : 0));

  const bool poisson = a.flags & F_POISSON;
  const bool bg_poisson = poisson && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const int h = ipc ? 1 : 0;
  const int b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = blockIdx.x * (BX - 2 * h) - h;  // pixel of thread (0, 0)
  const int oy = blockIdx.y * (TH - 2 * h) - h;
  const int x = ox + tx;
  const bool col_valid = x >= 0 && x < S;
  const bool col_interior = col_valid && tx >= h && tx < BX - h;
  const size_t plane = static_cast<size_t>(S) * S;
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);

  for (int k = ty * BX + tx; k < NR; k += BX * BY) {
    s_dt[k] = a.dts[b * NR + k];
    s_y0[k] = a.y0s[b * NR + k];
  }

  // Pixel j of this thread: row oy + ty + BY * j of column x.
  int y[PY];
  bool valid[PY], interior[PY];
  uint32_t pix[PY];
  float cum[PY], bg[PY], bias[PY], gmul[PY], c1[PY], c2[PY], c3[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) {
    const int row = ty + BY * j;
    y[j] = oy + row;
    valid[j] = col_valid && y[j] >= 0 && y[j] < S;
    interior[j] = valid[j] && col_interior && row >= h && row < TH - h;
    const size_t p = valid[j] ? static_cast<size_t>(y[j]) * S + x : 0;
    pix[j] = static_cast<uint32_t>(p);
    cum[j] = 0.0f;
    bg[j] = bias[j] = c1[j] = c2[j] = c3[j] = 0.0f;
    gmul[j] = a.inv_gain_scalar;
    if (valid[j]) {
      bg[j] = a.bg_rate[b * plane + p];
      bias[j] = a.bias[p];
      if (!(a.flags & F_SCALAR_GAIN)) gmul[j] = a.inv_gain[p];
      c1[j] = a.nl[p];
      c2[j] = a.nl[plane + p];
      c3[j] = a.nl[2 * plane + p];
    }
  }

  for (int g0 = 0; g0 < NR; g0 += G) {
    const int g1 = min(NR, g0 + G);
    if (with_cr) {
      if (g0) __syncthreads();  // the previous group's hits are consumed
      stage_hits(a, b, g0, g1, ox, oy, ty, tx, s_hits, s_count);
    }
    __syncthreads();  // hits (and the per-read scalars) staged

    for (int k = g0; k < g1; ++k) {
      const uint32_t rd = static_cast<uint32_t>(k);
      const size_t bk = static_cast<size_t>(b) * NR + k;
      const float dt = s_dt[k];
      const int y0 = s_y0[k];
      float z_bg[PY], z_rn[PY];
#pragma unroll
      for (int j = 0; j < PY; ++j) z_bg[j] = z_rn[j] = 0.0f;
      if (bg_poisson || read_noise) {
#pragma unroll
        for (int j = 0; j < PY; ++j)
          normal_pair(k0, k1, rd, pix[j], &z_bg[j], &z_rn[j]);
      }
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        if (!valid[j]) continue;
        cum[j] = add_background<EXACT>(cum[j], bg[j] * dt, bg_poisson,
                                       z_bg[j], k0, k1, rd, pix[j]);
        if (y[j] >= y0 && y[j] < y0 + W)
          cum[j] = add_band<EXACT>(
              cum[j], a.bands[(bk * W + (y[j] - y0)) * S + x], poisson, k0,
              k1, rd, pix[j]);
      }
      if (with_cr)
        add_staged_hits<PY>(s_hits + static_cast<size_t>(k - g0) * a.n_cr,
                            s_count[k - g0], y, x, valid, cum);

      float sig[PY];
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        sig[j] = cum[j];
        if (a.flags & F_NONLIN)
          sig[j] = nonlin(sig[j], a.fw, a.inv_fw, c1[j], c2[j], c3[j]);
      }
      if (ipc) {
        // Inter-pixel capacitance, kernel [[0,a,0],[a,1-4a,a],[0,a,0]]
        // with a zero boundary: the sensed signals meet in the tile.
#pragma unroll
        for (int j = 0; j < PY; ++j)
          s_tile[(ty + BY * j) * BX + tx] = valid[j] ? sig[j] : 0.0f;
        __syncthreads();
        const float one_m4a = 1.0f - 4.0f * a.ipc_alpha;
#pragma unroll
        for (int j = 0; j < PY; ++j) {
          if (!interior[j]) continue;
          const int at = (ty + BY * j) * BX + tx;
          const float up = s_tile[at - BX], down = s_tile[at + BX];
          const float left = s_tile[at - 1], right = s_tile[at + 1];
          sig[j] = sig[j] * one_m4a + a.ipc_alpha * (((up + down) + left) +
                                                     right);
        }
        __syncthreads();  // the tile is rewritten next read
      }
#pragma unroll
      for (int j = 0; j < PY; ++j) {
        if (!interior[j]) continue;
        float s = sig[j];
        if (a.flags & F_BIAS) s = s + bias[j];
        if (read_noise) s = s + a.rn * z_rn[j];
        __stcs(a.reads + bk * plane + pix[j], s * gmul[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PY; ++j)
    if (interior[j]) a.cum_out[b * plane + pix[j]] = cum[j];
}

template <bool EXACT>
int launch_exposure_readout(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exposure_readout_kernel<EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int h = (a.flags & F_IPC) ? 1 : 0;
  const int tw = BX - 2 * h, th = TH - 2 * h;
  const dim3 grid((a.S + tw - 1) / tw, (a.S + th - 1) / th, a.B);
  exposure_readout_kernel<EXACT><<<grid, dim3(BX, BY), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wayne_exposure_readout(
    const int* seed, const int* y0s, const float* dts, const float* bands,
    const float* bg_rate, const float* bias,
    const float* inv_gain, const float* nl, const int* cr_pos,
    const float* cr_q, float* reads, float* cum_out, int B, int NR, int W,
    int S, int n_cr, float rn, float fw, float inv_fw,
    float inv_gain_scalar, float ipc_alpha, int flags, void* stream) {
  const int G = stage_reads(NR, n_cr, flags);
  Args a{seed, y0s, dts, bands, bg_rate, bias, inv_gain, nl,
         cr_pos, cr_q, reads, cum_out, B, NR, W, S, n_cr, G,
         rn, fw, inv_fw, inv_gain_scalar, ipc_alpha, flags};
  const size_t smem = readout_smem(NR, n_cr, G, flags);
  const auto st = static_cast<cudaStream_t>(stream);
  return (flags & F_EXACT_POISSON) ? launch_exposure_readout<true>(a, smem, st)
                                   : launch_exposure_readout<false>(a, smem,
                                                                    st);
}
