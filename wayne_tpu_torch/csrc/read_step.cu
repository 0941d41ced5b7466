// Per-read readout kernels for NVIDIA Hopper (sm_90a): one read of every
// exposure of a chunk per launch, the charge frame read from and written
// back to device memory.
//
// read_step_banded_kernel replaces the JAX package's Pallas TPU kernel
// `fused_read_step_banded` (wayne_tpu/ops/pallas_readout.py, kernel body
// `_kernel_banded`); read_step_kernel replaces `fused_read_step` (body
// `_kernel`). Their plain PyTorch versions, with the same Philox draws, are
// `sample_band` then `read_step_banded_plain`, and `read_step_plain`, in
// wayne_tpu_torch/ops/readout.py.
//
// What they compute, for each exposure b of a chunk and one emitted read k:
//   banded (B2):
//     cum  = cum_in + Poisson(bg_rate * dt)
//     cum[y0 : y0 + W] += Poisson(band)         (band: EXPECTED electrons)
//     cum += q_i for the read's cosmic-ray hits, in list order
//     dn   = (nonlin(min(cum, fw)) -> IPC -> + bias -> + rn * z) * inv_gain
//   full frame (B3):
//     cum  = (cum_in + add) + Poisson(bg_rate * dt)   (add: band + hits)
//     dn   = (nonlin(min(cum, fw)) -> + bias -> + rn * z) * inv_gain
// With the noise off (no F_POISSON) the band is added as given.
//
// Draws are the whole-exposure kernel's (readout.cu): Philox4x32-10 keyed
// by the exposure's two seed words, counter (k, y * S + x, tag, 0), tag 0
// for the (background z, read-noise z) pair, 1 for the band's normal, 2
// and 3 for the small-lambda uniforms of the background and the band, with
// k the emitted read index. So the per-read path draws exactly the numbers
// the whole-exposure path draws.
//
// Design. B2 is one read of the whole-exposure kernel's chain, tiled as it
// is: each thread owns ROWS pixels of one column, BY rows apart, so a warp
// is one 32-pixel row segment for each of its rows (coalesced loads and
// stores) and each thread runs ROWS independent Philox / Box-Muller /
// sampler chains; a block covers BX x TH pixels (TH = BY * ROWS), the grid
// is (column tiles, row tiles, exposures). Every input is loaded before the
// chains run.
//   * Cosmic rays: every warp compacts its own segment of the read's hit
//     list, in list order, to the hits inside the block's tile, into shared
//     memory (detector.cuh, compact_hits), before the chains run; one
//     barrier after them, then each pixel adds the segments' hits in
//     segment order, so a hit lands exactly once and two hits on one pixel
//     add in list order.
//   * IPC: a one-pixel halo whose pixels recompute their charge exactly
//     (every draw is keyed by pixel); a tile TH rows tall recomputes 12% of
//     its pixels where a BY-row tile recomputed 30%. The charge enters from
//     and leaves to device memory, so cum_out must not alias cum_in (a halo
//     pixel reads what another block writes). The band may start at any row
//     y0: nothing assumes the TPU's 8-row alignment.
//   * The band's draw is one out-of-line function: four inlined copies
//     spilled on every row for the few rows the band covers.
// B3 is a pure per-pixel pass on a grid of (column groups, rows,
// exposures), no 64-bit division: each thread owns 4 consecutive pixels of
// a row, loaded and stored 16 bytes at a time where the frame allows it
// (S % 4 = 0, aligned planes), one by one in the frame's last columns.
// In both, the background's exact small-lambda branch (a second Philox
// block, an exp and a 12-term sum) runs once per warp over the pixels that
// take it, compacted in shared memory (detector.cuh, poisson_sample_warp),
// rather than once for each of a thread's pixels wherever one lane of the
// warp takes it. With F_EXACT_POISSON a second instantiation of each kernel
// runs detector.cuh's exact sampler instead, every positive-lambda pixel
// through the same queue (the band's draw stays out of line).
//
// What bounds them on this card. Per launch at B = 8 and S = 512 the least
// traffic of B2 is cum in and out, dn and the background plane (4 x 8.4 MB),
// the five shared planes (bias, inv_gain, c1..c3, 5.2 MB) and the band;
// B3 reads the add frame (8.4 MB) instead of the band. ~38-46 MB at
// 3.35 TB/s is ~11-14 us. The operations per pixel are one Philox block
// (32-bit integer work, issued at half the fp32 rate), Box-Muller, the
// sampler and the readout chain, and on B2's band rows a second Philox
// block, Box-Muller and sampler. chip_smoke.py computes both bounds from
// each run's inputs, counting each operation at the rate of its pipe; the
// bytes bind there, but the compiled instruction stream (Box-Muller's
// precise log, sqrt and sincos alone are ~72 instructions) is what the
// kernels take: B3 runs at about the whole-exposure kernel's time per
// pixel and read (PERF.md).
//
// Built by wayne_tpu_torch/ops/readout.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xcompiler -fPIC -c    (then linked with readout.cu into one .so)

#include "detector.cuh"

namespace {

// Measured on an H100 against 1, 2 and 8 rows and 2 to 6 blocks per SM
// (PERF.md): B2 at 4 rows and 4 blocks (64 registers, no spill), B3 at 3
// blocks (80 registers; at 4 it spills 144 bytes and runs 10% slower).
constexpr int ROWS = 4;           // B2's pixels (rows, BY apart) per thread
constexpr int B2_MIN_BLOCKS = 4;  // blocks per SM the register count allows
constexpr int B3_MIN_BLOCKS = 3;
constexpr int TH = BY * ROWS;     // tile height in rows, halo included

struct StepArgs {
  const int* seed;       // (B, 2)
  const int* y0;         // (B,)            B2
  const float* dt;       // (B,)
  const float* cum_in;   // (B, S, S)
  const float* band;     // (B, W, S)       B2, expected electrons
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
  bool vec;              // B3: every plane 16-byte aligned, S % 4 = 0
};

// Hit-list entries each warp of a B2 block compacts.
__host__ __device__ inline int hit_segment(int n_cr) {
  return (n_cr + BY - 1) / BY;
}

// Dynamic shared memory of B2: each warp's compacted segment, then the IPC
// tile.
inline size_t banded_smem(int n_cr, int flags) {
  size_t bytes = 0;
  if (flags & F_CR) bytes += static_cast<size_t>(BY) * hit_segment(n_cr) *
                             sizeof(Hit);
  if (flags & F_IPC) bytes += BX * TH * 4;
  return bytes;
}

// A pixel's values of the shared planes: the non-linearity, the bias and
// the reciprocal gain (the scalar gain when the flags say so).
struct PixelPlanes {
  float c1, c2, c3, bias, gmul;
};

__device__ __forceinline__ PixelPlanes load_planes(const StepArgs& a,
                                                   bool valid, uint32_t p,
                                                   size_t plane) {
  PixelPlanes pl{0.0f, 0.0f, 0.0f, 0.0f, a.inv_gain_scalar};
  if (!valid) return pl;
  if (a.flags & F_NONLIN) {
    pl.c1 = a.nl[p];
    pl.c2 = a.nl[plane + p];
    pl.c3 = a.nl[2 * plane + p];
  }
  if (a.flags & F_BIAS) pl.bias = a.bias[p];
  if (!(a.flags & F_SCALAR_GAIN)) pl.gmul = a.inv_gain[p];
  return pl;
}

// The readout chain after the sensed signal: + bias, + rn * z, * gain.
__device__ __forceinline__ float emit(float sig, const StepArgs& a,
                                      bool read_noise, float z_rn,
                                      const PixelPlanes& pl) {
  if (a.flags & F_BIAS) sig = sig + pl.bias;
  if (read_noise) sig = sig + a.rn * z_rn;
  return sig * pl.gmul;
}

// The band's draw, compiled once rather than once per row of a thread:
// the band covers few rows, and four inlined copies cost registers and
// spills on every row (measured on an H100: no spills, 4% faster).
template <bool EXACT>
__device__ __noinline__ float add_band_call(float cum, float e, bool sampled,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t read, uint32_t pix) {
  return add_band<EXACT>(cum, e, sampled, k0, k1, read, pix);
}

// EXACT: the exact Poisson sampler (F_EXACT_POISSON), a second
// instantiation of each kernel, so the default one keeps its code.
template <bool EXACT>
__global__ void __launch_bounds__(BX * BY, B2_MIN_BLOCKS)
read_step_banded_kernel(StepArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_count[BY];
  __shared__ float2 s_queue[BY][BX * ROWS];  // each warp's small lambdas
  const int S = a.S, W = a.W, n_cr = a.n_cr;
  const bool ipc = a.flags & F_IPC;
  const bool with_cr = a.flags & F_CR;
  const int seg = hit_segment(n_cr);
  Hit* s_hits = reinterpret_cast<Hit*>(smem_raw);
  float* s_tile = reinterpret_cast<float*>(
      s_hits + (with_cr ? static_cast<size_t>(BY) * seg : 0));

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
  const float* cum_in = a.cum_in + b * plane;
  const float* bg_rate = a.bg_rate + b * plane;
  const uint32_t rd = static_cast<uint32_t>(a.read);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);
  const float dt = a.dt[b];
  const int y0 = a.y0[b];

  // Warp ty compacts entries [ty * seg, (ty + 1) * seg) of the hit list;
  // the barrier waits below, after the chains.
  if (with_cr) {
    const int* py = a.cr_pos + static_cast<size_t>(b) * 2 * n_cr;
    const int i0 = min(ty * seg, n_cr), i1 = min(i0 + seg, n_cr);
    const int n = compact_hits(py, py + n_cr,
                               a.cr_q + static_cast<size_t>(b) * n_cr, i0,
                               i1, ox, oy, TH, tx,
                               s_hits + static_cast<size_t>(ty) * seg);
    if (tx == 0) s_count[ty] = n;
  }

  // Pixel j of this thread: row oy + ty + BY * j of column x. Every
  // input is loaded before the chains run, so the loads are in flight
  // together.
  int y[ROWS];
  bool valid[ROWS], interior[ROWS], in_band[ROWS];
  uint32_t pix[ROWS];
  float cum[ROWS], bg[ROWS], band[ROWS], z_rn[ROWS];
  PixelPlanes pl[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int row = ty + BY * j;
    y[j] = oy + row;
    valid[j] = col_valid && y[j] >= 0 && y[j] < S;
    interior[j] = valid[j] && col_interior && row >= h && row < TH - h;
    in_band[j] = valid[j] && y[j] >= y0 && y[j] < y0 + W;
    pix[j] = valid[j] ? static_cast<uint32_t>(y[j] * S + x) : 0u;
    cum[j] = bg[j] = band[j] = 0.0f;
    if (valid[j]) {
      cum[j] = cum_in[pix[j]];
      bg[j] = bg_rate[pix[j]];
    }
    if (in_band[j])
      band[j] = a.band[(static_cast<size_t>(b) * W + (y[j] - y0)) * S + x];
    pl[j] = load_planes(a, valid[j], pix[j], plane);
  }
  float z_bg[ROWS], lam[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    z_bg[j] = z_rn[j] = 0.0f;
    if (bg_poisson || read_noise) normal_pair(k0, k1, rd, pix[j], &z_bg[j],
                                              &z_rn[j]);
    lam[j] = bg[j] * dt;
  }
  if (bg_poisson)
    poisson_sample_warp<ROWS, EXACT>(lam, z_bg, pix, k0, k1, rd,
                                     TAG_BG_UNIFORM, tx, s_queue[ty], lam);
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (!valid[j]) continue;
    cum[j] = cum[j] + lam[j];
    if (in_band[j])
      cum[j] = add_band_call<EXACT>(cum[j], band[j], poisson, k0, k1, rd,
                                    pix[j]);
  }
  if (with_cr) {
    __syncthreads();  // every warp's segment staged
    for (int w = 0; w < BY; ++w)
      add_staged_hits<ROWS>(s_hits + static_cast<size_t>(w) * seg,
                            s_count[w], y, x, valid, cum);
  }

  float sig[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    sig[j] = cum[j];
    if (a.flags & F_NONLIN)
      sig[j] = nonlin(sig[j], a.fw, a.inv_fw, pl[j].c1, pl[j].c2, pl[j].c3);
  }
  if (ipc) {
    // Inter-pixel capacitance, kernel [[0,a,0],[a,1-4a,a],[0,a,0]] with a
    // zero boundary: the sensed signals meet in the tile.
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      s_tile[(ty + BY * j) * BX + tx] = valid[j] ? sig[j] : 0.0f;
    __syncthreads();
    const float one_m4a = 1.0f - 4.0f * a.ipc_alpha;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (!interior[j]) continue;
      const int at = (ty + BY * j) * BX + tx;
      const float up = s_tile[at - BX], down = s_tile[at + BX];
      const float left = s_tile[at - 1], right = s_tile[at + 1];
      sig[j] = sig[j] * one_m4a + a.ipc_alpha * (((up + down) + left) +
                                                 right);
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (!interior[j]) continue;
    const size_t at = b * plane + pix[j];
    __stcs(a.dn + at, emit(sig[j], a, read_noise, z_rn[j], pl[j]));
    a.cum_out[at] = cum[j];
  }
}

// B3's pixels per thread: 4 consecutive, one 16-byte load or store each.
constexpr int PX = 4;

// v[0..PX) from p[0..n): one 16-byte load when vec (n = PX and p
// aligned), else n scalar loads and zeros.
__device__ __forceinline__ void load_px(const float* p, bool vec, int n,
                                        float* v) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < PX; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(BX * BY, B3_MIN_BLOCKS)
read_step_kernel(StepArgs a) {
  __shared__ float2 s_queue[BY][BX * PX];  // each warp's small lambdas
  const int S = a.S;
  const int b = blockIdx.z;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int x0 = (blockIdx.x * BX + threadIdx.x) * PX;
  // pixels x0 .. x0 + n - 1 of row y are this thread's; the whole warp
  // stays for the sampler
  const int n = y < S ? max(0, min(PX, S - x0)) : 0;
  const bool vec = a.vec && n == PX;
  const size_t plane = static_cast<size_t>(S) * S;
  const uint32_t p0 = n ? static_cast<uint32_t>(y * S + x0) : 0u;
  const size_t at = b * plane + p0;
  const bool bg_poisson = (a.flags & F_POISSON) && (a.flags & F_BG_POISSON);
  const bool read_noise = a.flags & F_READ_NOISE;
  const uint32_t rd = static_cast<uint32_t>(a.read);
  const uint32_t k0 = static_cast<uint32_t>(a.seed[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(a.seed[2 * b + 1]);
  const float dt = a.dt[b];

  float cum[PX], add[PX], lam[PX], c1[PX], c2[PX], c3[PX], bias[PX],
      gain[PX];
  load_px(a.cum_in + at, vec, n, cum);
  load_px(a.add + at, vec, n, add);
  load_px(a.bg_rate + at, vec, n, lam);
  if (a.flags & F_NONLIN) {
    load_px(a.nl + p0, vec, n, c1);
    load_px(a.nl + plane + p0, vec, n, c2);
    load_px(a.nl + 2 * plane + p0, vec, n, c3);
  }
  if (a.flags & F_BIAS) load_px(a.bias + p0, vec, n, bias);
  if (!(a.flags & F_SCALAR_GAIN)) load_px(a.inv_gain + p0, vec, n, gain);

  uint32_t pix[PX];
  float z_bg[PX], z_rn[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    pix[j] = p0 + j;
    z_bg[j] = z_rn[j] = 0.0f;
    if (bg_poisson || read_noise) normal_pair(k0, k1, rd, pix[j], &z_bg[j],
                                              &z_rn[j]);
    lam[j] = lam[j] * dt;
  }
  if (bg_poisson)
    poisson_sample_warp<PX, EXACT>(lam, z_bg, pix, k0, k1, rd,
                                   TAG_BG_UNIFORM, threadIdx.x,
                                   s_queue[threadIdx.y], lam);
  float dn[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    cum[j] = (cum[j] + add[j]) + lam[j];
    float sig = cum[j];
    if (a.flags & F_NONLIN) sig = nonlin(sig, a.fw, a.inv_fw, c1[j], c2[j],
                                         c3[j]);
    if (a.flags & F_BIAS) sig = sig + bias[j];
    if (read_noise) sig = sig + a.rn * z_rn[j];
    dn[j] = sig * ((a.flags & F_SCALAR_GAIN) ? a.inv_gain_scalar : gain[j]);
  }
  if (vec) {
    *reinterpret_cast<float4*>(a.cum_out + at) =
        make_float4(cum[0], cum[1], cum[2], cum[3]);
    __stcs(reinterpret_cast<float4*>(a.dn + at),
           make_float4(dn[0], dn[1], dn[2], dn[3]));
  } else {
    for (int j = 0; j < n; ++j) {   // the frame's last columns, or S % 4
      a.cum_out[at + j] = cum[j];
      __stcs(a.dn + at + j, dn[j]);
    }
  }
}

template <bool EXACT>
int launch_banded(const StepArgs& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        read_step_banded_kernel<EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int h = (a.flags & F_IPC) ? 1 : 0;
  const int tw = BX - 2 * h, th = TH - 2 * h;
  const dim3 grid((a.S + tw - 1) / tw, (a.S + th - 1) / th, a.B);
  read_step_banded_kernel<EXACT><<<grid, dim3(BX, BY), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool EXACT>
int launch_full_frame(const StepArgs& a, cudaStream_t stream) {
  const dim3 grid((a.S + PX * BX - 1) / (PX * BX), (a.S + BY - 1) / BY, a.B);
  read_step_kernel<EXACT><<<grid, dim3(BX, BY), 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
             rn, fw, inv_fw, inv_gain_scalar, ipc_alpha, flags, false};
  const size_t smem = banded_smem(n_cr, flags);
  const auto st = static_cast<cudaStream_t>(stream);
  return (flags & F_EXACT_POISSON) ? launch_banded<true>(a, smem, st)
                                   : launch_banded<false>(a, smem, st);
}

extern "C" int wayne_read_step(
    const int* seed, const float* dt, const float* cum_in, const float* add,
    const float* bg_rate, const float* bias, const float* inv_gain,
    const float* nl, float* cum_out, float* dn, int B, int S, int read,
    float rn, float fw, float inv_fw, float inv_gain_scalar, int flags,
    void* stream) {
  StepArgs a{seed, nullptr, dt, cum_in, nullptr, add, bg_rate, bias,
             inv_gain, nl, nullptr, nullptr, cum_out, dn, B, 0, S, 0, read,
             rn, fw, inv_fw, inv_gain_scalar, 0.0f, flags, false};
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  // every 4-pixel group starts 16-byte aligned in every plane
  a.vec = S % PX == 0 && aligned(cum_in) && aligned(add) &&
          aligned(bg_rate) && aligned(bias) && aligned(inv_gain) &&
          aligned(nl) && aligned(cum_out) && aligned(dn);
  const auto st = static_cast<cudaStream_t>(stream);
  return (flags & F_EXACT_POISSON) ? launch_full_frame<true>(a, st)
                                   : launch_full_frame<false>(a, st);
}
