// The RECTE trap recurrence of a white light curve, and its forward-mode
// derivative, for NVIDIA Hopper (sm_90a): ops/recte.py's white_ramp at one
// illuminated rate a curve.
//
// It replaces no TPU kernel: the JAX package writes this recurrence as a
// lax.scan (wayne_tpu/ops/recte.py, _trap_scan), which XLA compiles into
// one loop. The port walked it as ~25 one-element torch operations an
// exposure, and torch.func.jacfwd carried the Levenberg-Marquardt fit's six
// tangents through each of them. Here one launch returns the ramp of every
// row, and, given a tangent of the rate and of the two initial fills for
// each row, the ramp's tangent. The autograd Function around it
// (ops/recte.py, _WhiteRamp) launches it once for the value and once, with
// the tangents of every direction as rows, in its jvp. Its plain PyTorch
// version is white_ramp_plain in ops/recte.py.
//
// What it computes, for each row b (rate r, initial fills f0_s, f0_f) and
// each trap population p in {s, f} (n traps, capture efficiency eta,
// release time tau), over the exposures k = 0 .. N-1 of exposure time dt:
//   gap_k = max((t_k - t_{k-1}) - dt, 0), gap_0 = 0
//   E    *= exp(-gap_k / tau)                     free decay over the gap
//   a = eta r, b = a / n + 1 / tau, E_inf = a / b, X = exp(-b dt)
//   E'    = E_inf + (E - E_inf) X                 constant illumination
//   deficit_k = (E'_s - E_s) + (E'_f - E_f)
//   ramp_k    = 1 - deficit_k / max(r dt, 1e-20)
// starting from E = f0 n. The tangent (TANGENT = true) follows each of those
// operations with the rule PyTorch's forward-mode autodiff applies to it
// (derivatives.yaml: a product u v gives u' v + u v', a quotient u / v gives
// (u' - v' (u / v)) / v, exp(u) gives u' exp(u)), in the same order, so it
// equals torch.func.jacfwd of the loop bit for bit, as the values equal the
// loop's: every operation is separately rounded (--fmad=false), expf and
// the division are the full-precision ones, and the constants arrive from
// the wrapper rounded to float32 as PyTorch rounds them on the card: a
// division by a Python float becomes a product with its float32 reciprocal,
// 1.0 / tau is a Python float.
//
// Bound and design. The work of a row is two dependent chains of N steps
// (~6 floating-point operations each, ~12 with the tangent) and ~2 KB of
// memory at the fitted visit's 86 exposures, so the bound on this card is
// the chain's latency, a few microseconds; bytes and operations are
// negligible. One warp a row keeps the whole recurrence on one SM: its
// lanes compute the gaps' decays, which do not depend on the state, into
// shared memory; then lanes 0 and 1 run the slow and the fast population's
// chains in registers, in lock step (a population's value and tangent
// depend on the rate and its own fill only), writing each step's change to
// shared memory; then every lane writes the ramp (and its tangent) of its
// exposures.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxExposures = 2048;      // 24 bytes of shared memory each

struct Population {
  float n;            // traps
  float eta;          // capture efficiency
  float inv_n;        // float32 reciprocal of n (a / n on the card)
  float inv_tau;      // 1.0 / tau rounded once
  float inv_tau_gap;  // float32 reciprocal of tau (gap / tau on the card)
};

struct Rows {
  const float* starts;   // (B, N)
  const float* rate;     // (B,)
  const float* f0_s;     // (B,)
  const float* f0_f;     // (B,)
  const float* t_rate;   // (B,) tangents, TANGENT only
  const float* t_f0_s;
  const float* t_f0_f;
  float* ramp;           // (B, N)
  float* d_ramp;         // (B, N), TANGENT only
  int N;
  float dt;
};

template <bool TANGENT>
__global__ void __launch_bounds__(32) recte_white_ramp_kernel(
    Rows a, Population slow, Population fast) {
  extern __shared__ float smem[];
  const int N = a.N;
  float* decay = smem;              // (2, N): slow, fast
  float* delta = smem + 2 * N;      // (2, 2, N): value, tangent
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* t = a.starts + static_cast<size_t>(b) * N;
  const float dt = a.dt;

  for (int k = lane; k < N; k += 32) {
    float gap = 0.0f;
    if (k > 0) {
      gap = (t[k] - t[k - 1]) - dt;
      gap = gap < 0.0f ? 0.0f : gap;          // clamp_min, NaN kept
    }
    decay[k] = expf(-gap * slow.inv_tau_gap);
    decay[N + k] = expf(-gap * fast.inv_tau_gap);
  }
  __syncwarp();

  const float r = a.rate[b];
  const float t_r = TANGENT ? a.t_rate[b] : 0.0f;
  if (lane < 2) {
    const Population P = lane == 0 ? slow : fast;
    const float* g = decay + lane * N;
    float* out = delta + lane * 2 * N;
    const float aa = P.eta * r;
    const float bb = aa * P.inv_n + P.inv_tau;
    const float e_inf = aa / bb;
    const float x = expf(-bb * dt);
    float e = (lane == 0 ? a.f0_s[b] : a.f0_f[b]) * P.n;
    float t_e = 0.0f, t_einf = 0.0f, t_x = 0.0f;
    if (TANGENT) {
      const float t_a = t_r * P.eta;
      const float t_b = t_a * P.inv_n;
      t_einf = (t_a - t_b * e_inf) / bb;
      t_x = (-t_b * dt) * x;
      t_e = (lane == 0 ? a.t_f0_s[b] : a.t_f0_f[b]) * P.n;
    }
    for (int k = 0; k < N; ++k) {
      e = e * g[k];
      const float d = e - e_inf;
      const float e_new = e_inf + d * x;
      out[k] = e_new - e;
      e = e_new;
      if (TANGENT) {
        t_e = t_e * g[k];
        const float t_new = t_einf + (t_x * d + (t_e - t_einf) * x);
        out[N + k] = t_new - t_e;
        t_e = t_new;
      }
    }
  }
  __syncwarp();

  const float fd = r * dt;
  const float D = fd < 1e-20f ? 1e-20f : fd;  // clamp_min, NaN kept
  const float t_D = fd >= 1e-20f ? t_r * dt : 0.0f;   // the clamp's slope
  const float* ds = delta;
  const float* df = delta + 2 * N;
  const size_t row = static_cast<size_t>(b) * N;
  for (int k = lane; k < N; k += 32) {
    const float q = (ds[k] + df[k]) / D;
    a.ramp[row + k] = 1.0f - q;
    if (TANGENT) {
      a.d_ramp[row + k] = -(((ds[N + k] + df[N + k]) - t_D * q) / D);
    }
  }
}

}  // namespace

// d_ramp and the three tangent pointers null: the value only.
extern "C" int wayne_recte_white_ramp(
    const float* starts, const float* rate, const float* f0_s,
    const float* f0_f, const float* t_rate, const float* t_f0_s,
    const float* t_f0_f, float* ramp, float* d_ramp, int B, int N, float dt,
    float n_s, float eta_s, float inv_n_s, float inv_tau_s,
    float inv_tau_gap_s, float n_f, float eta_f, float inv_n_f,
    float inv_tau_f, float inv_tau_gap_f, void* stream) {
  const bool tangent = d_ramp != nullptr;
  if (B < 1 || N < 1 || N > kMaxExposures ||
      (tangent && (!t_rate || !t_f0_s || !t_f0_f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows rows{starts, rate, f0_s, f0_f, t_rate, t_f0_s, t_f0_f,
                  ramp, d_ramp, N, dt};
  const Population slow{n_s, eta_s, inv_n_s, inv_tau_s, inv_tau_gap_s};
  const Population fast{n_f, eta_f, inv_n_f, inv_tau_f, inv_tau_gap_f};
  const size_t smem = sizeof(float) * 6 * static_cast<size_t>(N);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tangent) {
    recte_white_ramp_kernel<true><<<B, 32, smem, st>>>(rows, slow, fast);
  } else {
    recte_white_ramp_kernel<false><<<B, 32, smem, st>>>(rows, slow, fast);
  }
  return static_cast<int>(cudaGetLastError());
}
