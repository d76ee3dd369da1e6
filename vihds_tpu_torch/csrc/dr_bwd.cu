// Reverse sweep of the fused fixed-grid dr_constant integration on Hopper:
// the backward of csrc/dr_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind "dr":
// _make_bwd_kernel, launched by _integrate_padded_bwd (the custom VJP of
// _integrate_padded).  It computes the same thing: given the stored forward
// trajectory and its cotangent g, walk the grid backwards, pulling the
// adjoint a through each step's VJP, and return the cotangents of the 23
// per-row constants and of y0.  The TPU kernel got each step's VJP by
// tracing jax.vjp of _one_step inside the kernel; here the VJP of the
// right-hand side is written out by hand (dr_rhs_vjp below), and its plain
// PyTorch twin is _dr_rhs_vjp_cols in vihds_tpu_torch/ops/fused_ode.py,
// which the CPU tests hold against torch.autograd and jax.grad.
//
// Layout (the wrapper fused_ode.dr_bwd checks it):
//   consts [23, R]    per-row constants in DR_CONST_NAMES order (enum below)
//   times  [T]        the time grid (it gets no cotangent)
//   traj   [T, 8, R]  the forward trajectory, traj[0] = y0
//   g      [T, 8, R]  cotangent of the trajectory
//   dc     [23, R]    out: cotangent of the constants
//   dy0    [8, R]     out: cotangent of y0
//
// Design: one thread per sample row.  The 23 constants load into registers
// once, 23 dc accumulators start at zero and the adjoint at a = g[T-1].  For
// i = T-2 ... 0 the thread reads y_i = traj[i, :, r], recomputes the step's
// stages from it, pulls a back through them (adding the constants' share into
// dc), and sets a = a_y + g[i].  Nothing but the two [T, 8, R] inputs is
// read from device memory, and each read traj[i, s, r] / g[i, s, r] of a warp
// covers 32 consecutive floats, so every load coalesces.  Blocks are 32
// threads: at the training shape R = 7,200 that is 225 blocks, so every one
// of the 132 SMs holds at least one warp (128-thread blocks would leave 75
// SMs idle).
//
// Derivatives (the same notes stand in _dr_rhs_vjp_cols):
//   gr = r s, s = sigmoid(4 (t - tlag))          dgr/dtlag = -4 r s (1 - s)
//   gamma = gr (1 - x/K)                         dgamma/dx = -gr/K, dgamma/dK = gr x/K^2
//   P = (e + A)/(1 + A), A = KGR bL + KGS bS     dP/dA = (1 - e)/(1 + A)^2, dP/de = 1/(1 + A)
//   bL = luxR^2 fracLuxR (bS likewise)           the gradient reaches fracLuxR / fracLasR
//   midpoint's second stage is evaluated at t1 + h/2, rk4's middle two too.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), at the training
// shape B=36, K=200 (R = 7,200), T = 86: the kernel reads traj and g,
// 2 * 86*8*7,200*4 B = 39.6 MB, plus 0.66 MB of constants, and writes
// 0.89 MB: ~41 MB, >= 12 us of memory traffic.  The arithmetic is about
// three times the forward's (a right-hand side and its pullback per stage):
// 431 flop per row per step for midpoint, 0.26 GFLOP, ~4 us.  So it is bound
// by bytes on paper, and by latency in practice: 7,200 threads are under two
// warps per SM, with a long dependent chain per step.  A faster schedule is
// later work.
//
// Numerics: precise expf and IEEE division, as in dr_fwd.cu; the expression
// order follows _dr_rhs_vjp_cols, and the compiler may contract a*b+c into
// FMAs, which the comparison with the plain version allows for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Packed constant rows, in vihds_tpu_torch/ops/fused_ode.py DR_CONST_NAMES order.
enum DrConst {
  C_r = 0,
  C_K,
  C_tlag,
  C_rc,
  C_a530,
  C_a480,
  C_drfp,
  C_dyfp,
  C_dcfp,
  C_dR,
  C_dS,
  C_e76,
  C_e81,
  C_aCFP,
  C_aYFP,
  C_KGR_76,
  C_KGS_76,
  C_KGR_81,
  C_KGS_81,
  C_aR,
  C_aS,
  C_fracLuxR,
  C_fracLasR,
  N_CONST
};

constexpr int N_SPECIES = 8;
constexpr int THREADS = 32;

enum Method { MODEULER = 0, MIDPOINT = 1, RK4 = 2 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// dr_constant right-hand side (the same math and order as dr_fwd.cu's).
__device__ __forceinline__ void dr_rhs(const float* c, float t, const float* y, float* f) {
  const float x = y[0], rfp = y[1], yfp = y[2], cfp = y[3];
  const float f530 = y[4], f480 = y[5], luxR = y[6], lasR = y[7];
  const float gr = c[C_r] * sigmoidf(4.0f * (t - c[C_tlag]));
  const float gamma = gr * (1.0f - x / c[C_K]);
  const float boundLuxR = luxR * luxR * c[C_fracLuxR];
  const float boundLasR = lasR * lasR * c[C_fracLasR];
  const float denom76 = 1.0f + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR;
  const float denom81 = 1.0f + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR;
  const float P76 = (c[C_e76] + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR) / denom76;
  const float P81 = (c[C_e81] + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR) / denom81;
  const float rc = c[C_rc];
  f[0] = gamma * x;
  f[1] = rc - (gamma + c[C_drfp]) * rfp;
  f[2] = rc * c[C_aYFP] * P81 - (gamma + c[C_dyfp]) * yfp;
  f[3] = rc * c[C_aCFP] * P76 - (gamma + c[C_dcfp]) * cfp;
  f[4] = rc * c[C_a530] - gamma * f530;
  f[5] = rc * c[C_a480] - gamma * f480;
  f[6] = rc * c[C_aR] - (gamma + c[C_dR]) * luxR;
  f[7] = rc * c[C_aS] - (gamma + c[C_dS]) * lasR;
}

// Pullback of dr_rhs at (t, y): for the cotangent w of its output, writes
// dy = (df/dy)^T w and adds (df/dc)^T w into dc (line for line
// _dr_rhs_vjp_cols).
__device__ __forceinline__ void dr_rhs_vjp(const float* c, float t, const float* y,
                                           const float* w, float* dy, float* dc) {
  const float x = y[0], rfp = y[1], yfp = y[2], cfp = y[3];
  const float f530 = y[4], f480 = y[5], luxR = y[6], lasR = y[7];
  // forward intermediates, recomputed
  const float sig = sigmoidf(4.0f * (t - c[C_tlag]));
  const float gr = c[C_r] * sig;
  const float omx = 1.0f - x / c[C_K];
  const float gamma = gr * omx;
  const float luxR2 = luxR * luxR;
  const float lasR2 = lasR * lasR;
  const float boundLuxR = luxR2 * c[C_fracLuxR];
  const float boundLasR = lasR2 * c[C_fracLasR];
  const float denom76 = 1.0f + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR;
  const float denom81 = 1.0f + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR;
  const float P76 = (c[C_e76] + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR) / denom76;
  const float P81 = (c[C_e81] + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR) / denom81;
  const float rc = c[C_rc];
  // pull w back through the eight outputs
  const float dgamma = w[0] * x - w[1] * rfp - w[2] * yfp - w[3] * cfp - w[4] * f530 -
                       w[5] * f480 - w[6] * luxR - w[7] * lasR;
  const float dP81 = w[2] * rc * c[C_aYFP];
  const float dP76 = w[3] * rc * c[C_aCFP];
  dc[C_rc] += w[1] + w[2] * c[C_aYFP] * P81 + w[3] * c[C_aCFP] * P76 + w[4] * c[C_a530] +
              w[5] * c[C_a480] + w[6] * c[C_aR] + w[7] * c[C_aS];
  dc[C_aYFP] += w[2] * rc * P81;
  dc[C_aCFP] += w[3] * rc * P76;
  dc[C_a530] += w[4] * rc;
  dc[C_a480] += w[5] * rc;
  dc[C_aR] += w[6] * rc;
  dc[C_aS] += w[7] * rc;
  dc[C_drfp] -= w[1] * rfp;
  dc[C_dyfp] -= w[2] * yfp;
  dc[C_dcfp] -= w[3] * cfp;
  dc[C_dR] -= w[6] * luxR;
  dc[C_dS] -= w[7] * lasR;
  // P = (e + A) / (1 + A)
  const float dA76 = dP76 * (1.0f - c[C_e76]) / (denom76 * denom76);
  const float dA81 = dP81 * (1.0f - c[C_e81]) / (denom81 * denom81);
  dc[C_e76] += dP76 / denom76;
  dc[C_e81] += dP81 / denom81;
  dc[C_KGR_76] += dA76 * boundLuxR;
  dc[C_KGS_76] += dA76 * boundLasR;
  dc[C_KGR_81] += dA81 * boundLuxR;
  dc[C_KGS_81] += dA81 * boundLasR;
  const float dbL = dA76 * c[C_KGR_76] + dA81 * c[C_KGR_81];
  const float dbS = dA76 * c[C_KGS_76] + dA81 * c[C_KGS_81];
  dc[C_fracLuxR] += dbL * luxR2;
  dc[C_fracLasR] += dbS * lasR2;
  // gamma = gr (1 - x/K), gr = r sig
  const float dgr = dgamma * omx;
  dc[C_K] += dgamma * gr * x / (c[C_K] * c[C_K]);
  dc[C_r] += dgr * sig;
  dc[C_tlag] -= 4.0f * dgr * c[C_r] * sig * (1.0f - sig);
  dy[0] = w[0] * gamma - dgamma * gr / c[C_K];
  dy[1] = -w[1] * (gamma + c[C_drfp]);
  dy[2] = -w[2] * (gamma + c[C_dyfp]);
  dy[3] = -w[3] * (gamma + c[C_dcfp]);
  dy[4] = -w[4] * gamma;
  dy[5] = -w[5] * gamma;
  dy[6] = 2.0f * dbL * luxR * c[C_fracLuxR] - w[6] * (gamma + c[C_dR]);
  dy[7] = 2.0f * dbS * lasR * c[C_fracLasR] - w[7] * (gamma + c[C_dS]);
}

// Pullback of one fixed-grid step at y = y_i (line for line _step_vjp): a
// holds the cotangent of y_{i+1} on entry and that of y_i on exit; the
// constants' share is added into dc.  The stages are recomputed from y_i.
template <int METHOD>
__device__ __forceinline__ void step_vjp(const float* c, float t1, float t2, const float* y,
                                         float* a, float* dc) {
  const float h = t2 - t1;
  const float hh = 0.5f * h;
  float f1[N_SPECIES], z[N_SPECIES], w[N_SPECIES], dz[N_SPECIES], d1[N_SPECIES];
  if (METHOD == MODEULER) {
    // y' = y + hh (f1 + f2), f1 = F(t1, y), f2 = F(t2, y + h f1)
    dr_rhs(c, t1, y, f1);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) {
      z[s] = y[s] + h * f1[s];
      w[s] = hh * a[s];
    }
    dr_rhs_vjp(c, t2, z, w, dz, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) w[s] = hh * a[s] + h * dz[s];
    dr_rhs_vjp(c, t1, y, w, d1, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else if (METHOD == MIDPOINT) {
    // y' = y + h f2, f2 = F(t1 + hh, y + hh f1), f1 = F(t1, y)
    dr_rhs(c, t1, y, f1);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) {
      z[s] = y[s] + hh * f1[s];
      w[s] = h * a[s];
    }
    dr_rhs_vjp(c, t1 + hh, z, w, dz, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) w[s] = hh * dz[s];
    dr_rhs_vjp(c, t1, y, w, d1, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else {  // RK4: y' = y + h6 (k1 + 2 k2 + 2 k3 + k4), stage k_j = F(t_j, z_j)
    const float tm = t1 + hh;
    const float h6 = h / 6.0f;
    float z2[N_SPECIES], z3[N_SPECIES], k[N_SPECIES], d4[N_SPECIES], d3[N_SPECIES];
    dr_rhs(c, t1, y, k);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) z2[s] = y[s] + hh * k[s];
    dr_rhs(c, tm, z2, k);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) z3[s] = y[s] + hh * k[s];
    dr_rhs(c, tm, z3, k);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) {
      z[s] = y[s] + h * k[s];  // z4
      w[s] = h6 * a[s];
    }
    dr_rhs_vjp(c, t2, z, w, d4, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) w[s] = 2.0f * h6 * a[s] + h * d4[s];
    dr_rhs_vjp(c, tm, z3, w, d3, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) w[s] = 2.0f * h6 * a[s] + hh * d3[s];
    dr_rhs_vjp(c, tm, z2, w, dz, dc);  // d2
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) w[s] = h6 * a[s] + hh * dz[s];
    dr_rhs_vjp(c, t1, y, w, d1, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) a[s] = a[s] + d4[s] + d3[s] + dz[s] + d1[s];
  }
}

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
dr_bwd_kernel(const float* __restrict__ consts, const float* __restrict__ times,
              const float* __restrict__ traj, const float* __restrict__ g,
              float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t stride = (size_t)R;
  const size_t tstride = (size_t)N_SPECIES * stride;

  float c[N_CONST], dc[N_CONST];
#pragma unroll
  for (int j = 0; j < N_CONST; ++j) {
    c[j] = consts[j * stride + r];
    dc[j] = 0.0f;
  }

  float a[N_SPECIES];
  const float* gT = g + (size_t)(T - 1) * tstride + r;
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) a[s] = gT[s * stride];

  float t2 = __ldg(times + (T - 1));
  for (int i = T - 2; i >= 0; --i) {
    const float t1 = __ldg(times + i);
    const float* yi = traj + (size_t)i * tstride + r;
    const float* gi = g + (size_t)i * tstride + r;
    float y[N_SPECIES];
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) y[s] = yi[s * stride];
    step_vjp<METHOD>(c, t1, t2, y, a, dc);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) a[s] += gi[s * stride];
    t2 = t1;
  }

#pragma unroll
  for (int j = 0; j < N_CONST; ++j) dc_out[j * stride + r] = dc[j];
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) dy0_out[s * stride + r] = a[s];
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// of contiguous float32 tensors; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); a bad ``method`` or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int dr_bwd_launch(const float* consts, const float* times, const float* traj,
                             const float* g, float* dc, float* dy0, int R, int T, int method,
                             void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(THREADS);
  const dim3 grid((unsigned)((R + THREADS - 1) / THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      dr_bwd_kernel<MODEULER><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
      break;
    case MIDPOINT:
      dr_bwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
      break;
    case RK4:
      dr_bwd_kernel<RK4><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
