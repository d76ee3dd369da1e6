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
// right-hand side is written out by hand (dr_rhs_vjp in dr_common.cuh), and
// its plain PyTorch twin is _dr_rhs_vjp_cols in
// vihds_tpu_torch/ops/fused_ode.py, which the CPU tests hold against
// torch.autograd and jax.grad.
//
// Layout (the wrapper fused_ode.dr_bwd checks it):
//   consts [23, R]    per-row constants in DR_CONST_NAMES order (DrConst, dr_common.cuh)
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
// The derivatives are noted at dr_rhs_vjp in dr_common.cuh; midpoint's
// second stage is evaluated at t1 + h/2, rk4's middle two too.
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
// Numerics as stated in dr_common.cuh.

#include "dr_common.cuh"

namespace {

constexpr int THREADS = 32;

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
  const DrRhs rhs{c};
  const DrVjp vjp{c, dc};

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
    step_vjp<METHOD, N_SPECIES>(rhs, vjp, t1, t2, y, a);
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
