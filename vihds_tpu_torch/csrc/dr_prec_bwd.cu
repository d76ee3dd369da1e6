// Reverse sweep of the fused fixed-grid dr_constant_precisions integration
// on Hopper: the backward of csrc/dr_prec_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "dr_prec": _make_bwd_kernel, launched by _integrate_padded_w_bwd (the
// custom VJP of _integrate_padded_w).  It computes the same thing: given the
// stored forward trajectory and its cotangent g, walk the grid backwards,
// pulling the adjoint a through each step's VJP, and return the cotangents
// of the 23 per-row constants, of y0, and of the precision nets' shared
// weight matrix, summed over every row and step.  The TPU kernel traced
// jax.vjp of the step; here the precision block's pullback is written out by
// hand (prec_rhs_vjp in dr_common.cuh, beside dr_rhs_vjp for the species),
// and its plain PyTorch twin _prec_rhs_vjp_cols is held against
// torch.autograd and jax.grad on the CPU.
//
// Layout (the wrapper fused_ode.dr_prec_bwd checks it):
//   wmat   [8, 10]            the weight matrix (dr_prec_fwd.cu)
//   consts [23, R]            per-row constants in DR_CONST_NAMES order
//   times  [T]                the time grid (it gets no cotangent)
//   traj   [T, 12, R]         the forward trajectory, traj[0] = y0
//   g      [T, 12, R]         cotangent of the trajectory
//   dw     [n_blocks, 8, 10]  out: each block's partial sum of dW
//   dc     [23, R]            out: cotangent of the constants
//   dy0    [12, R]            out: cotangent of y0
//
// Design: dr_bwd.cu's sweep, one thread per sample row in 32-thread blocks
// (225 blocks at the training shape R = 7,200, so every SM holds a warp),
// constants, their cotangents and the adjoint in registers, traj and g read
// coalesced once each.  What is new is dW, one [8, 10] sum over all rows
// and steps:
//   * each thread accumulates its own 80 partials over the whole sweep in a
//     column of the block's shared [80][32] array (10 KB), not in registers,
//     which dr_bwd's sweep already fills; column-per-thread keeps the 32
//     threads of a warp on 32 banks;
//   * the block then sums its 32 columns in a fixed order and writes one
//     [8, 10] partial; the wrapper sums the n_blocks partials.  No float
//     atomics anywhere, so two runs give the same dW bit for bit, as the
//     TPU kernel's per-cell partials summed on the host (pallas_ode.py:533);
//   * threads past the edge (r >= R) zero their column and skip the sweep,
//     so they add exact zeros and read no uninitialised shared memory; they
//     stay in the block for its barriers.  (The TPU kernel padded with
//     constants of 1 so that padded lanes stayed finite, pallas_ode.py:551-557.)
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), at the training
// shape B=36, K=200 (R = 7,200), T = 86: traj and g, 2 * 86*12*7,200*4 B =
// 59.4 MB, plus 0.66 MB of constants read and 1.0 MB of dc and dy0 written:
// 61.1 MB, >= 18.2 us.  The arithmetic is ~750 flop per right-hand side
// pullback (157 species, ~590 precision block) and ~1,850 per midpoint step:
// 1.1 GFLOP, 17 us, close to the memory bound; rk4 (~4,000 per step) is
// bound by its operations.  In practice it is latency-bound, as dr_bwd is.
//
// Numerics as stated in dr_common.cuh.

#include "dr_common.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int S = N_SPECIES + N_PREC;

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
dr_prec_bwd_kernel(const float* __restrict__ wmat, const float* __restrict__ consts,
                   const float* __restrict__ times, const float* __restrict__ traj,
                   const float* __restrict__ g, float* __restrict__ dw_out,
                   float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  __shared__ float W[N_W];
  __shared__ float dWs[N_W * THREADS];  // [80][THREADS]: column tid is thread tid's
  const int tid = threadIdx.x;
  for (int e = tid; e < N_W; e += THREADS) W[e] = wmat[e];
#pragma unroll 4
  for (int e = 0; e < N_W; ++e) dWs[e * THREADS + tid] = 0.0f;
  __syncthreads();

  const int r = blockIdx.x * THREADS + tid;
  if (r < R) {
    const size_t stride = (size_t)R;
    const size_t tstride = (size_t)S * stride;

    float c[N_CONST], dc[N_CONST];
#pragma unroll
    for (int j = 0; j < N_CONST; ++j) {
      c[j] = consts[j * stride + r];
      dc[j] = 0.0f;
    }
    const DrPrecRhs rhs{c, W};
    const DrPrecVjp<THREADS> vjp{c, dc, W, dWs + tid};

    float a[S];
    const float* gT = g + (size_t)(T - 1) * tstride + r;
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = gT[s * stride];

    float t2 = __ldg(times + (T - 1));
    for (int i = T - 2; i >= 0; --i) {
      const float t1 = __ldg(times + i);
      const float* yi = traj + (size_t)i * tstride + r;
      const float* gi = g + (size_t)i * tstride + r;
      float y[S];
#pragma unroll
      for (int s = 0; s < S; ++s) y[s] = yi[s * stride];
      step_vjp<METHOD, S>(rhs, vjp, t1, t2, y, a);
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] += gi[s * stride];
      t2 = t1;
    }

#pragma unroll
    for (int j = 0; j < N_CONST; ++j) dc_out[j * stride + r] = dc[j];
#pragma unroll
    for (int s = 0; s < S; ++s) dy0_out[s * stride + r] = a[s];
  }

  // the block's partial sum of dW, each entry summed over the 32 columns in
  // thread order
  __syncthreads();
  for (int e = tid; e < N_W; e += THREADS) {
    float sum = 0.0f;
    for (int i = 0; i < THREADS; ++i) sum += dWs[e * THREADS + i];
    dw_out[(size_t)blockIdx.x * N_W + e] = sum;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// of contiguous float32 tensors; ``dw`` holds ceil(R / 32) partials of
// [8, 10]; ``stream`` is a cudaStream_t.  Returns the cudaError_t of the
// launch (0 on success); a bad ``method`` or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int dr_prec_bwd_launch(const float* wmat, const float* consts, const float* times,
                                  const float* traj, const float* g, float* dw, float* dc,
                                  float* dy0, int R, int T, int method, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(THREADS);
  const dim3 grid((unsigned)((R + THREADS - 1) / THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      dr_prec_bwd_kernel<MODEULER><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc,
                                                          dy0, R, T);
      break;
    case MIDPOINT:
      dr_prec_bwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc,
                                                          dy0, R, T);
      break;
    case RK4:
      dr_prec_bwd_kernel<RK4><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc, dy0,
                                                     R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
