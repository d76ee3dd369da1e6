// blackbox_bwd: reverse sweep of the fused black-box integration on Hopper,
// the backward of blackbox_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_blackbox.py:
// _make_bwd_kernel, launched by _integrate_padded_bwd
// (pallas_blackbox.py:176). Given the stored trajectory and its cotangent g it
// walks the grid backwards, recomputing each step's stages and pulling the
// adjoint through the right-hand side's hand-derived pullback
// (blackbox_common.cuh's bb::Vjp), and returns the cotangents of the 21
// per-row constants and of y0, and of the 1,760 shared weights summed over
// every row and step. The TPU kernel summed each grid cell's weight
// cotangents on the host; here each 32-row block reduces its rows' shares
// through a shared tile after every pullback, in a fixed order without
// atomics, and writes one partial (see blackbox_common.cuh), which the
// wrapper sums: two runs give the same dW bit for bit.
//
// Layout (the wrapper fused_blackbox.blackbox_bwd checks it):
//   wflat  [1760]          the weights, as blackbox_fwd.cu
//   consts [21, R]         per-row constants
//   times  [T]             the time grid (it gets no cotangent)
//   traj   [T, 10, R]      the forward trajectory
//   g      [T, 10, R]      cotangent of the trajectory
//   dw     [n_blocks, 1760] out: each 32-row block's partial sum of dW
//   dc     [21, R]         out: cotangent of the constants
//   dy0    [10, R]         out: cotangent of y0
//
// Bound on an H100 SXM (67 TFLOP/s f32): the function needs, per midpoint
// step and row, each stage's right-hand side once (2 x 3,600 flops) and one
// pullback through each stage given its activations (2 x 6,940: 3,485 for
// the cotangents through both nets, 3,455 for the weights' share), 21,152
// flops with the state updates. At the training shape (B=36, K=200: R =
// 7,200, T = 86) that is 12.9 GFLOP, >= 0.19 ms; traj and g (2 x 24.8 MB)
// take >= 0.015 ms. So the operations bound it; chip_smoke.py counts them
// (bb_flops, bb_step_flops). This kernel does more than that: each pullback
// recomputes its stage's activations, so a midpoint step evaluates the nets
// three times, not two.

#include "blackbox_common.cuh"

// Device pointers of contiguous float32 tensors (dw holds ceil(R / 32)
// partials of [1760]); stream is a cudaStream_t.  Returns the cudaError_t of
// the launch (0 on success); a bad method or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int blackbox_bwd_launch(const float* wflat, const float* consts, const float* times,
                                   const float* traj, const float* g, float* dw, float* dc,
                                   float* dy0, int R, int T, int method, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(bb::BWD_ROWS);
  const dim3 grid((unsigned)((R + bb::BWD_ROWS - 1) / bb::BWD_ROWS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      bb::bwd_kernel<MODEULER><<<grid, block, 0, s>>>(wflat, consts, times, traj, g, dw, dc,
                                                      dy0, R, T);
      break;
    case MIDPOINT:
      bb::bwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(wflat, consts, times, traj, g, dw, dc,
                                                      dy0, R, T);
      break;
    case RK4:
      bb::bwd_kernel<RK4><<<grid, block, 0, s>>>(wflat, consts, times, traj, g, dw, dc, dy0, R,
                                                 T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
