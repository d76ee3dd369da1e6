// blackbox_fwd: fused fixed-grid integration of the black-box ODE of
// models/dr_blackbox.py on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_blackbox.py:
// _make_kernel, launched by _integrate_padded (pallas_blackbox.py:149). Each
// step runs the two nets of the right-hand side (NeuralStates and
// NeuralPrecisions, 1,760 shared weights) per sample row; the kernel is
// blackbox_common.cuh's bb::fwd_kernel: one thread per row, the weights in
// shared memory (read by broadcast), the row's 21 constants and 10 states in
// registers for the whole time loop.
//
// Layout (the wrapper fused_blackbox.blackbox_fwd checks it):
//   wflat  [1760]       the 12 weight leaves of WEIGHT_LEAVES, row-major, concatenated
//   consts [21, R]      per-row constants [z1..5, x1..5, y1..2, treatments, device one-hot]
//   y0     [10, R]      initial states: 4 observed, 2 latent species, 4 precisions
//   times  [T]          the time grid
//   out    [T, 10, R]   the trajectory, out[0] = y0
//
// Bound on an H100 SXM (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): one
// right-hand side is 3,600 flops per row (3,390 of them the layers'
// multiply-adds; the rest biases, relus, 20 sigmoids at 4 and the outputs).
// At the serving chunk (B=36, K=1000: R = 36,000, T = 86, midpoint: two
// right-hand sides and the state updates, 7,243 flops a step) that is 22.2
// GFLOP, >= 0.33 ms; the trajectory it writes, 124 MB, takes >= 0.037 ms. So
// the operations bound it; chip_smoke.py counts them (bb_flops,
// bb_step_flops) and computes the bound from each run's shapes.

#include "blackbox_common.cuh"

// Device pointers of contiguous float32 tensors; stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success); a bad method or shape
// returns cudaErrorInvalidValue without launching.
extern "C" int blackbox_fwd_launch(const float* wflat, const float* consts, const float* y0,
                                   const float* times, float* out, int R, int T, int method,
                                   void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(bb::FWD_THREADS);
  const dim3 grid((unsigned)((R + bb::FWD_THREADS - 1) / bb::FWD_THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      bb::fwd_kernel<MODEULER><<<grid, block, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case MIDPOINT:
      bb::fwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case RK4:
      bb::fwd_kernel<RK4><<<grid, block, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
