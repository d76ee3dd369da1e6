// blackbox_fwd: fused fixed-grid integration of the black-box ODE of
// models/dr_blackbox.py on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_blackbox.py:
// _make_kernel, launched by _integrate_padded (pallas_blackbox.py:149). Each
// step runs the two nets of the right-hand side (NeuralStates and
// NeuralPrecisions, 1,760 shared weights) per sample row; the kernel is
// blackbox_common.cuh's bb::fwd_kernel.
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
//
// The design works at that bound's terms.  A block is the backward's, 32 rows
// x 8 warps, each warp one slice of the nets' 45 hidden units, so at the
// training shape (R = 7,200) its 225 blocks reach every SM with 8-16 warps,
// and three blocks fit on an SM (at most 80 registers a thread, 18,496 B of
// shared memory).  The weights are staged in the order each thread reads
// them, so one 16-byte broadcast load feeds four multiply-adds; the output
// sums are taken four rows a thread, so one 16-byte load of a unit feeds
// four more.  The price: two barriers a stage, the hidden units and sigmoids
// passed through shared memory, and the state update repeated by all eight
// threads of a row.  What holds it now is issue and shared-load throughput:
// on an H100 at K=200 the hidden layers and the output sums take about a
// third of the time each (tools/blackbox_bwd_compare.py --direction fwd);
// the barriers cost nothing measurable.

#include "blackbox_common.cuh"

// Device pointers of contiguous float32 tensors; stream is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success); a bad method or shape
// returns cudaErrorInvalidValue without launching.
extern "C" int blackbox_fwd_launch(const float* wflat, const float* consts, const float* y0,
                                   const float* times, float* out, int R, int T, int method,
                                   void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + bb::FWD_ROWS - 1) / bb::FWD_ROWS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      bb::fwd_kernel<MODEULER><<<grid, bb::FWD_THREADS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case MIDPOINT:
      bb::fwd_kernel<MIDPOINT><<<grid, bb::FWD_THREADS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case RK4:
      bb::fwd_kernel<RK4><<<grid, bb::FWD_THREADS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The block of method's kernel: its threads, its shared memory in bytes (all
// of it static) and how many such blocks one SM holds at once.  Returns the
// cudaError_t of the query (0 on success).
template <int METHOD>
static int block_of(int* threads, int* smem_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, bb::fwd_kernel<METHOD>);
  if (err != cudaSuccess) return (int)err;
  *threads = bb::FWD_THREADS;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bb::fwd_kernel<METHOD>,
                                                            bb::FWD_THREADS, 0);
}

extern "C" int blackbox_fwd_block(int method, int* threads, int* smem_bytes, int* blocks_per_sm) {
  switch (method) {
    case MODEULER:
      return block_of<MODEULER>(threads, smem_bytes, blocks_per_sm);
    case MIDPOINT:
      return block_of<MIDPOINT>(threads, smem_bytes, blocks_per_sm);
    case RK4:
      return block_of<RK4>(threads, smem_bytes, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
