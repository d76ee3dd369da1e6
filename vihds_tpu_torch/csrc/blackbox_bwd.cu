// blackbox_bwd: reverse sweep of the fused black-box integration on Hopper,
// the backward of blackbox_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_blackbox.py:
// _make_bwd_kernel, launched by _integrate_padded_bwd
// (pallas_blackbox.py:176). Given the stored trajectory and its cotangent g it
// walks the grid backwards, evaluating each step's stages and pulling the
// adjoint through the right-hand side's hand-derived pullback, and returns
// the cotangents of the 21 per-row constants and of y0, and of the 1,760
// shared weights summed over every row and step. The TPU kernel summed each
// grid cell's weight cotangents on the host; here each block of BWD_ROWS
// (32) rows reduces its rows' shares through a shared tile after every
// pullback, in a fixed order without atomics, and writes one partial (see
// blackbox_common.cuh), which the wrapper sums: two runs give the same dW
// bit for bit.
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
// (bb_flops, bb_step_flops). The design works at that bound's terms: a block
// is 32 rows x 8 warps, each warp one slice of the 45 hidden units, so the
// 225 blocks at R = 7,200 put 8-16 warps on each SM (two blocks fit at 128
// registers a thread); each stage's activations are kept from its forward
// for its pullback, so the kernel evaluates the nets as often as the
// function does; the weights are staged in the order each thread reads
// them, one 16-byte broadcast load for four multiply-adds; and the weight
// cotangent, reduced after every pullback, is read four rows a load in
// strips that share their loads.  Shared-memory loads still bound it: at
// K=200 the reduction takes ~40 % of the kernel's time
// (tools/blackbox_bwd_compare.py --no-dw).

#include "blackbox_common.cuh"

// One method's launch; its block takes more than the 48 KB of shared memory
// a kernel gets unasked (bb::bwd_smem_bytes), so the launch asks first.
template <int METHOD>
static int launch(const float* wflat, const float* consts, const float* times, const float* traj,
                  const float* g, float* dw, float* dc, float* dy0, int R, int T,
                  cudaStream_t s) {
  constexpr int smem = bb::bwd_smem_bytes(METHOD);
  const cudaError_t err = cudaFuncSetAttribute(
      bb::bwd_kernel<METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((R + bb::BWD_ROWS - 1) / bb::BWD_ROWS));
  bb::bwd_kernel<METHOD><<<grid, bb::BWD_THREADS, smem, s>>>(wflat, consts, times, traj, g, dw,
                                                             dc, dy0, R, T);
  return (int)cudaGetLastError();
}

// Device pointers of contiguous float32 tensors (dw holds ceil(R / 32)
// partials of [1760]); stream is a cudaStream_t.  Returns the cudaError_t of
// the launch (0 on success); a bad method or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int blackbox_bwd_launch(const float* wflat, const float* consts, const float* times,
                                   const float* traj, const float* g, float* dw, float* dc,
                                   float* dy0, int R, int T, int method, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      return launch<MODEULER>(wflat, consts, times, traj, g, dw, dc, dy0, R, T, s);
    case MIDPOINT:
      return launch<MIDPOINT>(wflat, consts, times, traj, g, dw, dc, dy0, R, T, s);
    case RK4:
      return launch<RK4>(wflat, consts, times, traj, g, dw, dc, dy0, R, T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The block of method's kernel: its threads, its dynamic shared memory in
// bytes and how many such blocks one SM holds at once.  Returns the
// cudaError_t of the query (0 on success).
template <int METHOD>
static int block_of(int* threads, int* smem_bytes, int* blocks_per_sm) {
  *threads = bb::BWD_THREADS;
  *smem_bytes = bb::bwd_smem_bytes(METHOD);
  const cudaError_t err = cudaFuncSetAttribute(
      bb::bwd_kernel<METHOD>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bb::bwd_kernel<METHOD>,
                                                            bb::BWD_THREADS, *smem_bytes);
}

extern "C" int blackbox_bwd_block(int method, int* threads, int* smem_bytes, int* blocks_per_sm) {
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
