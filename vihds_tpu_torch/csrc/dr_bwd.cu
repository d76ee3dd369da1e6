// dr_bwd: reverse sweep of the fused fixed-grid dr_constant integration on
// Hopper, the backward of dr_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind "dr":
// _make_bwd_kernel, launched by _integrate_padded_bwd (pallas_ode.py:443).
// Given the stored forward trajectory and its cotangent g it walks the grid
// backwards, pulling the adjoint through each step's pullback, and returns the
// cotangents of the 23 per-row constants and of y0. The kernel is
// dr_common.cuh's bwd_kernel over Dr: a block of 32 rows x 2 warps (lane =
// row).  A stage warp runs ahead, forming each step's points and the terms
// that do not depend on the adjoint (the sigmoid, the divisions and sums of
// the right-hand side) into a ring of shared tiles; the pullback warp
// carries the adjoint and the constants' cotangents through each step's
// pullback over them.  The right-hand side's pullback is written out by hand
// there (dr_rhs_vjp).
//
// Layout (the wrapper fused_ode.kind_bwd checks it):
//   consts [23, R]    per-row constants in DR_CONST_NAMES order
//   times  [T]        the time grid (it gets no cotangent)
//   traj   [T, 8, R] the forward trajectory, traj[0] = y0
//   g      [T, 8, R] cotangent of the trajectory
//   dc     [23, R]    out: cotangent of the constants
//   dy0    [8, R]    out: cotangent of y0
//
// Bound on an H100 SXM (3.35 TB/s): at the training shape B=36, K=200 (R =
// 7,200), T = 86: traj and g, 2 * 86*8*7,200*4 B = 39.6 MB, plus 0.66 MB of
// constants read and 0.89 MB written: ~41 MB, >= 12 us. The operation count per
// step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int dr_bwd_launch(const float* consts, const float* times, const float* traj,
                             const float* g, float* dc, float* dy0, int R, int T, int method,
                             void* stream) {
  return bwd_launch<Dr, false>(nullptr, consts, times, traj, g, nullptr, dc, dy0, R, T, method,
                               stream);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int dr_bwd_block(int method, int* rows, int* threads, int* smem_bytes,
                            int* registers, int* blocks_per_sm) {
  return bwd_block<Dr, false>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
