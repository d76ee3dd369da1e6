// relay_bwd: reverse sweep of the fused fixed-grid relay_constant integration
// on Hopper, the backward of relay_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind "relay":
// _make_bwd_kernel, launched by _integrate_padded_bwd (pallas_ode.py:443).
// Given the stored forward trajectory and its cotangent g it walks the grid
// backwards, pulling the adjoint through each step's pullback, and returns the
// cotangents of the 29 per-row constants and of y0. The kernel is
// dr_common.cuh's bwd_kernel over Relay: a block of 32 rows x 2 warps (lane =
// row).  A stage warp runs ahead, forming each step's points and the terms
// that do not depend on the adjoint (the sigmoid, the divisions and sums of
// the right-hand side) into a ring of shared tiles; the pullback warp
// carries the adjoint and the constants' cotangents through each step's
// pullback over them.  The right-hand side's pullback is written out by hand
// there (relay_rhs_vjp).
//
// Layout (the wrapper fused_ode.kind_bwd checks it):
//   consts [29, R]    per-row constants in RELAY_CONST_NAMES order
//   times  [T]        the time grid (it gets no cotangent)
//   traj   [T, 12, R] the forward trajectory, traj[0] = y0
//   g      [T, 12, R] cotangent of the trajectory
//   dc     [29, R]    out: cotangent of the constants
//   dy0    [12, R]    out: cotangent of y0
//
// Bound on an H100 SXM (3.35 TB/s): at the training shape B=36, K=200 (R =
// 7,200), T = 99: traj and g, 2 * 99*12*7,200*4 B = 68.4 MB, plus 0.84 MB of
// constants read and 1.18 MB of dc and dy0 written: 70.5 MB, >= 21.0 us. The
// operation count per step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int relay_bwd_launch(const float* consts, const float* times, const float* traj,
                                const float* g, float* dc, float* dy0, int R, int T, int method,
                                void* stream) {
  return bwd_launch<Relay, false>(nullptr, consts, times, traj, g, nullptr, dc, dy0, R, T, method,
                                  stream);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int relay_bwd_block(int method, int* rows, int* threads, int* smem_bytes,
                               int* registers, int* blocks_per_sm) {
  return bwd_block<Relay, false>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
