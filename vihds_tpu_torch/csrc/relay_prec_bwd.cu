// relay_prec_bwd: reverse sweep of the fused fixed-grid
// relay_constant_precisions integration on Hopper, the backward of
// relay_prec_fwd.cu.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "relay_prec": _make_bwd_kernel, launched by _integrate_padded_w_bwd
// (pallas_ode.py:500). Given the stored forward trajectory and its cotangent g
// it walks the grid backwards, pulling the adjoint through each step's
// pullback, and returns the cotangents of the 29 per-row constants and of y0,
// and of the precision nets' weight matrix, summed over every row and step. The
// kernel is dr_common.cuh's prec_bwd_kernel over Relay: a block of 32 rows x 5
// warps, a warp for each of the four precision states and one for the species,
// meeting at each point of a step through shared tiles; the right-hand side's
// pullback is written out by hand there (relay_rhs_vjp, CoreWarp and PrecWarp).
//
// Layout (the wrapper fused_ode.kind_bwd checks it):
//   (R = F x Rf sample rows, fold-major; F = 1 is one fold, the kernel's grid
//   is (blocks of a fold, F): see dr_common.cuh)
//   wmat   [F, 8, 14] the precision nets' weights of each of F folds: rows
//                     0..3 production, 4..7 degradation, column 0 the bias
//   consts [29, R]    per-row constants in RELAY_CONST_NAMES order
//   times  [T]        the time grid (it gets no cotangent)
//   traj   [T, 16, R] the forward trajectory, traj[0] = y0
//   g      [T, 16, R] cotangent of the trajectory
//   dw     [F, n_blocks, 8, 14]  out: each 32-row block's partial sum of dW
//   dc     [29, R]    out: cotangent of the constants
//   dy0    [16, R]    out: cotangent of y0
//
// Bound on an H100 SXM (3.35 TB/s): at the training shape B=36, K=200 (R =
// 7,200), T = 99: traj and g, 2 * 99*16*7,200*4 B = 91.2 MB, plus 0.84 MB of
// constants read and 1.30 MB of dc and dy0 written: 93.4 MB, >= 27.9 us. The
// operation count per step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int relay_prec_bwd_launch(const float* wmat, const float* consts, const float* times,
                                     const float* traj, const float* g, float* dw, float* dc,
                                     float* dy0, int R, int T, int method, int folds,
                                     void* stream) {
  return bwd_launch<Relay, true>(wmat, consts, times, traj, g, dw, dc, dy0, R, T, method,
                                 stream, folds);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int relay_prec_bwd_block(int method, int* rows, int* threads, int* smem_bytes,
                                    int* registers, int* blocks_per_sm) {
  return bwd_block<Relay, true>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
