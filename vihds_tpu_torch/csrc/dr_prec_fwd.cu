// dr_prec_fwd: fused fixed-grid forward integration of the
// dr_constant_precisions ODE (12 states, the last 4 the learned precisions, 23
// per-row constants) on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "dr_prec": _make_kernel with the _with_precisions right-hand side, launched
// by _integrate_padded_w (pallas_ode.py:474). It computes the same thing: y(t0)
// = y0, then T-1 fixed-grid steps of modeuler / midpoint / rk4 of the right-
// hand side, storing every state. The kernel is dr_common.cuh's prec_fwd_kernel
// over Dr: a block of 32 rows x 5 warps, one for the species, which runs ahead,
// and one for each of the four precision states, fed each point's features
// through a ring of shared tiles.
//
// Layout (the wrapper vihds_tpu_torch/ops/fused_ode.py packs and checks it):
//   (R = F x Rf sample rows, fold-major; F = 1 is one fold, the kernel's grid
//   is (blocks of a fold, F): see dr_common.cuh)
//   wmat   [F, 8, 10] the precision nets' weights of each of F folds: rows
//                     0..3 production, 4..7 degradation, column 0 the bias
//   consts [23, R]    per-row constants in DR_CONST_NAMES order
//   y0     [12, R]    initial state, state-major
//   times  [T]        the time grid
//   out    [T, 12, R] trajectory; out[0] = y0
//
// Bound on an H100 SXM (3.35 TB/s): at the serving chunk B=36, K=1000 (R =
// 36,000), T = 86: it writes 86*12*36,000*4 B = 148.6 MB and reads 5.0 MB of
// constants and y0: 153.6 MB, >= 45.9 us of memory traffic. The operation count
// per step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int dr_prec_fwd_launch(const float* wmat, const float* consts, const float* y0,
                                  const float* times, float* out, int R, int T, int method,
                                  int folds, void* stream) {
  return fwd_launch<Dr, true>(wmat, consts, y0, times, out, R, T, method, stream, folds);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int dr_prec_fwd_block(int method, int* rows, int* threads, int* smem_bytes,
                                 int* registers, int* blocks_per_sm) {
  return prec_fwd_block<Dr>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
