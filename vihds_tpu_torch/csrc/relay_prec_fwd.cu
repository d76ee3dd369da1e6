// relay_prec_fwd: fused fixed-grid forward integration of the
// relay_constant_precisions ODE (16 states, the last 4 the learned precisions,
// 29 per-row constants) on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "relay_prec": _make_kernel with the _with_precisions right-hand side,
// launched by _integrate_padded_w (pallas_ode.py:474). It computes the same
// thing: y(t0) = y0, then T-1 fixed-grid steps of modeuler / midpoint / rk4 of
// the right-hand side, storing every state. The kernel is dr_common.cuh's
// prec_fwd_kernel over Relay: a block of 32 rows x 5 warps, one for the
// species, which runs ahead, and one for each of the four precision states, fed
// each point's features through a ring of shared tiles.
//
// Layout (the wrapper vihds_tpu_torch/ops/fused_ode.py packs and checks it):
//   wmat   [8, 14]    the precision nets' weights: rows 0..3 production,
//                     4..7 degradation, column 0 the bias
//   consts [29, R]    per-row constants in RELAY_CONST_NAMES order
//   y0     [16, R]    initial state, state-major
//   times  [T]        the time grid
//   out    [T, 16, R] trajectory; out[0] = y0
//
// Bound on an H100 SXM (3.35 TB/s): at the serving chunk B=36, K=1000 (R =
// 36,000), T = 99: it writes 99*16*36,000*4 B = 228.1 MB and reads 6.5 MB of
// constants and y0: 234.6 MB, >= 70.0 us of memory traffic. The operation count
// per step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int relay_prec_fwd_launch(const float* wmat, const float* consts, const float* y0,
                                     const float* times, float* out, int R, int T, int method,
                                     void* stream) {
  return fwd_launch<Relay, true>(wmat, consts, y0, times, out, R, T, method, stream);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int relay_prec_fwd_block(int method, int* rows, int* threads, int* smem_bytes,
                                    int* registers, int* blocks_per_sm) {
  return prec_fwd_block<Relay>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
