// degrader_fwd: fused fixed-grid forward integration of the degrader_constant
// ODE (11 states, 28 per-row constants) on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "degrader": _make_kernel, launched by _integrate_padded (pallas_ode.py:419).
// It computes the same thing: y(t0) = y0, then T-1 fixed-grid steps of modeuler
// / midpoint / rk4 of the right-hand side, storing every state. The kernel and
// the right-hand side are dr_common.cuh's (fwd_kernel over Degrader): a block of 32 rows x 3
// warps, lane l of each on row l, over which each row's species split in the
// order they depend on each other: a growth warp (x, which sets gamma), a
// regulator warp (LuxR and LasR, which set P76 and P81) and a reporter warp
// (the other species), meeting at each point of a step through a ring of
// shared tiles.
//
// Layout (the wrapper vihds_tpu_torch/ops/fused_ode.py packs and checks it):
//   consts [28, R]    per-row constants in DEGRADER_CONST_NAMES order
//   y0     [11, R]    initial state, state-major
//   times  [T]        the time grid
//   out    [T, 11, R] trajectory; out[0] = y0
//
// Bound on an H100 SXM (3.35 TB/s): at the serving chunk B=36, K=1000 (R =
// 36,000), T = 135: it writes 135*11*36,000*4 B = 213.8 MB and reads 5.6 MB of
// constants and y0: 219.4 MB, >= 65.5 us of memory traffic. The operation count
// per step is in chip_smoke.py (FLOPS).

#include "dr_common.cuh"

extern "C" int degrader_fwd_launch(const float* consts, const float* y0, const float* times,
                                   float* out, int R, int T, int method, void* stream) {
  return fwd_launch<Degrader, false>(nullptr, consts, y0, times, out, R, T, method, stream);
}

// The kernel's block for method (sample rows, threads, static shared memory
// in bytes, registers a thread, blocks one SM holds at once); 0 or the
// cudaError_t.
extern "C" int degrader_fwd_block(int method, int* rows, int* threads, int* smem_bytes,
                                  int* registers, int* blocks_per_sm) {
  return fwd_block<Degrader>(method, rows, threads, smem_bytes, registers, blocks_per_sm);
}
