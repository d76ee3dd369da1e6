// Fused fixed-grid forward integration of the dr_constant ODE on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind "dr":
// _make_kernel (the forward time loop) reached through _integrate_padded and
// dr_constant_simulate.  It computes the same thing: y(t0) = y0, then T-1
// fixed-grid steps of modeuler / midpoint / rk4 (_one_step) of the 8-state
// dr_constant right-hand side (_dr_rhs_cols), storing every state.
//
// Layout (the wrapper vihds_tpu_torch/ops/fused_ode.py packs it):
//   consts [23, R]  per-row constants in DR_CONST_NAMES order (DrConst, dr_common.cuh)
//   y0     [8, R]   initial state, species-major
//   times  [T]      the time grid
//   out    [T, 8, R] trajectory; out[0] = y0
//
// Design: one thread per sample row.  The 23 constants and the 8 states stay
// in registers for the whole time loop; the time grid is read through the
// read-only cache; each step stores out[t, s, r], so the 32 threads of a warp
// write 32 consecutive floats of one species row and every store coalesces.
// The ragged edge is masked with r < R.  The TPU kernel padded R up to its
// block size with constants = 1 and y0 = 1e-3 (pallas_ode.py:551-560) only
// because a grid cell there processes a whole block; with the mask no padded
// row exists, so no padding values are needed.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): at the serving chunk
// B=36, K=1000 (R = 36,000), T = 86 the kernel writes 86*8*36,000*4 B =
// 99.1 MB and reads 23*36,000*4 + 8*36,000*4 B = 4.5 MB, about 104 MB in all,
// i.e. >= 31 us of memory traffic.  The arithmetic is 6.1 M right-hand side
// evaluations for midpoint (12.2 M for rk4) of ~60 flops, 0.4 (0.7) GFLOP,
// i.e. 6 (11) us: the kernel is bound by the bytes it must write.  With 36,000 threads (~8.5 warps per SM)
// there is little parallelism to hide the dependent-arithmetic latency of
// each step, so in practice it is latency-bound; a faster schedule is later
// work.
//
// The right-hand side and the step are dr_common.cuh's, shared with the
// other dr kernels; numerics as stated there.

#include "dr_common.cuh"

namespace {

constexpr int THREADS = 128;

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
dr_fwd_kernel(const float* __restrict__ consts, const float* __restrict__ y0,
              const float* __restrict__ times, float* __restrict__ out, int R, int T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t stride = (size_t)R;

  float c[N_CONST];
#pragma unroll
  for (int j = 0; j < N_CONST; ++j) c[j] = consts[j * stride + r];
  const DrRhs rhs{c};

  float y[N_SPECIES];
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) {
    y[s] = y0[s * stride + r];
    out[s * stride + r] = y[s];
  }

  float t1 = __ldg(times);
  for (int i = 1; i < T; ++i) {
    const float t2 = __ldg(times + i);
    one_step<METHOD, N_SPECIES>(rhs, t1, t2, y);
    float* o = out + (size_t)i * N_SPECIES * stride + r;
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) o[s * stride] = y[s];
    t1 = t2;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// of contiguous float32 tensors; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); a bad ``method`` or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int dr_fwd_launch(const float* consts, const float* y0, const float* times,
                             float* out, int R, int T, int method, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(THREADS);
  const dim3 grid((unsigned)((R + THREADS - 1) / THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      dr_fwd_kernel<MODEULER><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
      break;
    case MIDPOINT:
      dr_fwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
      break;
    case RK4:
      dr_fwd_kernel<RK4><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
