// Fused fixed-grid forward integration of the dr_constant ODE on Hopper.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind "dr":
// _make_kernel (the forward time loop) reached through _integrate_padded and
// dr_constant_simulate.  It computes the same thing: y(t0) = y0, then T-1
// fixed-grid steps of modeuler / midpoint / rk4 (_one_step) of the 8-state
// dr_constant right-hand side (_dr_rhs_cols), storing every state.
//
// Layout (the wrapper vihds_tpu_torch/ops/fused_ode.py packs it):
//   consts [23, R]  per-row constants in DR_CONST_NAMES order (enum below)
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
// Numerics: precise expf and IEEE division (build without --use_fast_math);
// the sigmoid is 1/(1+expf(-x)).  The expression order follows the JAX
// kernel; the compiler may contract a*b+c into FMAs, which the comparison
// with the plain PyTorch version allows for in its stated tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Packed constant rows, in vihds_tpu_torch/ops/fused_ode.py DR_CONST_NAMES order.
enum DrConst {
  C_r = 0,
  C_K,
  C_tlag,
  C_rc,
  C_a530,
  C_a480,
  C_drfp,
  C_dyfp,
  C_dcfp,
  C_dR,
  C_dS,
  C_e76,
  C_e81,
  C_aCFP,
  C_aYFP,
  C_KGR_76,
  C_KGS_76,
  C_KGR_81,
  C_KGS_81,
  C_aR,
  C_aS,
  C_fracLuxR,
  C_fracLasR,
  N_CONST
};

constexpr int N_SPECIES = 8;
constexpr int THREADS = 128;

enum Method { MODEULER = 0, MIDPOINT = 1, RK4 = 2 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// dr_constant right-hand side (same math and order as _dr_rhs_cols).
__device__ __forceinline__ void dr_rhs(const float* c, float t, const float* y, float* f) {
  const float x = y[0], rfp = y[1], yfp = y[2], cfp = y[3];
  const float f530 = y[4], f480 = y[5], luxR = y[6], lasR = y[7];
  const float gr = c[C_r] * sigmoidf(4.0f * (t - c[C_tlag]));
  const float gamma = gr * (1.0f - x / c[C_K]);
  const float boundLuxR = luxR * luxR * c[C_fracLuxR];
  const float boundLasR = lasR * lasR * c[C_fracLasR];
  const float denom76 = 1.0f + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR;
  const float denom81 = 1.0f + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR;
  const float P76 = (c[C_e76] + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR) / denom76;
  const float P81 = (c[C_e81] + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR) / denom81;
  const float rc = c[C_rc];
  f[0] = gamma * x;
  f[1] = rc - (gamma + c[C_drfp]) * rfp;
  f[2] = rc * c[C_aYFP] * P81 - (gamma + c[C_dyfp]) * yfp;
  f[3] = rc * c[C_aCFP] * P76 - (gamma + c[C_dcfp]) * cfp;
  f[4] = rc * c[C_a530] - gamma * f530;
  f[5] = rc * c[C_a480] - gamma * f480;
  f[6] = rc * c[C_aR] - (gamma + c[C_dR]) * luxR;
  f[7] = rc * c[C_aS] - (gamma + c[C_dS]) * lasR;
}

// One fixed-grid update of y in place (same math and order as _one_step).
template <int METHOD>
__device__ __forceinline__ void one_step(const float* c, float t1, float t2, float* y) {
  const float h = t2 - t1;
  float f1[N_SPECIES], f2[N_SPECIES], tmp[N_SPECIES];
  if (METHOD == MODEULER) {
    dr_rhs(c, t1, y, f1);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) tmp[s] = y[s] + h * f1[s];
    dr_rhs(c, t2, tmp, f2);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) y[s] = y[s] + hh * (f1[s] + f2[s]);
  } else if (METHOD == MIDPOINT) {
    dr_rhs(c, t1, y, f1);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) tmp[s] = y[s] + hh * f1[s];
    dr_rhs(c, t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) y[s] = y[s] + h * f2[s];
  } else {  // RK4
    float k3[N_SPECIES], k4[N_SPECIES];
    const float hh = 0.5f * h;
    dr_rhs(c, t1, y, f1);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) tmp[s] = y[s] + hh * f1[s];
    dr_rhs(c, t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) tmp[s] = y[s] + hh * f2[s];
    dr_rhs(c, t1 + hh, tmp, k3);
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s) tmp[s] = y[s] + h * k3[s];
    dr_rhs(c, t2, tmp, k4);
    const float h6 = h / 6.0f;
#pragma unroll
    for (int s = 0; s < N_SPECIES; ++s)
      y[s] = y[s] + h6 * (f1[s] + 2.0f * f2[s] + 2.0f * k3[s] + k4[s]);
  }
}

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

  float y[N_SPECIES];
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) {
    y[s] = y0[s * stride + r];
    out[s * stride + r] = y[s];
  }

  float t1 = __ldg(times);
  for (int i = 1; i < T; ++i) {
    const float t2 = __ldg(times + i);
    one_step<METHOD>(c, t1, t2, y);
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
