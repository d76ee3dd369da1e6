// Fused fixed-grid forward integration of the dr_constant_precisions ODE on
// Hopper: the 8 dr_constant species plus 4 learned observation precisions.
//
// Replaces the Pallas TPU kernel of vihds_tpu/ops/pallas_ode.py, kind
// "dr_prec": _make_kernel with the _with_precisions right-hand side, reached
// through _integrate_padded_w and dr_constant_precisions_simulate.  It
// computes the same thing: y(t0) = y0, then T-1 fixed-grid steps of
// modeuler / midpoint / rk4 of the 12-state right-hand side, storing every
// state.  The precision rows are the n_hidden=0 NeuralPrecisions block
//   dprec_j = sigmoid(Wp_j . f) - sigmoid(Wd_j . f) * prec_j,
//   f = [1, tanh t, tanh y_0, ..., tanh y_7],
// with the two nets' weights in one [8, 10] matrix (fused_ode._prec_wmat).
//
// Layout (the wrapper fused_ode._integrate_prec_cuda checks it):
//   wmat   [8, 10]    rows 0..3 production, 4..7 degradation; column 0 the bias
//   consts [23, R]    per-row constants in DR_CONST_NAMES order (DrConst, dr_common.cuh)
//   y0     [12, R]    initial state, species-major: 8 species, 4 precisions
//   times  [T]        the time grid
//   out    [T, 12, R] trajectory; out[0] = y0
//
// Design: dr_fwd.cu's, one thread per sample row with the 23 constants and
// 12 states in registers for the whole time loop, a masked edge instead of
// the TPU's padding, and coalesced out[t, s, r] stores.  The weight matrix,
// which every row shares, is loaded into shared memory once per block before
// the mask (so every thread reaches the barrier); each read of it is one word
// for the whole warp, which the hardware broadcasts.  The TPU kernel fed the
// matrix to its matrix unit; here the 8 dot products of length 10 are 160
// FMAs per right-hand side on the CUDA cores, beside 9 tanhf and 8 sigmoids.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): at the serving chunk
// B=36, K=1000 (R = 36,000), T = 86 the kernel writes 86*12*36,000*4 B =
// 148.6 MB and reads 3.3 MB of constants and 1.7 MB of y0: 153.6 MB,
// >= 45.9 us.  The arithmetic is ~270 flop per right-hand side (59 for the
// species, ~210 for the precision block), ~590 per midpoint step: 1.8 GFLOP,
// 27 us; rk4 takes 3.8 GFLOP, 56 us, and is bound by its operations.  With
// 36,000 threads there is little parallelism to hide each step's dependent
// latency, so in practice it is latency-bound, as dr_fwd is.
//
// The right-hand sides and the step are dr_common.cuh's; numerics as stated
// there.

#include "dr_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int S = N_SPECIES + N_PREC;

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
dr_prec_fwd_kernel(const float* __restrict__ wmat, const float* __restrict__ consts,
                   const float* __restrict__ y0, const float* __restrict__ times,
                   float* __restrict__ out, int R, int T) {
  __shared__ float W[N_W];
  for (int e = threadIdx.x; e < N_W; e += blockDim.x) W[e] = wmat[e];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t stride = (size_t)R;

  float c[N_CONST];
#pragma unroll
  for (int j = 0; j < N_CONST; ++j) c[j] = consts[j * stride + r];
  const DrPrecRhs rhs{c, W};

  float y[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    y[s] = y0[s * stride + r];
    out[s * stride + r] = y[s];
  }

  float t1 = __ldg(times);
  for (int i = 1; i < T; ++i) {
    const float t2 = __ldg(times + i);
    one_step<METHOD, S>(rhs, t1, t2, y);
    float* o = out + (size_t)i * S * stride + r;
#pragma unroll
    for (int s = 0; s < S; ++s) o[s * stride] = y[s];
    t1 = t2;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  All pointers are device pointers
// of contiguous float32 tensors; ``stream`` is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success); a bad ``method`` or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int dr_prec_fwd_launch(const float* wmat, const float* consts, const float* y0,
                                  const float* times, float* out, int R, int T, int method,
                                  void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(THREADS);
  const dim3 grid((unsigned)((R + THREADS - 1) / THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      dr_prec_fwd_kernel<MODEULER><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
      break;
    case MIDPOINT:
      dr_prec_fwd_kernel<MIDPOINT><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
      break;
    case RK4:
      dr_prec_fwd_kernel<RK4><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
