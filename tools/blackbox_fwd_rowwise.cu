// A variant of blackbox_fwd for timing against it (tools/blackbox_bwd_compare.py
// --direction fwd --rowwise): one thread per sample row, 32-row blocks (one
// warp), no barriers in the time loop.  Each thread runs both nets for its
// row, four hidden units at a time: the hidden weights are staged input-major
// with the units padded to a multiple of four, so one 16-byte broadcast load
// feeds the four units' multiply-adds of one input, and each unit's output
// weights (p then d) are contiguous, so one load feeds four output sums.
// Every float sum keeps the order of vihds_tpu_torch/csrc/blackbox_common.cuh
// (inputs in index order, then the bias; output sums over the units in
// index order, then the bias inside the sigmoid), so the trajectory equals
// bb::fwd_kernel's bit for bit unless the compiler contracts differently.
//
// Built with the port's flags and -I vihds_tpu_torch/csrc; the entry point
// has blackbox_fwd.cu's signature.

#include "blackbox_common.cuh"

namespace {
namespace rw {
using namespace bb;

constexpr int ROWS = 32;
constexpr int HS = 28;  // the states net's units, padded to a multiple of 4
// staged weights (floats, each block 16-byte aligned): per net the hidden
// weights [inputs][units], their biases, the output weights [units][p | d]
// and the output biases [p | d]
constexpr int S_H = 0;
constexpr int S_HB = S_H + N_IN * HS;
constexpr int S_O = S_HB + HS;
constexpr int S_OB = S_O + H * 2 * NS;
constexpr int P_H = S_OB + 2 * NS;
constexpr int P_HB = P_H + N_INP * HP;
constexpr int P_O = P_HB + HP;
constexpr int P_OB = P_O + HP * 2 * NP;
constexpr int N_R = P_OB + 2 * NP;
static_assert(S_HB % 4 == 0 && S_O % 4 == 0 && P_H % 4 == 0 && P_HB % 4 == 0 && P_O % 4 == 0 &&
                  HP % 4 == 0 && (2 * NS) % 4 == 0 && (2 * NP) % 4 == 0,
              "float4 loads of the staged weights");

__device__ __forceinline__ float staged(const float* __restrict__ w, int e) {
  if (e < S_HB) {
    const int i = e / HS, k = e % HS;
    return k < H ? w[SH_W + i * H + k] : 0.0f;
  }
  if (e < S_O) return e - S_HB < H ? w[SH_B + e - S_HB] : 0.0f;
  if (e < S_OB) {
    const int k = (e - S_O) / (2 * NS), j = (e - S_O) % (2 * NS);
    return j < NS ? w[SP_W + k * NS + j] : w[SD_W + k * NS + j - NS];
  }
  if (e < P_H) return e - S_OB < NS ? w[SP_B + e - S_OB] : w[SD_B + e - S_OB - NS];
  if (e < P_HB) return w[PH_W + e - P_H];
  if (e < P_O) return w[PH_B + e - P_HB];
  if (e < P_OB) {
    const int k = (e - P_O) / (2 * NP), j = (e - P_O) % (2 * NP);
    return j < NP ? w[PP_W + k * NP + j] : w[PD_W + k * NP + j - NP];
  }
  return e - P_OB < NP ? w[PP_B + e - P_OB] : w[PD_B + e - P_OB - NP];
}

// net N with its staged blocks at WH (hidden weights, HPAD units a row), WHB,
// WO and WOB
template <class N, int WH, int WHB, int WO, int WOB, int HPAD>
__device__ __forceinline__ void net(const float* W, const float* c, float t, const float* y,
                                    float* f) {
  constexpr int O2 = 2 * N::OUT;
  float p[O2];  // p, then d
#pragma unroll
  for (int j = 0; j < O2; ++j) p[j] = 0.0f;
#pragma unroll 1
  for (int k0 = 0; k0 < N::HID; k0 += 4) {
    const float4* w = reinterpret_cast<const float4*>(W + WH) + k0 / 4;
    float a[4];
    if (N::TIME) {
      const float4 w4 = w[0];
      a[0] = w4.x * t;
      a[1] = w4.y * t;
      a[2] = w4.z * t;
      a[3] = w4.w * t;
    } else {
      a[0] = a[1] = a[2] = a[3] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NS + NC; ++i) {
      const float x = i < NS ? y[i] : c[i - NS];
      const float4 w4 = w[(N::TIME + i) * (HPAD / 4)];
      a[0] += w4.x * x;
      a[1] += w4.y * x;
      a[2] += w4.z * x;
      a[3] += w4.w * x;
    }
    const float4 b4 = reinterpret_cast<const float4*>(W + WHB)[k0 / 4];
    const float h[4] = {fmaxf(a[0] + b4.x, 0.0f), fmaxf(a[1] + b4.y, 0.0f),
                        fmaxf(a[2] + b4.z, 0.0f), fmaxf(a[3] + b4.w, 0.0f)};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (k0 + kk >= N::HID) continue;
      const float4* wo = reinterpret_cast<const float4*>(W + WO + (k0 + kk) * O2);
#pragma unroll
      for (int j = 0; j < O2; j += 4) {
        const float4 o4 = wo[j / 4];
        p[j] += o4.x * h[kk];
        p[j + 1] += o4.y * h[kk];
        p[j + 2] += o4.z * h[kk];
        p[j + 3] += o4.w * h[kk];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N::OUT; ++j)
    f[N::Y0 + j] = sigmoidf(p[j] + W[WOB + j]) - sigmoidf(p[N::OUT + j] + W[WOB + N::OUT + j]) *
                                                     y[N::Y0 + j];
}

struct RowRhs {
  const float* W;
  const float* c;

  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    net<StatesNet, S_H, S_HB, S_O, S_OB, HS>(W, c, t, y, f);
    net<PrecNet, P_H, P_HB, P_O, P_OB, HP>(W, c, t, y, f);
  }
};

template <int METHOD>
__global__ void __launch_bounds__(ROWS)
row_kernel(const float* __restrict__ wflat, const float* __restrict__ consts,
           const float* __restrict__ y0, const float* __restrict__ times,
           float* __restrict__ out, int R, int T) {
  __shared__ __align__(16) float W[N_R];
  for (int e = threadIdx.x; e < N_R; e += ROWS) W[e] = staged(wflat, e);
  __syncthreads();
  const int r = blockIdx.x * ROWS + threadIdx.x;
  if (r >= R) return;
  const size_t stride = (size_t)R;
  float c[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) c[j] = consts[j * stride + r];
  const RowRhs rhs{W, c};
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

}  // namespace rw
}  // namespace

extern "C" int blackbox_fwd_launch(const float* wflat, const float* consts, const float* y0,
                                   const float* times, float* out, int R, int T, int method,
                                   void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((R + rw::ROWS - 1) / rw::ROWS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case MODEULER:
      rw::row_kernel<MODEULER><<<grid, rw::ROWS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case MIDPOINT:
      rw::row_kernel<MIDPOINT><<<grid, rw::ROWS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    case RK4:
      rw::row_kernel<RK4><<<grid, rw::ROWS, 0, s>>>(wflat, consts, y0, times, out, R, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
