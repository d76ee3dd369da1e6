// Device code of the fused black-box ODE kernels (blackbox_fwd.cu and
// blackbox_bwd.cu): the right-hand side of models/dr_blackbox.py, its
// hand-derived pullback and the two kernels.  The fixed-grid steps and their
// pullbacks are the mechanistic kernels' (one_step and step_vjp in
// dr_common.cuh), so all kernels step the same three methods.
//
// The right-hand side is two small nets whose weights every sample row shares
// (NeuralStates and NeuralPrecisions with a relu hidden layer):
//   h  = relu(W_h^T [x; c] + b_h)        dx = sigmoid(W_p^T h + b_p) - sigmoid(W_d^T h + b_d) x
//   hp = relu(Wp_h^T [t; x; c] + bp_h)   dv = sigmoid(Wp_p^T hp + bp_p) - sigmoid(Wp_d^T hp + bp_d) v
// over the row's NS ODE states x, 4 precision states v and NC constants c.
// Its plain PyTorch twin is vihds_tpu_torch/ops/fused_blackbox.py
// (_bb_rhs_cols, _net_vjp), which the CPU tests hold against torch.autograd
// and against the JAX package's Pallas kernel in interpret mode;
// chip_smoke.py holds these kernels against the twin on the card.
//
// The widths are those of specs/dr_blackbox_icml.yaml, fixed at compile time
// (fused_blackbox.KERNEL_LEAF_SHAPES; its wrapper refuses any other).  The
// weights arrive as one float vector: the 12 leaves of
// fused_blackbox.WEIGHT_LEAVES, each [n_in, n_out] row-major or [n_out],
// concatenated in that order (offsets below).
//
// Numerics: f32 on the CUDA cores, precise expf and IEEE division (no
// --use_fast_math, no tensor cores: TF32 would not hold the float32
// tolerances the port keeps); each dot product sums its terms in index
// order, then adds the bias, as the plain version's matmul + bias does.

#pragma once

#include "dr_common.cuh"

namespace {
namespace bb {

constexpr int NS = 6;                // ODE states the nets model: 4 observed + 2 latent species
constexpr int NP = N_PREC;           // precision states
constexpr int S = NS + NP;           // all states
constexpr int NC = 21;               // constants: 12 latents, 2 treatments, 7 device entries
constexpr int H = 25;                // NeuralStates' hidden width
constexpr int HP = 20;               // NeuralPrecisions' hidden width
constexpr int N_IN = NS + NC;        // NeuralStates' input [x; c]
constexpr int N_INP = 1 + NS + NC;   // NeuralPrecisions' input [t; x; c]

// offsets of the 12 leaves in the weight vector
constexpr int SH_W = 0;
constexpr int SH_B = SH_W + N_IN * H;
constexpr int SP_W = SH_B + H;
constexpr int SP_B = SP_W + H * NS;
constexpr int SD_W = SP_B + NS;
constexpr int SD_B = SD_W + H * NS;
constexpr int PH_W = SD_B + NS;
constexpr int PH_B = PH_W + N_INP * HP;
constexpr int PP_W = PH_B + HP;
constexpr int PP_B = PP_W + HP * NP;
constexpr int PD_W = PP_B + NP;
constexpr int PD_B = PD_W + HP * NP;
constexpr int N_W = PD_B + NP;  // 1,760
static_assert(N_W == 1760, "the dr_blackbox_icml weight count");

// --------------------------------------------------------------------------
// The backward's block: BWD_ROWS sample rows, one thread each, one warp.
//
// The weight cotangent is a sum over every row and every pullback of outer
// products, 1,760 entries per pullback and row.  The mechanistic _prec
// backwards keep a per-thread column of their 80-112 entries in shared
// memory; at 1,760 entries that would be 225 KB per 32-row block.  Instead
// each pullback stages, per row, the vectors whose outer products make dW
// into a shared tile (feature f of row r at tile[f * LD + r]; LD = rows + 1,
// so both the per-row writes and the per-entry reads below fall on distinct
// banks):
//   inputs:      t, x (6), c (21, staged once), 1 (for the biases), h (25), hp (20)
//   cotangents:  dah (25), dap | dad (12), dahp (20), dapp | dapd (8)
// and after a barrier the block's threads reduce it: thread i owns the
// entries e = i, i + 32, ... of the weight vector and adds, for each, the
// sum over the tile's rows in row order of input[e] * cotangent[e] into its
// entry of the block's shared accumulator dWs.  The arithmetic equals the
// per-row outer products'; the order is fixed, no atomics anywhere, so two
// runs give the same dW bit for bit.  A second barrier frees the tile for the
// next pullback.  At the end each block writes dWs as its partial, and the
// wrapper sums the partials over the blocks (fused_blackbox.blackbox_bwd).
// Rows past the edge (r >= R) run the sweep on row R - 1, to reach every
// barrier, and stage zero cotangents, so they add exact zeros.
// --------------------------------------------------------------------------
constexpr int FWD_THREADS = 128;
constexpr int BWD_ROWS = 32;
constexpr int LD = BWD_ROWS + 1;

// tile features; pin = [t; x; c] is F_T .. F_T + N_INP - 1 and aug = [x; c]
// is F_X .. F_X + N_IN - 1
enum Feature : int {
  F_T = 0,
  F_X = F_T + 1,
  F_C = F_X + NS,
  F_ONE = F_C + NC,
  F_H = F_ONE + 1,
  F_HP = F_H + H,
  F_DAH = F_HP + HP,
  F_DAP = F_DAH + H,  // dap (NS), then dad (NS)
  F_DAHP = F_DAP + 2 * NS,
  F_DAPP = F_DAHP + HP,  // dapp (NP), then dapd (NP)
  N_F = F_DAPP + 2 * NP
};
static_assert(N_F <= 256, "feature indices are packed in 8 bits");

// (input feature, cotangent feature) of weight entry e, packed as in | cot << 8
__device__ __forceinline__ unsigned short entry_features(int e) {
  int in, cot;
  if (e < SH_B) {
    in = F_X + e / H;
    cot = F_DAH + e % H;
  } else if (e < SP_W) {
    in = F_ONE;
    cot = F_DAH + (e - SH_B);
  } else if (e < SP_B) {
    in = F_H + (e - SP_W) / NS;
    cot = F_DAP + (e - SP_W) % NS;
  } else if (e < SD_W) {
    in = F_ONE;
    cot = F_DAP + (e - SP_B);
  } else if (e < SD_B) {
    in = F_H + (e - SD_W) / NS;
    cot = F_DAP + NS + (e - SD_W) % NS;
  } else if (e < PH_W) {
    in = F_ONE;
    cot = F_DAP + NS + (e - SD_B);
  } else if (e < PH_B) {
    in = F_T + (e - PH_W) / HP;
    cot = F_DAHP + (e - PH_W) % HP;
  } else if (e < PP_W) {
    in = F_ONE;
    cot = F_DAHP + (e - PH_B);
  } else if (e < PP_B) {
    in = F_HP + (e - PP_W) / NP;
    cot = F_DAPP + (e - PP_W) % NP;
  } else if (e < PD_W) {
    in = F_ONE;
    cot = F_DAPP + (e - PP_B);
  } else if (e < PD_B) {
    in = F_HP + (e - PD_W) / NP;
    cot = F_DAPP + NP + (e - PD_W) % NP;
  } else {
    in = F_ONE;
    cot = F_DAPP + NP + (e - PD_B);
  }
  return (unsigned short)(in | (cot << 8));
}

// --------------------------------------------------------------------------
// The two nets, and the right-hand side (fused_blackbox._bb_rhs_cols) for
// one row: W the weights (shared memory, read by every thread at the same
// address, so each read is a broadcast), c the row's constants, y its S
// states.  The hidden units are visited one at a time and each is folded into
// the output sums at once, so no hidden vector is held in registers.
// --------------------------------------------------------------------------

// A net of the right-hand side: its weight leaves' offsets, its hidden and
// output widths, the first state it writes (its outputs are the derivatives
// of y[Y0 .. Y0 + OUT - 1], which its degradation term multiplies), whether
// its input begins with the time, and the backward tile's features of its
// hidden units, their cotangents and its output layer's cotangents.
struct StatesNet {
  static constexpr int W_H = SH_W, B_H = SH_B, W_P = SP_W, B_P = SP_B, W_D = SD_W, B_D = SD_B;
  static constexpr int HID = H, OUT = NS, Y0 = 0, TIME = 0;
  static constexpr int F_HID = F_H, F_DHID = F_DAH, F_DOUT = F_DAP;
};
struct PrecNet {
  static constexpr int W_H = PH_W, B_H = PH_B, W_P = PP_W, B_P = PP_B, W_D = PD_W, B_D = PD_B;
  static constexpr int HID = HP, OUT = NP, Y0 = NS, TIME = 1;
  static constexpr int F_HID = F_HP, F_DHID = F_DAHP, F_DOUT = F_DAPP;
};

// The net's hidden layer and the sums of its output layer (before the
// biases) into p, d; with STORE, hidden unit k also goes to hid[k * LD].
template <class N, bool STORE>
__device__ __forceinline__ void net_forward(const float* W, const float* c, float t,
                                            const float* y, float* p, float* d, float* hid) {
#pragma unroll
  for (int j = 0; j < N::OUT; ++j) p[j] = d[j] = 0.0f;
#pragma unroll 5
  for (int k = 0; k < N::HID; ++k) {
    float a = N::TIME ? W[N::W_H + k] * t : 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) a += W[N::W_H + (N::TIME + i) * N::HID + k] * y[i];
#pragma unroll
    for (int j = 0; j < NC; ++j) a += W[N::W_H + (N::TIME + NS + j) * N::HID + k] * c[j];
    const float hk = fmaxf(a + W[N::B_H + k], 0.0f);
    if constexpr (STORE) hid[k * LD] = hk;
#pragma unroll
    for (int j = 0; j < N::OUT; ++j) {
      p[j] += W[N::W_P + k * N::OUT + j] * hk;
      d[j] += W[N::W_D + k * N::OUT + j] * hk;
    }
  }
}

struct Rhs {
  const float* c;
  const float* W;

  template <class N>
  __device__ __forceinline__ void net(float t, const float* y, float* f) const {
    float p[N::OUT], d[N::OUT];
    net_forward<N, false>(W, c, t, y, p, d, nullptr);
#pragma unroll
    for (int j = 0; j < N::OUT; ++j)
      f[N::Y0 + j] = sigmoidf(p[j] + W[N::B_P + j]) - sigmoidf(d[j] + W[N::B_D + j]) * y[N::Y0 + j];
  }

  __device__ __forceinline__ void operator()(float t, const float* y, float* f) const {
    net<StatesNet>(t, y, f);
    net<PrecNet>(t, y, f);
  }
};

// The pullback of Rhs at (t, y) for the cotangent w of its output
// (fused_blackbox._bb_rhs_vjp_cols, _net_vjp): writes dy, adds the constants'
// share into the row's dc and, with the block, the weights' share into dWs.
// Every thread of the block must call it at the same point of the sweep.  Per
// net, with sp, sd the sigmoids of the output layer:
//   dy_out = -w sd;  dap = w sp (1 - sp);  dad = -w y_out sd (1 - sd)
//   dah_k = (h_k > 0) (W_p[k, :] . dap + W_d[k, :] . dad);  d input = W_h dah
// The time input passes nothing on.  The hidden units are kept in the row's
// tile column between the two passes over them.
struct Vjp {
  const float* c;
  float* dc;
  const float* W;
  float* tile;                   // [N_F][LD]
  float* dWs;                    // [N_W], the block's accumulator
  const unsigned short* pairs;   // [N_W], entry_features of each entry
  bool live;                     // r < R: stage this row's cotangents

  // one net's pullback: sets dy of its outputs, adds its share into
  // dy[0 .. NS-1] and the constants' dcl, stages its vectors in col
  template <class N>
  __device__ __forceinline__ void net(float t, const float* y, const float* w, float* dy,
                                      float* dcl, float* col) const {
    float p[N::OUT], d[N::OUT], dap[N::OUT], dad[N::OUT], dx[NS];
    net_forward<N, true>(W, c, t, y, p, d, col + N::F_HID * LD);
#pragma unroll
    for (int j = 0; j < N::OUT; ++j) {
      const float sp = sigmoidf(p[j] + W[N::B_P + j]);
      const float sd = sigmoidf(d[j] + W[N::B_D + j]);
      const float wj = w[N::Y0 + j];
      dy[N::Y0 + j] = -wj * sd;
      dap[j] = wj * sp * (1.0f - sp);
      dad[j] = -wj * y[N::Y0 + j] * sd * (1.0f - sd);
      col[(N::F_DOUT + j) * LD] = live ? dap[j] : 0.0f;
      col[(N::F_DOUT + N::OUT + j) * LD] = live ? dad[j] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) dx[i] = 0.0f;
#pragma unroll 5
    for (int k = 0; k < N::HID; ++k) {
      float dh = 0.0f;
#pragma unroll
      for (int j = 0; j < N::OUT; ++j)
        dh += W[N::W_P + k * N::OUT + j] * dap[j] + W[N::W_D + k * N::OUT + j] * dad[j];
      const float dah = col[(N::F_HID + k) * LD] > 0.0f ? dh : 0.0f;
      col[(N::F_DHID + k) * LD] = live ? dah : 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) dx[i] += W[N::W_H + (N::TIME + i) * N::HID + k] * dah;
#pragma unroll
      for (int j = 0; j < NC; ++j) dcl[j] += W[N::W_H + (N::TIME + NS + j) * N::HID + k] * dah;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) dy[i] += dx[i];
  }

  __device__ __forceinline__ void operator()(float t, const float* y, const float* w,
                                             float* dy) const {
    float* col = tile + threadIdx.x;
    float dcl[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) dcl[j] = 0.0f;
    col[F_T * LD] = t;
#pragma unroll
    for (int i = 0; i < NS; ++i) col[(F_X + i) * LD] = y[i];
    net<StatesNet>(t, y, w, dy, dcl, col);
    net<PrecNet>(t, y, w, dy, dcl, col);
#pragma unroll
    for (int j = 0; j < NC; ++j) dc[j] += dcl[j];

    // the weights' share: the block's rows reduced per entry, in row order
    __syncthreads();
    for (int e = threadIdx.x; e < N_W; e += BWD_ROWS) {
      const unsigned short pr = pairs[e];
      const float* in = tile + (pr & 0xff) * LD;
      const float* ct = tile + (pr >> 8) * LD;
      float sum = 0.0f;
#pragma unroll 8
      for (int r = 0; r < BWD_ROWS; ++r) sum += in[r] * ct[r];
      dWs[e] += sum;
    }
    __syncthreads();
  }
};

// --------------------------------------------------------------------------
// The kernels
//
// Forward (the TPU kernel's _make_kernel): one thread per sample row, the
// weights staged into shared memory once per block (before the edge mask, so
// every thread reaches the barrier), the row's constants and states in
// registers for the whole time loop, out[t, s, r] stored coalesced.  The TPU
// kernel padded R up to its block with constants 0 and y0 1e-3
// (pallas_blackbox.py:256-260); the mask leaves no padded row.
//
// Backward (_make_bwd_kernel): the reverse sweep over the stored trajectory,
// as dr_common.cuh's bwd_kernel (each step's stages recomputed from
// traj[i], then pulled back in reverse; dc and dy0 per row in registers),
// with the weight cotangent reduced per block as described above.
// --------------------------------------------------------------------------
template <int METHOD>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_kernel(const float* __restrict__ wflat, const float* __restrict__ consts,
           const float* __restrict__ y0, const float* __restrict__ times,
           float* __restrict__ out, int R, int T) {
  __shared__ float W[N_W];
  for (int e = threadIdx.x; e < N_W; e += blockDim.x) W[e] = wflat[e];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t stride = (size_t)R;

  float c[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) c[j] = consts[j * stride + r];
  const Rhs rhs{c, W};

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

template <int METHOD>
__global__ void __launch_bounds__(BWD_ROWS)
bwd_kernel(const float* __restrict__ wflat, const float* __restrict__ consts,
           const float* __restrict__ times, const float* __restrict__ traj,
           const float* __restrict__ g, float* __restrict__ dw_out,
           float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  __shared__ float W[N_W];
  __shared__ float dWs[N_W];
  __shared__ unsigned short pairs[N_W];
  __shared__ float tile[N_F * LD];
  const int tid = threadIdx.x;
  for (int e = tid; e < N_W; e += BWD_ROWS) {
    W[e] = wflat[e];
    dWs[e] = 0.0f;
    pairs[e] = entry_features(e);
  }

  const int r0 = blockIdx.x * BWD_ROWS + tid;
  const bool live = r0 < R;
  const int r = live ? r0 : R - 1;
  const size_t stride = (size_t)R;
  const size_t tstride = (size_t)S * stride;

  float c[NC], dc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    c[j] = consts[j * stride + r];
    dc[j] = 0.0f;
    tile[(F_C + j) * LD + tid] = c[j];
  }
  tile[F_ONE * LD + tid] = 1.0f;
  __syncthreads();

  const Rhs rhs{c, W};
  const Vjp vjp{c, dc, W, tile, dWs, pairs, live};

  float a[S];
  const float* gT = g + (size_t)(T - 1) * tstride + r;
#pragma unroll
  for (int s = 0; s < S; ++s) a[s] = gT[s * stride];

  float t2 = __ldg(times + (T - 1));
  for (int i = T - 2; i >= 0; --i) {
    const float t1 = __ldg(times + i);
    const float* yi = traj + (size_t)i * tstride + r;
    const float* gi = g + (size_t)i * tstride + r;
    float y[S];
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = yi[s * stride];
    step_vjp<METHOD, S>(rhs, vjp, t1, t2, y, a);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] += gi[s * stride];
    t2 = t1;
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NC; ++j) dc_out[j * stride + r] = dc[j];
#pragma unroll
    for (int s = 0; s < S; ++s) dy0_out[s * stride + r] = a[s];
  }
  // each thread writes the entries it reduced (the last pullback ended on a
  // barrier, so every entry is final)
  for (int e = tid; e < N_W; e += BWD_ROWS) dw_out[(size_t)blockIdx.x * N_W + e] = dWs[e];
}

}  // namespace bb
}  // namespace
