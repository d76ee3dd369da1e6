// Device code of the fused black-box ODE kernels (blackbox_fwd.cu and
// blackbox_bwd.cu): the right-hand side of models/dr_blackbox.py, its
// hand-derived pullback and the two kernels, both run by one block of rows x
// warps (below).  The forward steps with the mechanistic kernels' one_step
// (dr_common.cuh); the backward has its own step pullback (step_vjp below),
// which keeps each stage's activations from its right-hand side for the
// stage's pullback, with the arithmetic of dr_common.cuh's step_vjp.
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

// A net of the right-hand side: its weight leaves' offsets, its hidden and
// output widths, the first state it writes (its outputs are the derivatives
// of y[Y0 .. Y0 + OUT - 1], which its degradation term multiplies), whether
// its input begins with the time, its first hidden unit U0 among both nets'
// NU units and its first output sum O0 among their NO.
struct StatesNet {
  static constexpr int W_H = SH_W, B_H = SH_B, W_P = SP_W, B_P = SP_B, W_D = SD_W, B_D = SD_B;
  static constexpr int HID = H, OUT = NS, Y0 = 0, TIME = 0, U0 = 0, O0 = 0;
};
struct PrecNet {
  static constexpr int W_H = PH_W, B_H = PH_B, W_P = PP_W, B_P = PP_B, W_D = PD_W, B_D = PD_B;
  static constexpr int HID = HP, OUT = NP, Y0 = NS, TIME = 1, U0 = H, O0 = 2 * NS;
};

// --------------------------------------------------------------------------
// The block of both kernels: BWD_ROWS sample rows x BWD_SLICES warps.
//
// Lane l of warp q works on sample row l of the block and on slice q of the
// two nets' NU = 45 hidden units (units u = q, q + 8, ...; the states net's
// 25 first, then the precision net's 20).  The row's states, adjoint and
// constants are held by all of its BWD_SLICES threads alike; the nets' work
// is split among them, each float sum done by one thread in the order a
// sweep with one thread per row takes (each dot product's terms in index
// order, then the bias; each output sum over the units in index order, then
// its bias inside the sigmoid), so the results are that sweep's bit for bit:
//   forward of a stage: each thread computes its units' pre-activations
//     (inputs in index order, then the bias) and relus into the stage's slot;
//     after a barrier each of the NO = 20 output sums (p and d of the states
//     net, then of the precision net) is summed by one thread over its net's
//     units in index order, and its sigmoid goes to the slot (the forward
//     kernel's threads take one sum of four rows each, the backward's the
//     sums of their own row); after a second barrier every thread reads the
//     20 sigmoids and forms the right-hand side of its row.
//   pullback of a stage: every thread forms the output layer's cotangents
//     from the slot's sigmoids, and each its units' cotangents dah_k; after a
//     barrier each of the NX = 27 input cotangent sums (dx 6, dc 21) is
//     summed by one thread over the units in index order, the states net's
//     then the precision net's, and the block's threads reduce the weights'
//     share (below); after a second barrier every thread reads its row's dx.
// In the backward a stage's slot keeps its input (t, z), its hidden units and
// its sigmoids from its forward until its pullback, so a midpoint or modeuler
// step evaluates the nets twice and an rk4 step four times, not 3 and 7
// times.  The forward kernel runs only the stages' forwards, through one slot
// (its second barrier ends every read of the slot's units, and every thread
// reads the sigmoids before it reaches the next stage's first barrier), and
// each thread repeats the state update of one_step for its row.
//
// The weight cotangent is a sum over every row and every pullback of outer
// products, 1,760 entries per pullback and row.  Each pullback has in the
// shared tile, per row, the vectors whose outer products make dW (feature f
// of row r at tile[f * LD + r]; LD = rows + 4, so the per-row writes fall on
// distinct banks and the per-entry reads, four rows a 16-byte load, on
// distinct 16-byte bank groups):
//   inputs:      t, z (the stage's slot), c, 1 (for the biases), h, hp (slot)
//   cotangents:  dah | dahp (45), dap | dad | dapp | dapd (20)
// and after the pullback's first barrier the block's threads reduce it: for
// each entry e one thread takes the sum over the tile's rows, in row order,
// of input[e] * cotangent[e] and adds it into e's place in the block's shared
// accumulator dWs.  A thread takes a strip of entries of one leaf row, which
// share their input, and the lanes of its warp the same strip of other rows,
// so the strip's cotangent loads are broadcasts (dw_items below).  The order
// is fixed, no atomics anywhere, so two runs give the same dW bit for bit.  At the end each block writes dWs as its partial,
// and the wrapper sums the partials over the blocks
// (fused_blackbox.blackbox_bwd, whose BWD_ROWS is this one).  Rows past the
// edge (r >= R) run the sweep on row R - 1, to reach every barrier, and stage
// zero cotangents, so they add exact zeros.
//
// Weights are staged in shared memory in the order each thread reads them,
// so one 16-byte broadcast load feeds four multiply-adds: each unit's input
// weights contiguous (WF_H), each output sum's weights over its units
// (WF_O), each unit's (W_p, W_d) pairs over the outputs (WB_O) and, per
// slice, each unit's weights into the slice's input cotangent sums (WB_I);
// the forward stages the first two (and their biases) only.
// --------------------------------------------------------------------------
constexpr int BWD_ROWS = 32;
constexpr int BWD_SLICES = 8;
constexpr int BWD_THREADS = BWD_ROWS * BWD_SLICES;
constexpr int BWD_MIN_BLOCKS = 65536 / (128 * BWD_THREADS);  // at most 128 registers a thread
// the forward's block is the backward's; with no cotangents it needs fewer
// registers, so three blocks (24 warps) fit on an SM
constexpr int FWD_ROWS = BWD_ROWS;
constexpr int FWD_THREADS = BWD_THREADS;
constexpr int FWD_MIN_BLOCKS = 65536 / (80 * FWD_THREADS);  // at most 80 registers a thread
constexpr int LD = BWD_ROWS + 4;     // a feature's row: 16-byte aligned, banks staggered
constexpr int NU = H + HP;           // hidden units of both nets
constexpr int NO = 2 * (NS + NP);    // output sums: p, d of the states net, then p, d of the precisions'
constexpr int NX = NS + NC;          // input cotangent sums: dx, then dc
constexpr int SUMS = (NX + BWD_SLICES - 1) / BWD_SLICES;  // input cotangent sums a thread owns
static_assert(SUMS == 4, "a slice's input cotangent weights are one float4 per unit");

// staged weights (floats; each block 16-byte aligned)
constexpr int OUT_LD = 28;                       // a WF_O row: a net's units, padded
constexpr int WB_LD = 2 * NS;                    // a WB_O row: (W_p, W_d) per output, padded
constexpr int WF_H = 0;                          // [NU][N_INP]: a states unit's row starts with a 0
constexpr int WF_HB = WF_H + NU * N_INP;         // [NU]: hidden biases
constexpr int WF_O = WF_HB + (NU + 3) / 4 * 4;   // [NO][OUT_LD]: output sums' weights
constexpr int WF_OB = WF_O + NO * OUT_LD;        // [NO]: output biases
constexpr int WB_O = WF_OB + NO;                 // [NU][WB_LD]
constexpr int WB_I = WB_O + NU * WB_LD;          // [BWD_SLICES][NU][SUMS]
constexpr int N_WS = WB_I + BWD_SLICES * NU * SUMS;
constexpr int N_WF = WB_O;                       // the forward's: WF_H .. WF_OB
static_assert(WF_HB % 4 == 0 && WF_O % 4 == 0 && WB_O % 4 == 0 && WB_I % 4 == 0 && N_WS % 4 == 0,
              "float4 loads of the staged weights");
static_assert(BWD_ROWS % 4 == 0 && LD % 4 == 0 && (N_WS + 2 * N_W) % 4 == 0,
              "float4 loads of the tile's rows");

// tile features: the common ones, then one slot of N_SLOT per stage
enum Common : int {
  F_C = 0,
  F_ONE = F_C + NC,
  F_DAH = F_ONE + 1,   // dah (H), then dahp (HP)
  F_DOUT = F_DAH + NU, // dap (NS), dad (NS), dapp (NP), dapd (NP)
  F_DYO = F_DOUT + NO, // -w sd of the states net's outputs
  F_DY = F_DYO + NS,   // dy of the states net's outputs: -w sd, then dx of both nets
  N_COMMON = F_DY + NS
};
enum Slot : int {
  F_T = 0,
  F_Z = F_T + 1,       // the stage's input states
  F_H = F_Z + S,       // h (H), then hp (HP)
  F_SIG = F_H + NU,    // the output sums' sigmoids, in F_DOUT's order
  N_SLOT = F_SIG + NO
};
static_assert(N_COMMON + 4 * N_SLOT < (1 << 16), "feature indices are packed in 16 bits");

// stages a step keeps: one slot each
__host__ __device__ constexpr int bwd_slots(int method) { return method == RK4 ? 4 : 2; }

// dynamic shared memory of the backward block: staged weights, dWs, the
// entries' features, the tile
__host__ __device__ constexpr int bwd_smem_bytes(int method) {
  return 4 * (N_WS + 2 * N_W + (N_COMMON + bwd_slots(method) * N_SLOT) * LD);
}

// The staged weight at WF_H .. N_WS (zero in the pads) from the weight vector
__device__ __forceinline__ float staged_weight(const float* __restrict__ w, int e) {
  if (e < WF_HB) {  // WF_H
    const int u = e / N_INP, i = e % N_INP;
    if (u < H) return i == 0 ? 0.0f : w[SH_W + (i - 1) * H + u];
    return w[PH_W + i * HP + (u - H)];
  }
  if (e < WF_O) {
    const int u = e - WF_HB;
    return u < H ? w[SH_B + u] : u < NU ? w[PH_B + (u - H)] : 0.0f;
  }
  if (e < WF_OB) {
    const int o = (e - WF_O) / OUT_LD, k = (e - WF_O) % OUT_LD;
    if (o < 2 * NS) return k < H ? w[(o < NS ? SP_W : SD_W) + k * NS + o % NS] : 0.0f;
    return k < HP ? w[(o < 2 * NS + NP ? PP_W : PD_W) + k * NP + (o - 2 * NS) % NP] : 0.0f;
  }
  if (e < WB_O) {
    const int o = e - WF_OB;
    return o < NS ? w[SP_B + o] : o < 2 * NS ? w[SD_B + o - NS]
         : o < 2 * NS + NP ? w[PP_B + o - 2 * NS] : w[PD_B + o - 2 * NS - NP];
  }
  if (e < WB_I) {
    const int u = (e - WB_O) / WB_LD, j = (e - WB_O) % WB_LD / 2, d = (e - WB_O) % 2;
    if (u < H) return w[(d ? SD_W : SP_W) + u * NS + j];
    return j < NP ? w[(d ? PD_W : PP_W) + (u - H) * NP + j] : 0.0f;
  }
  const int q = (e - WB_I) / (NU * SUMS), u = (e - WB_I) / SUMS % NU, m = (e - WB_I) % SUMS;
  const int s = q + BWD_SLICES * m;  // the input: x_s (s < NS) or c_(s - NS)
  if (s >= NX) return 0.0f;
  return u < H ? w[SH_W + s * H + u] : w[PH_W + (1 + s) * HP + (u - H)];
}

// (input feature, cotangent feature) of weight entry e, packed as in | cot
// << 16; an input feature >= N_COMMON lies in a stage's slot (slot 0's index)
__device__ __forceinline__ unsigned entry_features(int e) {
  constexpr int SL = N_COMMON;  // slot 0
  int in, cot;
  if (e < SH_B) {
    const int i = e / H;
    in = i < NS ? SL + F_Z + i : F_C + (i - NS);
    cot = F_DAH + e % H;
  } else if (e < SP_W) {
    in = F_ONE;
    cot = F_DAH + (e - SH_B);
  } else if (e < SP_B) {
    in = SL + F_H + (e - SP_W) / NS;
    cot = F_DOUT + (e - SP_W) % NS;
  } else if (e < SD_W) {
    in = F_ONE;
    cot = F_DOUT + (e - SP_B);
  } else if (e < SD_B) {
    in = SL + F_H + (e - SD_W) / NS;
    cot = F_DOUT + NS + (e - SD_W) % NS;
  } else if (e < PH_W) {
    in = F_ONE;
    cot = F_DOUT + NS + (e - SD_B);
  } else if (e < PH_B) {
    const int i = (e - PH_W) / HP;
    in = i == 0 ? SL + F_T : i <= NS ? SL + F_Z + (i - 1) : F_C + (i - 1 - NS);
    cot = F_DAH + H + (e - PH_W) % HP;
  } else if (e < PP_W) {
    in = F_ONE;
    cot = F_DAH + H + (e - PH_B);
  } else if (e < PP_B) {
    in = SL + F_H + H + (e - PP_W) / NP;
    cot = F_DOUT + 2 * NS + (e - PP_W) % NP;
  } else if (e < PD_W) {
    in = F_ONE;
    cot = F_DOUT + 2 * NS + (e - PP_B);
  } else if (e < PD_B) {
    in = SL + F_H + H + (e - PD_W) / NP;
    cot = F_DOUT + 2 * NS + NP + (e - PD_W) % NP;
  } else {
    in = F_ONE;
    cot = F_DOUT + 2 * NS + NP + (e - PD_B);
  }
  return (unsigned)in | ((unsigned)cot << 16);
}

// The weights' share of a pullback is reduced in warp items: lane l of item
// (e0, stride, lanes, len) takes the len entries e0 + l stride + t, t < len,
// of one leaf row, which share their input feature, and the item's lanes
// share the cotangent features of t, so each of those loads is a broadcast.
// Warp w takes items w, w + 8, w + 16, ordered so that each warp's strips sum
// to 9 entries (10 and 7 for two); every weight entry lies in one item.
struct DwItem {
  short e0, stride, lanes, len;
};
constexpr int DW_LEN = 5;  // the longest strip
constexpr int N_DW_ITEMS = 24;
__constant__ DwItem dw_items[N_DW_ITEMS] = {
    // the hidden layers' weights: a leaf row per lane, strips of 5 units
    {SH_W, H, N_IN, 5}, {SH_W + 5, H, N_IN, 5}, {SH_W + 10, H, N_IN, 5},
    {SH_W + 15, H, N_IN, 5}, {SH_W + 20, H, N_IN, 5}, {PH_W, HP, N_INP, 5},
    {PH_W + 5, HP, N_INP, 5}, {PH_W + 15, HP, N_INP, 5},
    // the output layers' weights: a hidden unit per lane
    {SP_W, NS, H, 3}, {SP_W + 3, NS, H, 3}, {SD_W, NS, H, 3}, {SD_W + 3, NS, H, 3},
    {PP_W, NP, HP, NP}, {PD_W, NP, HP, NP}, {PH_W + 10, HP, N_INP, 5},
    // the biases: an entry per lane
    {SH_B, 1, H, 1}, {SP_B, 1, NS, 1}, {SD_B, 1, NS, 1}, {PH_B, 1, HP, 1}, {PP_B, 1, NP, 1},
    {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, {PD_B, 1, NP, 1}};

// the first of net N's units (or output sums) that slice q owns, counted in
// the net: units u = N::U0 + k with u = q mod BWD_SLICES
template <class N>
__device__ __forceinline__ int first_unit(int q) {
  return (q + BWD_SLICES - N::U0 % BWD_SLICES) % BWD_SLICES;
}
template <class N>
__device__ __forceinline__ int first_sum(int q) {
  return (q + BWD_SLICES - N::O0 % BWD_SLICES) % BWD_SLICES;
}

// One thread of either kernel's block: lane `row` of warp `q`, which holds
// its row's constants; the forward of a stage.
struct SliceThread {
  const float* Ws;         // staged weights
  int row, q;
  float c[NC];             // the row's constants

  // net N's hidden units of this slice at the input in = [t; x; c] into col
  template <class N>
  __device__ __forceinline__ void hidden(const float* in, float* col) const {
    for (int k = first_unit<N>(q); k < N::HID; k += BWD_SLICES) {
      const int u = N::U0 + k;
      const float4* w = reinterpret_cast<const float4*>(Ws + WF_H + u * N_INP);
      float4 w4 = w[0];
      float a = N::TIME ? w4.x * in[0] : 0.0f;
      a += w4.y * in[1];
      a += w4.z * in[2];
      a += w4.w * in[3];
#pragma unroll
      for (int i = 4; i < N_INP; i += 4) {
        w4 = w[i / 4];
        a += w4.x * in[i];
        a += w4.y * in[i + 1];
        a += w4.z * in[i + 2];
        a += w4.w * in[i + 3];
      }
      col[(F_H + u) * LD] = fmaxf(a + Ws[WF_HB + u], 0.0f);
    }
  }

  // net N's output sums of this slice over the units in col, their sigmoids into col
  template <class N>
  __device__ __forceinline__ void outputs(float* col) const {
    const float* h = col + (F_H + N::U0) * LD;
    for (int j = first_sum<N>(q); j < 2 * N::OUT; j += BWD_SLICES) {
      const int o = N::O0 + j;
      const float* w = Ws + WF_O + o * OUT_LD;
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < N::HID; k += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + k);
        p += w4.x * h[k * LD];
        if (k + 1 < N::HID) p += w4.y * h[(k + 1) * LD];
        if (k + 2 < N::HID) p += w4.z * h[(k + 2) * LD];
        if (k + 3 < N::HID) p += w4.w * h[(k + 3) * LD];
      }
      col[(F_SIG + o) * LD] = sigmoidf(p + Ws[WF_OB + o]);
    }
  }

  // net N's output sum o of rows 4 g .. 4 g + 3 over the units in the slot
  // whose row 0's column is base, its sigmoids into the slot: each unit's
  // four rows one 16-byte load, each weight four multiply-adds
  template <class N>
  __device__ __forceinline__ void sums_by_4(float* base, int o, int g) const {
    const float4* h = reinterpret_cast<const float4*>(base + (F_H + N::U0) * LD) + g;
    const float* w = Ws + WF_O + o * OUT_LD;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
#pragma unroll
    for (int k = 0; k < N::HID; k += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + k);
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (k + kk < N::HID) {
          const float4 h4 = h[(k + kk) * (LD / 4)];
          p0 += wk[kk] * h4.x;
          p1 += wk[kk] * h4.y;
          p2 += wk[kk] * h4.z;
          p3 += wk[kk] * h4.w;
        }
    }
    const float b = Ws[WF_OB + o];
    float4 sg;
    sg.x = sigmoidf(p0 + b);
    sg.y = sigmoidf(p1 + b);
    sg.z = sigmoidf(p2 + b);
    sg.w = sigmoidf(p3 + b);
    reinterpret_cast<float4*>(base + (F_SIG + o) * LD)[g] = sg;
  }

  // The forward of one stage at (t, z) through col, this row's column of a
  // slot (its units and sigmoids); with F, the right-hand side f of the row.
  // The output sums are taken per row (slice q the sums o = q mod
  // BWD_SLICES of its row) or, with BY_4, four rows a thread (lane l of warp
  // q the sum 4 q + l / 8 of the rows 4 (l % 8) .. + 3; warps 0-4 work, 5-7
  // wait): a quarter of the loads of the units, but four sigmoids a thread.
  // Every thread of the block calls it at the same point.
  template <bool F, bool BY_4 = false>
  __device__ __forceinline__ void forward(float* col, float t, const float* z, float* f) const {
    float in[N_INP];
    in[0] = t;
#pragma unroll
    for (int i = 0; i < NS; ++i) in[1 + i] = z[i];
#pragma unroll
    for (int j = 0; j < NC; ++j) in[1 + NS + j] = c[j];
    hidden<StatesNet>(in, col);
    hidden<PrecNet>(in, col);
    __syncthreads();
    if constexpr (BY_4) {
      static_assert(BWD_ROWS == 32 && NO <= 4 * BWD_SLICES, "a warp takes 4 sums of 8 row quads");
      const int o = 4 * q + row / 8;
      if (o < 2 * NS)
        sums_by_4<StatesNet>(col - row, o, row % 8);
      else if (o < NO)
        sums_by_4<PrecNet>(col - row, o, row % 8);
    } else {
      outputs<StatesNet>(col);
      outputs<PrecNet>(col);
    }
    __syncthreads();
    if constexpr (F) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        f[j] = col[(F_SIG + j) * LD] - col[(F_SIG + NS + j) * LD] * z[j];
#pragma unroll
      for (int j = 0; j < NP; ++j)
        f[NS + j] = col[(F_SIG + 2 * NS + j) * LD] - col[(F_SIG + 2 * NS + NP + j) * LD] * z[NS + j];
    }
  }
};

// The right-hand side of the forward kernel's block for one_step
// (dr_common.cuh): each call one stage through the block's one slot.
struct SliceRhs {
  const SliceThread* th;
  float* col;  // this row's column of the slot

  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    th->forward<true, true>(col, t, y, f);
  }
};

// One thread of the backward block.
struct BwdThread : SliceThread {
  float* dWs;              // [N_W] the block's accumulator
  const unsigned* pairs;   // [N_W] entry_features of each entry
  float* tile;             // [N_COMMON + slots * N_SLOT][LD]
  int tid;
  bool live;               // r < R: stage this row's cotangents
  float dc[SUMS];          // this thread's input cotangent sums of dc, over the sweep

  __device__ __forceinline__ float* common() const { return tile + row; }
  __device__ __forceinline__ float* slot(int s) const {
    return tile + (N_COMMON + s * N_SLOT) * LD + row;
  }

  // The forward of one stage at (t, z) into slot s, which keeps (t, z) too;
  // with F, the right-hand side f of the row.
  template <bool F>
  __device__ __forceinline__ void stage(int s, float t, const float* z, float* f) const {
    float* col = slot(s);
    if (q == 0) col[F_T * LD] = t;
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (i % BWD_SLICES == q) col[(F_Z + i) * LD] = z[i];
    forward<F>(col, t, z, f);
  }

  // net N's output cotangents for w (all of them, in registers; the slice's
  // share staged) and its units' cotangents of this slice, staged; the
  // precision net also sets dy of its outputs
  template <class N>
  __device__ __forceinline__ void unit_cotangents(const float* col, const float* w,
                                                  float* dy) const {
    float* cc = common();
    float dap[N::OUT], dad[N::OUT];
#pragma unroll
    for (int j = 0; j < N::OUT; ++j) {
      const float sp = col[(F_SIG + N::O0 + j) * LD];
      const float sd = col[(F_SIG + N::O0 + N::OUT + j) * LD];
      const float wj = w[N::Y0 + j];
      if (N::TIME)
        dy[N::Y0 + j] = -wj * sd;
      else if (j % BWD_SLICES == q)
        cc[(F_DYO + j) * LD] = -wj * sd;
      dap[j] = wj * sp * (1.0f - sp);
      dad[j] = -wj * col[(F_Z + N::Y0 + j) * LD] * sd * (1.0f - sd);
      if ((N::O0 + j) % BWD_SLICES == q) cc[(F_DOUT + N::O0 + j) * LD] = live ? dap[j] : 0.0f;
      if ((N::O0 + N::OUT + j) % BWD_SLICES == q)
        cc[(F_DOUT + N::O0 + N::OUT + j) * LD] = live ? dad[j] : 0.0f;
    }
    for (int k = first_unit<N>(q); k < N::HID; k += BWD_SLICES) {
      const int u = N::U0 + k;
      const float4* wo = reinterpret_cast<const float4*>(Ws + WB_O + u * WB_LD);
      float dh = 0.0f;
#pragma unroll
      for (int j = 0; j < N::OUT; j += 2) {
        const float4 w4 = wo[j / 2];
        dh += w4.x * dap[j] + w4.y * dad[j];
        dh += w4.z * dap[j + 1] + w4.w * dad[j + 1];
      }
      const float dah = col[(F_H + u) * LD] > 0.0f ? dh : 0.0f;
      cc[(F_DAH + u) * LD] = live ? dah : 0.0f;
    }
  }

  // the slice's input cotangent sums over net N's units into acc
  template <class N>
  __device__ __forceinline__ void input_sums(float* acc) const {
    const float* cc = common();
    const float4* wi = reinterpret_cast<const float4*>(Ws + WB_I) + q * NU;
#pragma unroll 5
    for (int k = 0; k < N::HID; ++k) {
      const int u = N::U0 + k;
      const float dah = cc[(F_DAH + u) * LD];
      const float4 w4 = wi[u];
      acc[0] += w4.x * dah;
      acc[1] += w4.y * dah;
      acc[2] += w4.z * dah;
      acc[3] += w4.w * dah;
    }
  }

  // The pullback of slot s's stage for the cotangent w of its right-hand
  // side (fused_blackbox._bb_rhs_vjp_cols, _net_vjp): writes dy, adds the
  // constants' share into dc and, with the block, the weights' share into
  // dWs.  Every thread of the block calls it at the same point.  Per net,
  // with sp, sd the sigmoids of the output layer:
  //   dy_out = -w sd;  dap = w sp (1 - sp);  dad = -w y_out sd (1 - sd)
  //   dah_k = (h_k > 0) (W_p[k, :] . dap + W_d[k, :] . dad);  d input = W_h dah
  // The time input passes nothing on.
  __device__ __forceinline__ void pull(int s, const float* w, float* dy) {
    const float* col = slot(s);
    float* cc = common();
    unit_cotangents<StatesNet>(col, w, dy);
    unit_cotangents<PrecNet>(col, w, dy);
    __syncthreads();

    // the slice's input cotangent sums: dx_q (q < NS) per net, each added
    // to dy_q = -w_q sd_q in turn, and dc over both nets
    float acc[SUMS] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dyq = q < NS ? cc[(F_DYO + q) * LD] : 0.0f;
    input_sums<StatesNet>(acc);
    if (q < NS) {
      dyq += acc[0];
      acc[0] = 0.0f;
    }
    input_sums<PrecNet>(acc);
    if (q < NS) {
      dyq += acc[0];
      cc[(F_DY + q) * LD] = dyq;
    }
#pragma unroll
    for (int m = 0; m < SUMS; ++m) {
      const int x = q + BWD_SLICES * m;
      if (x >= NS && x < NX) dc[m] += acc[m];
    }

    // the weights' share: the block's rows reduced per entry, in row order
    const int shift = s * N_SLOT;
    const int lane = tid % 32;
    for (int it = tid / 32; it < N_DW_ITEMS; it += BWD_THREADS / 32) {
      const DwItem d = dw_items[it];
      if (lane >= d.lanes) continue;
      const int e = d.e0 + lane * d.stride;
      int fi = (int)(pairs[e] & 0xffffu);
      if (fi >= N_COMMON) fi += shift;
      const float4* in = reinterpret_cast<const float4*>(tile + fi * LD);
      int ct[DW_LEN];  // the strip's cotangent rows, in float4s from the tile's start
      float sum[DW_LEN];
#pragma unroll
      for (int t = 0; t < DW_LEN; ++t) {
        ct[t] = (int)(pairs[e + min(t, d.len - 1)] >> 16) * (LD / 4);
        sum[t] = 0.0f;
      }
      const float4* rows4 = reinterpret_cast<const float4*>(tile);
#pragma unroll
      for (int r = 0; r < BWD_ROWS / 4; ++r) {
        const float4 a = in[r];
#pragma unroll
        for (int t = 0; t < DW_LEN; ++t)
          if (t < d.len) {
            const float4 b = rows4[ct[t] + r];
            sum[t] += a.x * b.x;
            sum[t] += a.y * b.y;
            sum[t] += a.z * b.z;
            sum[t] += a.w * b.w;
          }
      }
#pragma unroll
      for (int t = 0; t < DW_LEN; ++t)
        if (t < d.len) dWs[e + t] += sum[t];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NS; ++i) dy[i] = cc[(F_DY + i) * LD];
  }
};

// Pullback of one fixed-grid step at y = y_i: a holds the cotangent of
// y_{i+1} on entry and that of y_i on exit.  The arithmetic of dr_common.cuh's
// step_vjp, with each stage's forward kept in its slot for its pullback
// instead of recomputed there.
template <int METHOD>
__device__ __forceinline__ void step_vjp(BwdThread& th, float t1, float t2, const float* y,
                                         float* a) {
  const float h = t2 - t1;
  const float hh = 0.5f * h;
  float f1[S], z[S], w[S], dz[S], d1[S];
  if (METHOD == MODEULER) {
    // y' = y + hh (f1 + f2), f1 = F(t1, y), f2 = F(t2, y + h f1)
    th.stage<true>(0, t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s] = y[s] + h * f1[s];
      w[s] = hh * a[s];
    }
    th.stage<false>(1, t2, z, nullptr);
    th.pull(1, w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * a[s] + h * dz[s];
    th.pull(0, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else if (METHOD == MIDPOINT) {
    // y' = y + h f2, f2 = F(t1 + hh, y + hh f1), f1 = F(t1, y)
    th.stage<true>(0, t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s] = y[s] + hh * f1[s];
      w[s] = h * a[s];
    }
    th.stage<false>(1, t1 + hh, z, nullptr);
    th.pull(1, w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * dz[s];
    th.pull(0, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else {  // RK4: y' = y + h6 (k1 + 2 k2 + 2 k3 + k4), stage k_j = F(t_j, z_j)
    const float tm = t1 + hh;
    const float h6 = h / 6.0f;
    float k[S], d4[S], d3[S];
    th.stage<true>(0, t1, y, k);
#pragma unroll
    for (int s = 0; s < S; ++s) z[s] = y[s] + hh * k[s];  // z2
    th.stage<true>(1, tm, z, k);
#pragma unroll
    for (int s = 0; s < S; ++s) z[s] = y[s] + hh * k[s];  // z3
    th.stage<true>(2, tm, z, k);
#pragma unroll
    for (int s = 0; s < S; ++s) z[s] = y[s] + h * k[s];  // z4
    th.stage<false>(3, t2, z, nullptr);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h6 * a[s];
    th.pull(3, w, d4);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + h * d4[s];
    th.pull(2, w, d3);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + hh * d3[s];
    th.pull(1, w, dz);  // d2
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h6 * a[s] + hh * dz[s];
    th.pull(0, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + d4[s] + d3[s] + dz[s] + d1[s];
  }
}

// --------------------------------------------------------------------------
// The kernels
//
// Forward (the TPU kernel's _make_kernel): the block described above steps
// its rows with one_step, each stage's nets split over the warps through one
// slot; the weights staged into shared memory once per block, the row's
// constants and states in registers for the whole time loop, state s of the
// row stored by slice s % BWD_SLICES, so out[t, s, r] is stored coalesced.
// The TPU kernel padded R up to its block with constants 0 and y0 1e-3
// (pallas_blackbox.py:256-260); rows past the edge (r >= R) run on row R - 1,
// to reach every barrier, and store nothing.
//
// Backward (_make_bwd_kernel): the reverse sweep over the stored trajectory
// by the block described above (each step's stages evaluated from traj[i]
// into their slots, then pulled back in reverse; dc, dy0 per row in
// registers), with the weight cotangent reduced per block.
// --------------------------------------------------------------------------
template <int METHOD>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
fwd_kernel(const float* __restrict__ wflat, const float* __restrict__ consts,
           const float* __restrict__ y0, const float* __restrict__ times,
           float* __restrict__ out, int R, int T) {
  __shared__ __align__(16) float Ws[N_WF];
  __shared__ __align__(16) float slot[N_SLOT * LD];
  for (int e = threadIdx.x; e < N_WF; e += FWD_THREADS) Ws[e] = staged_weight(wflat, e);
  SliceThread th;
  th.Ws = Ws;
  th.row = threadIdx.x % FWD_ROWS;
  th.q = threadIdx.x / FWD_ROWS;

  const int r0 = blockIdx.x * FWD_ROWS + th.row;
  const bool live = r0 < R;
  const int r = live ? r0 : R - 1;
  const size_t stride = (size_t)R;

#pragma unroll
  for (int j = 0; j < NC; ++j) th.c[j] = consts[j * stride + r];
  float y[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    y[s] = y0[s * stride + r];
    if (live && s % BWD_SLICES == th.q) out[s * stride + r] = y[s];
  }
  __syncthreads();

  const SliceRhs rhs{&th, slot + th.row};
  float t1 = __ldg(times);
  for (int i = 1; i < T; ++i) {
    const float t2 = __ldg(times + i);
    one_step<METHOD, S>(rhs, t1, t2, y);
    if (live) {
      float* o = out + (size_t)i * S * stride + r;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s % BWD_SLICES == th.q) o[s * stride] = y[s];
    }
    t1 = t2;
  }
}

template <int METHOD>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
bwd_kernel(const float* __restrict__ wflat, const float* __restrict__ consts,
           const float* __restrict__ times, const float* __restrict__ traj,
           const float* __restrict__ g, float* __restrict__ dw_out,
           float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  extern __shared__ __align__(16) float smem[];
  BwdThread th;
  th.Ws = smem;
  th.dWs = smem + N_WS;
  th.pairs = reinterpret_cast<const unsigned*>(smem + N_WS + N_W);
  th.tile = smem + N_WS + 2 * N_W;
  th.tid = threadIdx.x;
  th.row = th.tid % BWD_ROWS;
  th.q = th.tid / BWD_ROWS;
  for (int e = th.tid; e < N_WS; e += BWD_THREADS) smem[e] = staged_weight(wflat, e);
  for (int e = th.tid; e < N_W; e += BWD_THREADS) {
    th.dWs[e] = 0.0f;
    reinterpret_cast<unsigned*>(smem + N_WS + N_W)[e] = entry_features(e);
  }

  const int r0 = blockIdx.x * BWD_ROWS + th.row;
  th.live = r0 < R;
  const int r = th.live ? r0 : R - 1;
  const size_t stride = (size_t)R;
  const size_t tstride = (size_t)S * stride;

#pragma unroll
  for (int j = 0; j < NC; ++j) th.c[j] = consts[j * stride + r];
#pragma unroll
  for (int m = 0; m < SUMS; ++m) th.dc[m] = 0.0f;
  if (th.q == 0) {
    float* cc = th.common();
#pragma unroll
    for (int j = 0; j < NC; ++j) cc[(F_C + j) * LD] = th.c[j];
    cc[F_ONE * LD] = 1.0f;
  }
  __syncthreads();

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
    step_vjp<METHOD>(th, t1, t2, y, a);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] += gi[s * stride];
    t2 = t1;
  }

  if (th.live) {
#pragma unroll
    for (int m = 0; m < SUMS; ++m) {
      const int x = th.q + BWD_SLICES * m;
      if (x >= NS && x < NX) dc_out[(x - NS) * stride + r] = th.dc[m];
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s % BWD_SLICES == th.q) dy0_out[s * stride + r] = a[s];
  }
  // each thread writes the entries it reduced (the last pullback ended on a
  // barrier, so every entry is final)
  for (int e = th.tid; e < N_W; e += BWD_THREADS)
    dw_out[(size_t)blockIdx.x * N_W + e] = th.dWs[e];
}

}  // namespace bb
}  // namespace
