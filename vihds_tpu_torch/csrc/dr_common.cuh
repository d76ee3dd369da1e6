// Device code shared by the fused dr_constant kernels (dr_fwd.cu, dr_bwd.cu,
// dr_prec_fwd.cu, dr_prec_bwd.cu): the packed constant order, the 8-species
// right-hand side and its hand-derived pullback, the learned-precision block
// of the *_precisions models and its pullback, and the fixed-grid steps and
// their pullbacks, written once over any right-hand side.
//
// Each function here has a plain PyTorch twin in
// vihds_tpu_torch/ops/fused_ode.py that repeats its arithmetic line for line
// (named beside each one); the CPU tests hold the twins against
// torch.autograd and against the JAX package's Pallas kernels in interpret
// mode, and chip_smoke.py holds each kernel against its twin on the card.
//
// Numerics: precise expf / tanhf and IEEE division (the kernels are built
// without --use_fast_math); the sigmoid is 1/(1+expf(-x)).  The expression
// order follows the plain versions; the compiler may contract a*b+c into
// FMAs, which the comparisons with the plain versions allow for.

#pragma once

#include <cuda_runtime.h>

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
// learned-precision states of the *_precisions models, after the species
constexpr int N_PREC = 4;
// the precision nets' input features [1, tanh t, tanh y_0 .. tanh y_7]
constexpr int N_FEAT = 2 + N_SPECIES;
// the weight matrix [2 N_PREC, N_FEAT], row-major: rows 0..3 production,
// 4..7 degradation, column 0 the bias (fused_ode.WMAT_SHAPE)
constexpr int N_W = 2 * N_PREC * N_FEAT;

enum Method { MODEULER = 0, MIDPOINT = 1, RK4 = 2 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// dr_constant right-hand side over y[0..7] (_dr_rhs_cols).
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

// Pullback of dr_rhs at (t, y): for the cotangent w[0..7] of its output,
// writes dy[0..7] = (df/dy)^T w and adds (df/dc)^T w into dc
// (_dr_rhs_vjp_cols, which spells out the derivatives):
//   gr = r s, s = sigmoid(4 (t - tlag))          dgr/dtlag = -4 r s (1 - s)
//   gamma = gr (1 - x/K)                         dgamma/dx = -gr/K, dgamma/dK = gr x/K^2
//   P = (e + A)/(1 + A), A = KGR bL + KGS bS     dP/dA = (1 - e)/(1 + A)^2, dP/de = 1/(1 + A)
//   bL = luxR^2 fracLuxR (bS likewise)           the gradient reaches fracLuxR / fracLasR
__device__ __forceinline__ void dr_rhs_vjp(const float* c, float t, const float* y,
                                           const float* w, float* dy, float* dc) {
  const float x = y[0], rfp = y[1], yfp = y[2], cfp = y[3];
  const float f530 = y[4], f480 = y[5], luxR = y[6], lasR = y[7];
  // forward intermediates, recomputed
  const float sig = sigmoidf(4.0f * (t - c[C_tlag]));
  const float gr = c[C_r] * sig;
  const float omx = 1.0f - x / c[C_K];
  const float gamma = gr * omx;
  const float luxR2 = luxR * luxR;
  const float lasR2 = lasR * lasR;
  const float boundLuxR = luxR2 * c[C_fracLuxR];
  const float boundLasR = lasR2 * c[C_fracLasR];
  const float denom76 = 1.0f + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR;
  const float denom81 = 1.0f + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR;
  const float P76 = (c[C_e76] + c[C_KGR_76] * boundLuxR + c[C_KGS_76] * boundLasR) / denom76;
  const float P81 = (c[C_e81] + c[C_KGR_81] * boundLuxR + c[C_KGS_81] * boundLasR) / denom81;
  const float rc = c[C_rc];
  // pull w back through the eight outputs
  const float dgamma = w[0] * x - w[1] * rfp - w[2] * yfp - w[3] * cfp - w[4] * f530 -
                       w[5] * f480 - w[6] * luxR - w[7] * lasR;
  const float dP81 = w[2] * rc * c[C_aYFP];
  const float dP76 = w[3] * rc * c[C_aCFP];
  dc[C_rc] += w[1] + w[2] * c[C_aYFP] * P81 + w[3] * c[C_aCFP] * P76 + w[4] * c[C_a530] +
              w[5] * c[C_a480] + w[6] * c[C_aR] + w[7] * c[C_aS];
  dc[C_aYFP] += w[2] * rc * P81;
  dc[C_aCFP] += w[3] * rc * P76;
  dc[C_a530] += w[4] * rc;
  dc[C_a480] += w[5] * rc;
  dc[C_aR] += w[6] * rc;
  dc[C_aS] += w[7] * rc;
  dc[C_drfp] -= w[1] * rfp;
  dc[C_dyfp] -= w[2] * yfp;
  dc[C_dcfp] -= w[3] * cfp;
  dc[C_dR] -= w[6] * luxR;
  dc[C_dS] -= w[7] * lasR;
  // P = (e + A) / (1 + A)
  const float dA76 = dP76 * (1.0f - c[C_e76]) / (denom76 * denom76);
  const float dA81 = dP81 * (1.0f - c[C_e81]) / (denom81 * denom81);
  dc[C_e76] += dP76 / denom76;
  dc[C_e81] += dP81 / denom81;
  dc[C_KGR_76] += dA76 * boundLuxR;
  dc[C_KGS_76] += dA76 * boundLasR;
  dc[C_KGR_81] += dA81 * boundLuxR;
  dc[C_KGS_81] += dA81 * boundLasR;
  const float dbL = dA76 * c[C_KGR_76] + dA81 * c[C_KGR_81];
  const float dbS = dA76 * c[C_KGS_76] + dA81 * c[C_KGS_81];
  dc[C_fracLuxR] += dbL * luxR2;
  dc[C_fracLasR] += dbS * lasR2;
  // gamma = gr (1 - x/K), gr = r sig
  const float dgr = dgamma * omx;
  dc[C_K] += dgamma * gr * x / (c[C_K] * c[C_K]);
  dc[C_r] += dgr * sig;
  dc[C_tlag] -= 4.0f * dgr * c[C_r] * sig * (1.0f - sig);
  dy[0] = w[0] * gamma - dgamma * gr / c[C_K];
  dy[1] = -w[1] * (gamma + c[C_drfp]);
  dy[2] = -w[2] * (gamma + c[C_dyfp]);
  dy[3] = -w[3] * (gamma + c[C_dcfp]);
  dy[4] = -w[4] * gamma;
  dy[5] = -w[5] * gamma;
  dy[6] = 2.0f * dbL * luxR * c[C_fracLuxR] - w[6] * (gamma + c[C_dR]);
  dy[7] = 2.0f * dbS * lasR * c[C_fracLasR] - w[7] * (gamma + c[C_dS]);
}

// The precision nets' input at (t, y) (_prec_features).
__device__ __forceinline__ void prec_features(float t, const float* y, float* f) {
  f[0] = 1.0f;
  f[1] = tanhf(t);
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) f[2 + s] = tanhf(y[s]);
}

// The learned-precision block of the *_precisions right-hand side over
// y[0..11] (the precision rows of _dr_prec_rhs_cols):
//   dv_j = sigmoid(W_j . f) - sigmoid(W_{4+j} . f) * y[8 + j],  j = 0..3.
// W is the [8, 10] weight matrix, read from shared memory (every thread of a
// warp reads the same word, which the hardware broadcasts).
__device__ __forceinline__ void prec_rhs(const float* W, float t, const float* y, float* dv) {
  float f[N_FEAT];
  prec_features(t, y, f);
#pragma unroll
  for (int j = 0; j < N_PREC; ++j) {
    float p = 0.0f, d = 0.0f;
#pragma unroll
    for (int k = 0; k < N_FEAT; ++k) {
      p += W[j * N_FEAT + k] * f[k];
      d += W[(N_PREC + j) * N_FEAT + k] * f[k];
    }
    dv[j] = sigmoidf(p) - sigmoidf(d) * y[N_SPECIES + j];
  }
}

// Pullback of prec_rhs at (t, y) for the cotangent w[0..11] of the whole
// right-hand side (_prec_rhs_vjp_cols): adds the block's share into
// dy[0..7], writes dy[8..11], and adds the weights' share into this
// thread's accumulators dW[e * STRIDE], e = 0..79 (a column of the block's
// shared [80][STRIDE] array).  With p = Wp f, d = Wd f, sp = sigmoid(p),
// sd = sigmoid(d) and w_j the cotangent of dprec_j:
//   dprec_j = -w_j sd_j;  dp_j = w_j sp_j (1 - sp_j);  dd_j = -w_j prec_j sd_j (1 - sd_j)
//   dW[j, :] += dp_j f,  dW[4 + j, :] += dd_j f,  df = Wp^T dp + Wd^T dd
//   dy_s += df[2 + s] (1 - tanh^2 y_s); f[0] = 1 and f[1] = tanh t pass nothing on.
template <int STRIDE>
__device__ __forceinline__ void prec_rhs_vjp(const float* W, float t, const float* y,
                                             const float* w, float* dy, float* dW) {
  float f[N_FEAT], df[N_FEAT];
  prec_features(t, y, f);
#pragma unroll
  for (int k = 0; k < N_FEAT; ++k) df[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < N_PREC; ++j) {
    float p = 0.0f, d = 0.0f;
#pragma unroll
    for (int k = 0; k < N_FEAT; ++k) {
      p += W[j * N_FEAT + k] * f[k];
      d += W[(N_PREC + j) * N_FEAT + k] * f[k];
    }
    const float sp = sigmoidf(p), sd = sigmoidf(d);
    const float wv = w[N_SPECIES + j];
    const float dp = wv * sp * (1.0f - sp);
    const float dd = -wv * y[N_SPECIES + j] * sd * (1.0f - sd);
    dy[N_SPECIES + j] = -wv * sd;
#pragma unroll
    for (int k = 0; k < N_FEAT; ++k) {
      dW[(j * N_FEAT + k) * STRIDE] += dp * f[k];
      dW[((N_PREC + j) * N_FEAT + k) * STRIDE] += dd * f[k];
      df[k] += W[j * N_FEAT + k] * dp + W[(N_PREC + j) * N_FEAT + k] * dd;
    }
  }
#pragma unroll
  for (int s = 0; s < N_SPECIES; ++s) dy[s] += df[2 + s] * (1.0f - f[2 + s] * f[2 + s]);
}

// One fixed-grid update of the S states y in place under rhs(t, y, f)
// (_one_step).
template <int METHOD, int S, class Rhs>
__device__ __forceinline__ void one_step(const Rhs& rhs, float t1, float t2, float* y) {
  const float h = t2 - t1;
  float f1[S], f2[S], tmp[S];
  if (METHOD == MODEULER) {
    rhs(t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + h * f1[s];
    rhs(t2, tmp, f2);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + hh * (f1[s] + f2[s]);
  } else if (METHOD == MIDPOINT) {
    rhs(t1, y, f1);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f1[s];
    rhs(t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + h * f2[s];
  } else {  // RK4
    float k3[S], k4[S];
    const float hh = 0.5f * h;
    rhs(t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f1[s];
    rhs(t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f2[s];
    rhs(t1 + hh, tmp, k3);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + h * k3[s];
    rhs(t2, tmp, k4);
    const float h6 = h / 6.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + h6 * (f1[s] + 2.0f * f2[s] + 2.0f * k3[s] + k4[s]);
  }
}

// Pullback of one fixed-grid step at y = y_i (_step_vjp): a holds the
// cotangent of y_{i+1} on entry and that of y_i on exit; vjp(t, z, w, dz)
// writes the right-hand side's pullback dz and adds the parameters' share
// into the accumulators it holds.  The stages are recomputed from y_i.
template <int METHOD, int S, class Rhs, class Vjp>
__device__ __forceinline__ void step_vjp(const Rhs& rhs, const Vjp& vjp, float t1, float t2,
                                         const float* y, float* a) {
  const float h = t2 - t1;
  const float hh = 0.5f * h;
  float f1[S], z[S], w[S], dz[S], d1[S];
  if (METHOD == MODEULER) {
    // y' = y + hh (f1 + f2), f1 = F(t1, y), f2 = F(t2, y + h f1)
    rhs(t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s] = y[s] + h * f1[s];
      w[s] = hh * a[s];
    }
    vjp(t2, z, w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * a[s] + h * dz[s];
    vjp(t1, y, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else if (METHOD == MIDPOINT) {
    // y' = y + h f2, f2 = F(t1 + hh, y + hh f1), f1 = F(t1, y)
    rhs(t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s] = y[s] + hh * f1[s];
      w[s] = h * a[s];
    }
    vjp(t1 + hh, z, w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * dz[s];
    vjp(t1, y, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else {  // RK4: y' = y + h6 (k1 + 2 k2 + 2 k3 + k4), stage k_j = F(t_j, z_j)
    const float tm = t1 + hh;
    const float h6 = h / 6.0f;
    float z2[S], z3[S], k[S], d4[S], d3[S];
    rhs(t1, y, k);
#pragma unroll
    for (int s = 0; s < S; ++s) z2[s] = y[s] + hh * k[s];
    rhs(tm, z2, k);
#pragma unroll
    for (int s = 0; s < S; ++s) z3[s] = y[s] + hh * k[s];
    rhs(tm, z3, k);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z[s] = y[s] + h * k[s];  // z4
      w[s] = h6 * a[s];
    }
    vjp(t2, z, w, d4);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + h * d4[s];
    vjp(tm, z3, w, d3);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + hh * d3[s];
    vjp(tm, z2, w, dz);  // d2
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h6 * a[s] + hh * dz[s];
    vjp(t1, y, w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + d4[s] + d3[s] + dz[s] + d1[s];
  }
}

// The right-hand sides and pullbacks as the step templates call them.
struct DrRhs {
  const float* c;
  __device__ __forceinline__ void operator()(float t, const float* y, float* f) const {
    dr_rhs(c, t, y, f);
  }
};

struct DrVjp {
  const float* c;
  float* dc;
  __device__ __forceinline__ void operator()(float t, const float* y, const float* w,
                                             float* dy) const {
    dr_rhs_vjp(c, t, y, w, dy, dc);
  }
};

struct DrPrecRhs {
  const float* c;
  const float* W;
  __device__ __forceinline__ void operator()(float t, const float* y, float* f) const {
    dr_rhs(c, t, y, f);
    prec_rhs(W, t, y, f + N_SPECIES);
  }
};

template <int STRIDE>
struct DrPrecVjp {
  const float* c;
  float* dc;
  const float* W;
  float* dW;
  __device__ __forceinline__ void operator()(float t, const float* y, const float* w,
                                             float* dy) const {
    dr_rhs_vjp(c, t, y, w, dy, dc);
    prec_rhs_vjp<STRIDE>(W, t, y, w, dy, dW);
  }
};

}  // namespace
