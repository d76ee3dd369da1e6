// Device code shared by the port's fused ODE kernels, one .cu per kind and
// direction (dr, dr_prec, relay, relay_prec, degrader, degrader_prec; _fwd
// and _bwd):
//   * the packed constant orders of the three mechanistic families;
//   * the 8-species core that all three share (the dr_constant species) and
//     its hand-derived pullback, written once over a constant layout;
//   * each family's right-hand side and pullback: dr is the core alone,
//     relay and degrader add rows that feed back into the core's terms;
//   * the learned-precision block of the *_precisions models over any number
//     of species, and its pullback;
//   * the fixed-grid steps and their pullbacks over any right-hand side;
//   * the forward and backward kernels over any kind, and their launchers.
// Each .cu under csrc/ is a C entry point <kind>_<fwd|bwd>_launch that calls
// one launcher here.
//
// Each right-hand side and pullback here has a plain PyTorch twin in
// vihds_tpu_torch/ops/fused_ode.py that repeats its arithmetic line for line
// (named beside each one); the CPU tests hold the twins against
// torch.autograd and against the JAX package's Pallas kernels in interpret
// mode, and chip_smoke.py holds each kernel against its twin on the card.
//
// Numerics: precise expf / tanhf and IEEE division (the kernels are built
// without --use_fast_math); the sigmoid is 1/(1+expf(-x)).  The expression
// order follows the plain versions; the compiler may contract a*b+c into
// FMAs, which the comparisons with the plain versions allow for.  A
// pullback divides a cotangent through div0, which skips the division's slow
// path on a zero numerator and gives the IEEE quotient all the same.

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

// Packed constant rows of the relay family, in fused_ode.RELAY_CONST_NAMES order.
enum RelayConst {
  RL_r = 0,
  RL_K,
  RL_tlag,
  RL_rc,
  RL_a530,
  RL_a480,
  RL_drfp,
  RL_dyfp,
  RL_dcfp,
  RL_dR,
  RL_dS,
  RL_dluxI,
  RL_dlasI,
  RL_e76,
  RL_e81,
  RL_aCFP,
  RL_aYFP,
  RL_KGR_76,
  RL_KGS_76,
  RL_KGR_81,
  RL_KGS_81,
  RL_KC6,
  RL_KC12,
  RL_Klux,
  RL_Klas,
  RL_aR,
  RL_aS,
  RL_fracLuxR,
  RL_fracLasR,
  N_RELAY_CONST
};

// Packed constant rows of the degrader family, in
// fused_ode.DEGRADER_CONST_NAMES order.  PBAD, rC6 and rC12 are computed per
// row on the host, like fracLuxR / fracLasR.
enum DegraderConst {
  DG_r = 0,
  DG_K,
  DG_tlag,
  DG_rc,
  DG_a530,
  DG_a480,
  DG_drfp,
  DG_dyfp,
  DG_dcfp,
  DG_dR,
  DG_dS,
  DG_e76,
  DG_e81,
  DG_aCFP,
  DG_aYFP,
  DG_KGR_76,
  DG_KGS_76,
  DG_KGR_81,
  DG_KGS_81,
  DG_aR,
  DG_aS,
  DG_aI,
  DG_daiiA,
  DG_PBAD,
  DG_rC6,
  DG_rC12,
  DG_fracLuxR,
  DG_fracLasR,
  N_DEGRADER_CONST
};

// learned-precision states of the *_precisions models, after the species
constexpr int N_PREC = 4;

// The precision nets' input features [1, tanh t, tanh y_0 .. tanh y_{ns-1}]
// and their weight matrix [2 N_PREC, n_feat(ns)], row-major: rows 0..3
// production, 4..7 degradation, column 0 the bias (fused_ode.KINDS[..].wmat_shape).
__host__ __device__ constexpr int n_feat(int ns) { return 2 + ns; }
__host__ __device__ constexpr int n_w(int ns) { return 2 * N_PREC * n_feat(ns); }

enum Method { MODEULER = 0, MIDPOINT = 1, RK4 = 2 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// x / d for a denominator d > 0 and finite: the IEEE quotient, signed zero
// included.  An IEEE division takes a slow path on a zero numerator, and
// most of a training step's trajectory cotangent is exactly zero (samples
// whose IWAE weight underflows, species that are not observed), so a zero x
// is divided as a one and its own zero returned.  The empty asm hides the
// substitute from the compiler, which would otherwise divide x itself and
// select afterwards.
__device__ __forceinline__ float div0(float x, float d) {
  float n = x == 0.0f ? 1.0f : x;
  asm("" : "+f"(n));
  const float q = n / d;
  return x == 0.0f ? x : q;
}

// --------------------------------------------------------------------------
// The 8-species core (OD, RFP, YFP, CFP, F530, F480, LuxR, LasR), over the
// row indices L:: of a family's constants.
// --------------------------------------------------------------------------
#define CORE_LAYOUT(P)                                                                      \
  enum : int {                                                                              \
    r = P##r, K = P##K, tlag = P##tlag, rc = P##rc, a530 = P##a530, a480 = P##a480,         \
    drfp = P##drfp, dyfp = P##dyfp, dcfp = P##dcfp, dR = P##dR, dS = P##dS, e76 = P##e76,   \
    e81 = P##e81, aCFP = P##aCFP, aYFP = P##aYFP, KGR_76 = P##KGR_76, KGS_76 = P##KGS_76,   \
    KGR_81 = P##KGR_81, KGS_81 = P##KGS_81, aR = P##aR, aS = P##aS,                         \
    fracLuxR = P##fracLuxR, fracLasR = P##fracLasR                                          \
  }
struct DrCore { CORE_LAYOUT(C_); };
struct RelayCore { CORE_LAYOUT(RL_); };
struct DegraderCore { CORE_LAYOUT(DG_); };
#undef CORE_LAYOUT

// The core's intermediates at (t, y) (_core_terms)
struct CoreTerms {
  float sig, gr, omx, gamma, luxR2, lasR2, boundLuxR, boundLasR, denom76, denom81, P76, P81;
};

// The terms that are products of a state or constant and sig or omx, as
// core_terms forms them
template <class L>
__device__ __forceinline__ CoreTerms core_products(const float* c, const float* y, float sig,
                                                   float omx) {
  CoreTerms k;
  k.sig = sig;
  k.gr = c[L::r] * k.sig;
  k.omx = omx;
  k.gamma = k.gr * k.omx;
  k.luxR2 = y[6] * y[6];
  k.lasR2 = y[7] * y[7];
  k.boundLuxR = k.luxR2 * c[L::fracLuxR];
  k.boundLasR = k.lasR2 * c[L::fracLasR];
  return k;
}

template <class L>
__device__ __forceinline__ CoreTerms core_terms(const float* c, float t, const float* y) {
  CoreTerms k = core_products<L>(c, y, sigmoidf(4.0f * (t - c[L::tlag])), 1.0f - y[0] / c[L::K]);
  k.denom76 = 1.0f + c[L::KGR_76] * k.boundLuxR + c[L::KGS_76] * k.boundLasR;
  k.denom81 = 1.0f + c[L::KGR_81] * k.boundLuxR + c[L::KGS_81] * k.boundLasR;
  k.P76 = (c[L::e76] + c[L::KGR_76] * k.boundLuxR + c[L::KGS_76] * k.boundLasR) / k.denom76;
  k.P81 = (c[L::e81] + c[L::KGR_81] * k.boundLuxR + c[L::KGS_81] * k.boundLasR) / k.denom81;
  return k;
}

// The core's terms at a point as a pullback takes them: the six that end in
// a division or a sum, tp[0..5] (core_publish); the products are formed
// again from them (core_terms_at), as core_terms forms them, so that a
// pullback given tp compiles to the arithmetic it has given core_terms.
constexpr int N_CORE_TERMS = 6;

__device__ __forceinline__ void core_publish(const CoreTerms& k, float* tp) {
  tp[0] = k.sig;
  tp[1] = k.omx;
  tp[2] = k.denom76;
  tp[3] = k.denom81;
  tp[4] = k.P76;
  tp[5] = k.P81;
}

template <class L>
__device__ __forceinline__ CoreTerms core_terms_at(const float* c, const float* y,
                                                   const float* tp) {
  CoreTerms k = core_products<L>(c, y, tp[0], tp[1]);
  k.denom76 = tp[2];
  k.denom81 = tp[3];
  k.P76 = tp[4];
  k.P81 = tp[5];
  return k;
}

// The core's eight rows f[0..7] (_core_rows)
template <class L>
__device__ __forceinline__ void core_rhs(const float* c, const CoreTerms& k, const float* y,
                                         float* f) {
  const float rc = c[L::rc], gamma = k.gamma;
  f[0] = gamma * y[0];
  f[1] = rc - (gamma + c[L::drfp]) * y[1];
  f[2] = rc * c[L::aYFP] * k.P81 - (gamma + c[L::dyfp]) * y[2];
  f[3] = rc * c[L::aCFP] * k.P76 - (gamma + c[L::dcfp]) * y[3];
  f[4] = rc * c[L::a530] - gamma * y[4];
  f[5] = rc * c[L::a480] - gamma * y[5];
  f[6] = rc * c[L::aR] - (gamma + c[L::dR]) * y[6];
  f[7] = rc * c[L::aS] - (gamma + c[L::dS]) * y[7];
}

// Pullback of the core, first half (_core_rows_vjp): for the cotangent
// w[0..7] of the core's rows, adds the share of the constants each row reads
// directly into dc and returns the rows' cotangents of gamma, P76 and P81.
// A family's extra rows add their own shares to these three before the
// second half pulls them back through the core's terms.
template <class L>
__device__ __forceinline__ void core_rows_vjp(const float* c, const CoreTerms& k, const float* y,
                                              const float* w, float* dc, float& dgamma,
                                              float& dP76, float& dP81) {
  const float rc = c[L::rc];
  dgamma = w[0] * y[0] - w[1] * y[1] - w[2] * y[2] - w[3] * y[3] - w[4] * y[4] - w[5] * y[5] -
           w[6] * y[6] - w[7] * y[7];
  dP81 = w[2] * rc * c[L::aYFP];
  dP76 = w[3] * rc * c[L::aCFP];
  dc[L::rc] += w[1] + w[2] * c[L::aYFP] * k.P81 + w[3] * c[L::aCFP] * k.P76 + w[4] * c[L::a530] +
               w[5] * c[L::a480] + w[6] * c[L::aR] + w[7] * c[L::aS];
  dc[L::aYFP] += w[2] * rc * k.P81;
  dc[L::aCFP] += w[3] * rc * k.P76;
  dc[L::a530] += w[4] * rc;
  dc[L::a480] += w[5] * rc;
  dc[L::aR] += w[6] * rc;
  dc[L::aS] += w[7] * rc;
  dc[L::drfp] -= w[1] * y[1];
  dc[L::dyfp] -= w[2] * y[2];
  dc[L::dcfp] -= w[3] * y[3];
  dc[L::dR] -= w[6] * y[6];
  dc[L::dS] -= w[7] * y[7];
}

// Pullback of the core, second half (_core_terms_vjp): pulls dgamma, dP76
// and dP81 back through the core's terms into dc, and writes dy[0..7]
// (the states' cotangent through the core's rows and terms):
//   gr = r s, s = sigmoid(4 (t - tlag))          dgr/dtlag = -4 r s (1 - s)
//   gamma = gr (1 - x/K)                         dgamma/dx = -gr/K, dgamma/dK = gr x/K^2
//   P = (e + A)/(1 + A), A = KGR bL + KGS bS     dP/dA = (1 - e)/(1 + A)^2, dP/de = 1/(1 + A)
//   bL = luxR^2 fracLuxR (bS likewise)           the gradient reaches fracLuxR / fracLasR
template <class L>
__device__ __forceinline__ void core_terms_vjp(const float* c, const CoreTerms& k, const float* y,
                                               const float* w, float dgamma, float dP76,
                                               float dP81, float* dy, float* dc) {
  // P = (e + A) / (1 + A)
  const float dA76 = div0(dP76 * (1.0f - c[L::e76]), k.denom76 * k.denom76);
  const float dA81 = div0(dP81 * (1.0f - c[L::e81]), k.denom81 * k.denom81);
  dc[L::e76] += div0(dP76, k.denom76);
  dc[L::e81] += div0(dP81, k.denom81);
  dc[L::KGR_76] += dA76 * k.boundLuxR;
  dc[L::KGS_76] += dA76 * k.boundLasR;
  dc[L::KGR_81] += dA81 * k.boundLuxR;
  dc[L::KGS_81] += dA81 * k.boundLasR;
  const float dbL = dA76 * c[L::KGR_76] + dA81 * c[L::KGR_81];
  const float dbS = dA76 * c[L::KGS_76] + dA81 * c[L::KGS_81];
  dc[L::fracLuxR] += dbL * k.luxR2;
  dc[L::fracLasR] += dbS * k.lasR2;
  // gamma = gr (1 - x/K), gr = r sig
  const float dgr = dgamma * k.omx;
  dc[L::K] += div0(dgamma * k.gr * y[0], c[L::K] * c[L::K]);
  dc[L::r] += dgr * k.sig;
  dc[L::tlag] -= 4.0f * dgr * c[L::r] * k.sig * (1.0f - k.sig);
  const float gamma = k.gamma;
  dy[0] = w[0] * gamma - div0(dgamma * k.gr, c[L::K]);
  dy[1] = -w[1] * (gamma + c[L::drfp]);
  dy[2] = -w[2] * (gamma + c[L::dyfp]);
  dy[3] = -w[3] * (gamma + c[L::dcfp]);
  dy[4] = -w[4] * gamma;
  dy[5] = -w[5] * gamma;
  dy[6] = 2.0f * dbL * y[6] * c[L::fracLuxR] - w[6] * (gamma + c[L::dR]);
  dy[7] = 2.0f * dbS * y[7] * c[L::fracLasR] - w[7] * (gamma + c[L::dS]);
}

// --------------------------------------------------------------------------
// The three families' right-hand sides and pullbacks.  For the cotangent w
// of a right-hand side's output at a point y, its pullback writes dy =
// (df/dy)^T w and adds (df/dc)^T w into dc.  A pullback takes the terms of
// the point that do not depend on w as the array tp that the family's
// terms() fills at (t, y): the core's (core_publish), then the family's own.
// --------------------------------------------------------------------------

// dr_constant, y[0..7] (_dr_rhs_cols): the core alone, core_rhs.

// (_dr_rhs_vjp_cols)
__device__ __forceinline__ void dr_rhs_vjp(const float* c, const float* tp, const float* y,
                                           const float* w, float* dy, float* dc) {
  const CoreTerms k = core_terms_at<DrCore>(c, y, tp);
  float dgamma, dP76, dP81;
  core_rows_vjp<DrCore>(c, k, y, w, dc, dgamma, dP76, dP81);
  core_terms_vjp<DrCore>(c, k, y, w, dgamma, dP76, dP81, dy, dc);
}

// relay_constant, y[0..11] (_relay_rhs_cols): the core, the synthases LuxI
// (y[8]) and LasI (y[9]) driven by P81 / P76, and the secreted C6 (y[10])
// and C12 (y[11]), which no row reads (fracLuxR / fracLasR stay at the
// initial treatments).
// Its rows over the core's terms k at y.
__device__ __forceinline__ void relay_rows(const float* c, const CoreTerms& k, const float* y,
                                           float* f) {
  core_rhs<RelayCore>(c, k, y, f);
  const float x = y[0], luxI = y[8], lasI = y[9], rc = c[RL_rc];
  f[8] = rc * k.P81 - (k.gamma + c[RL_dluxI]) * luxI;
  f[9] = rc * k.P76 - (k.gamma + c[RL_dlasI]) * lasI;
  f[10] = (c[RL_KC6] * rc * x * luxI) / (1.0f + luxI / c[RL_Klux]);
  f[11] = (c[RL_KC12] * rc * x * lasI) / (1.0f + lasI / c[RL_Klas]);
}

// the relay pullback's terms: the core's, then D6 and D12 (below)
__device__ __forceinline__ void relay_terms(const float* c, float t, const float* y, float* tp) {
  core_publish(core_terms<RelayCore>(c, t, y), tp);
  tp[N_CORE_TERMS] = 1.0f + y[8] / c[RL_Klux];
  tp[N_CORE_TERMS + 1] = 1.0f + y[9] / c[RL_Klas];
}

// (_relay_rhs_vjp_cols)  The extra rows feed the core's gamma, P76 and P81,
// so their shares join the core rows' before the core's terms are pulled
// back.  With C6' = n6 / D6, n6 = KC6 rc x luxI, D6 = 1 + luxI / Klux:
//   dn6 = w10 / D6, dD6 = -dn6 n6 / D6; D6 passes dD6 / Klux to luxI and
//   -dD6 luxI / Klux^2 to Klux (C12' likewise with KC12, lasI, Klas).
__device__ __forceinline__ void relay_rhs_vjp(const float* c, const float* tp, const float* y,
                                              const float* w, float* dy, float* dc) {
  const CoreTerms k = core_terms_at<RelayCore>(c, y, tp);
  float dgamma, dP76, dP81;
  core_rows_vjp<RelayCore>(c, k, y, w, dc, dgamma, dP76, dP81);
  const float x = y[0], luxI = y[8], lasI = y[9], rc = c[RL_rc];
  // luxI' = rc P81 - (gamma + dluxI) luxI, lasI' = rc P76 - (gamma + dlasI) lasI
  dgamma -= w[8] * luxI + w[9] * lasI;
  dP81 += w[8] * rc;
  dP76 += w[9] * rc;
  dc[RL_rc] += w[8] * k.P81 + w[9] * k.P76;
  dc[RL_dluxI] -= w[8] * luxI;
  dc[RL_dlasI] -= w[9] * lasI;
  // C6' = n6 / D6, C12' = n12 / D12
  const float D6 = tp[N_CORE_TERMS];
  const float D12 = tp[N_CORE_TERMS + 1];
  const float dn6 = div0(w[10], D6);
  const float dn12 = div0(w[11], D12);
  const float dD6 = div0(-dn6 * (c[RL_KC6] * rc * x * luxI), D6);
  const float dD12 = div0(-dn12 * (c[RL_KC12] * rc * x * lasI), D12);
  dc[RL_KC6] += dn6 * rc * x * luxI;
  dc[RL_KC12] += dn12 * rc * x * lasI;
  dc[RL_rc] += dn6 * c[RL_KC6] * x * luxI + dn12 * c[RL_KC12] * x * lasI;
  dc[RL_Klux] -= div0(dD6 * luxI, c[RL_Klux] * c[RL_Klux]);
  dc[RL_Klas] -= div0(dD12 * lasI, c[RL_Klas] * c[RL_Klas]);
  core_terms_vjp<RelayCore>(c, k, y, w, dgamma, dP76, dP81, dy, dc);
  dy[0] += dn6 * c[RL_KC6] * rc * luxI + dn12 * c[RL_KC12] * rc * lasI;
  dy[8] = -w[8] * (k.gamma + c[RL_dluxI]) + dn6 * c[RL_KC6] * rc * x + div0(dD6, c[RL_Klux]);
  dy[9] = -w[9] * (k.gamma + c[RL_dlasI]) + dn12 * c[RL_KC12] * rc * x + div0(dD12, c[RL_Klas]);
  dy[10] = 0.0f;
  dy[11] = 0.0f;
}

// degrader_constant, y[0..10] (_degrader_rhs_cols): the core, the lactonase
// AiiA (y[8]) driven by the arabinose input PBAD, and C6 (y[9]) and C12
// (y[10]), which no row reads.  aiiA' is copied as the reference writes it:
// daiiA is not multiplied by aiiA.
// Its rows over the core's terms k at y.
__device__ __forceinline__ void degrader_rows(const float* c, const CoreTerms& k, const float* y,
                                              float* f) {
  core_rhs<DegraderCore>(c, k, y, f);
  const float x = y[0], aiiA = y[8];
  f[8] = c[DG_rc] * c[DG_aI] * c[DG_PBAD] - (c[DG_daiiA] + k.gamma * aiiA);
  f[9] = x * c[DG_rC6] * aiiA;
  f[10] = x * c[DG_rC12] * aiiA;
}

// (_degrader_rhs_vjp_cols)  aiiA' feeds gamma; C6' and C12' read x, aiiA
// and the host-side rC6 / rC12.
__device__ __forceinline__ void degrader_rhs_vjp(const float* c, const float* tp, const float* y,
                                                 const float* w, float* dy, float* dc) {
  const CoreTerms k = core_terms_at<DegraderCore>(c, y, tp);
  float dgamma, dP76, dP81;
  core_rows_vjp<DegraderCore>(c, k, y, w, dc, dgamma, dP76, dP81);
  const float x = y[0], aiiA = y[8], rc = c[DG_rc];
  dgamma -= w[8] * aiiA;
  dc[DG_rc] += w[8] * c[DG_aI] * c[DG_PBAD];
  dc[DG_aI] += w[8] * rc * c[DG_PBAD];
  dc[DG_PBAD] += w[8] * rc * c[DG_aI];
  dc[DG_daiiA] -= w[8];
  dc[DG_rC6] += w[9] * x * aiiA;
  dc[DG_rC12] += w[10] * x * aiiA;
  core_terms_vjp<DegraderCore>(c, k, y, w, dgamma, dP76, dP81, dy, dc);
  const float dC = w[9] * c[DG_rC6] + w[10] * c[DG_rC12];
  dy[0] += dC * aiiA;
  dy[8] = -w[8] * k.gamma + dC * x;
  dy[9] = 0.0f;
  dy[10] = 0.0f;
}

// The families as the kernels take them: constant count NC, species count
// NS, the pullback's term count NT, the core's constant layout; right-hand
// side (its rows over the core's terms at the point), those rows, the
// pullback's terms at a point and the pullback.
struct Dr {
  enum : int { NC = N_CONST, NS = 8 };
  static constexpr int NT = N_CORE_TERMS;
  using Core = DrCore;
  static constexpr int FWD_REPORTER_WARPS = 1;  // the forward's (fwd_kernel)
  static __device__ __forceinline__ void rhs(const float* c, float t, const float* y, float* f) {
    rows(c, core_terms<DrCore>(c, t, y), y, f);
  }
  static __device__ __forceinline__ void rows(const float* c, const CoreTerms& k, const float* y,
                                              float* f) {
    core_rhs<DrCore>(c, k, y, f);
  }
  static __device__ __forceinline__ void terms(const float* c, float t, const float* y,
                                               float* tp) {
    core_publish(core_terms<DrCore>(c, t, y), tp);
  }
  static __device__ __forceinline__ void vjp(const float* c, const float* tp, const float* y,
                                             const float* w, float* dy, float* dc) {
    dr_rhs_vjp(c, tp, y, w, dy, dc);
  }
};

struct Relay {
  enum : int { NC = N_RELAY_CONST, NS = 12 };
  static constexpr int NT = N_CORE_TERMS + 2;
  using Core = RelayCore;
  // the forward's reporter warps (fwd_kernel): relay's own four reporters
  // divide twice a point, so they take a warp of their own
  static constexpr int FWD_REPORTER_WARPS = 2;
  static __device__ __forceinline__ void rhs(const float* c, float t, const float* y, float* f) {
    rows(c, core_terms<RelayCore>(c, t, y), y, f);
  }
  static __device__ __forceinline__ void rows(const float* c, const CoreTerms& k, const float* y,
                                              float* f) {
    relay_rows(c, k, y, f);
  }
  static __device__ __forceinline__ void terms(const float* c, float t, const float* y,
                                               float* tp) {
    relay_terms(c, t, y, tp);
  }
  static __device__ __forceinline__ void vjp(const float* c, const float* tp, const float* y,
                                             const float* w, float* dy, float* dc) {
    relay_rhs_vjp(c, tp, y, w, dy, dc);
  }
};

struct Degrader {
  enum : int { NC = N_DEGRADER_CONST, NS = 11 };
  static constexpr int NT = N_CORE_TERMS;
  using Core = DegraderCore;
  static constexpr int FWD_REPORTER_WARPS = 1;  // the forward's (fwd_kernel)
  static __device__ __forceinline__ void rhs(const float* c, float t, const float* y, float* f) {
    rows(c, core_terms<DegraderCore>(c, t, y), y, f);
  }
  static __device__ __forceinline__ void rows(const float* c, const CoreTerms& k, const float* y,
                                              float* f) {
    degrader_rows(c, k, y, f);
  }
  static __device__ __forceinline__ void terms(const float* c, float t, const float* y,
                                               float* tp) {
    core_publish(core_terms<DegraderCore>(c, t, y), tp);
  }
  static __device__ __forceinline__ void vjp(const float* c, const float* tp, const float* y,
                                             const float* w, float* dy, float* dc) {
    degrader_rhs_vjp(c, tp, y, w, dy, dc);
  }
};

// --------------------------------------------------------------------------
// Fixed-grid steps over any right-hand side
// --------------------------------------------------------------------------

// The point of a step at which one_step or step_vjp calls a right-hand side
// or its pullback: point 0 is y_i, then the stages' points in the order the
// step forms them (z for modeuler and midpoint; z2, z3, z4 for rk4).  The
// kernels' warps use it to find the point's shared tiles.
template <int M>
struct Stage {};

template <int METHOD>
__host__ __device__ constexpr int n_points() { return METHOD == RK4 ? 4 : 2; }

// One fixed-grid update of the S states y in place under rhs(Stage<M>, t,
// y, f) at each point M (_one_step).
template <int METHOD, int S, class Rhs>
__device__ __forceinline__ void one_step(const Rhs& rhs, float t1, float t2, float* y) {
  const float h = t2 - t1;
  float f1[S], f2[S], tmp[S];
  if constexpr (METHOD == MODEULER) {
    rhs(Stage<0>(), t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + h * f1[s];
    rhs(Stage<1>(), t2, tmp, f2);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + hh * (f1[s] + f2[s]);
  } else if constexpr (METHOD == MIDPOINT) {
    rhs(Stage<0>(), t1, y, f1);
    const float hh = 0.5f * h;
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f1[s];
    rhs(Stage<1>(), t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + h * f2[s];
  } else {  // RK4
    float k3[S], k4[S];
    const float hh = 0.5f * h;
    rhs(Stage<0>(), t1, y, f1);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f1[s];
    rhs(Stage<1>(), t1 + hh, tmp, f2);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + hh * f2[s];
    rhs(Stage<2>(), t1 + hh, tmp, k3);
#pragma unroll
    for (int s = 0; s < S; ++s) tmp[s] = y[s] + h * k3[s];
    rhs(Stage<3>(), t2, tmp, k4);
    const float h6 = h / 6.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] + h6 * (f1[s] + 2.0f * f2[s] + 2.0f * k3[s] + k4[s]);
  }
}

// The points of one fixed-grid step from z[0] = y_i (the forward half of
// _step_vjp): rhs(Stage<M>, t, z[M], f) writes the right-hand side at each
// point but the last, from which the step forms the next point.  Returns
// the last point's time.
template <int METHOD, int S, class Rhs>
__device__ __forceinline__ float step_points(const Rhs& rhs, float t1, float t2, float (*z)[S]) {
  const float h = t2 - t1;
  const float hh = 0.5f * h;
  float f[S];
  if (METHOD == MODEULER) {
    // y' = y + hh (f1 + f2), f1 = F(t1, y), f2 = F(t2, y + h f1)
    rhs(Stage<0>(), t1, z[0], f);
#pragma unroll
    for (int s = 0; s < S; ++s) z[1][s] = z[0][s] + h * f[s];
    return t2;
  } else if (METHOD == MIDPOINT) {
    // y' = y + h f2, f2 = F(t1 + hh, y + hh f1), f1 = F(t1, y)
    rhs(Stage<0>(), t1, z[0], f);
#pragma unroll
    for (int s = 0; s < S; ++s) z[1][s] = z[0][s] + hh * f[s];
    return t1 + hh;
  } else {  // RK4: y' = y + h6 (k1 + 2 k2 + 2 k3 + k4), stage k_j = F(t_j, z_j)
    const float tm = t1 + hh;
    rhs(Stage<0>(), t1, z[0], f);
#pragma unroll
    for (int s = 0; s < S; ++s) z[1][s] = z[0][s] + hh * f[s];
    rhs(Stage<1>(), tm, z[1], f);
#pragma unroll
    for (int s = 0; s < S; ++s) z[2][s] = z[0][s] + hh * f[s];
    rhs(Stage<2>(), tm, z[2], f);
#pragma unroll
    for (int s = 0; s < S; ++s) z[3][s] = z[0][s] + h * f[s];
    return t2;
  }
}

// The pullback of one fixed-grid step over its points z (the backward half
// of _step_vjp): a holds the cotangent of y_{i+1} on entry and that of y_i
// on exit; vjp(Stage<M>, t, z[M], w, dz) writes the right-hand side's
// pullback dz at point M and adds the parameters' share into the
// accumulators it holds.
template <int METHOD, int S, class Vjp>
__device__ __forceinline__ void step_pullback(const Vjp& vjp, float t1, float t2,
                                              const float (*z)[S], float* a) {
  const float h = t2 - t1;
  const float hh = 0.5f * h;
  float w[S], dz[S], d1[S];
  if (METHOD == MODEULER) {
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * a[s];
    vjp(Stage<1>(), t2, z[1], w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * a[s] + h * dz[s];
    vjp(Stage<0>(), t1, z[0], w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else if (METHOD == MIDPOINT) {
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h * a[s];
    vjp(Stage<1>(), t1 + hh, z[1], w, dz);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = hh * dz[s];
    vjp(Stage<0>(), t1, z[0], w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + dz[s] + d1[s];
  } else {  // RK4
    const float tm = t1 + hh;
    const float h6 = h / 6.0f;
    float d4[S], d3[S];
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h6 * a[s];
    vjp(Stage<3>(), t2, z[3], w, d4);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + h * d4[s];
    vjp(Stage<2>(), tm, z[2], w, d3);
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = 2.0f * h6 * a[s] + hh * d3[s];
    vjp(Stage<1>(), tm, z[1], w, dz);  // d2
#pragma unroll
    for (int s = 0; s < S; ++s) w[s] = h6 * a[s] + hh * dz[s];
    vjp(Stage<0>(), t1, z[0], w, d1);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = a[s] + d4[s] + d3[s] + dz[s] + d1[s];
  }
}

// Pullback of one fixed-grid step at y = y_i (_step_vjp): its points from
// y_i, then their pullback; rhs and vjp as above.
template <int METHOD, int S, class Rhs, class Vjp>
__device__ __forceinline__ void step_vjp(const Rhs& rhs, const Vjp& vjp, float t1, float t2,
                                         const float* y, float* a) {
  float z[n_points<METHOD>()][S];
#pragma unroll
  for (int s = 0; s < S; ++s) z[0][s] = y[s];
  step_points<METHOD, S>(rhs, t1, t2, z);
  step_pullback<METHOD, S>(vjp, t1, t2, z, a);
}

// --------------------------------------------------------------------------
// The kernels
//
// Forward (the TPU kernel's _make_kernel): a row's time loop runs in
// registers, its constants and states loaded once; the time grid is read
// through the read-only cache; each step stores out[t, s, r], so the 32
// lanes of a warp, on 32 consecutive rows, write 32 consecutive floats of
// one state row and every store coalesces.  A block runs 32 rows over
// several warps, lane l of every warp on row l: without the precision block
// (fwd_kernel) the row's species split over three warps, with it
// (prec_fwd_kernel) a warp runs the species and a warp each precision
// state, below.  The TPU kernel padded R up to its block size with
// constants = 1 and y0 = 1e-3 (pallas_ode.py:551-560) only because a grid
// cell there processes a whole block; here rows past the edge run row R - 1
// and store nothing, so no padded row exists.
//
// Backward (_make_bwd_kernel): the reverse sweep over the stored trajectory.
// The constants load into registers once, their cotangents start at zero and
// the adjoint at a = g[T-1]; for i = T-2 ... 0 the row reads y_i = traj[i,
// :, r], recomputes the step's stages from it, pulls a back through them
// (adding the constants' share into dc), and sets a = a_y + g[i].  Nothing
// but traj and g is read from device memory, each read coalesced.  The TPU
// kernel got each step's VJP by tracing jax.vjp of _one_step; here the
// pullbacks above are written out by hand.  A row is swept by several
// threads: without the precision block (bwd_kernel) by two, with it
// (prec_bwd_kernel) by five, below.
// --------------------------------------------------------------------------

// named barriers (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n_threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n_threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n_threads) : "memory");
}

__device__ __forceinline__ int next_slot(int slot, int ring) {
  return slot + 1 == ring ? 0 : slot + 1;
}

// --------------------------------------------------------------------------
// The forward without the precision block (fwd_kernel): a block of
// FWD_ROWS = 32 sample rows x 3 warps (relay 4), lane l of every warp on row
// l.  A row's species depend on each other one way, never back:
//   * x = y[0] alone sets gamma = r sig(t) (1 - x/K), and x' = gamma x;
//   * LuxR and LasR (y[6], y[7]) read gamma and set P76 and P81;
//   * every other species (RFP .. F480, y[1..5]; relay's LuxI, LasI, C6 and
//     C12; degrader's AiiA, C6 and C12) reads only gamma, P76, P81 and x.
// So the species split over warps that run ahead of each other:
//   * warp 0, the growth warp, holds x and forms each point's gamma (whose
//     sigmoid depends on the time alone, off x's chain);
//   * warp 1, the regulator warp, holds LuxR and LasR and forms each point's
//     P76 and P81 from them; its own two rows read the point's gamma;
//   * the reporter warps hold the other species and read gamma, x, P76 and
//     P81 (one warp; relay's own four, which divide twice a point, a second).
// Each warp runs one_step over its own species, with a right-hand side that
// forms its terms and rows by the family's own functions (core_terms,
// F::rows) over the point, the terms it does not own taken from a ring of
// shared slots; what it does not need is dead code.  A slot holds the terms
// of every point (y_i, then each stage's point, in the order one_step forms
// them) of two steps.
//
// Each slot has three mbarriers in shared memory (arrive, and a wait on the
// phase's parity): "gamma" (the growth warp has written the slot's gammas),
// "full" (the growth and regulator warps have written it all) and "free"
// (the regulator and reporter warps have read it).  At a slot's first point
// the growth and regulator warps wait for "free" before they write it, the
// regulator warp for "gamma", the reporter warps for "full"; each arrives
// after the slot's last point.  Every slot starts free (the regulator and
// reporter warps arrive once at each "free" first); slot n of the steps
// takes ring slot n mod FWD_RING on lap n / FWD_RING, whose parity the waits
// name.  On the H100 (NVIDIA H100 80GB HBM3, 700 W; tools/prec_fwd_compare.py)
// this beat, in order: named barriers (bar.sync holds every warp that syncs
// at one in step with the others, and a block whose barrier ids are
// computed takes all 16, so an SM held 4 blocks); a wait every point or
// every step rather than every two steps (the ring's own instructions
// outweighed what the split saved once the card was full); two or four rows
// a lane; and degrader's own species in the growth warp.
//
// Every float operation is that of the one-thread-per-row kernel this one
// replaced, in its order: each species' update the same one_step
// expression, each row the family's, each term core_terms'; gamma crosses
// the ring as the rounded product that kernel formed.  The stores stream
// (st.global.cs): the trajectory is written once here.  A lane past the edge
// (r >= R) runs row R - 1, stores its bits to row R - 1 again and reaches
// every wait.
// --------------------------------------------------------------------------
constexpr int FWD_ROWS = 32;
constexpr int FWD_RING = 4;  // slots of two steps
// blocks an SM must hold: nine hold a serving chunk's 1,125 blocks (36
// series x 1,000 samples) in one wave on 132 SMs
constexpr int FWD_MIN_BLOCKS = 9;

// mbarriers in shared memory
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity par has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int par) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(par)
      : "memory");
}

// A family's species over the forward's warps: warp 0 x = y[0], warp 1
// LuxR and LasR = y[6], y[7], then FWD_REPORTER_WARPS reporter warps over
// the reporters, species 1..5 and then 8..NS-1.
template <class F>
struct FwdSplit {
  static constexpr int N_REP = F::NS - 3;
  static constexpr int REP_WARPS = F::FWD_REPORTER_WARPS;
  static constexpr int WARPS = 2 + REP_WARPS;
  static constexpr int THREADS = FWD_ROWS * WARPS;
  static __host__ __device__ constexpr int reporter(int i) { return i < 5 ? 1 + i : 3 + i; }
  // reporter warp w runs reporters first(w) .. first(w + 1) - 1: the core's,
  // then the family's own
  static __host__ __device__ constexpr int first(int w) {
    return w == 0 ? 0 : w == REP_WARPS ? N_REP : 5;
  }
};

template <int METHOD>
struct FwdTiles {
  static constexpr int NPTS = n_points<METHOD>(), SLOT = 2 * NPTS;  // a slot's points
  unsigned long long gamma_full[FWD_RING];  // the growth warp's 32 lanes arrive
  unsigned long long full[FWD_RING];        // the growth and regulator warps'
  unsigned long long free[FWD_RING];        // the regulator and reporter warps'
  float gamma[FWD_RING][SLOT][FWD_ROWS];
  float x[FWD_RING][SLOT][FWD_ROWS];
  float P76[FWD_RING][SLOT][FWD_ROWS];
  float P81[FWD_RING][SLOT][FWD_ROWS];
};

// What every warp's right-hand side holds: the row's constants, the tiles,
// its lane, and the slot q of its step, H the step's place in the slot, and
// the parity par of the slot's lap.  Point M of the step is point H NPTS + M
// of the slot; a warp waits at the slot's first point and arrives at its
// last.
template <int METHOD, int H>
struct FwdWarpBase {
  using Tiles = FwdTiles<METHOD>;
  static constexpr int FIRST = H * Tiles::NPTS, LAST = Tiles::SLOT - 1;
  const float* c;
  Tiles* sh;
  int lane, q, par;
};

// The growth warp's right-hand side of x at point M (lane = row).
template <class F, int METHOD, int H>
struct GrowthFwdWarp : FwdWarpBase<METHOD, H> {
  using Base = FwdWarpBase<METHOD, H>;
  static constexpr int S = 1;
  static __host__ __device__ constexpr int species(int) { return 0; }
  __device__ __forceinline__ void arrive() const {
    mbar_arrive(&this->sh->gamma_full[this->q]);
    mbar_arrive(&this->sh->full[this->q]);
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    const auto& w = *this;
    constexpr int P = Base::FIRST + M;
    float z[F::NS] = {};
    z[0] = y[0];
    const CoreTerms k = core_terms<typename F::Core>(w.c, t, z);
    if constexpr (P == 0) mbar_wait(&w.sh->free[w.q], w.par);
    w.sh->gamma[w.q][P][w.lane] = k.gamma;
    w.sh->x[w.q][P][w.lane] = y[0];
    if constexpr (P == Base::LAST) arrive();
    float fz[F::NS];
    F::rows(w.c, k, z, fz);
    f[0] = fz[0];
  }
};

// The regulator warp's right-hand side of LuxR and LasR at point M.
template <class F, int METHOD, int H>
struct RegulatorFwdWarp : FwdWarpBase<METHOD, H> {
  using Base = FwdWarpBase<METHOD, H>;
  static constexpr int S = 2;
  static __host__ __device__ constexpr int species(int i) { return 6 + i; }
  __device__ __forceinline__ void arrive() const {
    mbar_arrive(&this->sh->full[this->q]);
    mbar_arrive(&this->sh->free[this->q]);
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    const auto& w = *this;
    constexpr int P = Base::FIRST + M;
    float z[F::NS] = {};
    z[6] = y[0];
    z[7] = y[1];
    CoreTerms k = core_terms<typename F::Core>(w.c, t, z);
    if constexpr (P == 0) mbar_wait(&w.sh->free[w.q], w.par);
    w.sh->P76[w.q][P][w.lane] = k.P76;
    w.sh->P81[w.q][P][w.lane] = k.P81;
    if constexpr (P == Base::LAST) mbar_arrive(&w.sh->full[w.q]);
    if constexpr (P == 0) mbar_wait(&w.sh->gamma_full[w.q], w.par);
    k.gamma = w.sh->gamma[w.q][P][w.lane];
    if constexpr (P == Base::LAST) mbar_arrive(&w.sh->free[w.q]);
    float fz[F::NS];
    F::rows(w.c, k, z, fz);
    f[0] = fz[6];
    f[1] = fz[7];
  }
};

// Reporter warp W's right-hand side of its reporters at point M.
template <class F, int METHOD, int W, int H>
struct ReporterFwdWarp : FwdWarpBase<METHOD, H> {
  using Base = FwdWarpBase<METHOD, H>;
  using Split = FwdSplit<F>;
  static constexpr int LO = Split::first(W), S = Split::first(W + 1) - LO;
  static __host__ __device__ constexpr int species(int i) { return Split::reporter(LO + i); }
  __device__ __forceinline__ void arrive() const { mbar_arrive(&this->sh->free[this->q]); }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float, const float* y, float* f) const {
    const auto& w = *this;
    constexpr int P = Base::FIRST + M;
    if constexpr (P == 0) mbar_wait(&w.sh->full[w.q], w.par);
    CoreTerms k = {};
    k.gamma = w.sh->gamma[w.q][P][w.lane];
    k.P76 = w.sh->P76[w.q][P][w.lane];
    k.P81 = w.sh->P81[w.q][P][w.lane];
    float z[F::NS] = {};
    z[0] = w.sh->x[w.q][P][w.lane];
    if constexpr (P == Base::LAST) arrive();
#pragma unroll
    for (int i = 0; i < S; ++i) z[species(i)] = y[i];
    float fz[F::NS];
    F::rows(w.c, k, z, fz);
#pragma unroll
    for (int i = 0; i < S; ++i) f[i] = fz[species(i)];
  }
};

// The warps' right-hand sides as fwd_warp takes them: At<H> for the H-th
// step of a slot.
template <class F, int METHOD>
struct GrowthWarps {
  template <int H>
  using At = GrowthFwdWarp<F, METHOD, H>;
};
template <class F, int METHOD>
struct RegulatorWarps {
  template <int H>
  using At = RegulatorFwdWarp<F, METHOD, H>;
};
template <class F, int METHOD, int W>
struct ReporterWarps {
  template <int H>
  using At = ReporterFwdWarp<F, METHOD, W, H>;
};

// One warp's share of a row's forward (Warps: the species it holds and its
// right-hand sides): the row's constants and its species' initial states,
// then T - 1 steps of one_step over them, each stored, two steps a slot.
// A slot whose second step lies past the grid's end takes its arrivals from
// the first step's warp.  A lane past the edge (r >= R) runs row R - 1 and
// stores it there too: the same bits as that row's own lane, so no store
// needs a branch.
template <class F, int METHOD, class Warps>
__device__ __forceinline__ void fwd_warp(FwdTiles<METHOD>* sh, const float* __restrict__ consts,
                                         const float* __restrict__ y0,
                                         const float* __restrict__ times,
                                         float* __restrict__ out, int lane, int r, int R, int T) {
  using W0 = typename Warps::template At<0>;
  using W1 = typename Warps::template At<1>;
  constexpr int S = W0::S;
  const int rr = min(r, R - 1);  // the row this thread runs
  const size_t stride = (size_t)R;
  float c[F::NC];
#pragma unroll
  for (int j = 0; j < F::NC; ++j) c[j] = consts[j * stride + rr];
  float y[S];
#pragma unroll
  for (int s = 0; s < S; ++s) y[s] = y0[W0::species(s) * stride + rr];
  // step i's states, streamed (written once, read by other kernels)
  auto store = [&](int i) {
    float* o = out + (size_t)i * F::NS * stride + rr;
#pragma unroll
    for (int s = 0; s < S; ++s) __stcs(o + W0::species(s) * stride, y[s]);
  };
  store(0);
  float t1 = __ldg(times);
  for (int i = 1; i < T; i += 2) {
    const int n = (i - 1) / 2;  // the slot's number
    const int q = n % FWD_RING, par = n / FWD_RING % 2;
    float t2 = __ldg(times + i);
    one_step<METHOD, S>(W0{{c, sh, lane, q, par}}, t1, t2, y);
    store(i);
    t1 = t2;
    if (i + 1 < T) {
      t2 = __ldg(times + i + 1);
      one_step<METHOD, S>(W1{{c, sh, lane, q, par}}, t1, t2, y);
      store(i + 1);
      t1 = t2;
    } else {
      W1{{c, sh, lane, q, par}}.arrive();
    }
  }
}

template <class F, int METHOD>
__global__ void __launch_bounds__(FwdSplit<F>::THREADS, FWD_MIN_BLOCKS)
fwd_kernel(const float* __restrict__ consts, const float* __restrict__ y0,
           const float* __restrict__ times, float* __restrict__ out, int R, int T) {
  using Split = FwdSplit<F>;
  __shared__ FwdTiles<METHOD> sh;
  const int lane = threadIdx.x % FWD_ROWS, warp = threadIdx.x / FWD_ROWS;
  const int r = blockIdx.x * FWD_ROWS + lane;
  if (threadIdx.x == 0) {
    for (int q = 0; q < FWD_RING; ++q) {
      mbar_init(&sh.gamma_full[q], FWD_ROWS);
      mbar_init(&sh.full[q], 2 * FWD_ROWS);
      mbar_init(&sh.free[q], FWD_ROWS * (1 + Split::REP_WARPS));
    }
  }
  __syncthreads();
  if (warp > 0) {  // every slot starts free
    for (int q = 0; q < FWD_RING; ++q) mbar_arrive(&sh.free[q]);
  }
  if (warp == 0) {
    fwd_warp<F, METHOD, GrowthWarps<F, METHOD>>(&sh, consts, y0, times, out, lane, r, R, T);
  } else if (warp == 1) {
    fwd_warp<F, METHOD, RegulatorWarps<F, METHOD>>(&sh, consts, y0, times, out, lane, r, R, T);
  } else if (warp == 2) {
    fwd_warp<F, METHOD, ReporterWarps<F, METHOD, 0>>(&sh, consts, y0, times, out, lane, r, R, T);
  } else {
    if constexpr (Split::REP_WARPS == 2)
      fwd_warp<F, METHOD, ReporterWarps<F, METHOD, 1>>(&sh, consts, y0, times, out, lane, r, R,
                                                       T);
  }
}

// --------------------------------------------------------------------------
// The backward without the precision block (bwd_kernel): a block of
// BWD_ROWS = 32 sample rows x 2 warps, lane l of both warps on row l.  A
// step's work splits by whether it depends on the adjoint a:
//   * warp 0, the stage warp, runs ahead: it reads y_i and g_i (the next
//     step's are loaded while it works on this one), forms the step's points
//     (step_points) and the family's terms at each point that the pullback
//     takes (F::terms: the core's sigmoid, divisions and sums, relay's D6 and
//     D12), and writes them with g_i into the next slot of a ring of shared
//     tiles (4 slots, rk4 2);
//   * warp 1, the pullback warp, holds the row's constants, their cotangents
//     dc and the adjoint, and runs the step's pullback (step_pullback, the
//     family's F::vjp at each point) over the slot's points and terms, then
//     adds g_i.
// Each slot has a "full" and a "free" named barrier: the stage warp arrives
// at "full" without waiting once it has written the slot, where the pullback
// warp waits; the pullback warp arrives at "free" once it has read the slot,
// where the stage warp waits before it writes the slot again, a ring later.
// Every slot starts free (the pullback warp arrives once at each "free"
// barrier first), and the stage warp drains the last arrivals at the end, so
// every barrier completes.
//
// Each value is formed by the expression, from the operands and in the order
// of the one-thread-per-row sweep this kernel replaced: the points and terms
// in F::terms and step_points, the pullback in step_pullback and F::vjp.
// The terms published are the ones that end in a division or a sum; a
// product is formed again where it is used (core_terms_at), and the
// pullback warp's step is one basic block, so nvcc contracts the pullback's
// products into adds as it did in that sweep: dc and dy0 equal that sweep's
// bit for bit in modeuler and midpoint, and in rk4 for relay and degrader;
// in dr's rk4 the outputs that read dgamma (dc of r, K, tlag; dy0 of x)
// move by float32 rounding, nvcc contracting dgamma's sum otherwise.  Rows
// past the edge (r >= R) sweep row R - 1, store nothing and reach every
// barrier.
// --------------------------------------------------------------------------
constexpr int BWD_ROWS = 32;
constexpr int BWD_THREADS = BWD_ROWS * 2;  // the stage warp and the pullback warp

template <class F, int METHOD>
struct BwdTiles {
  // the ring's slots (relay's rk4 stays under 48 KB of static shared memory)
  static constexpr int S = F::NS, NPTS = n_points<METHOD>(), RING = METHOD == RK4 ? 2 : 4;
  // named barriers: a "full" and a "free" one a slot
  static constexpr int FULL = 1, FREE = FULL + RING;
  float z[RING][NPTS][S][BWD_ROWS];       // step i's points: y_i, then the stages'
  float tp[RING][NPTS][F::NT][BWD_ROWS];  // the family's terms at each point
  float g[RING][S][BWD_ROWS];             // g_i
};

// The stage warp's right-hand side at point M (lane = row): the point and
// its terms into slot q.
template <class F, int METHOD>
struct StageWarp {
  BwdTiles<F, METHOD>* sh;
  const float* c;
  int lane, q;
  template <int M>
  __device__ __forceinline__ void publish(Stage<M>, float t, const float* z) const {
    float tp[F::NT];
    F::terms(c, t, z, tp);
#pragma unroll
    for (int s = 0; s < F::NS; ++s) sh->z[q][M][s][lane] = z[s];
#pragma unroll
    for (int j = 0; j < F::NT; ++j) sh->tp[q][M][j][lane] = tp[j];
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* z, float* f) const {
    publish(Stage<M>(), t, z);
    F::rhs(c, t, z, f);
  }
};

// The pullback warp's pullback at point M, over the terms in slot q.
template <class F, int METHOD>
struct PullbackWarp {
  BwdTiles<F, METHOD>* sh;
  const float* c;
  float* dc;
  int lane, q;
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float, const float* z, const float* w,
                                             float* dy) const {
    float tp[F::NT];
#pragma unroll
    for (int j = 0; j < F::NT; ++j) tp[j] = sh->tp[q][M][j][lane];
    F::vjp(c, tp, z, w, dy, dc);
  }
};

template <class F, int METHOD>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_kernel(const float* __restrict__ consts, const float* __restrict__ times,
           const float* __restrict__ traj, const float* __restrict__ g,
           float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  using Tiles = BwdTiles<F, METHOD>;
  constexpr int S = F::NS, NPTS = Tiles::NPTS, RING = Tiles::RING;
  __shared__ Tiles sh;
  const int lane = threadIdx.x % BWD_ROWS, warp = threadIdx.x / BWD_ROWS;
  const int r = blockIdx.x * BWD_ROWS + lane;
  const int rr = min(r, R - 1);  // the row this thread sweeps
  const size_t stride = (size_t)R;
  const size_t tstride = (size_t)S * stride;

  float c[F::NC];
#pragma unroll
  for (int j = 0; j < F::NC; ++j) c[j] = consts[j * stride + rr];
  int q = 0;
  float t2 = __ldg(times + (T - 1));

  if (warp == 0) {  // the stage warp
    float y[S], gi[S];
    const size_t first = (size_t)max(T - 2, 0) * tstride + rr;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      y[s] = traj[first + s * stride];
      gi[s] = g[first + s * stride];
    }
    for (int i = T - 2; i >= 0; --i) {
      const float t1 = __ldg(times + i);
      const size_t next = (size_t)max(i - 1, 0) * tstride + rr;
      float yn[S], gn[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        yn[s] = traj[next + s * stride];
        gn[s] = g[next + s * stride];
      }
      bar_sync(Tiles::FREE + q, BWD_THREADS);
      float z[NPTS][S];
#pragma unroll
      for (int s = 0; s < S; ++s) z[0][s] = y[s];
      const StageWarp<F, METHOD> stage{&sh, c, lane, q};
      const float t_last = step_points<METHOD, S>(stage, t1, t2, z);
      stage.publish(Stage<NPTS - 1>(), t_last, z[NPTS - 1]);
#pragma unroll
      for (int s = 0; s < S; ++s) sh.g[q][s][lane] = gi[s];
      bar_arrive(Tiles::FULL + q, BWD_THREADS);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        y[s] = yn[s];
        gi[s] = gn[s];
      }
      q = next_slot(q, RING);
      t2 = t1;
    }
    // the pullback warp's last arrival at each "free" barrier
    for (int n = 0; n < RING; ++n) {
      bar_sync(Tiles::FREE + q, BWD_THREADS);
      q = next_slot(q, RING);
    }
  } else {  // the pullback warp
    float dc[F::NC], a[S];
#pragma unroll
    for (int j = 0; j < F::NC; ++j) dc[j] = 0.0f;
    const float* gT = g + (size_t)(T - 1) * tstride + rr;
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = gT[s * stride];
#pragma unroll
    for (int n = 0; n < RING; ++n) bar_arrive(Tiles::FREE + n, BWD_THREADS);
    for (int i = T - 2; i >= 0; --i) {
      const float t1 = __ldg(times + i);
      bar_sync(Tiles::FULL + q, BWD_THREADS);
      float z[NPTS][S];
#pragma unroll
      for (int m = 0; m < NPTS; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s) z[m][s] = sh.z[q][m][s][lane];
      const PullbackWarp<F, METHOD> pullback{&sh, c, dc, lane, q};
      step_pullback<METHOD, S>(pullback, t1, t2, z, a);
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] += sh.g[q][s][lane];
      bar_arrive(Tiles::FREE + q, BWD_THREADS);
      q = next_slot(q, RING);
      t2 = t1;
    }
    if (r < R) {
#pragma unroll
      for (int j = 0; j < F::NC; ++j) dc_out[j * stride + r] = dc[j];
#pragma unroll
      for (int s = 0; s < S; ++s) dy0_out[s * stride + r] = a[s];
    }
  }
}

// --------------------------------------------------------------------------
// The backward with the precision block (prec_bwd_kernel): a block of
// PREC_BWD_ROWS = 32 sample rows x (N_PREC + 1) warps.  Lane l of every warp
// works on row l of the block.  Warp N_PREC, the core warp, holds the row's
// constants, their cotangents and the species' adjoint, and runs the family's
// right-hand side and pullback (F::rhs, F::vjp) and the species' part of
// step_vjp.  Warp j < N_PREC, a precision warp, holds precision state j: its
// adjoint, its nets' rows j (production) and N_PREC + j (degradation) of W,
// and those rows' weight cotangents, 2 n_feat(NS) partial sums kept in
// registers for the whole sweep.  Both kinds of warp run step_vjp, over the
// NS species and over the one state, and meet at each point of the step
// (Stage<M>) through shared tiles and named barriers:
//   * the core warp publishes the point's species (z[M]) and arrives at
//     BAR_POINT + M without waiting; the precision warps wait there, compute
//     the point's features tanh t, tanh y_s, a few each, into feat[M], meet
//     at BAR_PREC, and each forms its p_j, d_j and their sigmoids, which it
//     keeps for the point's pullback;
//   * in a pullback each precision warp forms dp_j, dd_j (into dpd[M]) and
//     its state's cotangent, meets the others at BAR_PREC, sums df[2 + s]
//     over j for a few species s (into df[M]), arrives at BAR_SHARE + M and
//     only then adds dp_j f and dd_j f into its registers; the core warp runs
//     F::vjp meanwhile, waits at BAR_SHARE + M and adds each species' share
//     df[2 + s] (1 - tanh^2 y_s).
// The precision states feed nothing back into the species, so the precision
// warps need from the core warp only the points, and the core warp waits
// only for the shares.  Each tile is written at most once per step between
// the barriers that order its readers; feat, which the core warp reads after
// the precision warps have moved on, alternates between two copies by step
// parity.
//
// Every float sum is the one-thread-per-row sweep's, in its order: p_j and
// d_j over the features in index order, df[k] over j in order, each weight
// cotangent entry over the row's pullbacks in the sweep's order, then over
// the block's 32 rows in row order (the block's partial, at the end), then
// over blocks in the wrapper.  The expressions keep that sweep's shapes and
// each warp's step stays one basic block, so nvcc contracts products into
// adds as it did there: midpoint's outputs equal that sweep's bit for bit;
// in modeuler's w = hh a + h dz (species 0 and 1) and in dr's rk4 nvcc
// fuses the other product, which moves dc and dy0 by float32 rounding.  No
// float atomics: two runs give
// the same dW bit for bit, as the TPU kernel's per-cell partials summed on
// the host (pallas_ode.py:533).  Rows past the edge (r >= R) sweep row R - 1
// and keep nothing: they write no dc or dy0 and put exact zeros into the
// block's partial, and they reach every barrier.
// --------------------------------------------------------------------------
constexpr int PREC_BWD_ROWS = 32;
constexpr int PREC_BWD_THREADS = PREC_BWD_ROWS * (N_PREC + 1);
constexpr int PREC_WARP_THREADS = PREC_BWD_ROWS * N_PREC;  // the precision warps'
// named barriers
constexpr int BAR_POINT = 1;  // + M: point M's species published (M < 4)
constexpr int BAR_SHARE = 5;  // + M: pullback M's df ready
constexpr int BAR_PREC = 9;   // the precision warps among themselves
constexpr int BAR_DONE = 10;  // the core warp has read its last tile

template <int NS, int NPTS>
struct PrecBwdTiles {
  float W[n_w(NS)];
  float z[NPTS][NS][PREC_BWD_ROWS];                           // point M's species
  float feat[2][NPTS][n_feat(NS) - 1][PREC_BWD_ROWS];         // its features 1.. (parity)
  float dpd[NPTS][2 * N_PREC][PREC_BWD_ROWS];                 // pullback M's dp_j, dd_j
  float df[NPTS][NS][PREC_BWD_ROWS];                          // pullback M's df[2 + s]
  float dW[n_w(NS)][PREC_BWD_ROWS + 1];                       // the rows' partials, at the end
};

// The core warp's right-hand side and pullback at point M (lane = row).
template <class F, int NPTS>
struct CoreWarp {
  using Tiles = PrecBwdTiles<F::NS, NPTS>;
  const float* c;
  float* dc;
  Tiles* sh;
  int lane, par;

  template <int M>
  __device__ __forceinline__ void publish(const float* y) const {
#pragma unroll
    for (int s = 0; s < F::NS; ++s) sh->z[M][s][lane] = y[s];
    bar_arrive(BAR_POINT + M, PREC_BWD_THREADS);
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    publish<M>(y);
    F::rhs(c, t, y, f);
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, const float* w,
                                             float* dy) const {
    if constexpr (M == NPTS - 1) publish<M>(y);  // the last point has no right-hand side
    float tp[F::NT];
    F::terms(c, t, y, tp);
    F::vjp(c, tp, y, w, dy, dc);
    bar_sync(BAR_SHARE + M, PREC_BWD_THREADS);
#pragma unroll
    for (int s = 0; s < F::NS; ++s) {
      const float f = sh->feat[par][M][1 + s][lane];
      dy[s] += sh->df[M][s][lane] * (1.0f - f * f);
    }
  }
};

// Precision warp j's right-hand side and pullback of its state at point M
// (the precision rows of _prec_rhs_cols and _prec_rhs_vjp_cols): with p =
// Wp f, d = Wd f, sp = sigmoid(p), sd = sigmoid(d) and w_j the cotangent of
// dprec_j,
//   dprec_j = sp_j - sd_j prec_j;  its pullback gives prec_j -w_j sd_j,
//   dp_j = w_j sp_j (1 - sp_j), dd_j = -w_j prec_j sd_j (1 - sd_j),
//   dW[j, :] += dp_j f, dW[4 + j, :] += dd_j f, df = Wp^T dp + Wd^T dd,
// and species s gets df[2 + s] (1 - tanh^2 y_s) (added by the core warp);
// f[0] = 1 and f[1] = tanh t pass nothing on.
template <int NS, int NPTS>
struct PrecWarp {
  static constexpr int NF = n_feat(NS);
  static constexpr int NQ = (NS + N_PREC - 1) / N_PREC;  // species whose df the warp sums
  using Tiles = PrecBwdTiles<NS, NPTS>;
  Tiles* sh;
  int lane, j, par;
  // in registers: rows j and N_PREC + j of W; for each of the warp's
  // species s (below) the 2 N_PREC entries of W's column 2 + s; the rows'
  // weight cotangents; each point's features and sigmoids
  const float* Wp;
  const float* Wd;
  const float* Wdf;  // [NQ][2 N_PREC]
  float* dWp;
  float* dWd;
  float* f;  // [NPTS][NF]
  float* sp;
  float* sd;

  // the q-th species whose df[2 + s] warp j sums: j, j + 4, ... (the last
  // warps repeat the last one)
  static __device__ __forceinline__ int species(int j, int q) {
    return min(j + N_PREC * q, NS - 1);
  }

  // wait for point M, compute its features 1 + j, 1 + j + 4, ... (the last
  // warps repeat the last one), then p_j, d_j.  No branch: a step's code
  // stays one basic block, within which nvcc contracts its products into
  // adds as it does in the one-thread-per-row sweep.
  template <int M>
  __device__ __forceinline__ void point(float t) const {
    bar_sync(BAR_POINT + M, PREC_BWD_THREADS);
#pragma unroll
    for (int i = 0; i < (NF - 1 + N_PREC - 1) / N_PREC; ++i) {
      const int e = min(j + N_PREC * i, NF - 2);  // feature e + 1: tanh t, then tanh y_{e-1}
      const float x = sh->z[M][max(e - 1, 0)][lane];
      sh->feat[par][M][e][lane] = tanhf(e == 0 ? t : x);
    }
    bar_sync(BAR_PREC, PREC_WARP_THREADS);
    float* fm = f + M * NF;
    fm[0] = 1.0f;
#pragma unroll
    for (int k = 1; k < NF; ++k) fm[k] = sh->feat[par][M][k - 1][lane];
    float p = 0.0f, d = 0.0f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      p += Wp[k] * fm[k];
      d += Wd[k] * fm[k];
    }
    sp[M] = sigmoidf(p);
    sd[M] = sigmoidf(d);
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f1) const {
    point<M>(t);
    f1[0] = sp[M] - sd[M] * y[0];
  }
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, const float* w,
                                             float* dy) const {
    if constexpr (M == NPTS - 1) point<M>(t);
    const float wv = w[0];
    const float spm = sp[M], sdm = sd[M];
    const float dp = wv * spm * (1.0f - spm);
    const float dd = -wv * y[0] * sdm * (1.0f - sdm);
    dy[0] = -wv * sdm;
    sh->dpd[M][j][lane] = dp;
    sh->dpd[M][N_PREC + j][lane] = dd;
    bar_sync(BAR_PREC, PREC_WARP_THREADS);
    float dpd[2 * N_PREC];
#pragma unroll
    for (int i = 0; i < 2 * N_PREC; ++i) dpd[i] = sh->dpd[M][i][lane];
    // df[2 + s] for the warp's species, summed over the nets' rows in order
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float* Wk = Wdf + q * 2 * N_PREC;
      float df = 0.0f;
#pragma unroll
      for (int i = 0; i < N_PREC; ++i) df += Wk[i] * dpd[i] + Wk[N_PREC + i] * dpd[N_PREC + i];
      sh->df[M][species(j, q)][lane] = df;
    }
    bar_arrive(BAR_SHARE + M, PREC_BWD_THREADS);
    const float* fm = f + M * NF;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      dWp[k] += dp * fm[k];
      dWd[k] += dd * fm[k];
    }
  }
};

template <class F, int METHOD>
__global__ void __launch_bounds__(PREC_BWD_THREADS, 2)
prec_bwd_kernel(const float* __restrict__ wmat, const float* __restrict__ consts,
                const float* __restrict__ times, const float* __restrict__ traj,
                const float* __restrict__ g, float* __restrict__ dw_out,
                float* __restrict__ dc_out, float* __restrict__ dy0_out, int R, int T) {
  constexpr int NS = F::NS, S = NS + N_PREC, NF = n_feat(NS), NW = n_w(NS);
  constexpr int NPTS = n_points<METHOD>();
  __shared__ PrecBwdTiles<NS, NPTS> sh;
  const int tid = threadIdx.x;
  const int lane = tid % PREC_BWD_ROWS, warp = tid / PREC_BWD_ROWS;
  for (int e = tid; e < NW; e += PREC_BWD_THREADS) sh.W[e] = wmat[e];
  __syncthreads();

  const int r = blockIdx.x * PREC_BWD_ROWS + lane;
  const int rr = min(r, R - 1);  // the row this thread sweeps
  const size_t stride = (size_t)R;
  const size_t tstride = (size_t)S * stride;
  const float* gT = g + (size_t)(T - 1) * tstride + rr;

  if (warp == N_PREC) {
    float c[F::NC], dc[F::NC];
#pragma unroll
    for (int q = 0; q < F::NC; ++q) {
      c[q] = consts[q * stride + rr];
      dc[q] = 0.0f;
    }
    float a[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) a[s] = gT[s * stride];

    float t2 = __ldg(times + (T - 1));
    for (int i = T - 2; i >= 0; --i) {
      const float t1 = __ldg(times + i);
      const float* yi = traj + (size_t)i * tstride + rr;
      const float* gi = g + (size_t)i * tstride + rr;
      float y[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) y[s] = yi[s * stride];
      const CoreWarp<F, NPTS> core{c, dc, &sh, lane, i & 1};
      step_vjp<METHOD, NS>(core, core, t1, t2, y, a);
#pragma unroll
      for (int s = 0; s < NS; ++s) a[s] += gi[s * stride];
      t2 = t1;
    }
    bar_arrive(BAR_DONE, PREC_BWD_THREADS);

    if (r < R) {
#pragma unroll
      for (int q = 0; q < F::NC; ++q) dc_out[q * stride + r] = dc[q];
#pragma unroll
      for (int s = 0; s < NS; ++s) dy0_out[s * stride + r] = a[s];
    }
  } else {
    const int j = warp;
    using Prec = PrecWarp<NS, NPTS>;
    float Wp[NF], Wd[NF], Wdf[Prec::NQ * 2 * N_PREC], dWp[NF], dWd[NF];
    float f[NPTS * NF], sp[NPTS], sd[NPTS];
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      Wp[k] = sh.W[j * NF + k];
      Wd[k] = sh.W[(N_PREC + j) * NF + k];
      dWp[k] = 0.0f;
      dWd[k] = 0.0f;
    }
#pragma unroll
    for (int q = 0; q < Prec::NQ; ++q)
#pragma unroll
      for (int i = 0; i < 2 * N_PREC; ++i)
        Wdf[q * 2 * N_PREC + i] = sh.W[i * NF + 2 + Prec::species(j, q)];
    float a[1] = {gT[(NS + j) * stride]};

    float t2 = __ldg(times + (T - 1));
    for (int i = T - 2; i >= 0; --i) {
      const float t1 = __ldg(times + i);
      float y[1] = {traj[(size_t)i * tstride + (NS + j) * stride + rr]};
      const Prec prec{&sh, lane, j, i & 1, Wp, Wd, Wdf, dWp, dWd, f, sp, sd};
      step_vjp<METHOD, 1>(prec, prec, t1, t2, y, a);
      a[0] += g[(size_t)i * tstride + (NS + j) * stride + rr];
      t2 = t1;
    }
    if (r < R) dy0_out[(NS + j) * stride + r] = a[0];

    bar_sync(BAR_DONE, PREC_BWD_THREADS);
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      sh.dW[j * NF + k][lane] = r < R ? dWp[k] : 0.0f;
      sh.dW[(N_PREC + j) * NF + k][lane] = r < R ? dWd[k] : 0.0f;
    }
  }

  // the block's partial sum of dW, each entry summed over the 32 rows in
  // row order
  __syncthreads();
  for (int e = tid; e < NW; e += PREC_BWD_THREADS) {
    float sum = 0.0f;
    for (int q = 0; q < PREC_BWD_ROWS; ++q) sum += sh.dW[e][q];
    dw_out[(size_t)blockIdx.x * NW + e] = sum;
  }
}

// --------------------------------------------------------------------------
// The forward with the precision block (prec_fwd_kernel): a block of
// PREC_FWD_ROWS = 32 sample rows x (N_PREC + 1) warps, lane l of every warp
// on row l, as the backward's.  The precision states feed nothing back into
// the species, so the species run ahead:
//   * warp N_PREC, the species warp, holds the row's
//     constants and species and runs F::rhs and the species' part of
//     one_step, storing out[i, s, r] for s < NS: a one-thread-per-row
//     forward of the species but for one thing.  At each point of a step
//     (y_i, then each stage's point, in the order one_step forms them) it
//     first writes the point's features tanh
//     y_s into the next slot of a ring of shared tiles, z[slot], and
//     arrives at the slot's "full" barrier without waiting;
//   * warp j < N_PREC, a precision warp, holds precision state j and rows j
//     (production) and N_PREC + j (degradation) of W in registers and runs
//     one_step over its one state.  At each point it computes tanh t, waits
//     at the slot's "full" barrier, reads the features, arrives at the
//     slot's "free" barrier, and forms dv_j = sigmoid(Wp . f) - sigmoid(Wd
//     . f) v_j (the precision rows of _prec_rhs_cols).
// The species warp waits at a slot's "free" barrier only before it writes
// the slot again, RING points later: the ring holds about two steps' points
// (16 named barriers bound rk4's to 7).  Every slot starts free (each
// precision warp arrives once at each "free" barrier first), and the species
// warp drains the last arrivals at the end, so every barrier completes.
// The species warp computes the features tanh y_s, which its chain can
// overlap: on the H100 that beat precision warps that share them out or
// each compute them all, and precision warps of 2 or 4 states.
//
// Every float operation is that of the one-thread-per-row kernel that ran
// the block before (fwd_kernel with it), in its order: the same one_step
// over the species and over each precision state, p and d summed from 0 over the
// features in index order, the same stage times from the same grid loads.
// Each warp's step stays one basic block (fixed-trip loops, clamped
// indices, selects), within which nvcc contracts products into adds as it
// did there: midpoint and rk4 give that kernel's trajectory bit for bit;
// in modeuler's f1 + f2 nvcc fuses the other product of species 0, as it
// does in a one-thread-per-row forward of the plain kinds.  Rows past the edge (r >= R) run row
// R - 1, store nothing and reach every barrier.
// --------------------------------------------------------------------------
constexpr int PREC_FWD_ROWS = 32;
constexpr int PREC_FWD_THREADS = PREC_FWD_ROWS * (N_PREC + 1);

// the ring's slots: two steps of points, rk4's bounded by the 15 named
// barriers (0 is __syncthreads): a "full" and a "free" one a slot
template <int METHOD>
__host__ __device__ constexpr int fwd_ring() { return METHOD == RK4 ? 7 : 2 * n_points<METHOD>(); }

template <int NS, int RING>
struct PrecFwdTiles {
  static constexpr int BAR_FULL = 1;         // + slot: the slot's features written
  static constexpr int BAR_FREE = 1 + RING;  // + slot: the precision warps have read them
  float W[n_w(NS)];
  float z[RING][NS][PREC_FWD_ROWS];  // a point's features tanh y_s
};

// The species warp's right-hand side at the next point (lane = row).
template <class F, int RING>
struct SpeciesFwdWarp {
  using Tiles = PrecFwdTiles<F::NS, RING>;
  const float* c;
  Tiles* sh;
  int lane;
  int* slot;
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* f) const {
    const int q = *slot;
    bar_sync(Tiles::BAR_FREE + q, PREC_FWD_THREADS);
#pragma unroll
    for (int s = 0; s < F::NS; ++s) sh->z[q][s][lane] = tanhf(y[s]);
    bar_arrive(Tiles::BAR_FULL + q, PREC_FWD_THREADS);
    *slot = next_slot(q, RING);
    F::rhs(c, t, y, f);
  }
};

// A precision warp's right-hand side of its state at the next point.
template <int NS, int RING>
struct PrecFwdWarp {
  static constexpr int NF = n_feat(NS);
  using Tiles = PrecFwdTiles<NS, RING>;
  Tiles* sh;
  int lane;
  const float* Wp;  // in registers: its state's row of W (production)
  const float* Wd;  // ... and its degradation row
  int* slot;
  template <int M>
  __device__ __forceinline__ void operator()(Stage<M>, float t, const float* y, float* dv) const {
    const int q = *slot;
    float f[NF];
    f[0] = 1.0f;
    f[1] = tanhf(t);
    bar_sync(Tiles::BAR_FULL + q, PREC_FWD_THREADS);
#pragma unroll
    for (int s = 0; s < NS; ++s) f[2 + s] = sh->z[q][s][lane];
    bar_arrive(Tiles::BAR_FREE + q, PREC_FWD_THREADS);
    *slot = next_slot(q, RING);
    float p = 0.0f, d = 0.0f;
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      p += Wp[k] * f[k];
      d += Wd[k] * f[k];
    }
    dv[0] = sigmoidf(p) - sigmoidf(d) * y[0];
  }
};

template <class F, int METHOD>
__global__ void __launch_bounds__(PREC_FWD_THREADS, 3)
prec_fwd_kernel(const float* __restrict__ wmat, const float* __restrict__ consts,
                const float* __restrict__ y0, const float* __restrict__ times,
                float* __restrict__ out, int R, int T) {
  constexpr int NS = F::NS, S = NS + N_PREC, NF = n_feat(NS), NW = n_w(NS);
  constexpr int RING = fwd_ring<METHOD>();
  using Tiles = PrecFwdTiles<NS, RING>;
  __shared__ Tiles sh;
  const int tid = threadIdx.x;
  const int lane = tid % PREC_FWD_ROWS, warp = tid / PREC_FWD_ROWS;
  for (int e = tid; e < NW; e += PREC_FWD_THREADS) sh.W[e] = wmat[e];
  __syncthreads();

  const int r = blockIdx.x * PREC_FWD_ROWS + lane;
  const int rr = min(r, R - 1);  // the row this thread runs
  const size_t stride = (size_t)R;
  int slot = 0;

  if (warp == N_PREC) {
    float c[F::NC];
#pragma unroll
    for (int q = 0; q < F::NC; ++q) c[q] = consts[q * stride + rr];
    float y[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) y[s] = y0[s * stride + rr];
    if (r < R) {
#pragma unroll
      for (int s = 0; s < NS; ++s) out[s * stride + r] = y[s];
    }
    const SpeciesFwdWarp<F, RING> species{c, &sh, lane, &slot};
    float t1 = __ldg(times);
    for (int i = 1; i < T; ++i) {
      const float t2 = __ldg(times + i);
      one_step<METHOD, NS>(species, t1, t2, y);
      if (r < R) {
        float* o = out + (size_t)i * S * stride + r;
#pragma unroll
        for (int s = 0; s < NS; ++s) o[s * stride] = y[s];
      }
      t1 = t2;
    }
    // the precision warps' last arrival at each "free" barrier
    for (int q = 0; q < RING; ++q) {
      bar_sync(Tiles::BAR_FREE + slot, PREC_FWD_THREADS);
      slot = next_slot(slot, RING);
    }
  } else {
    const int j = NS + warp;  // its state
    float Wp[NF], Wd[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      Wp[k] = sh.W[warp * NF + k];
      Wd[k] = sh.W[(N_PREC + warp) * NF + k];
    }
#pragma unroll
    for (int q = 0; q < RING; ++q) bar_arrive(Tiles::BAR_FREE + q, PREC_FWD_THREADS);
    float v[1] = {y0[j * stride + rr]};
    if (r < R) out[j * stride + r] = v[0];
    const PrecFwdWarp<NS, RING> prec{&sh, lane, Wp, Wd, &slot};
    float t1 = __ldg(times);
    for (int i = 1; i < T; ++i) {
      const float t2 = __ldg(times + i);
      one_step<METHOD, 1>(prec, t1, t2, v);
      if (r < R) out[((size_t)i * S + j) * stride + r] = v[0];
      t1 = t2;
    }
  }
}

// The launchers behind the C entry points.  All pointers are device pointers
// of contiguous float32 tensors (wmat and dw null without the precision
// block; dw holds ceil(R / 32) partials of [8, 2 + NS]); stream is a
// cudaStream_t.  They return the cudaError_t of the launch (0 on success); a
// bad method or shape returns cudaErrorInvalidValue without launching.
template <class F, bool PREC>
int fwd_launch(const float* wmat, const float* consts, const float* y0, const float* times,
               float* out, int R, int T, int method, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (PREC) {
    const dim3 block(PREC_FWD_THREADS);
    const dim3 grid((unsigned)((R + PREC_FWD_ROWS - 1) / PREC_FWD_ROWS));
    switch (method) {
      case MODEULER:
        prec_fwd_kernel<F, MODEULER><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
        break;
      case MIDPOINT:
        prec_fwd_kernel<F, MIDPOINT><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
        break;
      case RK4:
        prec_fwd_kernel<F, RK4><<<grid, block, 0, s>>>(wmat, consts, y0, times, out, R, T);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const dim3 block(FwdSplit<F>::THREADS);
    const dim3 grid((unsigned)((R + FWD_ROWS - 1) / FWD_ROWS));
    switch (method) {
      case MODEULER:
        fwd_kernel<F, MODEULER><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
        break;
      case MIDPOINT:
        fwd_kernel<F, MIDPOINT><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
        break;
      case RK4:
        fwd_kernel<F, RK4><<<grid, block, 0, s>>>(consts, y0, times, out, R, T);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

template <class F, bool PREC>
int bwd_launch(const float* wmat, const float* consts, const float* times, const float* traj,
               const float* g, float* dw, float* dc, float* dy0, int R, int T, int method,
               void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (PREC) {
    const dim3 block(PREC_BWD_THREADS);
    const dim3 grid((unsigned)((R + PREC_BWD_ROWS - 1) / PREC_BWD_ROWS));
    switch (method) {
      case MODEULER:
        prec_bwd_kernel<F, MODEULER><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc,
                                                            dy0, R, T);
        break;
      case MIDPOINT:
        prec_bwd_kernel<F, MIDPOINT><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc,
                                                            dy0, R, T);
        break;
      case RK4:
        prec_bwd_kernel<F, RK4><<<grid, block, 0, s>>>(wmat, consts, times, traj, g, dw, dc, dy0,
                                                       R, T);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const dim3 block(BWD_THREADS);
    const dim3 grid((unsigned)((R + BWD_ROWS - 1) / BWD_ROWS));
    switch (method) {
      case MODEULER:
        bwd_kernel<F, MODEULER><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
        break;
      case MIDPOINT:
        bwd_kernel<F, MIDPOINT><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
        break;
      case RK4:
        bwd_kernel<F, RK4><<<grid, block, 0, s>>>(consts, times, traj, g, dc, dy0, R, T);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// A kernel's block for method on the current card: its sample rows, its
// threads, its static shared memory in bytes, its registers a thread and how
// many such blocks one SM holds at once.  Returns the cudaError_t of the query
// (0 on success).
template <class Kernel>
int block_of(Kernel kernel, int n_rows, int n_threads, int* rows, int* threads, int* smem_bytes,
             int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *rows = n_rows;
  *threads = n_threads;
  *smem_bytes = (int)attr.sharedSizeBytes;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, n_threads, 0);
}

template <class F>
int fwd_block(int method, int* rows, int* threads, int* smem_bytes, int* registers,
              int* blocks_per_sm) {
  switch (method) {
    case MODEULER:
      return block_of(fwd_kernel<F, MODEULER>, FWD_ROWS, FwdSplit<F>::THREADS, rows, threads,
                      smem_bytes, registers, blocks_per_sm);
    case MIDPOINT:
      return block_of(fwd_kernel<F, MIDPOINT>, FWD_ROWS, FwdSplit<F>::THREADS, rows, threads,
                      smem_bytes, registers, blocks_per_sm);
    case RK4:
      return block_of(fwd_kernel<F, RK4>, FWD_ROWS, FwdSplit<F>::THREADS, rows, threads,
                      smem_bytes, registers, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int prec_fwd_block(int method, int* rows, int* threads, int* smem_bytes, int* registers,
                   int* blocks_per_sm) {
  switch (method) {
    case MODEULER:
      return block_of(prec_fwd_kernel<F, MODEULER>, PREC_FWD_ROWS, PREC_FWD_THREADS, rows,
                      threads, smem_bytes, registers, blocks_per_sm);
    case MIDPOINT:
      return block_of(prec_fwd_kernel<F, MIDPOINT>, PREC_FWD_ROWS, PREC_FWD_THREADS, rows,
                      threads, smem_bytes, registers, blocks_per_sm);
    case RK4:
      return block_of(prec_fwd_kernel<F, RK4>, PREC_FWD_ROWS, PREC_FWD_THREADS, rows,
                      threads, smem_bytes, registers, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class F, bool PREC, int METHOD>
int bwd_block_of(int* rows, int* threads, int* smem_bytes, int* registers, int* blocks_per_sm) {
  if constexpr (PREC) {
    return block_of(prec_bwd_kernel<F, METHOD>, PREC_BWD_ROWS, PREC_BWD_THREADS, rows, threads,
                    smem_bytes, registers, blocks_per_sm);
  } else {
    return block_of(bwd_kernel<F, METHOD>, BWD_ROWS, BWD_THREADS, rows, threads, smem_bytes,
                    registers, blocks_per_sm);
  }
}

// A backward kernel's block (block_of), with the precision block or without
template <class F, bool PREC>
int bwd_block(int method, int* rows, int* threads, int* smem_bytes, int* registers,
              int* blocks_per_sm) {
  switch (method) {
    case MODEULER:
      return bwd_block_of<F, PREC, MODEULER>(rows, threads, smem_bytes, registers, blocks_per_sm);
    case MIDPOINT:
      return bwd_block_of<F, PREC, MIDPOINT>(rows, threads, smem_bytes, registers, blocks_per_sm);
    case RK4:
      return bwd_block_of<F, PREC, RK4>(rows, threads, smem_bytes, registers, blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
