// The element residual and element Jacobian of one tet, evaluated by one
// thread from inputs in registers. Shared by K6 (element_rows.cu: inputs
// read from packed rows), K4/K5 (gather_elements.cu: inputs gathered from
// the nodal states) and the element passes of K1/K2 (lattice_residual.cu,
// lattice_jacobian.cu: inputs read at the lattice's vertex offsets), so the
// five kernels run one body.
//
// These are the bodies of dedflow_tpu/fem/pallas_kernels.py::_res_rows
// (67 input rows -> 24 output rows a*6+c) and ::_lhs_rows (27 -> 288 rows
// ab*18+c; with scalar_implicit 33 -> 288), the plain torch versions of
// which are dedflow_tpu_torch/fem/element_rows.py::res_rows and ::lhs_rows.
// Outputs go to o[row * M] for the element column the caller points `o` at,
// so a warp's stores are coalesced along the element axis.
//
// The guards of the JAX bodies are kept: tr > 0 ? tr : 1 (pallas_kernels.py:128
// and the residual's own) keeps every tau finite on dead or sliver columns,
// whose zero geometry then gives exact zeros.
#pragma once

#include "lattice_common.cuh"

namespace dedflow {

struct RowsResParams {
  double rho, mu, cp, kappa, fb0, fb1, fb2, dt;
};

struct RowsLhsParams {
  double rho, mu, f1, f2, dt, cp, kappa;
};

// Residual inputs: shape gradients sh[i][a], det, the 6 unique metric
// entries, and the element nodes' u, du, p (from the rate state), phi, T,
// dphi, dT and heat source.
struct ResInputs {
  float sh[3][4];
  float det, m00, m01, m02, m11, m12, m22;
  float u[3][4], du[3][4];
  float p[4], phi[4], tem[4], dphi[4], dtem[4], src[4];
};

// Jacobian inputs: shape gradients, the element nodes' velocity, det,
// gg = |G|^2 and tr(G); the 6 unique metric entries only in the implicit
// mode (the phi/T tangents' taus use the residual's form t1 = u.G.u).
struct LhsInputs {
  float sh[3][4], u[3][4];
  float det, gg, tr;
  float m00, m01, m02, m11, m12, m22;
};

__device__ __forceinline__ float dot4(const float* x, const float* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
}

__device__ __forceinline__ void res_body(const ResInputs& x, const RowsResParams& prm,
                                         float* __restrict__ o, size_t M) {
  const float rho = static_cast<float>(prm.rho);
  const float mu = static_cast<float>(prm.mu);
  const float rhocp = static_cast<float>(prm.rho * prm.cp);
  const float fb[3] = {static_cast<float>(prm.fb0), static_cast<float>(prm.fb1),
                       static_cast<float>(prm.fb2)};
  const double nu = prm.mu / prm.rho;
  const double alpha_th = prm.kappa / (prm.rho * prm.cp);
  const float t0 = static_cast<float>(4.0 / (prm.dt * prm.dt));
  const float visc3 = static_cast<float>(3.0 * nu * nu);
  const float alpha3 = static_cast<float>(3.0 * alpha_th * alpha_th);
  const float m00 = x.m00, m01 = x.m01, m02 = x.m02, m11 = x.m11, m12 = x.m12, m22 = x.m22;

  const float gg = m00 * m00 + m11 * m11 + m22 * m22 +
                   2.f * (m01 * m01 + m02 * m02 + m12 * m12);
  float tr = m00 + m11 + m22;
  tr = tr > 0.f ? tr : 1.f;  // dead or sliver columns: exact zeros, never NaN

  float grad_u[3][3], grad_p[3], grad_phi[3], grad_t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) grad_u[i][j] = dot4(x.u[i], x.sh[j]);
    grad_p[i] = dot4(x.p, x.sh[i]);
    grad_phi[i] = dot4(x.phi, x.sh[i]);
    grad_t[i] = dot4(x.tem, x.sh[i]);
  }
  const float divu = grad_u[0][0] + grad_u[1][1] + grad_u[2][2];

  float fm[3][4] = {}, fc[4] = {}, fphi[4] = {}, ft[4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float wq = static_cast<float>(kGw);
    float sl[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) sl[a] = static_cast<float>(shl(q, a));
    float uq[3], duq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      uq[i] = dot4(sl, x.u[i]);
      duq[i] = dot4(sl, x.du[i]);
    }
    const float pq = dot4(sl, x.p);
    const float dphiq = dot4(sl, x.dphi);
    const float dtemq = dot4(sl, x.dtem);
    const float srcq = dot4(sl, x.src);

    const float t1 = m00 * uq[0] * uq[0] + m11 * uq[1] * uq[1] + m22 * uq[2] * uq[2] +
                     2.f * (m01 * uq[0] * uq[1] + m02 * uq[0] * uq[2] + m12 * uq[1] * uq[2]);
    const float tau_m = rsqrtf(t0 + t1 + visc3 * gg) / rho;
    const float tau_c = sqrtf(t1 + visc3 * gg) / tr;
    const float tau_phi = rsqrtf(t0 + t1);
    const float tau_t = rsqrtf(t0 + t1 + alpha3 * gg) / rhocp;

    float r_l[3], tmp0[3], ucor[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float conv = uq[0] * grad_u[i][0] + uq[1] * grad_u[i][1] + uq[2] * grad_u[i][2];
      r_l[i] = rho * (duq[i] - fb[i] + conv) + grad_p[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) ucor[i] = uq[i] - tau_m * r_l[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      tmp0[i] = rho * (duq[i] - fb[i] + ucor[0] * grad_u[i][0] + ucor[1] * grad_u[i][1] +
                       ucor[2] * grad_u[i][2]);
    const float diag = -pq + rho * tau_c * divu;
    float t1ij[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        t1ij[i][j] = mu * (grad_u[i][j] + grad_u[j][i]) + rho * tau_m * r_l[i] * uq[j] -
                     rho * tau_m * tau_m * r_l[i] * r_l[j] + (i == j ? diag : 0.f);

    const float adv_phi = dphiq + (uq[0] * grad_phi[0] + uq[1] * grad_phi[1] + uq[2] * grad_phi[2]);
    const float adv_t = rhocp * (dtemq + uq[0] * grad_t[0] + uq[1] * grad_t[1] + uq[2] * grad_t[2]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = sl[a] * tmp0[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) acc += x.sh[j][a] * t1ij[i][j];
        fm[i][a] += wq * acc;
      }
      fc[a] += wq * (sl[a] * divu +
                     tau_m * (x.sh[0][a] * r_l[0] + x.sh[1][a] * r_l[1] + x.sh[2][a] * r_l[2]));
      const float shconv = uq[0] * x.sh[0][a] + uq[1] * x.sh[1][a] + uq[2] * x.sh[2][a];
      fphi[a] += wq * adv_phi * (sl[a] + tau_phi * shconv);
      ft[a] += wq * (adv_t - srcq) * (sl[a] + rhocp * tau_t * shconv);
    }
  }
  const float kdiff = static_cast<float>(kGwSum * prm.kappa);
  const float det = x.det;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ft[a] += kdiff * (x.sh[0][a] * grad_t[0] + x.sh[1][a] * grad_t[1] + x.sh[2][a] * grad_t[2]);
    o[(a * 6 + 0) * M] = fm[0][a] * det;
    o[(a * 6 + 1) * M] = fm[1][a] * det;
    o[(a * 6 + 2) * M] = fm[2][a] * det;
    o[(a * 6 + 3) * M] = fc[a] * det;
    o[(a * 6 + 4) * M] = fphi[a] * det;
    o[(a * 6 + 5) * M] = ft[a] * det;
  }
}

// kImplicit: components 16/17 are the consistent phi/T transport tangents
// (pallas_kernels._lhs_rows with scalar_implicit, weakform.scalar_lhs_blocks)
// from the per-point taus tau_phi[q] and tau_t[q]; each (a, b) entry is
// summed over q inside the output loop, so no (16,) accumulator stays live.
// Otherwise they are the state-independent identities, and kComp = 16 drops
// them (the lattice restores them from the node multiplicity).
//
// The layout `Out` places the outputs: component k of vertex pair
// ab = a*4+b goes to o[Out::pair(ab, M) + Out::comp(k, M)], and only where
// Out::wants(k), a compile-time constant once the loops are unrolled. A
// component the layout does not take is never computed, nor is what only
// it needs (the compiler drops the dead arithmetic), so a caller that
// needs a subset of the components pays for that subset and the
// per-element prologue. `o` is a restrict parameter of the body and the
// layout only computes offsets: with the pointer held in a sink object,
// K6's 33-row instantiation took 255 registers instead of 168 (nvcc 12.8,
// sm_90a); this way K5's and K6's PTX is that of plain column stores.
template <bool kImplicit, int kComp, class Out>
__device__ __forceinline__ void lhs_body_to(const LhsInputs& x, const RowsLhsParams& prm,
                                            float* __restrict__ o, size_t M) {
  static_assert(kComp == 18 || (kComp == 16 && !kImplicit), "16 components: frozen mode only");
  const float rho = static_cast<float>(prm.rho);
  const float t0 = static_cast<float>(4.0 / (prm.dt * prm.dt));
  const float visc2 = static_cast<float>(3.0 * (prm.mu / prm.rho) * (prm.mu / prm.rho));
  const float f2rho = static_cast<float>(prm.f2 * prm.rho);
  const float f1rho = static_cast<float>(prm.f1 * prm.rho);
  const float f2 = static_cast<float>(prm.f2);
  const float f2mu = static_cast<float>(prm.f2 * prm.mu * kGwSum);
  const float gw = static_cast<float>(kGw);
  const float det = x.det;
  const float gg = x.gg;
  const float tr_safe = x.tr > 0.f ? x.tr : 1.f;  // pallas_kernels.py:128

  float shconv[4][4], tau0[4];
  float tau_phi[4], tau_t[4];  // implicit mode only
  float gs_conv[4] = {}, gs_shl[4] = {}, tau0_sum = 0.f, c_grad2 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float uq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = static_cast<float>(shl(q, 0)) * x.u[i][0];
#pragma unroll
      for (int a = 1; a < 4; ++a) s += static_cast<float>(shl(q, a)) * x.u[i][a];
      uq[i] = s;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      shconv[q][a] = uq[0] * x.sh[0][a] + uq[1] * x.sh[1][a] + uq[2] * x.sh[2][a];
    // vertices 1..3 only, as in the reference body (pallas_kernels._lhs_rows)
    const float adv2 = shconv[q][1] * shconv[q][1] + shconv[q][2] * shconv[q][2] +
                       shconv[q][3] * shconv[q][3];
    tau0[q] = rsqrtf(t0 + adv2 + visc2 * gg) / rho;
    const float tau1 = sqrtf(adv2 + visc2 * gg) / tr_safe;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      gs_conv[a] += gw * tau0[q] * shconv[q][a];
      gs_shl[a] += gw * tau0[q] * static_cast<float>(shl(q, a));
    }
    tau0_sum += gw * tau0[q];
    c_grad2 += (f2rho * gw) * tau1;
    if constexpr (kImplicit) {
      const double alpha_th = prm.kappa / (prm.rho * prm.cp);
      const float alpha3 = static_cast<float>(3.0 * alpha_th * alpha_th);
      const float t1 = x.m00 * uq[0] * uq[0] + x.m11 * uq[1] * uq[1] + x.m22 * uq[2] * uq[2] +
                       2.f * (x.m01 * uq[0] * uq[1] + x.m02 * uq[0] * uq[2] +
                              x.m12 * uq[1] * uq[2]);
      tau_phi[q] = rsqrtf(t0 + t1);
      tau_t[q] = rsqrtf(t0 + t1 + alpha3 * gg) / static_cast<float>(prm.rho * prm.cp);
    }
  }

  const float c1 = static_cast<float>(prm.f1 * prm.rho * prm.rho * kGw);
  const float c2 = static_cast<float>(prm.f2 * prm.rho * kGw);
  const float c3 = static_cast<float>(prm.f2 * prm.rho * prm.rho * kGw);
  const float ident = det > 0.f ? 1.f : 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float tmp = f1rho * static_cast<float>(mass(a, b));
      float jphi = 0.f, jt = 0.f;  // implicit mode only
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float sa = static_cast<float>(shl(q, a));
        const float sb = static_cast<float>(shl(q, b));
        tmp += c1 * tau0[q] * shconv[q][a] * sb + c2 * sa * shconv[q][b] +
               c3 * tau0[q] * shconv[q][a] * shconv[q][b];
        if constexpr (kImplicit) {
          const float rhocp = static_cast<float>(prm.rho * prm.cp);
          // trial: d(rate)/d(dwg_b) = f1 N_b + f2 u.grad N_b, SUPG-tested
          const float trial = static_cast<float>(prm.f1) * sb + f2 * shconv[q][b];
          jphi += gw * (sa + tau_phi[q] * shconv[q][a]) * trial;
          jt += gw * (sa + rhocp * tau_t[q] * shconv[q][a]) * trial;
        }
      }
      const float e_k = x.sh[0][a] * x.sh[0][b] + x.sh[1][a] * x.sh[1][b] + x.sh[2][a] * x.sh[2][b];
      tmp += f2mu * e_k;
      float* op = o + Out::pair(a * 4 + b, M);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (!Out::wants(i * 3 + j)) continue;
          float v = f2mu * x.sh[j][a] * x.sh[i][b] + c_grad2 * x.sh[i][a] * x.sh[j][b];
          if (i == j) v += tmp;
          op[Out::comp(i * 3 + j, M)] = v * det;
        }
      const float gwshl_a = static_cast<float>(gwshl(a));
      const float gwshl_b = static_cast<float>(gwshl(b));
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (Out::wants(9 + i))
          op[Out::comp(9 + i, M)] = (-x.sh[i][a] * gwshl_b + rho * gs_conv[a] * x.sh[i][b]) * det;
        if (Out::wants(12 + i))
          op[Out::comp(12 + i, M)] = (f1rho * x.sh[i][a] * gs_shl[b] + f2 * gwshl_a * x.sh[i][b] +
                                      f2rho * x.sh[i][a] * gs_conv[b]) * det;
      }
      if (Out::wants(15)) op[Out::comp(15, M)] = tau0_sum * e_k * det;
      if constexpr (kImplicit) {
        const float rhocp = static_cast<float>(prm.rho * prm.cp);
        const float f2kappa = static_cast<float>(prm.f2 * prm.kappa * kGwSum);
        if (Out::wants(16)) op[Out::comp(16, M)] = jphi * det;
        if (Out::wants(17)) op[Out::comp(17, M)] = (rhocp * jt + f2kappa * e_k) * det;
      } else if constexpr (kComp == 18) {
        // state-independent phi-phi / T-T identities
        if (Out::wants(16)) op[Out::comp(16, M)] = a == b ? ident : 0.f;
        if (Out::wants(17)) op[Out::comp(17, M)] = a == b ? ident : 0.f;
      }
    }
  }
}

// Every component, to o[((a*4+b)*kComp + k) * M]: the element column the
// caller points `o` at, so a warp's stores are coalesced.
template <int kComp>
struct Columns {
  __device__ static constexpr bool wants(int) { return true; }
  __device__ static constexpr size_t pair(int ab, size_t M) {
    return static_cast<size_t>(ab * kComp) * M;
  }
  __device__ static constexpr size_t comp(int k, size_t M) { return k * M; }
};

template <bool kImplicit, int kComp = 18>
__device__ __forceinline__ void lhs_body(const LhsInputs& x, const RowsLhsParams& prm,
                                         float* __restrict__ o, size_t M) {
  lhs_body_to<kImplicit, kComp, Columns<kComp>>(x, prm, o, M);
}

}  // namespace dedflow
