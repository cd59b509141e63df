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
// so a warp's stores are coalesced along the element axis; the Jacobian can
// instead go straight to K9's staging rows (the `Staged` layout below), and
// the residual's 24 values (`res_values`) to wherever the caller stores
// them (K1's ring of cell layers, the staged K4's K8 staging rows).
//
// The guards of the JAX bodies are kept: tr > 0 ? tr : 1 (pallas_kernels.py:128
// and the residual's own) keeps every tau finite on dead or sliver columns,
// whose zero geometry then gives exact zeros.
#pragma once

#include <type_traits>

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

// The residual body: r[a][c], vertex a's component c (u, v, w, p, phi, T).
__device__ __forceinline__ void res_values(const ResInputs& x, const RowsResParams& prm,
                                           float r[4][6]) {
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
    r[a][0] = fm[0][a] * det;
    r[a][1] = fm[1][a] * det;
    r[a][2] = fm[2][a] * det;
    r[a][3] = fc[a] * det;
    r[a][4] = fphi[a] * det;
    r[a][5] = ft[a] * det;
  }
}

// The residual body's 24 rows a*6+c to o[(a*6+c) * M]: the element column
// the caller points `o` at, so a warp's stores are coalesced.
__device__ __forceinline__ void res_body(const ResInputs& x, const RowsResParams& prm,
                                         float* __restrict__ o, size_t M) {
  float r[4][6];
  res_values(x, prm, r);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) o[(a * 6 + c) * M] = r[a][c];
}

// Whether an output policy is a staged layout: false unless the policy
// declares kStaged, so the column layouts (Columns here, K2's Stage) do not.
template <class Out, class = void>
struct staged_layout : std::false_type {};
template <class Out>
struct staged_layout<Out, std::void_t<decltype(Out::kStaged)>>
    : std::bool_constant<Out::kStaged> {};

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
// A staged layout (staged_layout<Out>) gathers a pair's components in a row
// in registers, at offsets Out::comp(k, M), and stores the row whole at the
// pair's end to the slot Out::slot(pos, ab, M) it loaded at the pair's
// start (`pos`, `o2`: the staged layout's position table and second buffer).
template <bool kImplicit, int kComp, class Out>
__device__ __forceinline__ void lhs_body_to(const LhsInputs& x, const RowsLhsParams& prm,
                                            float* __restrict__ o, size_t M,
                                            const int* __restrict__ pos = nullptr,
                                            float* __restrict__ o2 = nullptr) {
  static_assert(kComp == 18 || (kComp == 16 && !kImplicit), "16 components: frozen mode only");
  constexpr bool kStagedOut = staged_layout<Out>::value;
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
      int slot = 0;  // a staged layout's row, loaded early: its latency hides behind the pair
      if constexpr (kStagedOut) slot = Out::slot(pos, a * 4 + b, M);
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
      float row[kComp];  // a staged layout's row
      float* op;
      if constexpr (kStagedOut)
        op = row;
      else
        op = o + Out::pair(a * 4 + b, M);
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
      if constexpr (kStagedOut) Out::store(row, slot, o, o2);
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

// The column of K9's staging row that takes vel/p component k < 16: the
// WinELL row order (sparse/winell.py COMP2WIN; fem/element_kernels.py's
// JAC_COMPS is its inverse): uu[i][j] -> 4j + i, up[i] -> 12 + i,
// pu[j] -> 4j + 3, pp -> 15.
__host__ __device__ constexpr int stage_col(int k) {
  return k < 9 ? 4 * (k % 3) + k / 3 : k < 12 ? k + 3 : k < 15 ? 4 * (k - 12) + 3 : 15;
}

constexpr int kStagedThreads = 128;  // the staged kernels' block: 4 warps

// st.global.v4.f32 of v to dst where p holds, as one predicated instruction:
// a branch around the store would split the body's basic block, and the
// compiler fuses multiplies and adds into FMAs only within a block, so the
// staged rows would round differently from the column kernel's.
__device__ __forceinline__ void store4_if(bool p, float4* dst, float4 v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
      "@q st.global.v4.f32 [%1], {%2, %3, %4, %5};\n\t}"
      :: "r"(static_cast<int>(p)), "l"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

// K9's staging rows (csrc/seg_reduce.cu's segment sum reads them): pair ab
// of the thread's element goes whole to row slot = pos[ab * M] of the
// (K, 16) buffer `o`, its 16 vel/p components in the WinELL row order
// (stage_col); in the implicit mode the phi/T tangents 16/17 go to row slot
// of the (K, 8) buffer `o2`, zero-padded to one 32-byte sector. A slot of
// -1 (a contribution the plan leaves out) stores nothing; its address is
// row 0's, never written through. The warp's 32 rows go through shared
// memory, and consecutive lanes store consecutive 16-byte quads of a row:
// 8 whole rows (16 sectors) a store instruction, as K9's staging pass does;
// the tangent rows go 16 a store instruction, two lanes a row. What a store
// instruction writes is whole sectors: four float4 stores a thread, each
// half a sector of a row of its own, took 2.3x as long (1.415 against 0.605
// ms for K6 at 1.18M tets), and one float4 of tangents a thread into a
// (K, 4) buffer added 0.70 ms to the implicit K6, whole sectors 0.43
// (NVIDIA H100 80GB HBM3, 700 W). Every lane of the warp must call it: the
// kernels have no early exit.
template <bool kImplicit>
struct Staged {
  static constexpr bool kStaged = true;
  __device__ static constexpr bool wants(int) { return true; }
  __device__ static constexpr int comp(int k, size_t) { return k < 16 ? stage_col(k) : k; }
  __device__ static __forceinline__ int slot(const int* __restrict__ pos, int ab, size_t M) {
    return __ldg(pos + ab * M);
  }
  __device__ static __forceinline__ void store(const float* row, int slot,
                                               float* __restrict__ o, float* __restrict__ o2) {
    __shared__ float4 tile[kStagedThreads / 32][32][5];  // 5 quads a row: conflict-free writes
    const int lane = threadIdx.x & 31;
    float4(*t)[5] = tile[threadIdx.x >> 5];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      t[lane][q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows 8i..8i+7, a quad a lane
      const int r = i * 8 + (lane >> 2), q = lane & 3;
      const int s = __shfl_sync(0xffffffffu, slot, r);
      store4_if(s >= 0, reinterpret_cast<float4*>(o) + static_cast<size_t>(max(s, 0)) * 4 + q,
                t[r][q]);
    }
    __syncwarp();  // the tile is free for the next pair
    if constexpr (kImplicit) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows 16i..16i+15: lane pair r stores row r's two quads
        const int r = i * 16 + (lane >> 1), q = lane & 1;
        const int s = __shfl_sync(0xffffffffu, slot, r);
        const float jphi = __shfl_sync(0xffffffffu, row[16], r);
        const float jt = __shfl_sync(0xffffffffu, row[17], r);
        // selects a component at a time: a choice between two float4 values
        // compiled to branches (32 in the implicit K6), and so to other FMAs
        store4_if(s >= 0, reinterpret_cast<float4*>(o2) + static_cast<size_t>(max(s, 0)) * 2 + q,
                  make_float4(q == 0 ? jphi : 0.f, q == 0 ? jt : 0.f, 0.f, 0.f));
      }
    }
  }
};

}  // namespace dedflow
