// K1: lattice volume residual (VMS Navier-Stokes + level set + temperature).
//
// Replaces the TPU kernel dedflow_tpu/fem/lattice.py::_res_t8_kernel (body
// pallas_kernels._res_rows_t8, driver _res_call / residual_fused), which
// DMAs haloed state windows into VMEM, evaluates the element residual of
// the six Kuhn slabs stacked on sublanes, and leaves the node reduction to
// 24 shifted adds in XLA. It computes the same function as
// pallas_kernels._res_rows on every (cell, slab) pair.
//
// Design (simple and right first):
// - Element pass: one thread per (cell c, slab t). It reads the cell's 19
//   geometry values and the states of its 4 vertices at c + delta[t][a]
//   (reads past N are zero, as the reference's padded state), evaluates
//   the residual body at 4 quadrature points and writes 24 values into an
//   element-indexed buffer (6, 24, N).
// - Node pass: one thread per (node n, component k) gathers the 24
//   contributions of slab t / vertex a from cell n - delta[t][a] in a fixed
//   (t, a) order. No atomics: a run's float32 result is the same from run
//   to run.
// What bounds it on an H100: the element pass is FP32 issue and registers
// (~60 live scalars, rsqrt/sqrt per quadrature point); the node pass is
// bytes (24 strided-but-coalesced reads per output). The element buffer
// costs one write and one read of 96 floats per node; fusing the two
// passes (shared-memory tiles or atomics) is later work.
//
// The pressure travels in the rate slot: p comes from dw_alpha row 3.

#include "lattice_common.cuh"

namespace dedflow {

struct ResParams {
  double rho, mu, cp, kappa, fb0, fb1, fb2, dt;
};

__global__ void __launch_bounds__(128)
residual_element_kernel(const float* __restrict__ geom,  // (6, 19, n)
                        const float* __restrict__ wa,    // (6, n)
                        const float* __restrict__ dwa,   // (6, n)
                        float* __restrict__ elem,        // (6, 24, n)
                        int n, Deltas dl, ResParams prm) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const size_t N = static_cast<size_t>(n);

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

  const float* g = geom + static_cast<size_t>(t) * 19 * N + c;
  float sh[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) sh[i][a] = g[(i * 4 + a) * N];
  const float det = g[12 * N];
  const float m00 = g[13 * N], m01 = g[14 * N], m02 = g[15 * N];
  const float m11 = g[16 * N], m12 = g[17 * N], m22 = g[18 * N];

  int dv[4];
  slab_deltas(dl, t, dv);
  float u[3][4], du[3][4], p[4], phi[4], tem[4], dphi[4], dtem[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
    const bool in = v < n;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      u[i][a] = in ? wa[i * N + v] : 0.f;
      du[i][a] = in ? dwa[i * N + v] : 0.f;
    }
    p[a] = in ? dwa[3 * N + v] : 0.f;
    phi[a] = in ? wa[4 * N + v] : 0.f;
    tem[a] = in ? wa[5 * N + v] : 0.f;
    dphi[a] = in ? dwa[4 * N + v] : 0.f;
    dtem[a] = in ? dwa[5 * N + v] : 0.f;
  }

  const float gg = m00 * m00 + m11 * m11 + m22 * m22 +
                   2.f * (m01 * m01 + m02 * m02 + m12 * m12);
  float tr = m00 + m11 + m22;
  tr = tr > 0.f ? tr : 1.f;  // dead cells: exact zeros, never NaN

  auto dot4 = [](const float* x, const float* y) {
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
  };
  float grad_u[3][3], grad_p[3], grad_phi[3], grad_t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) grad_u[i][j] = dot4(u[i], sh[j]);
    grad_p[i] = dot4(p, sh[i]);
    grad_phi[i] = dot4(phi, sh[i]);
    grad_t[i] = dot4(tem, sh[i]);
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
      uq[i] = dot4(sl, u[i]);
      duq[i] = dot4(sl, du[i]);
    }
    const float pq = dot4(sl, p);
    const float dphiq = dot4(sl, dphi);
    const float dtemq = dot4(sl, dtem);

    const float t1 = m00 * uq[0] * uq[0] + m11 * uq[1] * uq[1] + m22 * uq[2] * uq[2] +
                     2.f * (m01 * uq[0] * uq[1] + m02 * uq[0] * uq[2] + m12 * uq[1] * uq[2]);
    const float tau_m = rsqrtf(t0 + t1 + visc3 * gg) / rho;
    const float tau_c = sqrtf(t1 + visc3 * gg) / tr;
    const float tau_phi = rsqrtf(t0 + t1);
    const float tau_t = rsqrtf(t0 + t1 + alpha3 * gg) / rhocp;

    float r_l[3], tmp0[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float conv = uq[0] * grad_u[i][0] + uq[1] * grad_u[i][1] + uq[2] * grad_u[i][2];
      r_l[i] = rho * (duq[i] - fb[i] + conv) + grad_p[i];
    }
    float ucor[3];
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
        for (int j = 0; j < 3; ++j) acc += sh[j][a] * t1ij[i][j];
        fm[i][a] += wq * acc;
      }
      fc[a] += wq * (sl[a] * divu + tau_m * (sh[0][a] * r_l[0] + sh[1][a] * r_l[1] + sh[2][a] * r_l[2]));
      const float shconv = uq[0] * sh[0][a] + uq[1] * sh[1][a] + uq[2] * sh[2][a];
      fphi[a] += wq * adv_phi * (sl[a] + tau_phi * shconv);
      ft[a] += wq * adv_t * (sl[a] + rhocp * tau_t * shconv);
    }
  }
  const float kdiff = static_cast<float>(kGwSum * prm.kappa);
  float* o = elem + static_cast<size_t>(t) * 24 * N + c;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ft[a] += kdiff * (sh[0][a] * grad_t[0] + sh[1][a] * grad_t[1] + sh[2][a] * grad_t[2]);
    o[(a * 6 + 0) * N] = fm[0][a] * det;
    o[(a * 6 + 1) * N] = fm[1][a] * det;
    o[(a * 6 + 2) * N] = fm[2][a] * det;
    o[(a * 6 + 3) * N] = fc[a] * det;
    o[(a * 6 + 4) * N] = fphi[a] * det;
    o[(a * 6 + 5) * N] = ft[a] * det;
  }
}

// Node pass: out[k, n] = sum_{t, a} elem[t, a*6 + k, n - delta[t][a]].
__global__ void __launch_bounds__(256)
residual_node_kernel(const float* __restrict__ elem,  // (6, 24, n)
                     float* __restrict__ out,         // (6, n)
                     int n, Deltas dl) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kSlabs; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int cell = r - dl.d[t][a];
      if (cell >= 0) acc += elem[(static_cast<size_t>(t) * 24 + a * 6 + k) * N + cell];
    }
  out[k * N + r] = acc;
}

}  // namespace dedflow

extern "C" int dedflow_lattice_residual(const void* geom, const void* wa, const void* dwa,
                                        void* elem, void* out, int n, const int* deltas,
                                        double rho, double mu, double cp, double kappa,
                                        double fb0, double fb1, double fb2, double dt,
                                        void* stream) {
  using namespace dedflow;
  Deltas dl;
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) dl.d[t][a] = deltas[t * 4 + a];
  const ResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 eg((n + 127) / 128, kSlabs);
  residual_element_kernel<<<eg, 128, 0, s>>>(static_cast<const float*>(geom),
                                             static_cast<const float*>(wa),
                                             static_cast<const float*>(dwa),
                                             static_cast<float*>(elem), n, dl, prm);
  const dim3 ng((n + 255) / 256, 6);
  residual_node_kernel<<<ng, 256, 0, s>>>(static_cast<const float*>(elem),
                                          static_cast<float*>(out), n, dl);
  return static_cast<int>(cudaGetLastError());
}
