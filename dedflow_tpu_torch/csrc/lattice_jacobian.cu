// K2: lattice Jacobian straight into component-major DIA planes, with the
// Dirichlet masking epilogue.
//
// Replaces the TPU kernel dedflow_tpu/fem/lattice.py::_lhs_fused_body (run
// as _lhs_fused_kernel_masked, driver _lhs_call / jacobian_fused; body
// pallas_kernels._lhs_rows with ncomp=16). That kernel carries a DIA-plane
// accumulator from one sequential grid step to the next; GPU blocks run in
// no order, so nothing is carried here. Its unmasked mode (K2') is the same
// plane pass with keep = 1, add = 0 and no band.
//
// Design (simple and right first):
// - Element pass: one thread per (cell c, slab t) reads 15 geometry values
//   and the velocity of the 4 vertices at c + delta[t][a] (zero past N),
//   evaluates the element Jacobian (16 vertex pairs x 16 velocity/pressure
//   components) and writes it into an element buffer (6, 256, N).
// - Plane pass: one thread per (row r, component k) walks the 96
//   (slab, a, b) entries sorted by DIA plane (host-built table, fixed order)
//   and sums elem[t, (a*4+b)*16+k, r - delta[t][a]] into each plane. It then
//   applies the epilogue of the masked TPU kernel: times keep[k, r], plus
//   add[k, r] on the zero-offset plane, plus the pre-masked facet band.
//   A gather, not atomics: the float32 matrix, and so GMRES's iteration
//   count, repeats from run to run.
// What bounds it on an H100: the element pass is FP32 issue and registers
// (256 outputs computed pair by pair from ~50 live scalars); the plane pass
// is bytes (the 1536-float-per-node element buffer is written once and read
// once, about 2 GB at 1M tets). Fusing the passes is later work.
// Dead cells (zero geometry) give exact zeros: the tr > 0 guard keeps the
// tau divisions finite.

#include "lattice_common.cuh"

namespace dedflow {

constexpr int kPairs = 16;
constexpr int kComp = 16;
constexpr int kElemRows = kPairs * kComp;  // 256
constexpr int kEntries = kSlabs * 16;      // (t, a, b) triples

struct LhsParams {
  double rho, mu, f1, f2, dt;
};

// (t, a, b) entries sorted by plane: row offset t*256 + (a*4+b)*16 into the
// element buffer, the vertex shift delta[t][a], and the plane.
struct PlaneTable {
  int row[kEntries];
  int shift[kEntries];
  int plane[kEntries];
};

__global__ void __launch_bounds__(128)
jacobian_element_kernel(const float* __restrict__ geom,  // (6, 15, n)
                        const float* __restrict__ wa,    // (>=3, n) velocity rows
                        float* __restrict__ elem,        // (6, 256, n)
                        int n, Deltas dl, LhsParams prm) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const size_t N = static_cast<size_t>(n);

  const float rho = static_cast<float>(prm.rho);
  const float t0 = static_cast<float>(4.0 / (prm.dt * prm.dt));
  const float visc2 = static_cast<float>(3.0 * (prm.mu / prm.rho) * (prm.mu / prm.rho));
  const float f2rho = static_cast<float>(prm.f2 * prm.rho);
  const float f1rho = static_cast<float>(prm.f1 * prm.rho);
  const float f2 = static_cast<float>(prm.f2);
  const float f2mu = static_cast<float>(prm.f2 * prm.mu * kGwSum);
  const float gw = static_cast<float>(kGw);

  const float* g = geom + static_cast<size_t>(t) * 15 * N + c;
  float sh[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) sh[i][a] = g[(i * 4 + a) * N];
  const float det = g[12 * N];
  const float gg = g[13 * N];
  const float tr = g[14 * N];
  const float tr_safe = tr > 0.f ? tr : 1.f;  // dead cells: exact zeros

  int dv[4];
  slab_deltas(dl, t, dv);
  float u[3][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i][a] = v < n ? wa[i * N + v] : 0.f;
  }

  float shconv[4][4], tau0[4];
  float gs_conv[4] = {}, gs_shl[4] = {}, tau0_sum = 0.f, c_grad2 = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float uq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = static_cast<float>(shl(q, 0)) * u[i][0];
#pragma unroll
      for (int a = 1; a < 4; ++a) s += static_cast<float>(shl(q, a)) * u[i][a];
      uq[i] = s;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) shconv[q][a] = uq[0] * sh[0][a] + uq[1] * sh[1][a] + uq[2] * sh[2][a];
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
  }

  const float c_mass = f1rho;
  const float c1 = static_cast<float>(prm.f1 * prm.rho * prm.rho * kGw);
  const float c2 = static_cast<float>(prm.f2 * prm.rho * kGw);
  const float c3 = static_cast<float>(prm.f2 * prm.rho * prm.rho * kGw);
  float* o = elem + static_cast<size_t>(t) * kElemRows * N + c;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float tmp = c_mass * static_cast<float>(mass(a, b));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float sa = static_cast<float>(shl(q, a));
        const float sb = static_cast<float>(shl(q, b));
        tmp += c1 * tau0[q] * shconv[q][a] * sb + c2 * sa * shconv[q][b] +
               c3 * tau0[q] * shconv[q][a] * shconv[q][b];
      }
      const float e_k = sh[0][a] * sh[0][b] + sh[1][a] * sh[1][b] + sh[2][a] * sh[2][b];
      tmp += f2mu * e_k;
      float* op = o + static_cast<size_t>((a * 4 + b) * kComp) * N;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float v = f2mu * sh[j][a] * sh[i][b] + c_grad2 * sh[i][a] * sh[j][b];
          if (i == j) v += tmp;
          op[(i * 3 + j) * N] = v * det;
        }
      const float gwshl_a = static_cast<float>(gwshl(a));
      const float gwshl_b = static_cast<float>(gwshl(b));
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        op[(9 + i) * N] = (-sh[i][a] * gwshl_b + rho * gs_conv[a] * sh[i][b]) * det;
        op[(12 + i) * N] = (f1rho * sh[i][a] * gs_shl[b] + f2 * gwshl_a * sh[i][b] +
                            f2rho * sh[i][a] * gs_conv[b]) * det;
      }
      op[15 * N] = tau0_sum * e_k * det;
    }
  }
}

// Plane pass: data[p, k, r] = keep[k, r] * sum over the plane's entries
// + (p == d0) * add[k, r] + band[p, k, r - lo].
__global__ void __launch_bounds__(256)
jacobian_plane_kernel(const float* __restrict__ elem,  // (6, 256, n)
                      const float* __restrict__ keep,  // (16, n)
                      const float* __restrict__ add,   // (16, n)
                      const float* __restrict__ band,  // (D, 16, span) or null
                      int band_lo, int band_span,
                      float* __restrict__ out,         // (D, 16, n)
                      int n, int d0, PlaneTable tab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  const float kp = keep[k * N + r];
  const float ad = add[k * N + r];
  const bool in_band = band != nullptr && r >= band_lo && r < band_lo + band_span;

  auto finish = [&](int p, float acc) {
    float v = acc * kp;
    if (p == d0) v += ad;
    if (in_band) v += band[(static_cast<size_t>(p) * kComp + k) * band_span + (r - band_lo)];
    out[(static_cast<size_t>(p) * kComp + k) * N + r] = v;
  };

  int cur = tab.plane[0];
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    const int p = tab.plane[e];
    if (p != cur) {
      finish(cur, acc);
      acc = 0.f;
      cur = p;
    }
    const int cell = r - tab.shift[e];
    if (cell >= 0) acc += elem[static_cast<size_t>(tab.row[e] + k) * N + cell];
  }
  finish(cur, acc);
}

}  // namespace dedflow

// plane_entries: kEntries x (row, shift, plane), sorted by plane; every
// plane 0..D-1 appears at least once.
extern "C" int dedflow_lattice_jacobian(const void* geom, const void* wa, void* elem,
                                        const void* keep, const void* add, const void* band,
                                        int band_lo, int band_span, void* out, int n,
                                        const int* deltas, const int* plane_entries, int d0,
                                        double rho, double mu, double f1, double f2, double dt,
                                        void* stream) {
  using namespace dedflow;
  Deltas dl;
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) dl.d[t][a] = deltas[t * 4 + a];
  PlaneTable tab;
  for (int e = 0; e < kEntries; ++e) {
    tab.row[e] = plane_entries[3 * e];
    tab.shift[e] = plane_entries[3 * e + 1];
    tab.plane[e] = plane_entries[3 * e + 2];
  }
  const LhsParams prm{rho, mu, f1, f2, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 eg((n + 127) / 128, kSlabs);
  jacobian_element_kernel<<<eg, 128, 0, s>>>(static_cast<const float*>(geom),
                                             static_cast<const float*>(wa),
                                             static_cast<float*>(elem), n, dl, prm);
  const dim3 pg((n + 255) / 256, kComp);
  jacobian_plane_kernel<<<pg, 256, 0, s>>>(
      static_cast<const float*>(elem), static_cast<const float*>(keep),
      static_cast<const float*>(add), static_cast<const float*>(band), band_lo, band_span,
      static_cast<float*>(out), n, d0, tab);
  return static_cast<int>(cudaGetLastError());
}
