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
// The implicit mode (melt-pool runs) computes the matrix the JAX package
// builds on this tier from the 33-row K6 kernel and a 96-slice XLA reduce
// (lattice.py:676-730): the element body's consistent phi/T tangents in
// components 16/17, reduced into the phi-phi / T-T rows of every plane
// (scal) beside the 16 velocity/pressure rows (data), masked the same way.
//
// Design (simple and right first):
// - Element pass: one thread per (cell c, slab t) reads 15 geometry values
//   (and, implicit, the 6 metric entries of the residual geometry) and the
//   velocity of the 4 vertices at c + delta[t][a] (zero past N), runs the
//   Jacobian body of element_body.cuh (the body K5 and K6 run) and writes
//   16 vertex pairs x kComp components into an element buffer
//   (6, 16*kComp, N): kComp = 16 frozen, 18 implicit.
// - Plane pass: one thread per (row r, component k) walks the 96
//   (slab, a, b) entries sorted by DIA plane (host-built table, fixed order)
//   and sums elem[t, (a*4+b)*kComp+k, r - delta[t][a]] into each plane. It
//   then applies the epilogue of the masked TPU kernel: times keep[k, r],
//   plus add[k, r] on the zero-offset plane, plus the pre-masked facet band
//   (velocity/pressure rows only: the facet terms never touch phi/T).
//   Components 0-15 land in data (D, 16, N), 16/17 in scal rows 2p, 2p+1.
//   A gather, not atomics: the float32 matrix, and so GMRES's iteration
//   count, repeats from run to run.
// What bounds it on an H100: the element pass is FP32 issue and registers
// (256 or 288 outputs computed pair by pair from ~50 live scalars); the
// plane pass is bytes (the 1536- or 1728-float-per-node element buffer is
// written once and read once, about 2 GB at 1M tets). Fusing the passes is
// later work.
// Dead cells (zero geometry) give exact zeros: the tr > 0 guard keeps the
// tau divisions finite.

#include "element_body.cuh"

namespace dedflow {

constexpr int kEntries = kSlabs * 16;  // (t, a, b) triples

// (t, a, b) entries sorted by plane: the row t*16*kComp + (a*4+b)*kComp of
// the element buffer, the vertex shift delta[t][a], and the plane.
struct PlaneTable {
  int row[kEntries];
  int shift[kEntries];
  int plane[kEntries];
};

template <bool kImplicit>
__global__ void __launch_bounds__(128)
jacobian_element_kernel(const float* __restrict__ geom,   // (6, 15, n)
                        const float* __restrict__ mgeom,  // (6, 19, n) residual geometry, implicit
                        const float* __restrict__ wa,     // (>=3, n) velocity rows
                        float* __restrict__ elem,         // (6, 16*kComp, n)
                        int n, Deltas dl, RowsLhsParams prm) {
  constexpr int kComp = kImplicit ? 18 : 16;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const size_t N = static_cast<size_t>(n);

  LhsInputs x;
  const float* g = geom + static_cast<size_t>(t) * 15 * N + c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) x.sh[i][a] = g[(i * 4 + a) * N];
  x.det = g[12 * N];
  x.gg = g[13 * N];
  x.tr = g[14 * N];
  if constexpr (kImplicit) {
    const float* mg = mgeom + static_cast<size_t>(t) * 19 * N + c;
    x.m00 = mg[13 * N];
    x.m01 = mg[14 * N];
    x.m02 = mg[15 * N];
    x.m11 = mg[16 * N];
    x.m12 = mg[17 * N];
    x.m22 = mg[18 * N];
  }

  int dv[4];
  slab_deltas(dl, t, dv);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
#pragma unroll
    for (int i = 0; i < 3; ++i) x.u[i][a] = v < n ? wa[i * N + v] : 0.f;
  }
  lhs_body<kImplicit, kComp>(x, prm, elem + static_cast<size_t>(t) * 16 * kComp * N + c, N);
}

// Plane pass: value[p, k, r] = keep[k, r] * sum over the plane's entries
// + (p == d0) * add[k, r] + band[p, k, r - lo] (k < 16), stored in
// data[p, k, r] for k < 16 and scal[2p + k - 16, r] for k = 16, 17.
template <int kComp>
__global__ void __launch_bounds__(256)
jacobian_plane_kernel(const float* __restrict__ elem,  // (6, 16*kComp, n)
                      const float* __restrict__ keep,  // (kComp, n)
                      const float* __restrict__ add,   // (kComp, n)
                      const float* __restrict__ band,  // (D, 16, span) or null
                      int band_lo, int band_span,
                      float* __restrict__ out,         // (D, 16, n)
                      float* __restrict__ scal,        // (2D, n), kComp == 18
                      int n, int d0, PlaneTable tab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  const float kp = keep[k * N + r];
  const float ad = add[k * N + r];
  const bool vp = k < 16;
  const bool in_band = vp && band != nullptr && r >= band_lo && r < band_lo + band_span;

  auto finish = [&](int p, float acc) {
    float v = acc * kp;
    if (p == d0) v += ad;
    if (in_band) v += band[(static_cast<size_t>(p) * 16 + k) * band_span + (r - band_lo)];
    if (vp)
      out[(static_cast<size_t>(p) * 16 + k) * N + r] = v;
    else
      scal[(static_cast<size_t>(2 * p) + (k - 16)) * N + r] = v;
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

// plane_entries: kEntries x (slab, pair, shift, plane), sorted by plane;
// every plane 0..D-1 appears at least once. mgeom (the (6, 19, n) residual
// geometry) not null selects the implicit mode: keep/add are then (18, n)
// and scal (2D, n) receives the phi-phi / T-T rows; otherwise keep/add are
// (16, n) and scal is not written.
extern "C" int dedflow_lattice_jacobian(const void* geom, const void* mgeom, const void* wa,
                                        void* elem, const void* keep, const void* add,
                                        const void* band, int band_lo, int band_span, void* out,
                                        void* scal, int n, const int* deltas,
                                        const int* plane_entries, int d0, double rho, double mu,
                                        double f1, double f2, double dt, double cp, double kappa,
                                        void* stream) {
  using namespace dedflow;
  const bool implicit = mgeom != nullptr;
  if (n <= 0 || (implicit && scal == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  Deltas dl;
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) dl.d[t][a] = deltas[t * 4 + a];
  const int comps = implicit ? 18 : 16;
  PlaneTable tab;
  for (int e = 0; e < kEntries; ++e) {
    tab.row[e] = (plane_entries[4 * e] * 16 + plane_entries[4 * e + 1]) * comps;
    tab.shift[e] = plane_entries[4 * e + 2];
    tab.plane[e] = plane_entries[4 * e + 3];
  }
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 eg((n + 127) / 128, kSlabs);
  const float* g = static_cast<const float*>(geom);
  const float* mg = static_cast<const float*>(mgeom);
  const float* w = static_cast<const float*>(wa);
  float* el = static_cast<float*>(elem);
  const float* kp = static_cast<const float*>(keep);
  const float* ad = static_cast<const float*>(add);
  const float* bd = static_cast<const float*>(band);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scal);
  if (implicit) {
    jacobian_element_kernel<true><<<eg, 128, 0, s>>>(g, mg, w, el, n, dl, prm);
    jacobian_plane_kernel<18><<<dim3((n + 255) / 256, 18), 256, 0, s>>>(
        el, kp, ad, bd, band_lo, band_span, o, sc, n, d0, tab);
  } else {
    jacobian_element_kernel<false><<<eg, 128, 0, s>>>(g, mg, w, el, n, dl, prm);
    jacobian_plane_kernel<16><<<dim3((n + 255) / 256, 16), 256, 0, s>>>(
        el, kp, ad, bd, band_lo, band_span, o, sc, n, d0, tab);
  }
  return static_cast<int>(cudaGetLastError());
}
