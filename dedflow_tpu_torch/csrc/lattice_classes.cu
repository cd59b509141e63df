// K1c / K2c: the lattice volume residual and Jacobian for any run-time table
// of T <= 8 slabs: the translation-class tier (meshes without generator
// metadata, fem/lattice.py::build_class_context) and recovered lattices
// whose cells carry another split than the generator's Kuhn tets
// (mesh/recover.py, `lattice_tets`).
//
// They replace the same TPU kernels as K1 and K2, which the JAX package runs
// on these meshes with their tables given at trace time:
// dedflow_tpu/fem/lattice.py::_res_t8_kernel (K1, launched by _res_call)
// and ::_lhs_fused_body (K2, launched by _lhs_call), and for the implicit phi/T
// tangents pallas_kernels.py:544 with an XLA reduce. The fused K1 and K2
// (lattice_residual.cu, lattice_jacobian.cu) are compiled for the six Kuhn
// tets of a box; these entries take the slab offsets delta[t][a] and the
// plane table at run time, in a struct by value and in a small device table.
//
// These two-pass entries serve the tables that fem/lattice.py::grid_tables
// does not place on a node grid; a placed table runs the one-pass K1c / K2c
// (lattice_residual.cu, lattice_jacobian.cu: K1's and K2's kernels over a
// run-time table).
//
// Design (simple and right first; the pre-fusion two-pass K1 and K2,
// generalised):
// - K1c element pass: one thread per (slab t, base node c). It reads the 19
//   geometry rows of column c and the states (and heat source) at
//   c + delta[t][a], reads past N giving zero, runs element_body.cuh's
//   residual body (the one K4 and K6 run) and stores 24 values into a
//   (T, 24, N) element buffer.
// - K1c node pass: one thread per (node n, component k) adds the 4T
//   contributions elem[t, a*6 + k, n - delta[t][a]] in the plain version's
//   (t, a) order from +0 (reads below column 0 skipped).
// - K2c element pass: the same threads run the Jacobian body (lhs_body,
//   frozen or implicit with the metric rows of the residual geometry) into a
//   (T, 16*kComp, N) buffer, kComp = 16 frozen, 18 implicit.
// - K2c plane pass: one thread per (plane p, component k, node n) sums the
//   plane's (t, a, b) entries in the order of the plain version
//   (fem/lattice.py::plane_entries: host-built, (row, shift) pairs), then
//   the masked epilogue: times keep[k, n], plus add[k, n] on the zero-offset
//   plane, plus the pre-masked facet band (velocity/pressure rows only);
//   components 0-15 go to data (D, 16, N), 16/17 to scal rows 2p, 2p+1.
// No atomics: a run's float32 result repeats from run to run.
//
// A lane without an element of a class carries zero geometry: the bodies'
// tr > 0 guards keep its contributions exact zeros, as a box's dead cells.
// States are read at c + delta <= N - 1 + dmax: the reads are guarded, so no
// padding is needed for any dmax.
//
// What bounds them on an H100: the function's bound is K1's and K2's
// (operations for the residual, the DIA data's bytes for the Jacobian).
// These passes add the element buffer's write and read (T * 24 floats a
// node for K1c; T * 256 or 288 for K2c, about 1.08 GB at box 55 frozen):
// that traffic is the design's cost, which the one-pass kernels avoid.

#include "element_body.cuh"

namespace dedflow {

// Vertex offsets of the T <= 8 slabs, passed by value.
struct ClassDeltas {
  int nt;
  int d[kMaxSlabs][4];
};

// Vertex offsets of slab t (t is uniform across a block).
__device__ __forceinline__ void class_deltas(const ClassDeltas& dl, int t, int dv[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int v = 0;
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s) v = (s == t) ? dl.d[s][a] : v;
    dv[a] = v;
  }
}

__global__ void __launch_bounds__(128)
residual_classes_element_kernel(const float* __restrict__ geom,  // (T, 19, n)
                                const float* __restrict__ wa,    // (6, n)
                                const float* __restrict__ dwa,   // (6, n)
                                const float* __restrict__ src,   // (n,) or null
                                float* __restrict__ elem,        // (T, 24, n)
                                int n, ClassDeltas dl, RowsResParams prm) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const size_t N = static_cast<size_t>(n);

  ResInputs x;
  const float* g = geom + static_cast<size_t>(t) * 19 * N + c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) x.sh[i][a] = g[(i * 4 + a) * N];
  x.det = g[12 * N];
  x.m00 = g[13 * N];
  x.m01 = g[14 * N];
  x.m02 = g[15 * N];
  x.m11 = g[16 * N];
  x.m12 = g[17 * N];
  x.m22 = g[18 * N];

  int dv[4];
  class_deltas(dl, t, dv);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
    const bool in = v < n;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.u[i][a] = in ? wa[i * N + v] : 0.f;
      x.du[i][a] = in ? dwa[i * N + v] : 0.f;
    }
    x.p[a] = in ? dwa[3 * N + v] : 0.f;
    x.phi[a] = in ? wa[4 * N + v] : 0.f;
    x.tem[a] = in ? wa[5 * N + v] : 0.f;
    x.dphi[a] = in ? dwa[4 * N + v] : 0.f;
    x.dtem[a] = in ? dwa[5 * N + v] : 0.f;
    x.src[a] = (in && src != nullptr) ? src[v] : 0.f;
  }
  res_body(x, prm, elem + static_cast<size_t>(t) * 24 * N + c, N);
}

// out[k, n] = sum over (t, a) of elem[t, a*6 + k, n - delta[t][a]].
__global__ void __launch_bounds__(256)
residual_classes_node_kernel(const float* __restrict__ elem,  // (T, 24, n)
                             float* __restrict__ out,         // (6, n)
                             int n, ClassDeltas dl) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxSlabs; ++t) {
    if (t < dl.nt) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int cell = r - dl.d[t][a];
        if (cell >= 0) acc += elem[(static_cast<size_t>(t) * 24 + a * 6 + k) * N + cell];
      }
    }
  }
  out[k * N + r] = acc;
}

template <bool kImplicit>
__global__ void __launch_bounds__(128)
jacobian_classes_element_kernel(const float* __restrict__ geom,   // (T, 15, n)
                                const float* __restrict__ mgeom,  // (T, 19, n), implicit
                                const float* __restrict__ wa,     // (>=3, n) velocity rows
                                float* __restrict__ elem,         // (T, 16*kComp, n)
                                int n, ClassDeltas dl, RowsLhsParams prm) {
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
  class_deltas(dl, t, dv);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
#pragma unroll
    for (int i = 0; i < 3; ++i) x.u[i][a] = v < n ? wa[i * N + v] : 0.f;
  }
  lhs_body<kImplicit, kComp>(x, prm, elem + static_cast<size_t>(t) * 16 * kComp * N + c, N);
}

// value[p, k, n] = keep[k, n] * (sum over plane p's entries) + (p == d0) *
// add[k, n] + band[p, k, n - lo] (k < 16); data[p, k, n] for k < 16, scal
// [2p + k - 16, n] for k = 16, 17. entries[e] = (element-buffer row of the
// entry's (t, a, b) pair, delta[t][a]); plane p's are starts[p] ..
// starts[p+1] - 1.
template <int kComp>
__global__ void __launch_bounds__(256)
jacobian_classes_plane_kernel(const float* __restrict__ elem,  // (T, 16*kComp, n)
                              const float* __restrict__ keep,  // (kComp, n)
                              const float* __restrict__ add,   // (kComp, n)
                              const float* __restrict__ band,  // (D, 16, span) or null
                              int band_lo, int band_span,
                              float* __restrict__ out,         // (D, 16, n)
                              float* __restrict__ scal,        // (2D, n), kComp == 18
                              int n, const int* __restrict__ starts,
                              const int2* __restrict__ entries, int d0) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  const int e0 = __ldg(starts + p), e1 = __ldg(starts + p + 1);
  float acc = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int2 en = __ldg(entries + e);
    const int cell = r - en.y;
    if (cell >= 0) acc += elem[static_cast<size_t>(en.x + k) * N + cell];
  }
  float v = acc * keep[k * N + r];
  if (p == d0) v += add[k * N + r];
  if (k < 16) {
    if (band != nullptr && r >= band_lo && r < band_lo + band_span)
      v += band[(static_cast<size_t>(p) * 16 + k) * band_span + (r - band_lo)];
    out[(static_cast<size_t>(p) * 16 + k) * N + r] = v;
  } else {
    scal[(static_cast<size_t>(2 * p) + (k - 16)) * N + r] = v;
  }
}

bool read_deltas(int nt, const int* deltas, ClassDeltas* dl) {
  if (nt < 1 || nt > kMaxSlabs) return false;
  *dl = ClassDeltas{};
  dl->nt = nt;
  for (int t = 0; t < nt; ++t)
    for (int a = 0; a < 4; ++a) {
      dl->d[t][a] = deltas[t * 4 + a];
      if (dl->d[t][a] < 0) return false;
    }
  return true;
}

}  // namespace dedflow

// K1c. src: the (n,) nodal heat source, or null for none; elem: scratch of
// nt * 24 * n floats; deltas: nt x 4 vertex offsets (>= 0), nt <= 8.
extern "C" int dedflow_lattice_residual_classes(const void* geom, const void* wa, const void* dwa,
                                                const void* src, void* elem, void* out, int n,
                                                int nt, const int* deltas, double rho, double mu,
                                                double cp, double kappa, double fb0, double fb1,
                                                double fb2, double dt, void* stream) {
  using namespace dedflow;
  ClassDeltas dl;
  if (n <= 0 || !read_deltas(nt, deltas, &dl)) return static_cast<int>(cudaErrorInvalidValue);
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  residual_classes_element_kernel<<<dim3((n + 127) / 128, nt), 128, 0, s>>>(
      static_cast<const float*>(geom), static_cast<const float*>(wa),
      static_cast<const float*>(dwa), static_cast<const float*>(src), static_cast<float*>(elem),
      n, dl, prm);
  residual_classes_node_kernel<<<dim3((n + 255) / 256, 6), 256, 0, s>>>(
      static_cast<const float*>(elem), static_cast<float*>(out), n, dl);
  return static_cast<int>(cudaGetLastError());
}

// K2c. mgeom (the (nt, 19, n) residual geometry) not null selects the
// implicit mode: keep/add are then (18, n) and scal (2D, n) receives the
// phi-phi / T-T rows; otherwise keep/add are (16, n) and scal is not
// written. elem: scratch of nt * 16 * (16 or 18) * n floats; starts
// (num_planes + 1) and entries (starts[num_planes] x 2) are device int32
// tables (fem/lattice.py::plane_entries); d0 the zero-offset plane.
extern "C" int dedflow_lattice_jacobian_classes(const void* geom, const void* mgeom,
                                                const void* wa, void* elem, const void* keep,
                                                const void* add, const void* band, int band_lo,
                                                int band_span, void* out, void* scal, int n,
                                                int nt, const int* deltas, int num_planes,
                                                const void* starts, const void* entries, int d0,
                                                double rho, double mu, double f1, double f2,
                                                double dt, double cp, double kappa,
                                                void* stream) {
  using namespace dedflow;
  const bool implicit = mgeom != nullptr;
  ClassDeltas dl;
  if (n <= 0 || num_planes < 1 || num_planes > 65535 || d0 < 0 || d0 >= num_planes ||
      (implicit && scal == nullptr) || !read_deltas(nt, deltas, &dl))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 eg((n + 127) / 128, nt);
  const float* g = static_cast<const float*>(geom);
  const float* mg = static_cast<const float*>(mgeom);
  const float* w = static_cast<const float*>(wa);
  float* el = static_cast<float*>(elem);
  const float* kp = static_cast<const float*>(keep);
  const float* ad = static_cast<const float*>(add);
  const float* bd = static_cast<const float*>(band);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scal);
  const int* st = static_cast<const int*>(starts);
  const int2* en = static_cast<const int2*>(entries);
  if (implicit) {
    jacobian_classes_element_kernel<true><<<eg, 128, 0, s>>>(g, mg, w, el, n, dl, prm);
    jacobian_classes_plane_kernel<18><<<dim3((n + 255) / 256, 18, num_planes), 256, 0, s>>>(
        el, kp, ad, bd, band_lo, band_span, o, sc, n, st, en, d0);
  } else {
    jacobian_classes_element_kernel<false><<<eg, 128, 0, s>>>(g, mg, w, el, n, dl, prm);
    jacobian_classes_plane_kernel<16><<<dim3((n + 255) / 256, 16, num_planes), 256, 0, s>>>(
        el, kp, ad, bd, band_lo, band_span, o, sc, n, st, en, d0);
  }
  return static_cast<int>(cudaGetLastError());
}
