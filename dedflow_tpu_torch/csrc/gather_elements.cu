// K4 and K5: the element residual and the packed element Jacobian of the
// general gather tier, each fused with the gather of its element's nodal
// states.
//
// Replaces the TPU kernels of dedflow_tpu/fem/pallas_kernels.py:
// - K4 ns_residual_pallas (pallas_call at :434, kernel _res_kernel): the
//   alpha states of each element's 4 nodes gathered into packed (67, ne)
//   rows, then the residual body -> (24, ne) rows a*6+c;
// - K5 ns_lhs_packed_pallas (pallas_call at :507, kernel _lhs_kernel): the
//   nodal velocities gathered into packed (27, ne) rows, then the Jacobian
//   body -> (288, ne) rows ab*18+c. Given the 6 metric rows (a view of the
//   residual geometry's rows 13-18), K5 runs the body's implicit mode: the
//   phi/T transport tangents in components 16/17, which the JAX package
//   computes in XLA on this tier (dedflow_tpu/fem/ns.py:184-235).
// The plain torch versions are dedflow_tpu_torch/fem/element_kernels.py::
// ns_residual_gather_plain / ns_lhs_gather_plain (an index gather, then
// element_rows.res_rows / lhs_rows).
//
// Design (simple and right first): one thread per element. It reads its 4
// node ids and its geometry rows (coalesced across the warp along the element
// axis), gathers w, dw and the source straight from the component-major
// (6, N) states into registers, runs the element body of element_body.cuh
// (the body K6 runs) and writes its 24 or 288 output rows, coalesced along
// the element axis. The TPU path's packed (67, ne) / (27, ne) intermediate
// is never written to memory. Geometry and connectivity may be row-strided
// views (ld = row stride in elements), so an element range of a larger
// context runs without a copy.
// What bounds it on an H100: the Jacobian's write, as K6's
// (element_rows.cu): the column rows take 1.12 ms for 1,181,683 unordered
// tets, whether in one launch or in up to 24. The solver runs the staged
// entry (lhs_gather_staged_kernel): each pair's 16 vel/p components go as
// one 64-byte row to its plan position in K9's staging buffer (the implicit
// tangents to a (K, 8) one), whole sectors a store instruction: 0.71 ms on
// the unordered mesh, bit-equal to the column rows, against a byte bound of
// 0.41; the staging buffer's rows are where K9's segment sum reads them, so
// neither the (288, ne) rows nor K9's staging pass exist on that path
// (NVIDIA H100 80GB HBM3, 700 W). The residual reads 44 gathered state
// values per element: a node's components lie N apart, so each is its own
// 32-byte sector, served from L2 (the (6, N) states of 175,616 nodes are
// 4.2 MB each) when the node order is not local.

#include "element_body.cuh"

namespace dedflow {

__global__ void __launch_bounds__(128)
res_gather_kernel(const float* __restrict__ geom, long long geom_ld,  // (19, ld)
                  const int* __restrict__ ien, long long ien_ld,     // (4, ld)
                  const float* __restrict__ w,                       // (6, n)
                  const float* __restrict__ dw,                      // (6, n)
                  const float* __restrict__ src,                     // (n,) or null
                  int n, int m, RowsResParams prm,
                  float* __restrict__ out) {                         // (24, m)
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const size_t G = static_cast<size_t>(geom_ld);
  const size_t N = static_cast<size_t>(n);
  const float* g = geom + e;
  ResInputs x;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) x.sh[i][a] = g[(i * 4 + a) * G];
  x.det = g[12 * G];
  x.m00 = g[13 * G];
  x.m01 = g[14 * G];
  x.m02 = g[15 * G];
  x.m11 = g[16 * G];
  x.m12 = g[17 * G];
  x.m22 = g[18 * G];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t nd = static_cast<size_t>(ien[a * ien_ld + e]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.u[i][a] = w[i * N + nd];
      x.du[i][a] = dw[i * N + nd];
    }
    x.p[a] = dw[3 * N + nd];  // the pressure travels in the rate state
    x.phi[a] = w[4 * N + nd];
    x.tem[a] = w[5 * N + nd];
    x.dphi[a] = dw[4 * N + nd];
    x.dtem[a] = dw[5 * N + nd];
    x.src[a] = src != nullptr ? src[nd] : 0.f;
  }
  res_body(x, prm, out + e, static_cast<size_t>(m));
}

// Element e's Jacobian inputs: its geometry and metric rows, its nodes'
// velocities gathered from the (>= 3, n) state.
template <bool kImplicit>
__device__ __forceinline__ LhsInputs gather_lhs_inputs(
    const float* __restrict__ geom, long long geom_ld, const float* __restrict__ mgeom,
    long long mgeom_ld, const int* __restrict__ ien, long long ien_ld,
    const float* __restrict__ w, int n, int e) {
  const size_t G = static_cast<size_t>(geom_ld);
  const size_t N = static_cast<size_t>(n);
  const float* g = geom + e;
  LhsInputs x;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t nd = static_cast<size_t>(ien[a * ien_ld + e]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x.sh[i][a] = g[(i * 4 + a) * G];
      x.u[i][a] = w[i * N + nd];
    }
  }
  x.det = g[12 * G];
  x.gg = g[13 * G];
  x.tr = g[14 * G];
  if constexpr (kImplicit) {
    const float* mg = mgeom + e;
    const size_t MG = static_cast<size_t>(mgeom_ld);
    x.m00 = mg[0];
    x.m01 = mg[MG];
    x.m02 = mg[2 * MG];
    x.m11 = mg[3 * MG];
    x.m12 = mg[4 * MG];
    x.m22 = mg[5 * MG];
  }
  return x;
}

template <bool kImplicit>
__global__ void __launch_bounds__(128)
lhs_gather_kernel(const float* __restrict__ geom, long long geom_ld,  // (15, ld)
                  const float* __restrict__ mgeom, long long mgeom_ld,  // (6, ld), implicit
                  const int* __restrict__ ien, long long ien_ld,     // (4, ld)
                  const float* __restrict__ w,                       // (>= 3, n)
                  int n, int m, RowsLhsParams prm,
                  float* __restrict__ out) {                         // (288, m)
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const LhsInputs x =
      gather_lhs_inputs<kImplicit>(geom, geom_ld, mgeom, mgeom_ld, ien, ien_ld, w, n, e);
  lhs_body<kImplicit>(x, prm, out + e, static_cast<size_t>(m));
}

// The staged Jacobian: element e's 16 pairs go straight to K9's staging
// rows pos[ab * m + e] (element_body.cuh's Staged layout). A lane past the
// last element recomputes the last one and stores its rows again, the same
// values to the same rows: the warp's quad store needs every lane.
template <bool kImplicit>
__global__ void __launch_bounds__(kStagedThreads)
lhs_gather_staged_kernel(const float* __restrict__ geom, long long geom_ld,    // (15, ld)
                         const float* __restrict__ mgeom, long long mgeom_ld,  // (6, ld)
                         const int* __restrict__ ien, long long ien_ld,        // (4, ld)
                         const float* __restrict__ w,                          // (>= 3, n)
                         const int* __restrict__ pos,  // (16, m) plan positions, -1: none
                         int n, int m, RowsLhsParams prm,
                         float* __restrict__ stage,    // (K, 16)
                         float* __restrict__ tang) {   // (K, 8), implicit mode
  const int c = min(static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x), m - 1);
  const LhsInputs x =
      gather_lhs_inputs<kImplicit>(geom, geom_ld, mgeom, mgeom_ld, ien, ien_ld, w, n, c);
  lhs_body_to<kImplicit, kImplicit ? 18 : 16, Staged<kImplicit>>(
      x, prm, stage, static_cast<size_t>(m), pos + c, tang);
}

}  // namespace dedflow

// K4: (24, m) element residual rows of elements [0, m) of the strided views.
extern "C" int dedflow_res_gather(const void* geom, long long geom_ld, const void* ien,
                                  long long ien_ld, const void* w, const void* dw,
                                  const void* src, int n, int m, double rho, double mu,
                                  double cp, double kappa, double fb0, double fb1, double fb2,
                                  double dt, void* out, void* stream) {
  using namespace dedflow;
  if (m <= 0 || n <= 0 || geom_ld < m || ien_ld < m) return static_cast<int>(cudaErrorInvalidValue);
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  res_gather_kernel<<<(m + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), geom_ld, static_cast<const int*>(ien), ien_ld,
      static_cast<const float*>(w), static_cast<const float*>(dw),
      static_cast<const float*>(src), n, m, prm, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K5: (288, m) packed element Jacobian rows of elements [0, m); with the
// metric rows `mgeom` (not null) the implicit phi/T tangents in 16/17.
extern "C" int dedflow_lhs_gather(const void* geom, long long geom_ld, const void* mgeom,
                                  long long mgeom_ld, const void* ien, long long ien_ld,
                                  const void* w, int n, int m, double rho, double mu, double f1,
                                  double f2, double dt, double cp, double kappa, void* out,
                                  void* stream) {
  using namespace dedflow;
  if (m <= 0 || n <= 0 || geom_ld < m || ien_ld < m || (mgeom != nullptr && mgeom_ld < m))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  const dim3 grid((m + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(geom);
  const float* mg = static_cast<const float*>(mgeom);
  const int* ie = static_cast<const int*>(ien);
  const float* wp = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (mg != nullptr)
    lhs_gather_kernel<true><<<grid, 128, 0, s>>>(g, geom_ld, mg, mgeom_ld, ie, ien_ld, wp, n, m,
                                                  prm, o);
  else
    lhs_gather_kernel<false><<<grid, 128, 0, s>>>(g, geom_ld, mg, 0, ie, ien_ld, wp, n, m, prm,
                                                   o);
  return static_cast<int>(cudaGetLastError());
}

// K5 staged: the (K, 16) staging rows `stage` of a plan with element
// positions `pos` (16, m), for elements [0, m) of the strided views; with
// the metric rows `mgeom` (not null) also the implicit tangents' (K, 8)
// rows `tang`.
extern "C" int dedflow_lhs_gather_staged(const void* geom, long long geom_ld, const void* mgeom,
                                         long long mgeom_ld, const void* ien, long long ien_ld,
                                         const void* w, const void* pos, int n, int m,
                                         double rho, double mu, double f1, double f2, double dt,
                                         double cp, double kappa, void* stage, void* tang,
                                         void* stream) {
  using namespace dedflow;
  if (m <= 0 || n <= 0 || geom_ld < m || ien_ld < m ||
      (mgeom != nullptr && (mgeom_ld < m || tang == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  const dim3 grid((m + kStagedThreads - 1) / kStagedThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(geom);
  const float* mg = static_cast<const float*>(mgeom);
  const int* ie = static_cast<const int*>(ien);
  const float* wp = static_cast<const float*>(w);
  const int* p = static_cast<const int*>(pos);
  float* st = static_cast<float*>(stage);
  float* tg = static_cast<float*>(tang);
  if (mg != nullptr)
    lhs_gather_staged_kernel<true><<<grid, kStagedThreads, 0, s>>>(
        g, geom_ld, mg, mgeom_ld, ie, ien_ld, wp, p, n, m, prm, st, tg);
  else
    lhs_gather_staged_kernel<false><<<grid, kStagedThreads, 0, s>>>(
        g, geom_ld, mg, 0, ie, ien_ld, wp, p, n, m, prm, st, tg);
  return static_cast<int>(cudaGetLastError());
}
