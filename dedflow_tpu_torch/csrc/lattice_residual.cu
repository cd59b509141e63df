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
//   geometry values and the states (and heat source) of its 4 vertices at
//   c + delta[t][a] (reads past N are zero, as the reference's padded
//   state), runs the residual body of element_body.cuh (the body K4 and K6
//   run) at 4 quadrature points and writes 24 values into an
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
// The pressure travels in the rate slot: p comes from dw_alpha row 3. The
// heat source (melt-pool runs) is a nodal (N,) row or null (zero).

#include "element_body.cuh"

namespace dedflow {

__global__ void __launch_bounds__(128)
residual_element_kernel(const float* __restrict__ geom,  // (6, 19, n)
                        const float* __restrict__ wa,    // (6, n)
                        const float* __restrict__ dwa,   // (6, n)
                        const float* __restrict__ src,   // (n,) or null
                        float* __restrict__ elem,        // (6, 24, n)
                        int n, Deltas dl, RowsResParams prm) {
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
  slab_deltas(dl, t, dv);
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

// src: the (n,) nodal heat source, or null for none.
extern "C" int dedflow_lattice_residual(const void* geom, const void* wa, const void* dwa,
                                        const void* src, void* elem, void* out, int n,
                                        const int* deltas,
                                        double rho, double mu, double cp, double kappa,
                                        double fb0, double fb1, double fb2, double dt,
                                        void* stream) {
  using namespace dedflow;
  Deltas dl;
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) dl.d[t][a] = deltas[t * 4 + a];
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 eg((n + 127) / 128, kSlabs);
  residual_element_kernel<<<eg, 128, 0, s>>>(static_cast<const float*>(geom),
                                             static_cast<const float*>(wa),
                                             static_cast<const float*>(dwa),
                                             static_cast<const float*>(src),
                                             static_cast<float*>(elem), n, dl, prm);
  const dim3 ng((n + 255) / 256, 6);
  residual_node_kernel<<<ng, 256, 0, s>>>(static_cast<const float*>(elem),
                                          static_cast<float*>(out), n, dl);
  return static_cast<int>(cudaGetLastError());
}
