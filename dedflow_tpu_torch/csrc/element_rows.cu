// K6: the element residual and element Jacobian on row layouts, one
// element column at a time.
//
// Replaces the TPU kernel dedflow_tpu/fem/pallas_kernels.py::_pallas_rows_call
// (pallas_call at :544 for the slab-major form and :565 for the 2-D form)
// running _res_kernel / _lhs_kernel, reached through res_rows_call and
// lhs_rows_call. It computes the same functions as the plain bodies
// dedflow_tpu_torch/fem/element_rows.py::res_rows (67 -> 24 rows, row a*6+c)
// and ::lhs_rows (27 -> 288 rows, row ab*18+c).
// Inputs and outputs are (S, rows, M) float32 with the element column on the
// contiguous axis; S = 1 for the plain (rows, M) form.
//
// Design (simple and right first): one thread per (column m, slab s). It
// reads the column's input rows (coalesced across the warp) into registers
// and runs the element body of element_body.cuh (shared with K4/K5,
// gather_elements.cu) at the 4 quadrature points, writing every output row
// of that column. The Jacobian is built pair by pair from ~50 per-element
// scalars, never holding the 256/288 outputs. What bounds it on an H100:
// FP32 instruction throughput and registers (~60 live scalars, rsqrt/sqrt
// per quadrature point). The Jacobian's 1152 output bytes per element
// (1.36 GB at 1.18M tets) are written once, at well under the card's
// bandwidth: the pair-by-pair arithmetic, not the write, sets its time, as
// in K2's element pass.
//
// The implicit mode adds 6 input rows and, per (a, b) entry, two sums over
// the quadrature points (element_body.cuh): about 15% more arithmetic for
// the same 1152 output bytes per element.

#include "element_body.cuh"

namespace dedflow {

__global__ void __launch_bounds__(128)
res_rows_kernel(const float* __restrict__ inp,  // (S, 67, m)
                float* __restrict__ out,        // (S, 24, m)
                int m, RowsResParams prm) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= m) return;
  const size_t M = static_cast<size_t>(m);
  const float* in = inp + static_cast<size_t>(blockIdx.y) * 67 * M + c;
  ResInputs x;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x.sh[i][a] = in[(i * 4 + a) * M];
      x.u[i][a] = in[(19 + i * 4 + a) * M];
      x.du[i][a] = in[(31 + i * 4 + a) * M];
    }
  x.det = in[12 * M];
  x.m00 = in[13 * M];
  x.m01 = in[14 * M];
  x.m02 = in[15 * M];
  x.m11 = in[16 * M];
  x.m12 = in[17 * M];
  x.m22 = in[18 * M];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    x.p[a] = in[(43 + a) * M];
    x.phi[a] = in[(47 + a) * M];
    x.tem[a] = in[(51 + a) * M];
    x.dphi[a] = in[(55 + a) * M];
    x.dtem[a] = in[(59 + a) * M];
    x.src[a] = in[(63 + a) * M];
  }
  res_body(x, prm, out + static_cast<size_t>(blockIdx.y) * 24 * M + c, M);
}

template <bool kImplicit>
__global__ void __launch_bounds__(128)
lhs_rows_kernel(const float* __restrict__ inp,  // (S, 27|33, m)
                float* __restrict__ out,        // (S, 288, m)
                int m, RowsLhsParams prm) {
  constexpr int kRows = kImplicit ? 33 : 27;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= m) return;
  const size_t M = static_cast<size_t>(m);
  const float* in = inp + static_cast<size_t>(blockIdx.y) * kRows * M + c;
  LhsInputs x;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x.sh[i][a] = in[(i * 4 + a) * M];
      x.u[i][a] = in[(12 + i * 4 + a) * M];
    }
  x.det = in[24 * M];
  x.gg = in[25 * M];
  x.tr = in[26 * M];
  if constexpr (kImplicit) {
    x.m00 = in[27 * M];
    x.m01 = in[28 * M];
    x.m02 = in[29 * M];
    x.m11 = in[30 * M];
    x.m12 = in[31 * M];
    x.m22 = in[32 * M];
  }
  lhs_body<kImplicit>(x, prm, out + static_cast<size_t>(blockIdx.y) * 288 * M + c, M);
}

}  // namespace dedflow

extern "C" int dedflow_res_rows(const void* inp, void* out, int m, int slabs, double rho,
                                double mu, double cp, double kappa, double fb0, double fb1,
                                double fb2, double dt, void* stream) {
  using namespace dedflow;
  if (m <= 0 || slabs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  const dim3 grid((m + 127) / 128, slabs);
  res_rows_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(inp), static_cast<float*>(out), m, prm);
  return static_cast<int>(cudaGetLastError());
}

// implicit != 0: 33 input rows, the implicit phi/T tangents in 16/17.
extern "C" int dedflow_lhs_rows(const void* inp, void* out, int m, int slabs, double rho,
                                double mu, double f1, double f2, double dt, double cp,
                                double kappa, int implicit, void* stream) {
  using namespace dedflow;
  if (m <= 0 || slabs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  const dim3 grid((m + 127) / 128, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(inp);
  float* o = static_cast<float*>(out);
  if (implicit)
    lhs_rows_kernel<true><<<grid, 128, 0, s>>>(in, o, m, prm);
  else
    lhs_rows_kernel<false><<<grid, 128, 0, s>>>(in, o, m, prm);
  return static_cast<int>(cudaGetLastError());
}
