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
// scalars, never holding the 256/288 outputs.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W, 1,181,683
// Delaunay tets): not the arithmetic (3.06 Gop, 0.046 ms at the FP32 peak)
// but the write. The column Jacobian writes 1152 bytes an element (1.36 GB)
// in 1.10 ms, about 1.24 TB/s. Cut into 2 to 24 launches, or into 6 slabs,
// it is no faster (1.09-1.19 ms): the spread of the 288 rows over the
// output is not what holds it back.
//
// The solver runs the staged entry instead (lhs_rows_staged_kernel): the
// same body stores each pair's 16 vel/p components as one 64-byte row at
// its plan position in K9's staging buffer (csrc/seg_reduce.cu), in the
// WinELL row order, whole sectors a store instruction (element_body.cuh's
// Staged layout); the phi/T identities are neither computed nor stored.
// It writes 1.21 GB and reads 0.19 GB (inputs, positions): 0.62 ms against
// a byte bound of 0.42, and K9's staging pass and the (288, ne) rows are
// gone from the Jacobian path. Its rows equal the column kernel's bit for
// bit: the stores are predicated, so the body stays one basic block and
// the compiler fuses the same multiplies and adds.
//
// The implicit mode adds 6 input rows and, per (a, b) entry, two sums over
// the quadrature points (element_body.cuh): about 15% more arithmetic for
// the same 1152 output bytes per element; staged, the tangents go to a
// second (K, 8) buffer, one sector a row.

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

// The Jacobian inputs of the column `in` points at: rows r at in[r * M].
template <bool kImplicit>
__device__ __forceinline__ LhsInputs lhs_row_inputs(const float* __restrict__ in, size_t M) {
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
  return x;
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
  const LhsInputs x =
      lhs_row_inputs<kImplicit>(inp + static_cast<size_t>(blockIdx.y) * kRows * M + c, M);
  lhs_body<kImplicit>(x, prm, out + static_cast<size_t>(blockIdx.y) * 288 * M + c, M);
}

// The staged Jacobian: column e's 16 pairs go straight to K9's staging rows
// pos[ab * m + e] (element_body.cuh's Staged layout). A lane past the last
// column recomputes the last one and stores its rows again, the same values
// to the same rows: the warp's quad store needs every lane.
template <bool kImplicit>
__global__ void __launch_bounds__(kStagedThreads)
lhs_rows_staged_kernel(const float* __restrict__ inp,  // (27|33, m)
                       const int* __restrict__ pos,    // (16, m) plan positions, -1: none
                       int m, RowsLhsParams prm,
                       float* __restrict__ stage,      // (K, 16)
                       float* __restrict__ tang) {     // (K, 8), implicit mode
  const int c = min(static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x), m - 1);
  const size_t M = static_cast<size_t>(m);
  const LhsInputs x = lhs_row_inputs<kImplicit>(inp + c, M);
  lhs_body_to<kImplicit, kImplicit ? 18 : 16, Staged<kImplicit>>(x, prm, stage, M, pos + c,
                                                                 tang);
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

// The staged Jacobian: (27|33, m) input rows -> the (K, 16) staging rows
// `stage` of a plan with element positions `pos` (16, m), and with
// implicit != 0 the tangents' (K, 8) rows `tang`.
extern "C" int dedflow_lhs_rows_staged(const void* inp, const void* pos, int m, double rho,
                                       double mu, double f1, double f2, double dt, double cp,
                                       double kappa, int implicit, void* stage, void* tang,
                                       void* stream) {
  using namespace dedflow;
  if (m <= 0 || (implicit && tang == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  const dim3 grid((m + kStagedThreads - 1) / kStagedThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(inp);
  const int* p = static_cast<const int*>(pos);
  float* st = static_cast<float*>(stage);
  float* tg = static_cast<float*>(tang);
  if (implicit)
    lhs_rows_staged_kernel<true><<<grid, kStagedThreads, 0, s>>>(in, p, m, prm, st, tg);
  else
    lhs_rows_staged_kernel<false><<<grid, kStagedThreads, 0, s>>>(in, p, m, prm, st, tg);
  return static_cast<int>(cudaGetLastError());
}
