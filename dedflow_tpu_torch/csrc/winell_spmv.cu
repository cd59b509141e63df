// K7: the WinELL SpMV, y = A x on component-major (6, N) vectors.
//
// Replaces the TPU kernel dedflow_tpu/sparse/win_kernels.py::_matvec_kernel
// (pallas_call at :213, called from winell_matvec). That kernel streams
// column-sorted 128-entry vregs of 1024-row superpacks, gathers x with a
// lane-gather window loop and reduces rows with one-hot MXU matmuls: the TPU
// has no scatter unit. None of that carries over.
//
// Design: the entries are in CSR order (sparse/winell.py). Sixteen lanes of a
// warp share one row: lane l takes entries row_ptr[r] + l, + 16, ... in
// order, reads their 18 packed components (vals (18, S), entry axis
// contiguous, so the sixteen lanes read consecutive addresses) and the
// six x values of the entry's column, and accumulates the 4x4 vel/p block
// product and the two scalar diagonals. The sixteen partial sums are then
// combined by a fixed butterfly of warp shuffles and lane 0 writes the row:
// no atomics, so the product repeats bit for bit.
// What bounds it on an H100: bytes. Each entry is read once (18 floats and
// one int, 76 bytes: about 210 MB at 1.18M tets); x (24 bytes a node) is
// gathered through L1/L2, where it stays resident (4.2 MB at 175,616 nodes).
//
// The kernel is a template on the scalar type, built for float (the
// solver's state type on the card) and double (the f64 operator of
// krylov.precision "f64" and the residual of "ir"): the double instance
// moves 148 bytes an entry and stays bound by them.
//
// WinELL component order: row 4k+i (i<3) = d y_u[i] / d x_[k], row 4k+3 =
// d y_p / d x_[k] (k<3 velocity, k=3 pressure), rows 16/17 phi-phi / T-T.
//
// x has n_x >= n columns: the whole matrix's product passes n_x = n; a
// rank's own rows of an RCB partition (parallel.sharded) pass the extended
// vector [own | ghosts] of its halo plan, whose columns the entries index.
// The stride is the only difference: the whole matrix's product is the
// same arithmetic as with n as the stride.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kLanesPerRow = 16;

template <typename T>
__global__ void __launch_bounds__(256)
winell_spmv_kernel(const T* __restrict__ vals,        // (18, S)
                   const int* __restrict__ row_ptr,   // (n + 1,)
                   const int* __restrict__ col,       // (S,)
                   const T* __restrict__ x,           // (6, n_x)
                   T* __restrict__ y,                 // (6, n)
                   int n, long long n_x, long long num_entries) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (kLanesPerRow - 1);
  const long long row = gid / kLanesPerRow;
  const bool active = row < n;
  const size_t N = static_cast<size_t>(n);
  const size_t NX = static_cast<size_t>(n_x);
  const size_t S = static_cast<size_t>(num_entries);
  T acc[6] = {0, 0, 0, 0, 0, 0};
  if (active) {
    const int end = row_ptr[row + 1];
    for (int s = row_ptr[row] + lane; s < end; s += kLanesPerRow) {
      const int c = col[s];
      const T x0 = x[c], x1 = x[NX + c], x2 = x[2 * NX + c];
      const T x3 = x[3 * NX + c], x4 = x[4 * NX + c], x5 = x[5 * NX + c];
      const T* v = vals + s;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] += v[i * S] * x0 + v[(4 + i) * S] * x1 + v[(8 + i) * S] * x2 +
                  v[(12 + i) * S] * x3;
      acc[4] += v[16 * S] * x4;
      acc[5] += v[17 * S] * x5;
    }
  }
  // fixed butterfly over the row's sixteen lanes (every lane of the warp
  // reaches it: rows past n carry zeros and write nothing)
#pragma unroll
  for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (active && lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) y[k * N + row] = acc[k];
  }
}

template <typename T>
int launch(const void* vals, const void* row_ptr, const void* col, const void* x, void* y, int n,
           long long n_x, long long num_entries, void* stream) {
  if (n <= 0 || n_x < n) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n) * kLanesPerRow;
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  winell_spmv_kernel<T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const T*>(x), static_cast<T*>(y), n, n_x, num_entries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dedflow

// x (6, n_x): n_x = n for the whole matrix, [own | ghosts] for a rank's part.
extern "C" int dedflow_winell_spmv(const void* vals, const void* row_ptr, const void* col,
                                   const void* x, void* y, int n, long long n_x,
                                   long long num_entries, void* stream) {
  return dedflow::launch<float>(vals, row_ptr, col, x, y, n, n_x, num_entries, stream);
}

extern "C" int dedflow_winell_spmv_f64(const void* vals, const void* row_ptr, const void* col,
                                       const void* x, void* y, int n, long long n_x,
                                       long long num_entries, void* stream) {
  return dedflow::launch<double>(vals, row_ptr, col, x, y, n, n_x, num_entries, stream);
}
