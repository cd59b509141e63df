// K3: component-major DIA SpMV, y = A x with A = (data (D, 16, N), scal (2D, N)).
//
// Replaces the TPU kernel dedflow_tpu/sparse/dia_kernels.py::_mv_kernel
// (driver _dia_call / dia_matvec_pallas), which streams the matrix through
// double-buffered VMEM windows with a haloed x window and expands x to
// packed-component rows for full-sublane FMAs. None of that carries over.
//
// Design: one thread per row n computes all 6 outputs. For each plane k it
// reads x at column n + offsets[k] (zero outside [0, N)) and the 16
// velocity/pressure components data[k, c, n] plus the two scalar rows
// scal[2k, n], scal[2k+1, n]. The node axis is the contiguous one, so a
// warp reads consecutive addresses for every component.
// What bounds it on an H100: bytes. Each row reads its 15 x 18 matrix
// entries (1080 bytes) once; x (24 bytes a node) is reused by the 15
// planes through L1/L2. At 175,616 rows that is about 190 MB per product.
//
// Component order (sparse/fsbsr.py): 0..8 uu[i*3+j], 9..11 up[i],
// 12..14 pu[j], 15 pp; scal rows 2k = phi-phi, 2k+1 = T-T.
//
// The kernel is a template on the scalar type, built for float (the
// solver's state type on the card) and double (the f64 operator of
// krylov.precision "f64" and the residual of "ir"). The double instance is
// the same row-per-thread product; it moves twice the bytes and stays
// bound by them (the card's FP64 rate is half its FP32 rate, 60 flops a
// row against 2160 bytes).

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kMaxPlanesSpmv = 16;

struct Offsets {
  int o[kMaxPlanesSpmv];
};

template <typename T>
__global__ void __launch_bounds__(256)
dia_spmv_kernel(const T* __restrict__ data,  // (D, 16, n)
                const T* __restrict__ scal,  // (2D, n)
                const T* __restrict__ x,     // (6, n)
                T* __restrict__ y,           // (6, n)
                int n, int num_planes, Offsets off) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const size_t N = static_cast<size_t>(n);
  T y0 = 0, y1 = 0, y2 = 0, y3 = 0, y4 = 0, y5 = 0;
#pragma unroll
  for (int k = 0; k < kMaxPlanesSpmv; ++k) {
    if (k < num_planes) {
      const int col = r + off.o[k];
      if (col >= 0 && col < n) {
        const T x0 = x[col], x1 = x[N + col], x2 = x[2 * N + col];
        const T x3 = x[3 * N + col], x4 = x[4 * N + col], x5 = x[5 * N + col];
        const T* d = data + static_cast<size_t>(k) * 16 * N + r;
        y0 += d[0] * x0 + d[N] * x1 + d[2 * N] * x2 + d[9 * N] * x3;
        y1 += d[3 * N] * x0 + d[4 * N] * x1 + d[5 * N] * x2 + d[10 * N] * x3;
        y2 += d[6 * N] * x0 + d[7 * N] * x1 + d[8 * N] * x2 + d[11 * N] * x3;
        y3 += d[12 * N] * x0 + d[13 * N] * x1 + d[14 * N] * x2 + d[15 * N] * x3;
        y4 += scal[(2 * k) * N + r] * x4;
        y5 += scal[(2 * k + 1) * N + r] * x5;
      }
    }
  }
  y[r] = y0;
  y[N + r] = y1;
  y[2 * N + r] = y2;
  y[3 * N + r] = y3;
  y[4 * N + r] = y4;
  y[5 * N + r] = y5;
}

template <typename T>
int launch(const void* data, const void* scal, const void* x, void* y, int n, int num_planes,
           const int* offsets, void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanesSpmv) return static_cast<int>(cudaErrorInvalidValue);
  Offsets off{};
  for (int k = 0; k < num_planes; ++k) off.o[k] = offsets[k];
  dia_spmv_kernel<T><<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(scal), static_cast<const T*>(x),
      static_cast<T*>(y), n, num_planes, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dedflow

extern "C" int dedflow_dia_spmv(const void* data, const void* scal, const void* x, void* y,
                                int n, int num_planes, const int* offsets, void* stream) {
  return dedflow::launch<float>(data, scal, x, y, n, num_planes, offsets, stream);
}

extern "C" int dedflow_dia_spmv_f64(const void* data, const void* scal, const void* x, void* y,
                                    int n, int num_planes, const int* offsets, void* stream) {
  return dedflow::launch<double>(data, scal, x, y, n, num_planes, offsets, stream);
}
