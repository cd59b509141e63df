// K10: the nodal-state gather into element rows,
//
//     out[r, e] = x[c(r), ien[a(r), e]]   (a zero row where r has no source)
//
// for R output rows and elements e, from a (C, N) float32 state table.
//
// Replaces the TPU kernel dedflow_tpu/sparse/win_gather.py::_gather_kernel
// (pallas_call at :179, entry point win_gather :139). The caller's static
// row map (vertex a, component c) -> output row (win_gather.py's `rowmap`)
// is inverted on the host into one source code per output row,
// (a << 8) | c, or -1.
// The TPU kernel keeps the state table in VMEM and walks a host schedule of
// 512-column node windows per 128 elements with lane gathers, because the TPU
// has no per-lane random load; none of that carries over.
//
// Design: one thread per element. It reads its V <= 4 node ids (coalesced),
// then for each output row loads one state value (a random 4-byte load, from
// L2 when the table fits there: 14 rows x 175,616 nodes = 9.8 MB) and stores
// it, coalesced along the element axis. Pure copies: the result equals the
// plain torch gather bit for bit.
// What bounds it on an H100: bytes. Each output float is written once, each
// node id read once; the gathered reads hit L2 when the node order is local,
// and each is its own 32-byte sector when it is not.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kMaxGatherRows = 64;

struct RowSources {
  int code[kMaxGatherRows];  // (vertex << 8) | component, or -1 for a zero row
};

__global__ void __launch_bounds__(256)
win_gather_kernel(const int* __restrict__ ien, long long ien_ld, int nvert,  // (V, ld)
                  const float* __restrict__ x, int n,                       // (C, n)
                  RowSources rs, int num_rows,
                  float* __restrict__ out, int m) {                         // (R, m)
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  int node[4] = {0, 0, 0, 0};
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (a < nvert) node[a] = ien[a * ien_ld + e];
  const size_t N = static_cast<size_t>(n);
  const size_t M = static_cast<size_t>(m);
  for (int r = 0; r < num_rows; ++r) {
    const int code = rs.code[r];
    float v = 0.f;
    if (code >= 0) {
      const int a = code >> 8;
      // select from registers (a dynamic index would spill node[] to local memory)
      const int nd = a == 0 ? node[0] : a == 1 ? node[1] : a == 2 ? node[2] : node[3];
      v = x[static_cast<size_t>(code & 255) * N + static_cast<size_t>(nd)];
    }
    out[r * M + e] = v;
  }
}

}  // namespace dedflow

extern "C" int dedflow_win_gather(const void* ien, long long ien_ld, int nvert, const void* x,
                                  int n, const int* codes, int num_rows, void* out, int m,
                                  void* stream) {
  using namespace dedflow;
  if (m <= 0 || n <= 0 || nvert < 1 || nvert > 4 || ien_ld < m || num_rows < 1 ||
      num_rows > kMaxGatherRows)
    return static_cast<int>(cudaErrorInvalidValue);
  RowSources rs{};
  for (int r = 0; r < num_rows; ++r) rs.code[r] = codes[r];
  win_gather_kernel<<<(m + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ien), ien_ld, nvert, static_cast<const float*>(x), n, rs,
      num_rows, static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
