// K8 and K9: the deterministic segmented gather-reduce of irregular assembly,
//
//     y[r, t] = sum over k in [ptr[t], ptr[t+1]) of x[src[k] + comps[r] * cstride]
//
// for targets t and output rows r < C, with the contributions of each target
// sorted by (target, source) on the host (sparse/win_stream.py).
//
// Replaces two TPU kernels that compute this same permute-reduce
// (dedflow_tpu/sparse/win_stream.py:15-16 says so):
// - K8 dedflow_tpu/sparse/win_stream.py::_stream_kernel (pallas_call at :432),
//   C <= 8: the residual's node reduce, 4 contributions per element into N
//   nodes, read from the (24, ne) element residual rows a*6+c;
// - K9 dedflow_tpu/sparse/win_ring.py::_ring_kernel (pallas_call at :622),
//   C <= 16: the Jacobian's entry reduce, 16 contributions per element into
//   the WinELL entries, read from the (288, ne) element Jacobian rows ab*18+c
//   where the element kernel (K6) left them.
// The TPU kernels exist because the TPU has no scatter unit: packs of
// targets, column-sorted windows, double-buffered source slabs, rings of
// partial sums and bf16-split one-hot MXU reductions. None of that carries
// over. Each wrapper (stream_reduce, ring_reduce) launches its own
// instantiation and keeps its own launch counter.
//
// Design: one thread per target. It walks its contribution list in order and
// sums the C rows in registers, then writes C values (coalesced across the
// warp along the target axis). No atomics: the sum order is fixed, so a run
// repeats bit for bit.
// What bounds it on an H100: latency and sectors, not bandwidth. Every
// contribution reads one index and C floats that lie cstride apart, so each
// of its C reads lands in its own 32-byte sector, and each thread walks its
// list one dependent load after another. Consecutive targets draw on
// neighbouring elements (RCM nodes, elements sorted by min node), so part of
// each sector is reused from L2 by the next targets. At 1.18M tets the
// Jacobian reduce must read 1.21 GB of source rows, and takes well over the
// time the card's bandwidth would need for that: splitting a target's list
// over the lanes of a warp is the first tuning step.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kMaxRows = 16;

struct Comps {
  int c[kMaxRows];
};

template <int MAXC>
__global__ void __launch_bounds__(256)
seg_reduce_kernel(const float* __restrict__ x, long long cstride,
                  const int* __restrict__ ptr,   // (num_tgt + 1,)
                  const int* __restrict__ src,   // (num_contrib,)
                  Comps comps, int num_rows,
                  float* __restrict__ y,         // (num_rows, num_tgt)
                  int num_tgt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_tgt) return;
  size_t coff[MAXC];
#pragma unroll
  for (int r = 0; r < MAXC; ++r)
    coff[r] = r < num_rows ? static_cast<size_t>(comps.c[r]) * static_cast<size_t>(cstride) : 0;
  float acc[MAXC];
#pragma unroll
  for (int r = 0; r < MAXC; ++r) acc[r] = 0.f;
  const int end = ptr[t + 1];
  for (int k = ptr[t]; k < end; ++k) {
    const float* xs = x + static_cast<size_t>(src[k]);
#pragma unroll
    for (int r = 0; r < MAXC; ++r)
      if (r < num_rows) acc[r] += xs[coff[r]];
  }
  const size_t T = static_cast<size_t>(num_tgt);
#pragma unroll
  for (int r = 0; r < MAXC; ++r)
    if (r < num_rows) y[r * T + t] = acc[r];
}

template <int MAXC>
int launch(const void* x, long long cstride, const void* ptr, const void* src,
           const int* comps, int num_rows, void* y, int num_tgt, void* stream) {
  if (num_rows < 1 || num_rows > MAXC || num_tgt < 1) return static_cast<int>(cudaErrorInvalidValue);
  Comps cp{};
  for (int r = 0; r < num_rows; ++r) cp.c[r] = comps[r];
  seg_reduce_kernel<MAXC><<<(num_tgt + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), cstride, static_cast<const int*>(ptr),
      static_cast<const int*>(src), cp, num_rows, static_cast<float*>(y), num_tgt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dedflow

// K8: C <= 8 output rows (the residual's node reduce).
extern "C" int dedflow_stream_reduce(const void* x, long long cstride, const void* ptr,
                                     const void* src, const int* comps, int num_rows, void* y,
                                     int num_tgt, void* stream) {
  return dedflow::launch<8>(x, cstride, ptr, src, comps, num_rows, y, num_tgt, stream);
}

// K9: C <= 16 output rows (the Jacobian's entry reduce).
extern "C" int dedflow_ring_reduce(const void* x, long long cstride, const void* ptr,
                                   const void* src, const int* comps, int num_rows, void* y,
                                   int num_tgt, void* stream) {
  return dedflow::launch<16>(x, cstride, ptr, src, comps, num_rows, y, num_tgt, stream);
}
