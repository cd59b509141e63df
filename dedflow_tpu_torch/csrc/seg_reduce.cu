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
// instantiation and keeps its own launch counter; one counted launch is the
// two device kernels below, back to back on the caller's stream.
//
// What bounds a single pass on an H100: sectors. A pass that walks each
// target's contributions in plan order reads, per contribution, C floats that
// lie cstride apart: each lands in its own 32-byte sector, of which it uses 4
// bytes; the sector's other 7 floats belong to neighbouring elements, which
// feed targets far away in target order. At 1,181,683 Delaunay tets K9 reads
// 18,906,928 contributions x 16 rows x 32 B = 9.68 GB of sectors (2.89 ms at
// 3.35 TB/s; the one-thread-a-target kernel took 2.80 ms, the L2 catching
// what neighbouring targets share), and on the unordered mesh, where the L2
// catches nothing, 7.36 ms. No other thread mapping of that one pass changes
// the sector count.
//
// Design: two passes, no atomics.
// 1. Stage (stage_kernel): one thread a contribution, in ascending source
//    order (the plan's stage_src, with stage_pos its plan position). Thread i
//    reads x[stage_src[i] + comps[r] * cstride] for r < C: consecutive threads
//    read consecutive columns of each element row, so every byte fetched is
//    used. The block's 256 staged rows, zero-padded to W = C rounded up to 8
//    (a whole 32-byte sector), go through a shared-memory tile, and then
//    consecutive threads write consecutive 16-byte quads of each row
//    stage[stage_pos[i], 0:W] of a (K, W) staging buffer: a scattered write,
//    but every store instruction writes whole sectors (8 rows of 64 B for
//    W = 16). A first version in which each thread stored its own row (and
//    a thread a target summed whole rows) took 2.44 ms for K9 at 1.18M tets
//    against this one's 1.62 (chip_smoke.py, H100 80GB HBM3, 700 W).
// 2. Segment sum (segment_sum_kernel): a thread for each target and 16-byte
//    quad of its row. The W/4 threads of a target read the quads of each of
//    its contiguous rows [ptr[t], ptr[t+1]) together (whole sectors again),
//    add them in plan order (k ascending) with several rows in flight, and
//    write their sums coalesced along t. The order of the additions is that
//    of the single-pass kernel, so the result equals it bit for bit and
//    repeats from run to run.
// What bounds it: bytes. At 1.18M tets K9 (C = 16, W = 16) reads 1.21 GB of
// rows + 0.15 GB of stage arrays and writes 1.21 GB in pass 1, reads 1.21 GB
// back and writes 0.19 GB of output in pass 2: about 3.97 GB, 1.19 ms at
// 3.35 TB/s; K8 (C = 6, W = 8) about 0.46 GB. Neither depends on node order.
// On an H100 80GB HBM3 (700 W) K9 takes 1.62 ms on the RCM-ordered plan and
// 1.69 on the unordered one, about 2.4 TB/s over those bytes. The total is
// about 2.7x the least bytes of the function (the plan, one float per
// contribution and row, the output): the round trip through the staging
// buffer is the price of determinism and full sectors.
//
// The solvers' Jacobian takes no round trip: the staged element kernels
// (element_rows.cu, gather_elements.cu) store each contribution's 16 rows
// straight into the (K, 16) staging buffer at its plan position, and
// dedflow_segment_sum runs pass 2 alone over it (over a (K, 8) buffer for
// the implicit phi/T tangents). It reads 1.21 GB of rows and the plan's
// 0.01 GB of segment bounds and writes 0.19 GB at 1.18M tets: 0.555 ms on
// the RCM plan and 0.563 on the unordered one, against a byte bound of 0.42
// (the staging pass was the other 1.07 / 1.14 ms of K9; NVIDIA H100 80GB
// HBM3, 700 W). Its sums equal K9's bit for bit.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kMaxRows = 16;
constexpr int kStageThreads = 256;
constexpr int kSumThreads = 128;
constexpr int kRowsInFlight = 4;  // rows of the staging buffer a thread loads ahead (8: no faster)

struct Comps {
  int c[kMaxRows];
};

template <int W>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const float* __restrict__ x, long long cstride,
             const int* __restrict__ stage_src,  // (num_contrib,) ascending
             const int* __restrict__ stage_pos,  // (num_contrib,) plan positions
             Comps comps, int num_rows,
             float* __restrict__ stage,          // (num_contrib, W)
             int num_contrib) {
  constexpr int Q = W / 4;
  __shared__ float tile[W][kStageThreads + 1];  // column-major: conflict-free writes
  __shared__ int pos[kStageThreads];
  const int base = blockIdx.x * kStageThreads;
  const int i = base + threadIdx.x;
  if (i < num_contrib) {
    const float* xs = x + static_cast<size_t>(stage_src[i]);
#pragma unroll
    for (int r = 0; r < W; ++r)
      tile[r][threadIdx.x] =
          r < num_rows ? xs[static_cast<size_t>(comps.c[r]) * static_cast<size_t>(cstride)] : 0.f;
    pos[threadIdx.x] = stage_pos[i];
  }
  __syncthreads();
  const int n = min(kStageThreads, num_contrib - base);
  // consecutive threads write consecutive 16-byte quads of a row: whole sectors a store
  for (int s = threadIdx.x; s < n * Q; s += kStageThreads) {
    const int row = s / Q, q = s % Q;
    reinterpret_cast<float4*>(stage + static_cast<size_t>(pos[row]) * W)[q] =
        make_float4(tile[4 * q][row], tile[4 * q + 1][row], tile[4 * q + 2][row],
                    tile[4 * q + 3][row]);
  }
}

template <int W>
__global__ void __launch_bounds__(kSumThreads)
segment_sum_kernel(const float* __restrict__ stage,  // (num_contrib, W)
                   const int* __restrict__ ptr,      // (num_tgt + 1,)
                   int num_rows,
                   float* __restrict__ y,            // (num_rows, num_tgt)
                   int num_tgt) {
  constexpr int Q = W / 4;  // float4s a row: lanes q of one target read one row's 16-byte quads
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int t = static_cast<int>(g / Q), q = static_cast<int>(g % Q);
  if (t >= num_tgt) return;
  const float4* col = reinterpret_cast<const float4*>(stage) + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = ptr[t + 1];
  int k = ptr[t];
  for (; k + kRowsInFlight <= end; k += kRowsInFlight) {
    float4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) v[u] = __ldg(col + static_cast<size_t>(k + u) * Q);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {  // k ascending
      acc.x += v[u].x; acc.y += v[u].y; acc.z += v[u].z; acc.w += v[u].w;
    }
  }
  for (; k < end; ++k) {
    const float4 v = __ldg(col + static_cast<size_t>(k) * Q);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  const size_t T = static_cast<size_t>(num_tgt);
  const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * q + j < num_rows) y[(4 * q + j) * T + t] = a[j];
}

template <int W>
int launch_sum(const float* stage, const int* ptr, int num_rows, float* y, int num_tgt,
               cudaStream_t stream) {
  const long long threads = static_cast<long long>(num_tgt) * (W / 4);
  segment_sum_kernel<W><<<static_cast<unsigned>((threads + kSumThreads - 1) / kSumThreads),
                          kSumThreads, 0, stream>>>(stage, ptr, num_rows, y, num_tgt);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_width(const float* x, long long cstride, const int* ptr, const int* stage_src,
                 const int* stage_pos, int num_contrib, const Comps& comps, int num_rows,
                 float* stage, float* y, int num_tgt, cudaStream_t stream) {
  if (num_contrib > 0) {  // a plan without contributions stages nothing
    stage_kernel<W><<<(num_contrib + kStageThreads - 1) / kStageThreads, kStageThreads, 0,
                      stream>>>(x, cstride, stage_src, stage_pos, comps, num_rows, stage,
                                num_contrib);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tgt > 0)  // targets without contributions get zeros
    return launch_sum<W>(stage, ptr, num_rows, y, num_tgt, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXC>
int launch(const void* x, long long cstride, const void* ptr, const void* stage_src,
           const void* stage_pos, int num_contrib, const int* comps, int num_rows,
           void* stage, int width, void* y, int num_tgt, void* stream) {
  if (num_rows < 1 || num_rows > MAXC || num_rows > width || num_contrib < 0 || num_tgt < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Comps cp{};
  for (int r = 0; r < num_rows; ++r) cp.c[r] = comps[r];
  const auto args = [&](auto launch_w) {
    return launch_w(static_cast<const float*>(x), cstride, static_cast<const int*>(ptr),
                    static_cast<const int*>(stage_src), static_cast<const int*>(stage_pos),
                    num_contrib, cp, num_rows, static_cast<float*>(stage),
                    static_cast<float*>(y), num_tgt, static_cast<cudaStream_t>(stream));
  };
  if (width == 8) return args(launch_width<8>);
  if constexpr (MAXC > 8) {
    if (width == 16) return args(launch_width<16>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dedflow

// The entries take the plan (ptr, stage_src, stage_pos of num_contrib
// contributions), the staging buffer (num_contrib, width) float32 with width
// = num_rows rounded up to 8, and the (num_rows, num_tgt) output.

// K8: C <= 8 output rows (the residual's node reduce), width 8.
extern "C" int dedflow_stream_reduce(const void* x, long long cstride, const void* ptr,
                                     const void* stage_src, const void* stage_pos,
                                     int num_contrib, const int* comps, int num_rows,
                                     void* stage, int width, void* y, int num_tgt,
                                     void* stream) {
  return dedflow::launch<8>(x, cstride, ptr, stage_src, stage_pos, num_contrib, comps, num_rows,
                            stage, width, y, num_tgt, stream);
}

// K9: C <= 16 output rows (the Jacobian's entry reduce), width 8 or 16.
extern "C" int dedflow_ring_reduce(const void* x, long long cstride, const void* ptr,
                                   const void* stage_src, const void* stage_pos,
                                   int num_contrib, const int* comps, int num_rows,
                                   void* stage, int width, void* y, int num_tgt, void* stream) {
  return dedflow::launch<16>(x, cstride, ptr, stage_src, stage_pos, num_contrib, comps, num_rows,
                             stage, width, y, num_tgt, stream);
}

// K9's segment sum alone, over a (num_contrib, width) staging buffer that the
// staged element kernels (element_rows.cu, gather_elements.cu) filled at the
// plan's positions: width 16 (the 16 vel/p rows) or 8 (the implicit phi/T
// tangents in columns 0-1, zeros in 2-7), num_rows <= width.
extern "C" int dedflow_segment_sum(const void* stage, int width, const void* ptr, int num_rows,
                                   void* y, int num_tgt, void* stream) {
  using namespace dedflow;
  if (num_rows < 1 || num_rows > width || num_tgt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* st = static_cast<const float*>(stage);
  const int* pt = static_cast<const int*>(ptr);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) return launch_sum<8>(st, pt, num_rows, out, num_tgt, s);
  if (width == 16) return launch_sum<16>(st, pt, num_rows, out, num_tgt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
