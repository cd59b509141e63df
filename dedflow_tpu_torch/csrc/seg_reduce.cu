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
// instantiation and keeps its own launch counter; one counted launch with
// C > 1 is the two device kernels below (stage_kernel, segment_sum_kernel),
// back to back on the caller's stream, and with C = 1 the one pass of
// gather_sum_kernel (the last section of this header).
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
// Design for C > 1: two passes, no atomics.
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
// HBM3, 700 W). Its sums equal K9's bit for bit. The gather tier's residual
// takes no round trip either: the staged K4 (gather_elements.cu) stores
// each contribution's 6 rows into a (K, 8) buffer, and K8's wrapper
// stream_reduce_staged runs the segment sum alone over it: 0.072 ms at
// 1.18M tets against K8's 0.218 with its staging pass, bit-equal.
//
// One output row (the scalar heat / Poisson scatters, fem/assembly.py): no
// staging. With C = 1 a staged contribution is one float and seven zeros in
// a 32-byte row, so the two passes above move about 1.2 GB for K9's
// 15,972,000 contributions at box 55 against 148 MB of function (0.82 ms,
// 5.4x index_add's 0.15). gather_sum_kernel is one pass instead:
//
//     y[t] = sum over k in [ptr[t], ptr[t+1]) of x[src[k]],   k ascending
//
// A block owns kGatherThreads consecutive targets, one thread each, so its
// plan range [ptr[t0], ptr[t0 + 256]) is contiguous. In rounds of up to
// kGatherTile contributions the block loads src coalesced (streaming, so
// that src does not push x out of the L2), gathers x[src[k]] with
// kGatherAhead loads in flight per thread into shared memory in plan
// order, and then each thread adds the part of its own slice that the
// round holds, k ascending, carrying its sum from round to round. A slice
// longer than the tile, or a block whose slices together are, simply spans
// several rounds: one route for every plan, and all 256 threads gather a
// long slice's values. The additions are those of the staged kernels in
// the same order (acc from 0.f, one float added a step; no warp tree), so
// the result equals theirs bit for bit and repeats from run to run.
// Shared-memory slot i lies at i + i/32: a thread's slice starts where its
// neighbour's ends (about 24 floats on for K8, 6 for K9), and the padding
// spreads those strides over the banks.
// What bounds it: bytes, src and x read once each (64 + 64 MB for K9 at
// box 55) plus ptr and y: 148 MB, 0.044 ms at 3.35 TB/s; K8 33 MB. The
// scalar plans' sources are the flat (e, slot) indices of the element
// arrays as they lie (JAX's node_perm / mat_perm), so an element's 4 or 16
// values share one or two sectors, and the targets of one block read
// neighbouring elements: the L2 serves most of the gathers. On an NVIDIA
// H100 80GB HBM3 (700 W) at box 55, as the heat scatters call it
// (app/kernel_ab.py --heat, in turns with the staged route): K8 0.0170 ms
// (the staged route and its copy 0.1746; index_add 0.067), K9 0.0838 (1.166;
// index_add 0.152), bit-equal; the Poisson assembly 4.1-4.2 -> 2.8-2.9 ms.

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

constexpr int kGatherThreads = 256;  // targets a block, one thread each
constexpr int kGatherTile = 8192;    // contributions a block holds in shared memory a round
constexpr int kGatherAhead = 8;      // gathers a thread has in flight

__host__ __device__ constexpr int tile_slot(int i) { return i + (i >> 5); }  // bank spread

__global__ void __launch_bounds__(kGatherThreads)
gather_sum_kernel(const float* __restrict__ x,  // the source row, x[src[k]]
                  const int* __restrict__ ptr,  // (num_tgt + 1,)
                  const int* __restrict__ src,  // (num_contrib,) in plan order
                  float* __restrict__ y,        // (num_tgt,)
                  int num_tgt) {
  __shared__ float tile[tile_slot(kGatherTile)];
  const int t0 = blockIdx.x * kGatherThreads;
  const int t = t0 + threadIdx.x;
  const int k0 = ptr[t0], k1 = ptr[min(t0 + kGatherThreads, num_tgt)];
  const int lo = t < num_tgt ? ptr[t] : 0, hi = t < num_tgt ? ptr[t + 1] : 0;
  float acc = 0.f;
  for (int c0 = k0; c0 < k1; c0 += kGatherTile) {
    const int n = min(kGatherTile, k1 - c0);
    for (int base = threadIdx.x; base < n; base += kGatherThreads * kGatherAhead) {
      int s[kGatherAhead];
      float v[kGatherAhead];
#pragma unroll
      for (int u = 0; u < kGatherAhead; ++u) {
        const int i = base + u * kGatherThreads;
        s[u] = i < n ? __ldcs(src + c0 + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kGatherAhead; ++u)
        v[u] = s[u] >= 0 ? __ldg(x + static_cast<size_t>(s[u])) : 0.f;
#pragma unroll
      for (int u = 0; u < kGatherAhead; ++u) {
        const int i = base + u * kGatherThreads;
        if (i < n) tile[tile_slot(i)] = v[u];
      }
    }
    __syncthreads();
    const int end = min(hi, c0 + n);
    for (int k = max(lo, c0); k < end; ++k) acc += tile[tile_slot(k - c0)];  // k ascending
    __syncthreads();  // the next round overwrites the tile
  }
  if (t < num_tgt) y[t] = acc;
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

// K8 and K9 with one output row, one pass with no staging buffer:
// y[t] = sum over k in [ptr[t], ptr[t+1]) of x[src[k]] in plan order, over
// the plan (ptr, src: int32; x, y: float32; num_tgt >= 1).
extern "C" int dedflow_gather_sum(const void* x, const void* ptr, const void* src, void* y,
                                  int num_tgt, void* stream) {
  using namespace dedflow;
  if (num_tgt <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_sum_kernel<<<(num_tgt + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(ptr), static_cast<const int*>(src),
      static_cast<float*>(y), num_tgt);
  return static_cast<int>(cudaGetLastError());
}
