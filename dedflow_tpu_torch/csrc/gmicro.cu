// K12: the irregular-tier primitive probes of tools/gmicro.py on an H100.
//
// Replaces the TPU kernels timed by tools/gmicro.py::_run (pallas_call at
// :47; bodies k_copy :115, k_taa8 :125, k_taa32 :136, k_winbody :147,
// k_ohgather :186, k_reduce :74). They run over an (8, n) float32 stream
// x with an int32 index stream idx of the same shape, in blocks of 512
// lanes; n is a multiple of 512. The functions, not the TPU idioms (lane
// gathers on vregs, one-hot MXU products on bf16 hi/lo splits, fori_loop
// window passes), carry over:
//
//   copy            o = 2 x                                     (k_copy)
//   lane gather     o[r, 128t + l] = x[r, 128t + (idx[r, 128t + l] & 127)]
//                                                   (k_taa8 and k_taa32)
//   window gather   o[r, 512b + j] = x[r, 512b + (id & 511)] if 0 <= id >> 9 < nwin,
//                   else 0, with id = idx[0, 512b + j]    (k_winbody(nwin);
//                   k_ohgather is nwin = 1 on id & 511: `wrap`)
//   segment reduce  o[r', 512b + 128q + l] = sum over the columns j of block b
//                   with (idx[0, 512b + j] & 127) = l of sum_r x[r, 512b + j],
//                   the same for every hb: k_reduce(hb)'s (8 hb, 128) bins
//                   collapsed over h and r                  (k_reduce(hb))
//
// What bounds them on an H100: bytes (each input read once, each output
// written once; the arithmetic is negligible). The designs:
// - copy: four float4 loads in flight a thread, then four stores.
// - lane gather, two idioms: (i) the block's 8 x 512 lanes staged in
//   shared memory (16 KB, float4 loads), then each output gathered from
//   there; (ii) a warp per 128-lane tile, each lane holding 4 neighbouring
//   values in a float4: an output takes its value from the source lane by
//   4 __shfl_sync (one per component) and a select. Both read x, idx and
//   write o exactly once, coalesced.
// - window gather: the block staged as in (i); the 512 ids of row 0 are
//   read once and serve all 8 rows. nwin only moves the zero predicate, so
//   its time should not depend on nwin.
// - segment reduce: rows first, then bins (seg_bins_kernel). A CTA of 128
//   threads takes 512-lane blocks in a grid-stride loop, the next block's
//   loads in flight while the current one is binned: a thread reads its 4
//   neighbouring columns of the 8 rows as 8 float4 (coalesced, streaming)
//   and their 4 ids as an int4, and sums the rows in registers; the 512
//   column sums go into 128 bins in shared memory (512 B, two buffers so
//   that one barrier separates a block's reads from the next block's
//   adds), added warp-aggregated: the lanes of a warp whose columns share a
//   bin (__match_any_sync) sum their values in a tree over their ranks and
//   the lowest lane adds the sum by a shared atomic. Warps' adds into one
//   bin race, so the float32 sum order varies from run to run (roundoff of
//   at most 512 column sums a bin). Each thread then stores its 4 columns'
//   bins to the 8 rows as float4 (streaming). No (8 hb, 128) accumulator:
//   the time does not depend on hb.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kRows = 8;      // rows of the stream
constexpr int kBlock = 512;   // lanes a block (tools/gmicro.py:_B)
constexpr int kTile = 128;    // lanes a tile
constexpr int kThreads = 256;
constexpr int kBlockVec = kRows * kBlock / 4;  // float4s of a staged block

__global__ void __launch_bounds__(kThreads)
copy2_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long n4) {
  const long long base = static_cast<long long>(blockIdx.x) * (4 * kThreads) + threadIdx.x;
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = base + k * kThreads;
    if (i < n4) v[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = base + k * kThreads;
    if (i < n4) o[i] = make_float4(2.f * v[k].x, 2.f * v[k].y, 2.f * v[k].z, 2.f * v[k].w);
  }
}

// Stage x[:, 512 b : 512 b + 512] of an (8, n) stream into s (8 x 512).
__device__ __forceinline__ void stage_block(const float* __restrict__ x, long long n,
                                            long long base, float4* s) {
  for (int k = threadIdx.x; k < kBlockVec; k += kThreads) {
    const int r = k / (kBlock / 4), c4 = k % (kBlock / 4);
    s[k] = reinterpret_cast<const float4*>(x + r * n + base)[c4];
  }
}

__global__ void __launch_bounds__(kThreads)
lane_gather_smem_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ o, long long n) {
  __shared__ float4 s4[kBlockVec];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  stage_block(x, n, base, s4);
  __syncthreads();
  const float* s = reinterpret_cast<const float*>(s4);
  for (int k = threadIdx.x; k < kBlockVec; k += kThreads) {
    const int r = k / (kBlock / 4), j = 4 * (k % (kBlock / 4));
    const long long g = r * n + base + j;  // a multiple of 4
    const int4 id = *reinterpret_cast<const int4*>(idx + g);
    const int tile = r * kBlock + (j & ~(kTile - 1));
    *reinterpret_cast<float4*>(o + g) = make_float4(
        s[tile + (id.x & (kTile - 1))], s[tile + (id.y & (kTile - 1))],
        s[tile + (id.z & (kTile - 1))], s[tile + (id.w & (kTile - 1))]);
  }
}

// The value at tile lane `id & 127` of the warp's tile, whose lane l holds
// lanes 4l .. 4l + 3 in v.
__device__ __forceinline__ float tile_pick(const float4 v, int id) {
  const int s = id & (kTile - 1), src = s >> 2;
  const float a = __shfl_sync(0xffffffffu, v.x, src);
  const float b = __shfl_sync(0xffffffffu, v.y, src);
  const float c = __shfl_sync(0xffffffffu, v.z, src);
  const float d = __shfl_sync(0xffffffffu, v.w, src);
  const int k = s & 3;
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

__global__ void __launch_bounds__(kThreads)
lane_gather_shfl_kernel(const float4* __restrict__ x, const int4* __restrict__ idx,
                        float4* __restrict__ o, long long ntile) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  // every lane of a warp runs the same trip count, as __shfl_sync needs
  for (long long t = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       t < ntile; t += warps) {
    const long long q = t * 32 + lane;
    const float4 v = x[q];
    const int4 id = idx[q];
    o[q] = make_float4(tile_pick(v, id.x), tile_pick(v, id.y), tile_pick(v, id.z),
                       tile_pick(v, id.w));
  }
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx0,
                     float* __restrict__ o, long long n, int nwin, int wrap) {
  __shared__ float4 s4[kBlockVec];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  stage_block(x, n, base, s4);
  __syncthreads();
  const float* s = reinterpret_cast<const float*>(s4);
  for (int j = threadIdx.x; j < kBlock; j += kThreads) {
    int id = idx0[base + j];
    if (wrap) id &= kBlock - 1;
    const bool hit = (id >> 9) >= 0 && (id >> 9) < nwin;
    const int src = id & (kBlock - 1);
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r * n + base + j] = hit ? s[r * kBlock + src] : 0.f;
  }
}

// The sum of v over the lanes of the warp whose `bin` equals this lane's,
// valid in the lowest of them (a tree over the peers' ranks: the order
// depends only on which lanes are peers); every lane of the warp calls it.
__device__ __forceinline__ float peer_sum(int bin, float v, bool* leader) {
  const int lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(0xffffffffu, bin);
  *leader = (__ffs(peers) - 1) == lane;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);  // the peers above this lane
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);  // the next peer above, 1-based; 0: none
    const float t = __shfl_sync(0xffffffffu, v, next > 0 ? next - 1 : lane);
    if (next > 0) v += t;
    // lanes of odd rank have been added into their lower neighbour
    peers &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return v;
}

constexpr int kBinThreads = kBlock / 4;  // a thread a column quad of a block

__global__ void __launch_bounds__(kBinThreads)
seg_bins_kernel(const float4* __restrict__ x, const int4* __restrict__ idx0,
                float4* __restrict__ o, long long n4, long long nblk) {
  __shared__ __align__(16) float bins[2][kTile];
  const int t = threadIdx.x;
  bins[0][t] = 0.f;
  bins[1][t] = 0.f;
  long long b = blockIdx.x;
  float4 v[kRows];
  int4 id = make_int4(0, 0, 0, 0);
  if (b < nblk) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = __ldcs(x + r * n4 + b * kBinThreads + t);
    id = __ldcs(idx0 + b * kBinThreads + t);
  }
  __syncthreads();
  for (int k = 0; b < nblk; b += gridDim.x, ++k) {
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r) {
      s.x += v[r].x;
      s.y += v[r].y;
      s.z += v[r].z;
      s.w += v[r].w;
    }
    const int4 cur = id;
    const long long nb = b + gridDim.x;
    if (nb < nblk) {  // the next block's loads, in flight while this one is binned
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = __ldcs(x + r * n4 + nb * kBinThreads + t);
      id = __ldcs(idx0 + nb * kBinThreads + t);
    }
    float* bin = bins[k & 1];
    const int ids[4] = {cur.x, cur.y, cur.z, cur.w};
    const float sums[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = ids[q] & (kTile - 1);
      bool leader;
      const float total = peer_sum(l, sums[q], &leader);
      if (leader) atomicAdd(bin + l, total);
    }
    __syncthreads();
    // lanes 4t .. 4t + 3 of the block lie at tile lanes 4 (t % 32) .. + 3
    const float4 out = reinterpret_cast<const float4*>(bin)[t & (kTile / 4 - 1)];
    bins[(k + 1) & 1][t] = 0.f;  // its last reads were before the barrier above
#pragma unroll
    for (int r = 0; r < kRows; ++r) __stcs(o + r * n4 + b * kBinThreads + t, out);
    __syncthreads();
  }
}

}  // namespace dedflow

// The C entry points: 0 or the CUDA error of the launch. x, idx and o are
// contiguous (8, n) streams (n a multiple of 512, 16-byte aligned); only
// row 0 of idx is read by the window gather and the segment reduce.

extern "C" int dedflow_gm_copy2(const void* x, void* o, long long count, void* stream) {
  using namespace dedflow;
  if (count <= 0 || count % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = count / 4;
  const long long grid = (n4 + 4 * kThreads - 1) / (4 * kThreads);
  copy2_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dedflow_gm_lane_gather(const void* x, const void* idx, void* o, long long n,
                                      int shuffle, void* stream) {
  using namespace dedflow;
  if (n <= 0 || n % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shuffle) {
    const long long ntile = kRows * n / kTile;
    const long long want = (ntile + kThreads / 32 - 1) / (kThreads / 32);
    const unsigned grid = static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
    lane_gather_shfl_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float4*>(x),
                                                      static_cast<const int4*>(idx),
                                                      static_cast<float4*>(o), ntile);
  } else {
    lane_gather_smem_kernel<<<static_cast<unsigned>(n / kBlock), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(o), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dedflow_gm_window_gather(const void* x, const void* idx, void* o, long long n,
                                        int nwin, int wrap, void* stream) {
  using namespace dedflow;
  if (n <= 0 || n % kBlock != 0 || nwin < 0) return static_cast<int>(cudaErrorInvalidValue);
  window_gather_kernel<<<static_cast<unsigned>(n / kBlock), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(o), n, nwin,
      wrap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dedflow_gm_seg_reduce(const void* x, const void* idx, void* o, long long n,
                                     void* stream) {
  using namespace dedflow;
  if (n <= 0 || n % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_bins_kernel, kBinThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nblk = n / kBlock, fill = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(nblk < fill ? nblk : fill);
  seg_bins_kernel<<<grid, kBinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int4*>(idx), static_cast<float4*>(o),
      n / 4, nblk);
  return static_cast<int>(cudaGetLastError());
}
