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
//   segment reduce  acc[b][8h + r, l] = sum of x[r, 512b + j] over the j with
//                   (idx[0, 512b + j] & (128 hb - 1)) = 128h + l; then
//                   o[r', 512b + 128q + l] = sum over h, r of acc[b][8h + r, l]
//                                                          (k_reduce(hb))
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
// - segment reduce: the (8 hb, 128) accumulator lives in shared memory
//   (hb = 16: 64 KB, dynamic, past the 48 KB default after
//   cudaFuncSetAttribute); sources are added by shared-memory atomics (the
//   order of the adds varies from run to run: float32 roundoff of at most
//   512 terms a bin), then 256 threads collapse the 8 hb rows column by
//   column in a fixed order. With `acc` non-null the accumulators are also
//   written out, (n / 512, 8 hb, 128), so that a check can hold them.

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

__global__ void __launch_bounds__(kThreads)
seg_reduce_kernel(const float* __restrict__ x, const int* __restrict__ idx0,
                  float* __restrict__ o, float* __restrict__ acc_out, long long n, int hb) {
  extern __shared__ float acc[];  // (8 hb, 128)
  __shared__ float half_sum[2][kTile];
  const int nacc = kRows * hb * kTile;
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  for (int k = threadIdx.x; k < nacc; k += kThreads) acc[k] = 0.f;
  __syncthreads();
  const int mask = hb * kTile - 1;
  for (int j = threadIdx.x; j < kBlock; j += kThreads) {
    const int e = idx0[base + j] & mask;
    float* a = acc + (e >> 7) * (kRows * kTile) + (e & (kTile - 1));
#pragma unroll
    for (int r = 0; r < kRows; ++r) atomicAdd(a + r * kTile, x[r * n + base + j]);
  }
  __syncthreads();
  if (acc_out != nullptr) {
    float* dst = acc_out + static_cast<long long>(blockIdx.x) * nacc;
    for (int k = threadIdx.x; k < nacc; k += kThreads) dst[k] = acc[k];
  }
  // collapse: thread (half, l) sums rows half * 4 hb .. + 4 hb of column l
  const int l = threadIdx.x & (kTile - 1), half = threadIdx.x >> 7;
  float sum = 0.f;
  for (int row = half * 4 * hb; row < (half + 1) * 4 * hb; ++row) sum += acc[row * kTile + l];
  half_sum[half][l] = sum;
  __syncthreads();
  for (int k = threadIdx.x; k < kRows * kBlock; k += kThreads) {
    const int r = k / kBlock, c = k % kBlock, lc = c & (kTile - 1);
    o[r * n + base + c] = half_sum[0][lc] + half_sum[1][lc];
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

extern "C" int dedflow_gm_seg_reduce(const void* x, const void* idx, void* o, void* acc,
                                     long long n, int hb, void* stream) {
  using namespace dedflow;
  if (n <= 0 || n % kBlock != 0 || hb < 1 || hb > 16 || (hb & (hb - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kRows * hb * kTile * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(seg_reduce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_reduce_kernel<<<static_cast<unsigned>(n / kBlock), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(o),
      static_cast<float*>(acc), n, hb);
  return static_cast<int>(cudaGetLastError());
}
