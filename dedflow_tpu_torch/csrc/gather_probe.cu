// K13: the element gather probe of tools/gather_probe.py on an H100,
//
//     out[a * 16 + c, m] = win[idx[a, m], c]      a < 4, c < 16, m < M,
//
// from a (W, 16) float32 node window by the int32 (4, M) node ids of M
// elements (an id outside [0, W) gives zeros). It is the gather the
// element kernels K4/K5 and the state gather K10 run on every Newton
// iteration.
//
// Replaces the TPU kernels tools/gather_probe.py::_onehot_kernel (:33,
// pallas_call at :60: the gather as a one-hot matrix product on the MXU)
// and ::_tala_kernel (:48, pallas_call at :76: take_along_axis on a
// VMEM-resident (C, W) window). Neither idiom carries over; the card
// gathers by address. Two idioms, to measure against each other:
// (i) global: a thread per element reads its 4 ids and each node's 64-byte
//     row as 4 float4 loads through L1/L2 (K10's and K4/K5's gather);
//     stores are coalesced along the element axis.
// (ii) staged: the window is first copied into shared memory and the
//     gathers read it from there. W x 16 floats are 256 KB at the probe's
//     W = 4096, more than a block's 227 KB, so the 16 columns are staged
//     in passes of 16 / npass columns (npass 1, 2 or 4, the fewest that
//     fit: 2 passes of 128 KB at W = 4096); each pass copies the window's
//     columns once (coalesced float4s) and writes its rows of out.
// What bounds it on an H100: bytes, and at the probe's size (idx 1.05 MB,
// window 0.26 MB, out 16.8 MB) the launch: the bound is a few
// microseconds. Pure copies: the result equals the plain gather bit for
// bit.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kC = 16;           // floats a node row
constexpr int kGlobalThreads = 256;
constexpr int kStagedThreads = 512;

__global__ void __launch_bounds__(kGlobalThreads)
element_gather_global_kernel(const int* __restrict__ idx, const float4* __restrict__ win,
                             float* __restrict__ out, int m, int w) {
  const int e = blockIdx.x * kGlobalThreads + threadIdx.x;
  if (e >= m) return;
  const size_t M = static_cast<size_t>(m);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int node = idx[a * M + e];
    const bool ok = static_cast<unsigned>(node) < static_cast<unsigned>(w);
#pragma unroll
    for (int q = 0; q < kC / 4; ++q) {
      const float4 v = ok ? __ldg(win + static_cast<size_t>(node) * (kC / 4) + q)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      float* o = out + (a * kC + 4 * q) * M + e;
      o[0] = v.x;
      o[M] = v.y;
      o[2 * M] = v.z;
      o[3 * M] = v.w;
    }
  }
}

__global__ void __launch_bounds__(kStagedThreads)
element_gather_staged_kernel(const int* __restrict__ idx, const float4* __restrict__ win,
                             float* __restrict__ out, int m, int w, int npass) {
  extern __shared__ float4 tbl[];  // (w, vecs): this pass's columns of each node
  const int e = blockIdx.x * kStagedThreads + threadIdx.x;
  const size_t M = static_cast<size_t>(m);
  const int vecs = kC / 4 / npass;  // float4s a node and pass
  int node[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) node[a] = e < m ? idx[a * M + e] : -1;
  for (int p = 0; p < npass; ++p) {
    if (p > 0) __syncthreads();  // every thread done with the last pass's table
    for (int k = threadIdx.x; k < w * vecs; k += kStagedThreads)
      tbl[k] = win[static_cast<size_t>(k / vecs) * (kC / 4) + p * vecs + k % vecs];
    __syncthreads();
    if (e >= m) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const bool ok = static_cast<unsigned>(node[a]) < static_cast<unsigned>(w);
      for (int q = 0; q < vecs; ++q) {
        const float4 v = ok ? tbl[node[a] * vecs + q] : make_float4(0.f, 0.f, 0.f, 0.f);
        float* o = out + (a * kC + 4 * (p * vecs + q)) * M + e;
        o[0] = v.x;
        o[M] = v.y;
        o[2 * M] = v.z;
        o[3 * M] = v.w;
      }
    }
  }
}

}  // namespace dedflow

// idx: contiguous int32 (4, m); win: contiguous float32 (w, 16), 16-byte
// aligned; out: float32 (64, m). npass = 0 the global idiom; 1, 2 or 4 the
// staged one in that many column passes (the caller picks the fewest whose
// table fits a block; a table past the opt-in limit fails the attribute
// call). Returns 0 or the CUDA error of the launch.
extern "C" int dedflow_element_gather(const void* idx, const void* win, void* out, int m, int w,
                                      int npass, void* stream) {
  using namespace dedflow;
  if (m <= 0 || w <= 0 || !(npass == 0 || npass == 1 || npass == 2 || npass == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float4* t = static_cast<const float4*>(win);
  float* o = static_cast<float*>(out);
  if (npass == 0) {
    element_gather_global_kernel<<<(m + kGlobalThreads - 1) / kGlobalThreads, kGlobalThreads, 0,
                                   s>>>(i, t, o, m, w);
    return static_cast<int>(cudaGetLastError());
  }
  const long long smem = static_cast<long long>(w) * (kC / npass) * sizeof(float);
  if (smem > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(element_gather_staged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  element_gather_staged_kernel<<<(m + kStagedThreads - 1) / kStagedThreads, kStagedThreads,
                                 static_cast<size_t>(smem), s>>>(i, t, o, m, w, npass);
  return static_cast<int>(cudaGetLastError());
}
