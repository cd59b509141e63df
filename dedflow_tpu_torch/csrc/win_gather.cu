// K10: the nodal-state gather into the WinELL tier's element input rows,
//
//     out[row0 + r, e] = T[ien[a(r), e], c(r)]   (a zero row where r has no source)
//
// for elements e, where T is the node-major state table the row maps of
// dedflow_tpu/fem/win_assembly.py (_RES_ROWMAP, _JAC_ROWMAP) index: columns
// 0-5 the (N, 6) w_alpha, 6 the (N,) heat source, 8-13 the (N, 6) dw_alpha.
// The table is never built: each array is read where it lies.
//
//   residual map (48 rows, K6's residual input rows 19-66): u i*4+a (w 0-2),
//     du 12+i*4+a (dw 0-2), p 24+a (dw 3), phi 28+a (w 4), T 32+a (w 5),
//     dphi 36+a (dw 4), dT 40+a (dw 5), source 44+a (zero without one);
//     with `geom` the 19 geometry rows are copied into out rows 0-18 in the
//     same launch, so that one launch writes K6's whole (67, ne) input.
//   Jacobian map (12 rows, K6's Jacobian input rows 12-23): u i*4+a.
//
// Replaces the TPU kernel dedflow_tpu/sparse/win_gather.py::_gather_kernel
// (pallas_call at :179, entry point win_gather :139). The TPU kernel keeps a
// (16, N) component-major table in VMEM and walks a host schedule of
// 512-column node windows per 128 elements with lane gathers, because the
// TPU has no per-lane random load; none of that carries over.
//
// What bounds it on an H100: bytes. Each output float is written once, each
// node id and geometry value read once, each state sector read at least
// once. The gathers are not what costs: they hit the L2 (the node-major
// states are 8.4 MB at 175,616 nodes, 9.1 MB with the source). The stores
// do: 48 (67) rows written with 4-byte stores, a thread an element, stay
// far below the card's rate whatever the gathers do, and the same rows
// written as aligned 16-byte stores come close to it (variants timed on the
// RCM Delaunay mesh while this kernel was designed).
//
// Design: a block of 256 threads takes 256 consecutive elements, one a
// thread, with the row maps fixed at compile time (one instance a map; the
// residual's with and without the source). A thread reads its 4 node ids
// (coalesced) and per vertex the 24 contiguous bytes of w_alpha and of
// dw_alpha as three aligned float2 each (one or two 32-byte sectors, where
// a component-major table costs one sector a component) and the source
// value, all before its first store, and writes each value into a shared-
// memory tile of the block's rows (48 x 260 floats, 49,920 B), each row
// shifted by the alignment of its first element in `out`. After one
// barrier each warp writes whole rows: the tile's aligned quads go out as
// float4 streaming stores (K6 reads them once), the two edge quads of a row
// value by value. The geometry rows go from `geom` to `out` quad by quad
// (a float4 load and a float4 store; the wrapper checks that the two arrays
// share their alignment), in the same loop. Pure copies: the result equals
// the plain torch gather bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace dedflow {

constexpr int kJacobianMap = 0;
constexpr int kResidualMap = 1;
constexpr int kResidualSourceMap = 2;
constexpr int kGeomRows = 19;        // the residual geometry (element_rows.res_geom_rows)
constexpr int kGatherElems = 256;    // elements (threads) a block
constexpr int kTileWidth = kGatherElems + 4;  // a tile row: room for its shift
constexpr int kTileQuads = (kGatherElems + 6) / 4 + 1;  // quads a row spans, at most

template <int kMap>
__host__ __device__ constexpr int gather_rows() {
  return kMap == kJacobianMap ? 12 : 48;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// The float offset of row r's element e0 modulo 4 (out's base is 4-byte aligned).
__device__ __forceinline__ int shift_of(const float* base, long long ld, int r, long long e0) {
  return static_cast<int>(((reinterpret_cast<uintptr_t>(base) >> 2) + r * ld + e0) & 3);
}

// Write row `r` of the block's elements [e0, eend): tile row `src` (shifted by
// `sh`) or, with `grow` non-null, the geometry row read quad by quad.
__device__ __forceinline__ void write_row(float* __restrict__ orow, const float* __restrict__ src,
                                          const float* __restrict__ grow, int sh, long long e0,
                                          long long eend, int lane) {
  float* g = orow + e0 - sh;  // 16-byte aligned
  const float* gin = grow == nullptr ? nullptr : grow + e0 - sh;
  const int nq = (sh + static_cast<int>(eend - e0) + 3) >> 2;
  float4 v[(kTileQuads + 31) / 32];
#pragma unroll
  for (int j = 0; j < (kTileQuads + 31) / 32; ++j) {
    const int q = lane + 32 * j;
    const long long q0 = e0 - sh + 4 * q;
    if (q < nq && q0 >= e0 && q0 + 4 <= eend)
      v[j] = gin != nullptr ? __ldcs(reinterpret_cast<const float4*>(gin) + q)
                            : reinterpret_cast<const float4*>(src)[q];
  }
#pragma unroll
  for (int j = 0; j < (kTileQuads + 31) / 32; ++j) {
    const int q = lane + 32 * j;
    if (q >= nq) continue;
    const long long q0 = e0 - sh + 4 * q;
    if (q0 >= e0 && q0 + 4 <= eend) {
      __stcs(reinterpret_cast<float4*>(g) + q, v[j]);
    } else {  // an edge quad: the block's elements only
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q0 + k >= e0 && q0 + k < eend)
          __stcs(g + 4 * q + k, gin != nullptr ? __ldcs(gin + 4 * q + k) : src[4 * q + k]);
    }
  }
}

template <int kMap>
__global__ void __launch_bounds__(kGatherElems)
win_gather_kernel(const int* __restrict__ ien, long long ien_ld,  // (4, ld) node ids
                  const float* __restrict__ w,                    // (N, 6)
                  const float* __restrict__ dw,                   // (N, 6), residual only
                  const float* __restrict__ src,                  // (N,), kResidualSourceMap
                  const float* __restrict__ geom, long long geom_ld,  // (19, ld) or null
                  float* __restrict__ out, long long out_ld, int row0, int m) {
  constexpr bool kResidual = kMap != kJacobianMap;
  constexpr int kRows = gather_rows<kMap>();
  extern __shared__ __align__(16) float tile[];  // kRows x kTileWidth
  const int t = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kGatherElems;
  const long long e = e0 + t;
  const long long eend = e0 + kGatherElems < m ? e0 + kGatherElems : m;
  float* orow0 = out + row0 * out_ld;
  if (e < m) {
    int nd[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) nd[a] = __ldg(ien + a * ien_ld + e);
    float2 wv[4][3], dv[4][3];
    float sv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float* pw = w + 6 * static_cast<size_t>(nd[a]);
      wv[a][0] = load2(pw);
      if (kResidual) {
        wv[a][1] = load2(pw + 2);
        wv[a][2] = load2(pw + 4);
        const float* pd = dw + 6 * static_cast<size_t>(nd[a]);
        dv[a][0] = load2(pd);
        dv[a][1] = load2(pd + 2);
        dv[a][2] = load2(pd + 4);
        sv[a] = kMap == kResidualSourceMap ? __ldg(src + nd[a]) : 0.f;
      } else {
        wv[a][1].x = __ldg(pw + 2);
      }
    }
    auto put = [&](int r, float v) {
      tile[r * kTileWidth + shift_of(orow0, out_ld, r, e0) + t] = v;
    };
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      put(0 + a, wv[a][0].x);  // u: w 0-2
      put(4 + a, wv[a][0].y);
      put(8 + a, wv[a][1].x);
      if (kResidual) {
        put(12 + a, dv[a][0].x);  // du: dw 0-2
        put(16 + a, dv[a][0].y);
        put(20 + a, dv[a][1].x);
        put(24 + a, dv[a][1].y);  // p: dw 3
        put(28 + a, wv[a][2].x);  // phi: w 4
        put(32 + a, wv[a][2].y);  // T: w 5
        put(36 + a, dv[a][2].x);  // dphi: dw 4
        put(40 + a, dv[a][2].y);  // dT: dw 5
        put(44 + a, sv[a]);       // source
      }
    }
  }
  __syncthreads();
  const int lane = t & 31, warp = t >> 5;
  const int geom_rows = kResidual && geom != nullptr ? kGeomRows : 0;
  for (int r = warp; r < geom_rows + kRows; r += kGatherElems / 32) {
    if (r < geom_rows)
      write_row(out + r * out_ld, nullptr, geom + r * geom_ld, shift_of(out, out_ld, r, e0), e0,
                eend, lane);
    else
      write_row(orow0 + (r - geom_rows) * out_ld, tile + (r - geom_rows) * kTileWidth, nullptr,
                shift_of(orow0, out_ld, r - geom_rows, e0), e0, eend, lane);
  }
}

template <int kMap>
cudaError_t launch(const int* ien, long long ien_ld, const float* w, const float* dw,
                   const float* src, const float* geom, long long geom_ld, float* out,
                   long long out_ld, int row0, int m, cudaStream_t s) {
  const int smem = gather_rows<kMap>() * kTileWidth * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(win_gather_kernel<kMap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  win_gather_kernel<kMap><<<(m + kGatherElems - 1) / kGatherElems, kGatherElems, smem, s>>>(
      ien, ien_ld, w, dw, src, geom, geom_ld, out, out_ld, row0, m);
  return cudaGetLastError();
}

}  // namespace dedflow

// The C entry point: 0 or the CUDA error of the launch. `map` is 0 (the
// Jacobian's 12 rows), 1 (the residual's 48, zero source rows) or 2 (the
// residual's with `src`); the rows start at out row `row0`, and with the
// residual map a non-null `geom` (19 rows, row stride geom_ld) goes into
// out rows 0-18 (row0 is then 19), quad by quad: geom and out must then
// share their alignment (equal base addresses modulo 16 bytes and row
// strides modulo 4 floats). w and dw are contiguous (N, 6) arrays with
// 8-byte aligned rows; ien, geom and out have unit element strides and
// 4-byte aligned bases.
extern "C" int dedflow_win_gather(const void* ien, long long ien_ld, int map, const void* w,
                                  const void* dw, const void* src, const void* geom,
                                  long long geom_ld, void* out, long long out_ld, int row0,
                                  int m, void* stream) {
  using namespace dedflow;
  const bool residual = map == kResidualMap || map == kResidualSourceMap;
  const uintptr_t gp = reinterpret_cast<uintptr_t>(geom), op = reinterpret_cast<uintptr_t>(out);
  if (m <= 0 || ien_ld < m || out_ld < m || row0 < 0 || map < 0 || map > kResidualSourceMap ||
      (residual && dw == nullptr) || ((map == kResidualSourceMap) != (src != nullptr)) ||
      (op & 3) != 0 ||
      (geom != nullptr && (!residual || row0 != kGeomRows || geom_ld < m ||
                           (gp & 15) != (op & 15) || (geom_ld - out_ld) % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ien);
  const float *pw = static_cast<const float*>(w), *pd = static_cast<const float*>(dw),
              *ps = static_cast<const float*>(src), *pg = static_cast<const float*>(geom);
  float* po = static_cast<float*>(out);
  cudaError_t err;
  if (map == kJacobianMap)
    err = launch<kJacobianMap>(i, ien_ld, pw, nullptr, nullptr, nullptr, 0, po, out_ld, row0, m, s);
  else if (map == kResidualMap)
    err = launch<kResidualMap>(i, ien_ld, pw, pd, nullptr, pg, geom_ld, po, out_ld, row0, m, s);
  else
    err = launch<kResidualSourceMap>(i, ien_ld, pw, pd, ps, pg, geom_ld, po, out_ld, row0, m, s);
  return static_cast<int>(err);
}
