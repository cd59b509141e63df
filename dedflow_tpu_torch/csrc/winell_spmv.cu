// K7: the WinELL SpMV, y = A x on component-major (6, N) vectors.
//
// Replaces the TPU kernel dedflow_tpu/sparse/win_kernels.py::_matvec_kernel
// (pallas_call at :213, called from winell_matvec). That kernel streams
// column-sorted 128-entry vregs of 1024-row superpacks, gathers x with a
// lane-gather window loop and reduces rows with one-hot MXU matmuls: the TPU
// has no scatter unit. None of that carries over.
//
// What bounds it on an H100: bytes. Each entry is read once, 18 values and
// one column index: 76 bytes in float32, 148 in float64 (about 229 / 445 MB
// at 1.18M Delaunay tets); x and y are 24 (48) bytes a node.
//
// What held the first design back: sixteen lanes a row, one entry
// a lane, and each lane read its entry's six x values from the six
// component rows of the (6, n_x) vector: six 32-byte sectors for 24 useful
// bytes. In RCM order neighbouring rows share columns and L1 served most of
// them (65% of the bound); in generated node order, or on an RCB part that
// keeps it, almost every one went to L2: about 580 MB of sector traffic a
// product beside the 229 MB the bound counts (35-39% of the bound).
//
// The design:
//  1. node_major_kernel copies x into a node-major (n_x, 8) scratch, each
//     node's six values and two zeros in one 32-byte row (64 bytes, two
//     sectors, in float64): one coalesced pass over x. The product then
//     gathers one sector an entry (two in float64) in any node order.
//     One C entry launches both, back to back on the caller's stream: two
//     device launches a product, one launch count. (A programmatic
//     dependent launch of the product, its blocks reading bounds and
//     values while the pass finishes, saved 2-3 us a product but gave
//     wrong products under alternating inputs, most likely as the
//     read-only loads of the copy may move above griddepcontrol.wait. The
//     product must never be launched with a programmatic dependency, in a
//     graph edge or otherwise: schedule_fence below would then wait in the
//     first turn of some lanes only.)
//  2. winell_spmv_kernel<T> gives kLanes = 16 lanes to a row. Lane l
//     walks entries row_ptr[r] + l, + 16, ... in turns of two: both
//     entries' column, 18 values and x row are loaded before the first
//     FMA (an entry past the row's end reloads the first and adds +0
//     through a select; schedule_fence keeps ptxas from interleaving the
//     loads with the FMAs), and a row longer than 32 takes further turns
//     with every lane busy. The 16 partial sums are combined by a fixed
//     butterfly of four warp-shuffle rounds, which leaves the row's sum in
//     every lane; lane k writes component k. No atomics and a fixed order
//     a row: the product repeats bit for bit (solver.pc.SIMPLEPC's
//     component-restricted products rely on it).
//     Widths 4, 8 and 32, and turns of four entries, were measured: none
//     was faster on every matrix the solvers run (app/kernel_ab.py
//     --spmv; PERF.md).
//
// The kernels are templates on the scalar type, built for float (the
// solver's state type on the card) and double (the f64 operator of
// krylov.precision "f64" and the residual of "ir").
//
// WinELL component order: row 4k+i (i<3) = d y_u[i] / d x_[k], row 4k+3 =
// d y_p / d x_[k] (k<3 velocity, k=3 pressure), rows 16/17 phi-phi / T-T.
//
// x has n_x >= n columns: the whole matrix's product passes n_x = n; a
// rank's own rows of an RCB partition (parallel.sharded) pass the extended
// vector [own | ghosts] of its halo plan, whose columns the entries index.

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kThreads = 256;
constexpr int kLanes = 16;    // lanes a row
constexpr int kRowWidth = 8;  // node-major row: 6 values, 2 zeros
constexpr int kTurn = 2;      // entries a lane loads before its FMAs

__device__ __forceinline__ void store_row(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], 0.f, 0.f);
}

__device__ __forceinline__ void store_row(double* p, const double* v) {
  double2* q = reinterpret_cast<double2*>(p);
  q[0] = make_double2(v[0], v[1]);
  q[1] = make_double2(v[2], v[3]);
  q[2] = make_double2(v[4], v[5]);
  q[3] = make_double2(0.0, 0.0);
}

__device__ __forceinline__ void load_row(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y;
}

__device__ __forceinline__ void load_row(const double* p, double* v) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y; v[4] = c.x; v[5] = c.y;
}

// A scheduling fence: griddepcontrol.wait (sm_90), which returns at once
// in a grid launched without a programmatic dependency, behind a branch
// taken in a lane's first turn. The branch splits the turn, so ptxas keeps
// the column and value loads before it in flight together (64 registers
// in float32, 124 in float64; chip_smoke.py's build phase checks these
// counts). The same instruction taken in every turn, or an empty asm
// barrier, does not hold ptxas: it interleaves the loads with the FMAs in
// 40 / 64 registers and the product runs 9-28% slower, float64 slower than
// the first design (app/kernel_ab.py --spmv; PERF.md).
__device__ __forceinline__ void schedule_fence() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// (6, n_x) component-major -> (n_x, 8) node-major, a thread a node.
template <typename T>
__global__ void __launch_bounds__(kThreads)
node_major_kernel(const T* __restrict__ x, T* __restrict__ xn, long long n_x) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_x) return;
  const size_t NX = static_cast<size_t>(n_x);
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = x[k * NX + i];
  store_row(xn + kRowWidth * static_cast<size_t>(i), v);
}

// One entry's 4x4 vel/p block product and two scalar diagonals, added
// where `real` (else +0).
template <typename T>
__device__ __forceinline__ void add_entry(T* acc, const T* v, const T* xr, bool real) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T p = v[i] * xr[0] + v[4 + i] * xr[1] + v[8 + i] * xr[2] + v[12 + i] * xr[3];
    acc[i] += real ? p : T(0);
  }
  const T p4 = v[16] * xr[4], p5 = v[17] * xr[5];
  acc[4] += real ? p4 : T(0);
  acc[5] += real ? p5 : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
winell_spmv_kernel(const T* __restrict__ vals,        // (18, S)
                   const int* __restrict__ row_ptr,   // (n + 1,)
                   const int* __restrict__ col,       // (S,)
                   const T* __restrict__ xn,          // (n_x, 8) node-major
                   T* __restrict__ y,                 // (6, n)
                   int n, long long num_entries) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  constexpr int L = kLanes;
  const int lane = threadIdx.x & (L - 1);
  const long long row = gid / L;
  const bool active = row < n;
  const size_t N = static_cast<size_t>(n);
  const size_t S = static_cast<size_t>(num_entries);
  T acc[6] = {0, 0, 0, 0, 0, 0};
  const int begin = active ? row_ptr[row] : 0;
  const int end = active ? row_ptr[row + 1] : 0;
  for (int s = begin + lane; s < end; s += kTurn * L) {
    // kTurn entries a lane, all loaded before the first FMA: an
    // entry past the row's end loads entry s again and adds +0 (a select)
    int e[kTurn], c[kTurn];
#pragma unroll
    for (int u = 0; u < kTurn; ++u) {
      e[u] = s + u * L < end ? s + u * L : s;
      c[u] = col[e[u]];
    }
    T v[kTurn][18];
#pragma unroll
    for (int u = 0; u < kTurn; ++u)
#pragma unroll
      for (int i = 0; i < 18; ++i) v[u][i] = vals[i * S + e[u]];
    if (s == begin + lane) schedule_fence();  // a lane's first turn
    T xr[kTurn][6];
#pragma unroll
    for (int u = 0; u < kTurn; ++u) load_row(xn + kRowWidth * static_cast<size_t>(c[u]), xr[u]);
#pragma unroll
    for (int u = 0; u < kTurn; ++u) add_entry(acc, v[u], xr[u], s + u * L < end);
  }
  // fixed butterfly over the row's L lanes (every lane of the warp reaches
  // it: rows past n carry zeros and write nothing); a + b == b + a, so
  // every lane of the row ends with the same sum
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
  if (active) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k % L == lane) y[k * N + row] = acc[k];
  }
}

template <typename T>
int launch(const void* vals, const void* row_ptr, const void* col, const void* x, void* xn_,
           void* y, int n, long long n_x, long long num_entries, void* stream_) {
  if (n <= 0 || n_x < n)
    return static_cast<int>(cudaErrorInvalidValue);  // refused before anything runs
  const auto stream = static_cast<cudaStream_t>(stream_);
  T* xn = static_cast<T*>(xn_);
  node_major_kernel<T><<<static_cast<unsigned>((n_x + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(static_cast<const T*>(x), xn, n_x);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  const long long threads = static_cast<long long>(n) * kLanes;
  winell_spmv_kernel<T><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                          stream>>>(static_cast<const T*>(vals), static_cast<const int*>(row_ptr),
                                    static_cast<const int*>(col), xn, static_cast<T*>(y), n,
                                    num_entries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dedflow

// x (6, n_x): n_x = n for the whole matrix, [own | ghosts] for a rank's
// part; xn (n_x, 8) scratch of the node-major copy.
extern "C" int dedflow_winell_spmv(const void* vals, const void* row_ptr, const void* col,
                                   const void* x, void* xn, void* y, int n, long long n_x,
                                   long long num_entries, void* stream) {
  return dedflow::launch<float>(vals, row_ptr, col, x, xn, y, n, n_x, num_entries, stream);
}

extern "C" int dedflow_winell_spmv_f64(const void* vals, const void* row_ptr, const void* col,
                                       const void* x, void* xn, void* y, int n, long long n_x,
                                       long long num_entries, void* stream) {
  return dedflow::launch<double>(vals, row_ptr, col, x, xn, y, n, n_x, num_entries, stream);
}
