// K11: the dense grid contact sweep of the DEM, 27 neighbour offsets x K
// slots of spring-dashpot pair forces on grid-resident particle state.
//
// Replaces the TPU kernel dedflow_tpu/dem/grid.py::_pair_kernel (driver
// grid_pair_forces_pallas), which DMAs a haloed window of nine packed
// (8-row padded, pid-as-float) field blocks into VMEM per 2048-cell block
// and sweeps the pairs as dense (K8, 2048) vector arithmetic. None of that
// carries over: it computes the function of grid_pair_forces (the JAX
// _pair_sweep and the port's plain twin in dem/grid.py).
//
// Fields are (K, NC) float32, slot-major, flat cell index c fastest
// (z fastest inside a cell row); pid is int32. Neighbour offset (dx, dy, dz)
// of cell c is cell c + (dx*ny + dy)*nz + dz. A neighbour index outside
// [0, NC) is the plain version's zero padding (mask 0): no contribution.
// An index inside the range that wraps across a grid row is read as it is.
//
// What bounds it on an H100: a dilute cloud leaves most slots empty (the
// coupled grid: 100k live of 9.26M slots, K = 8), and an empty slot costs
// its mask read and three zero stores, 16 B: 148 MB, 0.044 ms at 3.35 TB/s.
// The live slots' 27 x K candidates are a chain of dependent L1/L2 loads
// (mask, then pid and seven fields), so their cost is latency, not bytes.
//
// Design: a thread per slot (k, c), c fastest, for the empty slots: a warp
// reads 32 consecutive masks and stores zeros, coalesced. A warp with live
// lanes (__ballot_sync) serves them one at a time with all 32 lanes: lane
// l takes candidates e = l, l + 32, ... of the centre's 27 x K list in the
// plain version's order (e = offset * K + kp, offsets in _offsets order),
// so a load instruction reads 32 candidates at once and, with K a template
// parameter, all the list's mask loads are in flight together; a live
// candidate's pid and fields are then loaded together, one round trip per
// group of 32 that holds one. Each lane computes its pair's normal and
// tangential terms with IEEE round-to-nearest intrinsics (no FMA
// contraction, IEEE sqrt and division), the plain version's arithmetic.
// The terms are then added in
// candidate order: per group of 32, the lanes whose pair touches
// (__ballot_sync) hand their terms to the whole warp in lane order
// (__shfl_sync), normal then tangential, so the sums are the plain
// version's sums bit for bit and repeat from run to run. A pair with
// act = 0 (empty neighbour, itself, or not touching) adds +-0 in the plain
// version and is skipped here: a sum that starts at +0 never becomes -0,
// so skipping it changes nothing.

#include <cuda_runtime.h>

namespace dedflow {

struct ContactArgs {
  float k_n, gamma_n, mu, gamma_t, eps;
  int tangential;  // mu > 0 and gamma_t > 0
};

struct Fields {
  const float *px, *py, *pz, *vx, *vy, *vz, *rad, *msk;
  const int* pid;
};

// The live centre of a sweep, broadcast to the warp.
struct Centre {
  float x0, x1, x2, u0, u1, u2, r, m;
  int id, c;
};

constexpr unsigned kFull = 0xffffffffu;

// Candidate e of the centre's 27 x K list: its slot index j, or -1 where
// the neighbour cell lies outside [0, NC).
__device__ __forceinline__ int candidate(int e, int K, int c, int NC, int ny, int nz) {
  const int o = e / K, kp = e - o * K;
  const int dx = o / 9 - 1, dy = (o / 3) % 3 - 1, dz = o % 3 - 1;
  const int cn = c + (dx * ny + dy) * nz + dz;
  return (cn < 0 || cn >= NC) ? -1 : kp * NC + cn;
}

// The pair terms of candidate slot j against centre s: w*n (t[0..2]) and
// (ft/tn)*t (t[3..5]); false when the pair adds nothing (act = 0). The
// neighbour's pid and fields are loaded together, one round trip.
__device__ __forceinline__ bool pair_terms(const Fields& f, const Centre& s, int j, float mn,
                                           const ContactArgs& a, float t[6]) {
  if (mn == 0.f) return false;
  const int pj = f.pid[j];
  const float xj0 = f.px[j], xj1 = f.py[j], xj2 = f.pz[j];
  const float vj0 = f.vx[j], vj1 = f.vy[j], vj2 = f.vz[j];
  const float rj = f.rad[j];
  if (pj == s.id) return false;
  const float d0 = __fsub_rn(s.x0, xj0);
  const float d1 = __fsub_rn(s.x1, xj1);
  const float d2 = __fsub_rn(s.x2, xj2);
  const float dist2 =
      __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
  const float dist = __fsqrt_rn(fmaxf(dist2, a.eps));
  const float delta = __fsub_rn(__fadd_rn(s.r, rj), dist);
  if (!(delta > 0.f)) return false;
  const float act = __fmul_rn(s.m, mn);
  const float w0 = __fsub_rn(s.u0, vj0);
  const float w1 = __fsub_rn(s.u1, vj1);
  const float w2 = __fsub_rn(s.u2, vj2);
  const float n0 = __fdiv_rn(d0, dist);
  const float n1 = __fdiv_rn(d1, dist);
  const float n2 = __fdiv_rn(d2, dist);
  const float vn =
      __fadd_rn(__fadd_rn(__fmul_rn(w0, n0), __fmul_rn(w1, n1)), __fmul_rn(w2, n2));
  const float fn = __fsub_rn(__fmul_rn(a.k_n, delta), __fmul_rn(a.gamma_n, vn));
  const float w = __fmul_rn(act, fn);
  t[0] = __fmul_rn(w, n0);
  t[1] = __fmul_rn(w, n1);
  t[2] = __fmul_rn(w, n2);
  if (a.tangential) {
    const float t0 = __fsub_rn(w0, __fmul_rn(vn, n0));
    const float t1 = __fsub_rn(w1, __fmul_rn(vn, n1));
    const float t2 = __fsub_rn(w2, __fmul_rn(vn, n2));
    const float t2sum =
        __fadd_rn(__fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1)), __fmul_rn(t2, t2));
    const float tn = __fsqrt_rn(fmaxf(t2sum, a.eps));
    const float ft = __fmul_rn(act, fminf(__fmul_rn(a.mu, fabsf(fn)), __fmul_rn(a.gamma_t, tn)));
    const float sc = __fdiv_rn(ft, tn);
    t[3] = __fmul_rn(sc, t0);
    t[4] = __fmul_rn(sc, t1);
    t[5] = __fmul_rn(sc, t2);
  }
  return true;
}

// Add the touching lanes' terms of one group of 32 candidates, in lane
// order, to the warp-uniform sums f.
__device__ __forceinline__ void add_group(bool act, const float t[6], int tangential,
                                          float f[3]) {
  unsigned bal = __ballot_sync(kFull, act);
  while (bal) {
    const int src = __ffs(bal) - 1;
    bal &= bal - 1;
#pragma unroll
    for (int i = 0; i < 3; ++i) f[i] = __fadd_rn(f[i], __shfl_sync(kFull, t[i], src));
    if (tangential) {
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = __fsub_rn(f[i], __shfl_sync(kFull, t[3 + i], src));
    }
  }
}

// KT > 0: the capacity K as a compile-time constant (the candidate list
// unrolled, its mask loads batched); KT == 0: any K, a group at a time.
// Five blocks an SM (at most 48 registers, a few bytes spilled to L1): the
// empty slots' stream needs the warps in flight more than the live path
// needs registers (the fastest of four to seven blocks and of no bound on
// the coupled grid and bench.py's two DEM cases, on an H100).
template <int KT>
__global__ void __launch_bounds__(256, 5)
dem_contact_kernel(Fields fl, float* __restrict__ fx, float* __restrict__ fy,
                   float* __restrict__ fz, int Krt, int NC, int ny, int nz, ContactArgs a) {
  const int K = KT > 0 ? KT : Krt;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = idx < K * NC;
  const float m = in ? fl.msk[idx] : 0.f;
  float out[3] = {0.f, 0.f, 0.f};
  unsigned live = __ballot_sync(kFull, m != 0.f);
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    Centre s;
    const int ci = __shfl_sync(kFull, idx, src);
    s.m = __shfl_sync(kFull, m, src);
    s.c = ci % NC;
    s.x0 = fl.px[ci], s.x1 = fl.py[ci], s.x2 = fl.pz[ci];  // one address: broadcast
    s.u0 = fl.vx[ci], s.u1 = fl.vy[ci], s.u2 = fl.vz[ci];
    s.r = fl.rad[ci];
    s.id = fl.pid[ci];
    float f[3] = {0.f, 0.f, 0.f};
    if constexpr (KT > 0) {
      constexpr int kGroups = (27 * KT + 31) / 32;
      float mn[kGroups];  // every mask load of the list in flight at once
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int e = g * 32 + lane;
        const int j = e < 27 * KT ? candidate(e, KT, s.c, NC, ny, nz) : -1;
        mn[g] = j >= 0 ? fl.msk[j] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int e = g * 32 + lane;
        float t[6] = {};
        const bool act =
            mn[g] != 0.f && pair_terms(fl, s, candidate(e, KT, s.c, NC, ny, nz), mn[g], a, t);
        add_group(act, t, a.tangential, f);
      }
    } else {
      for (int base = 0; base < 27 * K; base += 32) {
        const int e = base + lane;
        const int j = e < 27 * K ? candidate(e, K, s.c, NC, ny, nz) : -1;
        float t[6] = {};
        const bool act = j >= 0 && pair_terms(fl, s, j, fl.msk[j], a, t);
        add_group(act, t, a.tangential, f);
      }
    }
    if (lane == src) {
      out[0] = f[0];
      out[1] = f[1];
      out[2] = f[2];
    }
  }
  if (in) {
    fx[idx] = out[0];
    fy[idx] = out[1];
    fz[idx] = out[2];
  }
}

template <int KT>
void launch(const Fields& fl, float* fx, float* fy, float* fz, int K, int NC, int ny, int nz,
            const ContactArgs& a, cudaStream_t s) {
  const int total = K * NC;
  dem_contact_kernel<KT><<<(total + 255) / 256, 256, 0, s>>>(fl, fx, fy, fz, K, NC, ny, nz, a);
}

}  // namespace dedflow

extern "C" int dedflow_dem_contact(const void* px, const void* py, const void* pz,
                                   const void* vx, const void* vy, const void* vz,
                                   const void* rad, const void* msk, const void* pid,
                                   void* fx, void* fy, void* fz, int K, int NC, int ny,
                                   int nz, double k_n, double gamma_n, double mu,
                                   double gamma_t, double eps, int tangential,
                                   void* stream) {
  using namespace dedflow;
  if (K < 1 || NC < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ContactArgs a{static_cast<float>(k_n), static_cast<float>(gamma_n),
                      static_cast<float>(mu), static_cast<float>(gamma_t),
                      static_cast<float>(eps), tangential};
  const Fields fl{static_cast<const float*>(px), static_cast<const float*>(py),
                  static_cast<const float*>(pz), static_cast<const float*>(vx),
                  static_cast<const float*>(vy), static_cast<const float*>(vz),
                  static_cast<const float*>(rad), static_cast<const float*>(msk),
                  static_cast<const int*>(pid)};
  float* ox = static_cast<float*>(fx);
  float* oy = static_cast<float*>(fy);
  float* oz = static_cast<float*>(fz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the capacities of the repository's grids unrolled: the coupled
  // scenario's 8, bench.py's DEM cases (7, 9) and the small grids' 2-12
  switch (K) {
    case 2: launch<2>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 3: launch<3>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 4: launch<4>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 5: launch<5>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 6: launch<6>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 7: launch<7>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 8: launch<8>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 9: launch<9>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 10: launch<10>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 11: launch<11>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    case 12: launch<12>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
    default: launch<0>(fl, ox, oy, oz, K, NC, ny, nz, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
