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
// Design: one thread per centre slot (k, c), c fastest, so a warp reads 32
// consecutive cells of one neighbour row (coalesced); the 27 x K reuse of
// each neighbour field is left to L1/L2. The pairs are taken in the plain
// version's order (offsets in _offsets order, then slots kp = 0..K-1; per
// pair the normal term, then the tangential term), with the arithmetic
// written as IEEE round-to-nearest intrinsics (no FMA contraction, IEEE
// sqrt and division), so each pair's terms are the plain version's.
// A pair with act = 0 (empty centre or neighbour, itself, or not touching)
// adds +-0 there and is skipped here: the sums are unchanged. A centre slot
// with mask 0 therefore writes zeros at once.
// What bounds it on an H100: the fields' bytes (9 read + 3 written, 48*K*NC
// bytes) for the empty slots, which are most of the grid in a dilute
// cloud; the 27*K neighbour reads per live slot (L1/L2 traffic and
// latency, one thread walking them in order) for the occupied ones.

#include <cuda_runtime.h>

namespace dedflow {

struct ContactArgs {
  float k_n, gamma_n, mu, gamma_t, eps;
  int tangential;  // mu > 0 and gamma_t > 0
};

__global__ void __launch_bounds__(256)
dem_contact_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ vx,
                   const float* __restrict__ vy, const float* __restrict__ vz,
                   const float* __restrict__ rad, const float* __restrict__ msk,
                   const int* __restrict__ pid, float* __restrict__ fx,
                   float* __restrict__ fy, float* __restrict__ fz, int K, int NC,
                   int ny, int nz, ContactArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K * NC) return;
  const float m = msk[idx];
  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  if (m != 0.f) {
    const int c = idx % NC;
    const float x0 = px[idx], x1 = py[idx], x2 = pz[idx];
    const float u0 = vx[idx], u1 = vy[idx], u2 = vz[idx];
    const float r = rad[idx];
    const int id = pid[idx];
    for (int dx = -1; dx <= 1; ++dx) {
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dz = -1; dz <= 1; ++dz) {
          const int cn = c + (dx * ny + dy) * nz + dz;
          if (cn < 0 || cn >= NC) continue;  // zero padding: mask 0
          for (int kp = 0; kp < K; ++kp) {
            const int j = kp * NC + cn;
            const float mn = msk[j];
            if (mn == 0.f || pid[j] == id) continue;
            const float d0 = __fsub_rn(x0, px[j]);
            const float d1 = __fsub_rn(x1, py[j]);
            const float d2 = __fsub_rn(x2, pz[j]);
            const float dist2 =
                __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
            const float dist = __fsqrt_rn(fmaxf(dist2, a.eps));
            const float delta = __fsub_rn(__fadd_rn(r, rad[j]), dist);
            if (!(delta > 0.f)) continue;
            const float act = __fmul_rn(m, mn);
            const float w0 = __fsub_rn(u0, vx[j]);
            const float w1 = __fsub_rn(u1, vy[j]);
            const float w2 = __fsub_rn(u2, vz[j]);
            const float n0 = __fdiv_rn(d0, dist);
            const float n1 = __fdiv_rn(d1, dist);
            const float n2 = __fdiv_rn(d2, dist);
            const float vn =
                __fadd_rn(__fadd_rn(__fmul_rn(w0, n0), __fmul_rn(w1, n1)), __fmul_rn(w2, n2));
            const float fn = __fsub_rn(__fmul_rn(a.k_n, delta), __fmul_rn(a.gamma_n, vn));
            const float w = __fmul_rn(act, fn);
            f0 = __fadd_rn(f0, __fmul_rn(w, n0));
            f1 = __fadd_rn(f1, __fmul_rn(w, n1));
            f2 = __fadd_rn(f2, __fmul_rn(w, n2));
            if (a.tangential) {
              const float t0 = __fsub_rn(w0, __fmul_rn(vn, n0));
              const float t1 = __fsub_rn(w1, __fmul_rn(vn, n1));
              const float t2 = __fsub_rn(w2, __fmul_rn(vn, n2));
              const float t2sum =
                  __fadd_rn(__fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1)), __fmul_rn(t2, t2));
              const float tn = __fsqrt_rn(fmaxf(t2sum, a.eps));
              const float ft =
                  __fmul_rn(act, fminf(__fmul_rn(a.mu, fabsf(fn)), __fmul_rn(a.gamma_t, tn)));
              const float s = __fdiv_rn(ft, tn);
              f0 = __fsub_rn(f0, __fmul_rn(s, t0));
              f1 = __fsub_rn(f1, __fmul_rn(s, t1));
              f2 = __fsub_rn(f2, __fmul_rn(s, t2));
            }
          }
        }
      }
    }
  }
  fx[idx] = f0;
  fy[idx] = f1;
  fz[idx] = f2;
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
  const int total = K * NC;
  dem_contact_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(pz), static_cast<const float*>(vx),
      static_cast<const float*>(vy), static_cast<const float*>(vz),
      static_cast<const float*>(rad), static_cast<const float*>(msk),
      static_cast<const int*>(pid), static_cast<float*>(fx), static_cast<float*>(fy),
      static_cast<float*>(fz), K, NC, ny, nz, a);
  return static_cast<int>(cudaGetLastError());
}
