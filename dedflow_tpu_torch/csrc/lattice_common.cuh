// Shared tables and constants of the lattice kernels (lattice_residual.cu,
// lattice_jacobian.cu, lattice_classes.cu). Built by
// dedflow_tpu_torch/utils/nvcc.py.
//
// Lattice layout (dedflow_tpu_torch/fem/lattice.py): node id
// n = ix + Sy*iy + Sz*iz, cell id = the id of its lowest corner, and the
// six Kuhn tets of a cell are "slabs" t = 0..5. Vertex a of tet t of cell c
// is node c + delta[t][a]. Cells on the far faces (ix == nx, ...) are dead:
// their geometry is zero, so every contribution they make is exactly 0.
// Node states are component-major (k, n) float32 rows; element buffers are
// (6, rows, n) with the cell on the last (contiguous) axis.
#pragma once

#include <cuda_runtime.h>

namespace dedflow {

constexpr int kSlabs = 6;
constexpr int kMaxSlabs = 8;  // slabs of a run-time table (K1c, K2c)

// 4-point tet rule and its shape values (fem/quadrature.py):
// SHL[q][a] = A if q == a else B, GW[q] = 1/24.
constexpr double kQuadA = 0.5854101966249685;
constexpr double kQuadB = 0.1381966011250105;
constexpr double kGw = 0.0416666666666667;

__host__ __device__ constexpr double shl(int q, int a) {
  return q == a ? kQuadA : kQuadB;
}
// sum_q GW[q] SHL[q][a] SHL[q][b]
__host__ __device__ constexpr double mass(int a, int b) {
  return kGw * (shl(0, a) * shl(0, b) + shl(1, a) * shl(1, b) +
                shl(2, a) * shl(2, b) + shl(3, a) * shl(3, b));
}
// sum_q GW[q] SHL[q][a]
__host__ __device__ constexpr double gwshl(int a) {
  return kGw * (shl(0, a) + shl(1, a) + shl(2, a) + shl(3, a));
}
constexpr double kGwSum = 4.0 * kGw;

// Corner o (bits x, y, z) of the unit cell that is vertex a of Kuhn tet t
// (mesh/gen.py::_KUHN_TETS: 0137, 0327, 0267, 0647, 0457, 0517), one octal
// digit a vertex, a = 0 lowest.
__host__ __device__ constexpr int kuhn(int t, int a) {
  return ((t == 0   ? 07310
           : t == 1 ? 07230
           : t == 2 ? 07620
           : t == 3 ? 07460
           : t == 4 ? 07540
                    : 07150) >> (3 * a)) & 7;
}

// Vertex offsets of the six Kuhn tets, passed by value.
struct Deltas {
  int d[kSlabs][4];
};

// Vertex offsets of slab t (t is uniform across a block).
__device__ __forceinline__ void slab_deltas(const Deltas& dl, int t, int dv[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int v = 0;
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) v = (s == t) ? dl.d[s][a] : v;
    dv[a] = v;
  }
}

}  // namespace dedflow
