// K2: lattice Jacobian straight into component-major DIA planes, with the
// Dirichlet masking epilogue.
//
// Replaces the TPU kernel dedflow_tpu/fem/lattice.py::_lhs_fused_body (run
// as _lhs_fused_kernel_masked, driver _lhs_call / jacobian_fused; body
// pallas_kernels._lhs_rows with ncomp=16). That kernel accumulates the
// planes in VMEM and carries a dmax-wide strip from one sequential grid
// step to the next. Its unmasked mode (K2') is the same kernel with
// keep = 1, add = 0 and no band.
//
// The implicit mode (melt-pool runs) computes the matrix the JAX package
// builds on this tier from the 33-row K6 kernel and a 96-slice XLA reduce
// (lattice.py:676-730): the element body's consistent phi/T tangents in
// components 16/17, reduced into the phi-phi / T-T rows of every plane
// (scal) beside the 16 velocity/pressure rows (data), masked the same way.
//
// The function: value[p, k, r] = keep[k, r] * (sum of the element entries
// (t, a, b) of plane p, cell r - delta[t][a] >= 0) + (p == d0) * add[k, r]
// + band[p, k, r - lo] (k < 16, r in [lo, lo + span)), stored in
// data[p, k, r] (k < 16) and scal[2p + k - 16, r] (k = 16, 17).
//
// Design: one fused pass, no element buffer in device memory. GPU blocks
// run in no order, so nothing is carried from block to block; each block
// recomputes the cells it shares with its neighbours instead.
// - A block owns an 8 x 8 tile of nodes in (x, y), a chunk of node layers
//   in z and a group of components (4 of the 16 frozen ones, 6 of the 18
//   implicit ones; the diagonal uu components, which share one q-sum,
//   form one group with pp, and with phi-phi / T-T in the implicit mode).
// - It slides up its chunk one cell layer L at a time. Node (x, y, z)
//   receives from the cells (x - cx, y - cy, z - cz) of the corners
//   (cx, cy, cz) in {0, 1}^3, so layer L feeds node layers L and L + 1,
//   and the tile needs the 9 x 9 cells of its one-cell halo on the low
//   side in x and y: the cells are recomputed 81/64 times, and the layer
//   below the chunk once more. The halo cells take their flat index
//   x + Sy*y + Sz*z as it is (x = -1 wraps to the previous row, as the
//   plain version's r - delta does), and an index outside [0, N) gives
//   zero, as it does there.
// - Per cell layer, in rounds of slabs (frozen: two of three, implicit:
//   one of six): each thread evaluates (cell, slab) elements with the
//   Jacobian body of element_body.cuh, only the block's components
//   (lhs_body_to with the stage layout), into shared memory (slabs x 16
//   pairs x group x 81 floats: 62 KB frozen, 186 KB implicit). Then each
//   thread, owning one (node, component), adds the 16 (t, a, b) entries
//   of each of those slabs into 15 plane accumulators for node layer L
//   and 15 for L + 1, in registers, in a fixed order (the planes indexed
//   at compile time from the Kuhn table).
// - When layer L is complete, the thread applies the epilogue and stores
//   its 15 planes once. No atomics: each plane value is a fixed-order sum,
//   so the float32 matrix, and GMRES's iteration count, repeat from run to
//   run.
// What bounds it on an H100: the bytes of the geometry, the velocity and
// the 15 x 16 planes (264.5 MB at box 55 frozen: 0.079 ms at 3.35 TB/s)
// against the element body's FP32 issue: 6N elements of ~2,900 flops
// frozen (3.0 Gop, 0.045 ms at 67 TFLOP/s), recomputed here 1.19-1.27x
// for the halo and with its prologue once per component group, at 12-16
// warps an SM (128 / 168 registers). The earlier two-pass design wrote
// and read a (6, 16 x kComp, N) element buffer besides (2.16 GB at box 55
// frozen), which took most of its time (PERF.md §7 has the split).
// Dead cells (zero geometry) give exact zeros: the tr > 0 guard keeps the
// tau divisions finite.
//
// K2c (fem/lattice.py::jacobian_volume_classes) is the same kernel over a
// run-time table (the GridPlanes policy below; K2 is KuhnPlanes): any
// table of T <= 8 slabs that fem/lattice.py::grid_tables places on the
// node grid, the translation-class tier and recovered lattices whose cells
// carry another split. Slab t's element on cell c is column c + shift[t]
// of the context's geometry, its vertex a node column + delta[t][a]; the
// halo keeps the wrapped flat index and a column outside [0, N) gives
// zero, so every node receives what the plain version adds, column
// r - delta[t][a]. Its entries' planes and corners come at run time, so
// the plane sums live in shared memory beside the stage (a plane index
// known only at run time would put register accumulators in local
// memory); the loops over a round's entries stay compile-time, reading the
// table from the kernel's parameters (rounds of 3 slabs frozen, two blocks
// an SM; 4 implicit, one block). The vertex order of the file stays
// (the body's advection speed sums vertices 1..3): no slab is permuted
// onto the Kuhn table. It takes the place of K2c's two passes
// (lattice_classes.cu, now only for tables that do not place), whose
// element buffer (1.08 GB at box 55 frozen) was most of their time.

#include "element_body.cuh"

namespace dedflow {

constexpr int kTileX = 8, kTileY = 8, kTileNodes = kTileX * kTileY;
constexpr int kHaloX = kTileX + 1, kHalo = (kTileX + 1) * (kTileY + 1);
constexpr int kPlanes = 15;

// The 15 planes by corner difference (dx, dy, dz) = corner b - corner a,
// code (dx+1)*9 + (dy+1)*3 + (dz+1): bit `code` of kPlaneCodes is set for
// each plane the six tets touch, and a plane's index is the number of set
// bits below it (fem/lattice.py::FUSED_PLANE_CODES, the same list).
constexpr unsigned kPlaneCodes = 0x6c3761bu;
constexpr int kZeroPlane = 7;  // code 13, (0, 0, 0)

__device__ __forceinline__ int plane_of(int t, int a, int b) {
  const int ca = kuhn(t, a), cb = kuhn(t, b);
  const int code = ((cb & 1) - (ca & 1) + 1) * 9 + (((cb >> 1) & 1) - ((ca >> 1) & 1) + 1) * 3 +
                   ((cb >> 2) - (ca >> 2) + 1);
  return __popc(kPlaneCodes & ((1u << code) - 1u));
}

// Component groups (fem/lattice.py::FUSED_GROUPS, the same table): bit k
// of mask(g) is set for each component k of group g, which a block stages
// in ascending order.
template <bool kImplicit>
struct Groups {
  static constexpr int kCount = kImplicit ? 3 : 4;  // groups
  static constexpr int kSize = kImplicit ? 6 : 4;   // components a group
  // slabs a round and rounds a cell layer: frozen, two rounds of three
  // (62 KB of stage, two blocks an SM); implicit, one round of six (186 KB,
  // one block of 384 threads an SM, whose 486 elements fill it better)
  static constexpr int kRoundSlabs = kImplicit ? 6 : 3;
  static constexpr int kRounds = kSlabs / kRoundSlabs;
  // dynamic shared memory a block: a round's slabs x 16 pairs x kSize x kHalo
  static constexpr int kStageBytes =
      kRoundSlabs * 16 * kSize * kHalo * static_cast<int>(sizeof(float));
  __host__ __device__ static constexpr unsigned mask(int g) {
    return kImplicit ? (g == 0 ? 0x38111u : g == 1 ? 0xeeu : 0x7e00u)  // {0,4,8,15,16,17} ...
                     : (g == 0 ? 0x8111u : g == 1 ? 0x2eu : g == 2 ? 0x6c0u : 0x7800u);
  }
  // the component in slot i of group g
  __device__ static int comp(int g, int i) {
    unsigned m = mask(g);
    for (; i > 0; --i) m &= m - 1;
    return __ffs(m) - 1;
  }
};

// lhs_body_to's layout for the stage: the components of group kGroup of
// one element at s[(ab * kSize + slot) * kHalo] (the element's halo cell is
// the last, fastest index, so consecutive cells are consecutive banks).
template <bool kImplicit, int kGroup>
struct Stage {
  static constexpr unsigned kMask = Groups<kImplicit>::mask(kGroup);
  __device__ static constexpr bool wants(int k) { return (kMask >> k) & 1u; }
  __device__ static constexpr int pair(int ab, size_t) {
    return ab * Groups<kImplicit>::kSize * kHalo;
  }
  static __device__ __forceinline__ int comp(int k, size_t) {
    return __popc(kMask & ((1u << k) - 1u)) * kHalo;
  }
};

struct FusedArgs {
  const float* geom;   // (6, 15, n)
  const float* mgeom;  // (6, 19, n) residual geometry, implicit mode
  const float* wa;     // (>=3, n) velocity rows
  const float* keep;   // (kComp, n)
  const float* add;    // (kComp, n)
  const float* band;   // (D, 16, span) or null
  float* out;          // (D, 16, n)
  float* scal;         // (2D, n), implicit mode
  int band_lo, band_span;
  int n, sy, sz, ny, nz;  // nodes; row and layer strides; node rows a layer, node layers
  int tiles_x, tiles_y, zchunk;
  int plane[kPlanes];  // DIA plane of each of the 15 planes
  Deltas dl;
};

template <bool kImplicit, int kGroup>
__device__ __forceinline__ void produce_element(const FusedArgs& f, const RowsLhsParams& prm,
                                                int t, int c, const int dv[4], float* s) {
  const size_t N = static_cast<size_t>(f.n);
  LhsInputs x;
  const float* g = f.geom + static_cast<size_t>(t) * 15 * N + c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 4; ++a) x.sh[i][a] = g[(i * 4 + a) * N];
  x.det = g[12 * N];
  x.gg = g[13 * N];
  x.tr = g[14 * N];
  if constexpr (kImplicit) {
    const float* mg = f.mgeom + static_cast<size_t>(t) * 19 * N + c;
    x.m00 = mg[13 * N];
    x.m01 = mg[14 * N];
    x.m02 = mg[15 * N];
    x.m11 = mg[16 * N];
    x.m12 = mg[17 * N];
    x.m22 = mg[18 * N];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int v = c + dv[a];
#pragma unroll
    for (int i = 0; i < 3; ++i) x.u[i][a] = v < f.n ? f.wa[i * N + v] : 0.f;
  }
  lhs_body_to<kImplicit, kImplicit ? 18 : 16, Stage<kImplicit, kGroup>>(x, prm, s, 0);
}

// Round h of cell layer L: the elements of the round's slabs on the 81 halo
// cells into the stage. The table policy names the round's slabs and each
// slab's vertex offsets and column shift: the element of slab t on cell c
// is column c + shift (geometry), its vertex a node column + delta[t][a].
template <bool kImplicit, class Tab>
__device__ __forceinline__ void produce_round(const FusedArgs& f, const Tab& tab,
                                              const RowsLhsParams& prm, float* stage, int g,
                                              int x0, int y0, int L, int h) {
  using G = Groups<kImplicit>;
  constexpr int kThreads = kTileNodes * G::kSize;
  for (int e = threadIdx.x; e < tab.round_slabs(h) * kHalo; e += kThreads) {
    const int ts = e / kHalo, hc = e - ts * kHalo;
    const int cx = x0 - 1 + hc % kHaloX, cy = y0 - 1 + hc / kHaloX;
    const int t = tab.first_slab(h) + ts;
    int dv[4], shift;
    tab.slab(f, t, dv, shift);
    const int c = cx + f.sy * cy + f.sz * L + shift;
    float* s = stage + ts * 16 * G::kSize * kHalo + hc;
    // cells past the row or layer end feed no node of the tile
    if (cx < f.sy && cy < f.ny && c >= 0 && c < f.n) {
      switch (g) {
        case 0: produce_element<kImplicit, 0>(f, prm, t, c, dv, s); break;
        case 1: produce_element<kImplicit, 1>(f, prm, t, c, dv, s); break;
        case 2: produce_element<kImplicit, 2>(f, prm, t, c, dv, s); break;
        default:
          if constexpr (G::kCount > 3) produce_element<kImplicit, 3>(f, prm, t, c, dv, s);
          break;
      }
    } else {
      for (int i = 0; i < 16 * G::kSize; ++i) s[i * kHalo] = 0.f;
    }
  }
}

// The 48 (t, a, b) entries of round kH for this thread's (node, slot):
// corner a's z bit picks node layer L (cur) or L + 1 (nxt).
template <bool kImplicit, int kH>
__device__ __forceinline__ void consume_round(const float* stage, int slot, int lx, int ly,
                                              float cur[kPlanes], float nxt[kPlanes]) {
  using G = Groups<kImplicit>;
  constexpr int kG = G::kSize;
#pragma unroll
  for (int ts = 0; ts < G::kRoundSlabs; ++ts) {
    const int t = kH * G::kRoundSlabs + ts;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int ca = kuhn(t, a);
      const float* s = stage + ((ts * 16 + a * 4) * kG + slot) * kHalo +
                       (ly + 1 - ((ca >> 1) & 1)) * kHaloX + (lx + 1 - (ca & 1));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v = s[b * kG * kHalo];
        const int p = plane_of(t, a, b);
        if (ca >> 2)
          nxt[p] += v;
        else
          cur[p] += v;
      }
    }
  }
}

// Stores node layer L's value v of DIA plane dp for component k of node r,
// the facet band added (velocity/pressure rows).
__device__ __forceinline__ void store_plane(const FusedArgs& f, int k, int r, bool in_band,
                                            int dp, float v) {
  const size_t N = static_cast<size_t>(f.n);
  if (in_band) v += f.band[(static_cast<size_t>(dp) * 16 + k) * f.band_span + (r - f.band_lo)];
  if (k < 16)
    f.out[(static_cast<size_t>(dp) * 16 + k) * N + r] = v;
  else
    f.scal[(static_cast<size_t>(2 * dp) + (k - 16)) * N + r] = v;
}

// Table policies of the fused pass: which slabs a round stages, each slab's
// vertex offsets and column shift, and where the (t, a, b) entries of a
// round go until their node layer is complete.
//
// KuhnPlanes (K2): the six Kuhn slabs at compile time, in G::kRounds
// rounds, the 15 planes of kPlaneCodes summed in registers (cur: node layer
// L, nxt: L + 1).
struct KuhnArgs {};

template <bool kImplicit>
struct KuhnPlanes {
  using Args = KuhnArgs;
  using G = Groups<kImplicit>;
  static_assert(G::kRounds <= 2 && G::kRounds * G::kRoundSlabs == kSlabs, "one or two rounds");
  static constexpr int kStageBytes = G::kStageBytes;
  float cur[kPlanes], nxt[kPlanes];

  __device__ __forceinline__ KuhnPlanes(const KuhnArgs&, float*) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) cur[p] = nxt[p] = 0.f;
  }
  __device__ static constexpr int rounds() { return G::kRounds; }
  __device__ static constexpr int round_slabs(int) { return G::kRoundSlabs; }
  __device__ static constexpr int first_slab(int h) { return h * G::kRoundSlabs; }
  __device__ __forceinline__ static void slab(const FusedArgs& f, int t, int dv[4], int& shift) {
    slab_deltas(f.dl, t, dv);
    shift = 0;
  }
  __device__ __forceinline__ void consume(int h, const float* stage, int slot, int lx, int ly,
                                          int) {
    if (h == 0)
      consume_round<kImplicit, 0>(stage, slot, lx, ly, cur, nxt);
    else if constexpr (G::kRounds > 1)
      consume_round<kImplicit, 1>(stage, slot, lx, ly, cur, nxt);
  }
  __device__ __forceinline__ void store(const FusedArgs& f, int k, int r, float kp, float ad,
                                        bool in_band, int) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      float v = cur[p] * kp;
      if (p == kZeroPlane) v += ad;
      store_plane(f, k, r, in_band, f.plane[p], v);
    }
  }
  __device__ __forceinline__ void advance(int, bool) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      cur[p] = nxt[p];
      nxt[p] = 0.f;
    }
  }
};

// GridPlanes (K2c): any table of T <= 8 slabs placed on the node grid
// (fem/lattice.py::grid_tables), given at run time. A plane index known
// only at run time cannot index a register array, so the plane sums live
// in shared memory, (2, D, threads) floats after the stage: node layer L's
// in half L & 1, each thread its own column (no bank conflicts, no
// syncs). The zero-offset plane takes exactly the diagonal entries
// (a == b, known at compile time), so its two sums stay in registers.
// The consume loops over a round's (slab, a, b) entries at compile time,
// as K2's does; what the table gives at run time (corner a's halo shift
// and z bit, the entry's plane) comes from the kernel's parameters at
// compile-time indices, so it reads the constant bank, not memory. The
// three off-diagonal entries of a (t, a) go to three distinct planes, so
// their sums are read, added and written back together (one shared-memory
// latency a (t, a), not three). Each plane value is a fixed-order sum
// ((t, a) order), so it repeats from run to run. Rounds of kRoundSlabs
// slabs (frozen 3: two blocks an SM as K2; implicit 4: one block, two
// element passes a layer for 6 slabs as for 8). The slabs' vertex offsets
// and shifts, which the element pass reads at a slab index that differs
// across a warp, are copied to shared memory once a block.
struct GridArgs {
  int nt, planes, d0;
  int delta[kMaxSlabs][4];   // vertex offsets from the column
  int shift[kMaxSlabs];      // column = cell + shift
  int corner[kMaxSlabs][4];  // halo shift (1 - cy) * kHaloX + (1 - cx) | cz << 8
  int sum[kMaxSlabs][16];    // entry (a, b)'s plane x threads: its plane sum's offset
};

template <bool kImplicit>
struct GridPlanes {
  using Args = GridArgs;
  using G = Groups<kImplicit>;
  static constexpr int kThreads = kTileNodes * G::kSize;
  static constexpr int kRoundSlabs = kImplicit ? 4 : 3;
  static constexpr int kMaxRounds = (kMaxSlabs + kRoundSlabs - 1) / kRoundSlabs;
  static constexpr int kStageFloats = kRoundSlabs * 16 * G::kSize * kHalo;
  const GridArgs& a;
  float* sums;      // this thread's column of the (2, D, threads) sums
  int* slabs;       // (kMaxSlabs, 5): delta[t][0..3], shift[t]
  float d0cur, d0nxt;  // the zero-offset plane's sums of node layers L, L + 1

  __device__ __forceinline__ GridPlanes(const GridArgs& args, float* smem) : a(args) {
    sums = smem + kStageFloats + threadIdx.x;
    slabs = reinterpret_cast<int*>(smem + kStageFloats + 2 * a.planes * kThreads);
    for (int p = 0; p < 2 * a.planes; ++p) sums[p * kThreads] = 0.f;
    d0cur = d0nxt = 0.f;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int t = 0; t < kMaxSlabs; ++t) {
#pragma unroll
        for (int j = 0; j < 4; ++j) slabs[t * 5 + j] = a.delta[t][j];
        slabs[t * 5 + 4] = a.shift[t];
      }
    }
    __syncthreads();
  }
  __device__ __forceinline__ int rounds() const {
    return (a.nt + kRoundSlabs - 1) / kRoundSlabs;
  }
  __device__ __forceinline__ int round_slabs(int h) const {
    return min(kRoundSlabs, a.nt - h * kRoundSlabs);
  }
  __device__ static constexpr int first_slab(int h) { return h * kRoundSlabs; }
  __device__ __forceinline__ void slab(const FusedArgs&, int t, int dv[4], int& shift) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) dv[j] = slabs[t * 5 + j];
    shift = slabs[t * 5 + 4];
  }
  template <int kH>
  __device__ __forceinline__ void consume_round(const float* stage, int slot, int lx, int ly,
                                                int L) {
    constexpr int kG = G::kSize;
    float* cur = sums + (L & 1) * a.planes * kThreads;  // node layer L's sums
    float* nxt = sums + ((L + 1) & 1) * a.planes * kThreads;
    const float* st = stage + slot * kHalo + ly * kHaloX + lx;
#pragma unroll
    for (int ts = 0; ts < kRoundSlabs; ++ts) {
      const int t = kH * kRoundSlabs + ts;
      const int tc = t < kMaxSlabs ? t : kMaxSlabs - 1;  // an index in range where t is not
      if (t < a.nt) {
#pragma unroll
        for (int va = 0; va < 4; ++va) {
          const int c = a.corner[tc][va];
          const bool up = (c >> 8) != 0;  // corner a's z bit: node layer L + 1
          const float* s = st + (ts * 16 + va * 4) * kG * kHalo + (c & 0xff);
          float* d = up ? nxt : cur;
          float v[4], w[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) v[b] = s[b * kG * kHalo];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b != va) w[b] = d[a.sum[tc][va * 4 + b]];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (b != va) d[a.sum[tc][va * 4 + b]] = w[b] + v[b];
          d0cur += up ? 0.f : v[va];
          d0nxt += up ? v[va] : 0.f;
        }
      }
    }
  }
  __device__ __forceinline__ void consume(int h, const float* stage, int slot, int lx, int ly,
                                          int L) {
    switch (h) {
      case 0: consume_round<0>(stage, slot, lx, ly, L); break;
      case 1: consume_round<1>(stage, slot, lx, ly, L); break;
      default:
        if constexpr (kMaxRounds > 2) consume_round<2>(stage, slot, lx, ly, L);
        break;
    }
  }
  // stores node layer L's planes, zeroing their sums for layer L + 2
  __device__ __forceinline__ void store(const FusedArgs& f, int k, int r, float kp, float ad,
                                        bool in_band, int L) {
    float* c = sums + (L & 1) * a.planes * kThreads;
    for (int p = 0; p < a.planes; ++p) {
      float v = (p == a.d0 ? d0cur : c[p * kThreads]) * kp;
      c[p * kThreads] = 0.f;
      if (p == a.d0) v += ad;
      store_plane(f, k, r, in_band, p, v);
    }
  }
  // layer L's half serves layer L + 2: zeroed here where store did not
  __device__ __forceinline__ void advance(int L, bool stored) {
    if (!stored) {
      float* c = sums + (L & 1) * a.planes * kThreads;
      for (int p = 0; p < a.planes; ++p) c[p * kThreads] = 0.f;
    }
    d0cur = d0nxt;
    d0nxt = 0.f;
  }
};

template <bool kImplicit, class Tab>
__global__ void __launch_bounds__(kTileNodes * Groups<kImplicit>::kSize, kImplicit ? 1 : 2)
jacobian_fused_kernel(FusedArgs f, typename Tab::Args targ, RowsLhsParams prm) {
  using G = Groups<kImplicit>;
  extern __shared__ float stage[];  // round slabs x 16 x kSize x kHalo (, the policy's)
  int bid = blockIdx.x;
  const int g = bid % G::kCount;  // the groups of a tile are neighbours in launch order
  bid /= G::kCount;
  const int x0 = (bid % f.tiles_x) * kTileX;
  bid /= f.tiles_x;
  const int y0 = (bid % f.tiles_y) * kTileY;
  const int z0 = (bid / f.tiles_y) * f.zchunk;
  const int z1 = min(z0 + f.zchunk, f.nz);

  const int slot = threadIdx.x / kTileNodes;
  const int lx = threadIdx.x % kTileX, ly = (threadIdx.x % kTileNodes) / kTileX;
  const int k = G::comp(g, slot);
  const int x = x0 + lx, y = y0 + ly;
  const bool own = x < f.sy && y < f.ny;
  const size_t N = static_cast<size_t>(f.n);

  Tab tab(targ, stage);
  for (int L = z0 - 1; L < z1; ++L) {
#pragma unroll 1
    for (int h = 0; h < tab.rounds(); ++h) {
      produce_round<kImplicit>(f, tab, prm, stage, g, x0, y0, L, h);
      __syncthreads();
      tab.consume(h, stage, slot, lx, ly, L);
      __syncthreads();
    }
    const bool complete = L >= z0 && own;  // this thread's node of layer L is complete
    if (complete) {
      const int r = x + f.sy * y + f.sz * L;
      const float kp = f.keep[k * N + r];
      const float ad = f.add[k * N + r];
      const bool in_band =
          k < 16 && f.band != nullptr && r >= f.band_lo && r < f.band_lo + f.band_span;
      tab.store(f, k, r, kp, ad, in_band, L);
    }
    tab.advance(L, complete);
  }
}

template <bool kImplicit, class Tab>
int launch(const FusedArgs& f, const typename Tab::Args& targ, int smem, const RowsLhsParams& prm,
           cudaStream_t s) {
  using G = Groups<kImplicit>;
  cudaError_t err = cudaFuncSetAttribute(jacobian_fused_kernel<kImplicit, Tab>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (f.nz + f.zchunk - 1) / f.zchunk;
  const int blocks = G::kCount * f.tiles_x * f.tiles_y * chunks;
  jacobian_fused_kernel<kImplicit, Tab><<<blocks, kTileNodes * G::kSize, smem, s>>>(f, targ, prm);
  return static_cast<int>(cudaGetLastError());
}

// The arguments both entries share; false if the lattice's sizes are not
// a lattice's.
bool fused_args(FusedArgs* f, const void* geom, const void* mgeom, const void* wa,
                const void* keep, const void* add, const void* band, int band_lo, int band_span,
                void* out, void* scal, int n, int sy, int ny, int nz, int zchunk) {
  if (n <= 0 || sy < 1 || ny < 1 || nz < 1 || sy * ny * nz != n || zchunk < 1 ||
      (mgeom != nullptr && scal == nullptr))
    return false;
  f->geom = static_cast<const float*>(geom);
  f->mgeom = static_cast<const float*>(mgeom);
  f->wa = static_cast<const float*>(wa);
  f->keep = static_cast<const float*>(keep);
  f->add = static_cast<const float*>(add);
  f->band = static_cast<const float*>(band);
  f->out = static_cast<float*>(out);
  f->scal = static_cast<float*>(scal);
  f->band_lo = band_lo;
  f->band_span = band_span;
  f->n = n;
  f->sy = sy;
  f->sz = sy * ny;
  f->ny = ny;
  f->nz = nz;
  f->tiles_x = (sy + kTileX - 1) / kTileX;
  f->tiles_y = (ny + kTileY - 1) / kTileY;
  f->zchunk = zchunk;
  return true;
}

template <bool kImplicit>
void layout(int* o) {
  using G = Groups<kImplicit>;
  o[0] = kTileX;
  o[1] = kTileY;
  o[2] = G::kRoundSlabs;
  o[3] = G::kCount;
  o[4] = G::kSize;
  o[5] = G::kStageBytes;
  o[6] = static_cast<int>(kPlaneCodes);
  for (int g = 0; g < G::kCount; ++g) o[7 + g] = static_cast<int>(G::mask(g));
}

}  // namespace dedflow

// The tiling this build was compiled with, for the wrapper to check
// against fem/lattice.py's FUSED_* tables (one description, read from
// here): out[0..6] = tile x, tile y, slabs a round, groups, components a
// group, dynamic shared memory bytes, kPlaneCodes; out[7..] the groups'
// component masks. cap: ints in out (at least 11).
extern "C" int dedflow_lattice_jacobian_layout(int implicit, int* out, int cap) {
  if (out == nullptr || cap < 11) return static_cast<int>(cudaErrorInvalidValue);
  if (implicit)
    dedflow::layout<true>(out);
  else
    dedflow::layout<false>(out);
  return 0;
}

// The lattice is (sy, ny, nz) nodes, x fastest: sy nodes a row, ny rows a
// layer, nz layers, sz = sy * ny. deltas: (6, 4) vertex offsets, which
// must be the Kuhn corners' (the wrapper checks). planes: the DIA plane of
// each of the 15 planes in kPlaneCodes order. mgeom (the (6, 19, n)
// residual geometry) not null selects the implicit mode: keep/add are then
// (18, n) and scal (2D, n) receives the phi-phi / T-T rows; otherwise
// keep/add are (16, n) and scal is not written. zchunk: node layers a
// block.
extern "C" int dedflow_lattice_jacobian(const void* geom, const void* mgeom, const void* wa,
                                        const void* keep, const void* add, const void* band,
                                        int band_lo, int band_span, void* out, void* scal, int n,
                                        int sy, int ny, int nz, int zchunk, const int* deltas,
                                        const int* planes, double rho, double mu, double f1,
                                        double f2, double dt, double cp, double kappa,
                                        void* stream) {
  using namespace dedflow;
  FusedArgs f;
  if (!fused_args(&f, geom, mgeom, wa, keep, add, band, band_lo, band_span, out, scal, n, sy, ny,
                  nz, zchunk))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < kPlanes; ++p) f.plane[p] = planes[p];
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) f.dl.d[t][a] = deltas[t * 4 + a];
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mgeom != nullptr
             ? launch<true, KuhnPlanes<true>>(f, KuhnArgs{}, KuhnPlanes<true>::kStageBytes, prm, s)
             : launch<false, KuhnPlanes<false>>(f, KuhnArgs{}, KuhnPlanes<false>::kStageBytes,
                                                prm, s);
}

// K2c in one pass: the same tiling over a table of nt <= 8 slabs placed on
// the lattice of (sy, ny, nz) nodes (fem/lattice.py::grid_tables): slab t's
// element at column c is the cell c - shifts[t], its vertex a node c +
// deltas[t][a], the cell's corner corners[t][a] (0..7, bits x, y, z;
// checked). plane_tab: (nt, 4, 4) DIA plane of entry (t, a, b) (D =
// num_planes, d0 the zero-offset plane); round_slabs: slabs a round of the
// stage, which must be this build's (3 frozen, 4 implicit; fem/lattice.py
// checks its GRID_ROUND_SLABS against it). The other arguments are K2's.
extern "C" int dedflow_lattice_jacobian_grid(
    const void* geom, const void* mgeom, const void* wa, const void* keep, const void* add,
    const void* band, int band_lo, int band_span, void* out, void* scal, int n, int sy, int ny,
    int nz, int zchunk, int nt, const int* deltas, const int* corners, const int* shifts,
    const int* plane_tab, int num_planes, int d0, int round_slabs, double rho, double mu,
    double f1, double f2, double dt, double cp, double kappa, void* stream) {
  using namespace dedflow;
  const bool implicit = mgeom != nullptr;
  const int rs = implicit ? GridPlanes<true>::kRoundSlabs : GridPlanes<false>::kRoundSlabs;
  const int threads = implicit ? GridPlanes<true>::kThreads : GridPlanes<false>::kThreads;
  FusedArgs f;
  if (!fused_args(&f, geom, mgeom, wa, keep, add, band, band_lo, band_span, out, scal, n, sy, ny,
                  nz, zchunk) ||
      nt < 1 || nt > kMaxSlabs || num_planes < 1 || num_planes > 27 || d0 < 0 ||
      d0 >= num_planes || round_slabs != rs)
    return static_cast<int>(cudaErrorInvalidValue);
  GridArgs g{};
  g.nt = nt;
  g.planes = num_planes;
  g.d0 = d0;
  for (int t = 0; t < nt; ++t) {
    g.shift[t] = shifts[t];
    if (shifts[t] < 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int a = 0; a < 4; ++a) {
      const int c = corners[t * 4 + a];
      if (c < 0 || c > 7 ||
          deltas[t * 4 + a] + shifts[t] != (c & 1) + sy * ((c >> 1) & 1) + f.sz * (c >> 2))
        return static_cast<int>(cudaErrorInvalidValue);
      g.delta[t][a] = deltas[t * 4 + a];
      g.corner[t][a] = (1 - ((c >> 1) & 1)) * kHaloX + (1 - (c & 1)) + ((c >> 2) << 8);
      for (int b = 0; b < 4; ++b) {
        const int p = plane_tab[(t * 4 + a) * 4 + b];
        // the diagonal entries, and only they, go to the zero-offset plane;
        // a vertex's four entries go to four planes
        bool repeated = false;
        for (int b2 = 0; b2 < b; ++b2) repeated |= plane_tab[(t * 4 + a) * 4 + b2] == p;
        if (p < 0 || p >= num_planes || (p == d0) != (a == b) || repeated)
          return static_cast<int>(cudaErrorInvalidValue);
        g.sum[t][a * 4 + b] = p * threads;
      }
    }
  }
  const int smem = (rs * 16 * (implicit ? Groups<true>::kSize : Groups<false>::kSize) * kHalo +
                    2 * num_planes * threads + kMaxSlabs * 5) *
                   static_cast<int>(sizeof(float));
  const RowsLhsParams prm{rho, mu, f1, f2, dt, cp, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return implicit ? launch<true, GridPlanes<true>>(f, g, smem, prm, s)
                  : launch<false, GridPlanes<false>>(f, g, smem, prm, s);
}
