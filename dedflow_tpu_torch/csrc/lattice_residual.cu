// K1: lattice volume residual (VMS Navier-Stokes + level set + temperature).
//
// Replaces the TPU kernel dedflow_tpu/fem/lattice.py::_res_t8_kernel (body
// pallas_kernels._res_rows_t8, driver _res_call / residual_fused), which
// DMAs haloed state windows into VMEM, evaluates the element residual of
// the six Kuhn slabs stacked on sublanes, and leaves the node reduction to
// 24 shifted adds in XLA. It computes the same function as
// pallas_kernels._res_rows on every (cell, slab) pair, then
//
//     out[k, n] = sum over t = 0..5, a = 0..3 (in that order, from 0.0f)
//                 of elem[t, a*6 + k, n - delta[t][a]], cells < 0 skipped,
//
// the order of fem/lattice.py::_reduce_residual (residual_volume_plain).
//
// Design: one launch, each element computed once, no element buffer in
// device memory. The lattice is cut into 8 x 8 node tiles in (x, y). Node
// (x, y, z) takes vertex a of slab t from the cell (x - cx, y - cy, z - cz)
// of corner (cx, cy, cz) = kuhn(t, a), so node layer z of a tile needs cell
// layers z and z - 1 of the tile and of its left, lower and lower-left
// neighbours. A work item (L, T) computes tile T's cells of cell layer L
// (none for L = nz) and sums tile T's node layer L - 1 (none for L = 0):
// what that sum needs was computed by items a layer or two back, long
// done, so an item seldom waits (summing node layer L in item (L, T) made
// it wait for its neighbours' items of the same layer, started at the same
// time).
// - A block takes the next item from a ticket counter (atomicAdd), items in
//   (layer, tile) order (persistent blocks that fetch their next ticket
//   while they sum took 3-4% longer). Its 128 threads evaluate the item's
//   384 (cell, slab) elements with the residual body of element_body.cuh
//   (the body K4 and K6 run), 3 a thread, and store their 24 values to a
//   ring of R cell layers in device memory (R x tiles x 24 x 6 x 64
//   floats, R the wrapper's: more layers than the items resident on the
//   card span, so that an item seldom waits for its slot), then flag the
//   item produced. It waits for the items of layers L - 1 and L - 2 of the
//   tile and its left, lower and lower-left neighbours to be flagged, sums
//   its 64 nodes' 24 contributions of node layer L - 1 in the plain order
//   from the ring (reads through the L2, `ld.global.cg`), then flags the
//   item consumed. Before it overwrites its ring slot it waits until the
//   eight items that read the layer the slot held (items L - R + 1 and
//   L - R + 2 of the tile and its right, upper and upper-right neighbours)
//   are consumed.
// - Every wait is on an item with a smaller ticket, which a block that
//   started earlier holds: the blocks waited on never wait on a later one,
//   so the launch always completes (the decoupled look-back argument of
//   single-pass scans). A wait that outlasts kResSpin polls (a quarter of
//   a second or more; a call takes well under a millisecond) can only be a
//   fault, such as a workspace that a call on another stream shares: the
//   block goes on and traps at its end, so the launch fails and the
//   caller's next synchronisation raises. A wait that cannot end never
//   gives sums of slots that were not produced, and never hangs. (The trap
//   waits for the block's end: a trap in the wait loop, or a wait bounded
//   by the card's global timer, made the kernel 4-6% slower.)
// - The counter and the flags persist in the lattice context's `res_sync`
//   workspace from call to call: a call takes exactly `items` tickets
//   (tiles x (nz + 1)), so ticket / items + 1 numbers the call (the epoch
//   every flag is compared with) and ticket % items is the item. Calls on
//   one context must run in order (one stream).
// - A node's sum starts at +0.0f and adds its 24 contributions in (t, a)
//   order. A contribution of a cell that the plain version skips (index
//   below 0) or that lies on a dead cell reached by the wrapped index
//   (x - 1 = -1 lands on the previous row's dead cell) is +0.0f here, +-0
//   there; a sum that starts at +0.0f is never -0.0f, and x + 0.0f == x,
//   so the float32 result equals the former two-pass kernel's bit for bit.
//   The atomics (the ticket, the flags) only schedule the items; the
//   arithmetic has none, so it repeats from run to run.
// - Cells of a tile past the row or layer end run the body on cell 0 and
//   store zeros by a select, not a branch around the body: the body stays
//   one basic block, so the compiler fuses its multiplies and adds as in
//   the element kernels.
// What bounds it on an H100: the element body's FP32 issue (6N elements of
// ~2,200 operations: 2.33 Gop at box 55, 0.035 ms at 67 TFLOP/s) against
// the bytes of the (6, 19, N) geometry and the states (92.7 MB at box 55,
// 0.028 ms): the body issues at about 45% at 12 warps an SM. This kernel
// takes 0.145 ms at box 55; the former two-pass design, which wrote and
// read back a (6, 24, N) element buffer (101.2 MB), 0.158; a one-pass
// design that recomputed each tile's halo cells instead (81/64 of the
// cells, and a layer more a z chunk) 0.177 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).
//
// The pressure travels in the rate slot: p comes from dw_alpha row 3. The
// heat source (melt-pool runs) is a nodal (N,) row or null (zero).
//
// K1c (fem/lattice.py::residual_volume_classes) is the same kernel over a
// run-time table (the GridCells policy below; K1 is KuhnCells): any table
// of T <= 8 slabs that fem/lattice.py::grid_tables places on the node grid
// (the translation-class tier, recovered lattices with another split).
// Slab t's element on cell c is column c + shift[t] of the context's
// geometry (a slab whose tet lacks corner 0 has its column at its smallest
// node), its vertex a the corner corners[t][a] of the cell; a ring slot
// holds T x 64 elements (T x 24 x 64 floats), computed ceil(T / 2) to a
// thread, and each node adds its 4T contributions in the plain (t, a)
// order. The cells left of, below and under the grid are zeros here, and
// grid_tables places a class table only where the columns they stand for
// hold no element, so the sums are the plain version's bit for bit, as
// K1's are (on the Kuhn table the two kernels agree bit for bit). It takes
// the place of K1c's two passes (lattice_classes.cu, now only for tables
// that do not place), which wrote and read a (T, 24, N) element buffer.

#include "element_body.cuh"

namespace dedflow {

constexpr int kResTile = 8, kResCells = kResTile * kResTile;  // nodes / cells of a tile
constexpr int kResThreads = 128, kResBlocksPerSM = 3;
constexpr int kResSlot = 4 * kSlabs * 6 * kResCells;     // floats of a tile's cell layer
constexpr int kResSpin = 1 << 22;                        // polls of a flag before a fault
static_assert(kSlabs * kResCells == 3 * kResThreads, "3 elements a thread");
static_assert(kResCells * 6 == 3 * kResThreads, "a node and 3 components a thread");

struct ResArgs {
  const float* geom;  // (6, 19, n)
  const float* wa;    // (6, n)
  const float* dwa;   // (6, n)
  const float* src;   // (n,) or null
  float* out;         // (6, n)
  float* ring;        // (ring_layers, tiles, 24, 6, 64)
  unsigned long long* counter;  // tickets taken so far, all calls
  int* produced;      // (items,) epoch of the item's last production
  int* consumed;      // (items,) epoch of the item's last consumption
  int n, sy, sz, ny, nz;  // nodes; row and layer strides; node rows a layer, node layers
  int tiles_x, tiles, items, ring_layers;
  Deltas dl;
};

// Wait until *flag holds `epoch`, then order the reads after it; false if
// it did not within kResSpin polls (a fault).
__device__ __forceinline__ bool wait_flag(const int* flag, int epoch) {
  bool ok = false;
  for (int i = 0; i < kResSpin; ++i) {
    if (*reinterpret_cast<const volatile int*>(flag) == epoch) {
      ok = true;
      break;
    }
    __nanosleep(64);
  }
  __threadfence();
  return ok;
}

// Cell policies of the ticketed pass: the slabs, their corners, vertex
// offsets and column shifts, and the floats of a ring slot.
//
// KuhnCells (K1): the six Kuhn slabs at compile time, 3 elements a thread.
struct KuhnCells {
  static constexpr bool kRunTime = false;
  static constexpr int kMax = kSlabs;
  __device__ static constexpr int slabs() { return kSlabs; }
  __device__ static constexpr int rounds() { return kSlabs * kResCells / kResThreads; }
  __device__ static constexpr int slot() { return kResSlot; }
  __device__ static constexpr int corner(int t, int a) { return kuhn(t, a); }
  __device__ __forceinline__ static void slab(const ResArgs& f, const int*, int t, int dv[4],
                                              int& shift) {
    slab_deltas(f.dl, t, dv);
    shift = 0;
  }
};

// GridCells (K1c): a table of nt <= 8 slabs placed on the node grid
// (fem/lattice.py::grid_tables), at run time: slab t's element on cell c is
// column c + shift[t] of the geometry, its vertex a node column +
// delta[t][a] = cell + the offset of corner[t][a]. A slot holds 24 x nt x
// 64 floats; an odd nt leaves the upper half of the last round's threads
// without a slab (they compute slab nt - 1 again and store nothing). The
// offsets and shifts are read from a copy in shared memory (a warp's slab
// index is known only at run time).
struct GridCells {
  static constexpr bool kRunTime = true;
  static constexpr int kMax = kMaxSlabs;
  int nt, slot_floats;
  int corners[kMaxSlabs][4], delta[kMaxSlabs][4], shift[kMaxSlabs];
  __device__ __forceinline__ int slabs() const { return nt; }
  __device__ __forceinline__ int rounds() const {
    return (nt * kResCells + kResThreads - 1) / kResThreads;
  }
  __device__ __forceinline__ int slot() const { return slot_floats; }
  __device__ __forceinline__ int corner(int t, int a) const { return corners[t][a]; }
  // the (kMaxSlabs, 5) table of delta[t][0..3], shift[t] (thread 0)
  __device__ __forceinline__ void copy_slabs(int* table) const {
#pragma unroll
    for (int t = 0; t < kMaxSlabs; ++t) {
#pragma unroll
      for (int a = 0; a < 4; ++a) table[t * 5 + a] = delta[t][a];
      table[t * 5 + 4] = shift[t];
    }
  }
  __device__ __forceinline__ static void slab(const ResArgs&, const int* table, int t, int dv[4],
                                              int& sh) {
#pragma unroll
    for (int a = 0; a < 4; ++a) dv[a] = table[t * 5 + a];
    sh = table[t * 5 + 4];
  }
};

template <class Cells>
__global__ void __launch_bounds__(kResThreads, kResBlocksPerSM)
residual_fused_kernel(ResArgs f, Cells cells, RowsResParams prm) {
  __shared__ int s_item, s_epoch, s_fault;
  __shared__ int s_slabs[Cells::kRunTime ? kMaxSlabs * 5 : 1];
  if (threadIdx.x == 0) {
    if constexpr (Cells::kRunTime) cells.copy_slabs(s_slabs);
    s_fault = 0;
    const unsigned long long ticket = atomicAdd(f.counter, 1ull);
    s_item = static_cast<int>(ticket % static_cast<unsigned long long>(f.items));
    s_epoch = static_cast<int>(ticket / static_cast<unsigned long long>(f.items)) + 1;
  }
  __syncthreads();
  const int item = s_item, epoch = s_epoch;
  const int L = item / f.tiles, T = item - L * f.tiles;
  const int tx = T % f.tiles_x, ty = T / f.tiles_x, tiles_y = f.tiles / f.tiles_x;
  const int x0 = tx * kResTile, y0 = ty * kResTile;
  const size_t N = static_cast<size_t>(f.n);

  // the slot's previous layer, L - R, is read by node layers L - R and
  // L - R + 1 of this tile and of its right, upper, upper-right neighbours,
  // which items L - R + 1 and L - R + 2 sum
  if (threadIdx.x < 8) {
    const int j = threadIdx.x, lw = L - f.ring_layers + 1 + (j >> 2);
    const int ux = tx + (j & 1), uy = ty + ((j >> 1) & 1);
    if (lw >= 0 && ux < f.tiles_x && uy < tiles_y)
      if (!wait_flag(f.consumed + lw * f.tiles + uy * f.tiles_x + ux, epoch)) s_fault = 1;
  }
  __syncthreads();

  float* slot =
      f.ring + (static_cast<size_t>(L % f.ring_layers) * f.tiles + T) * cells.slot();
#pragma unroll 1
  for (int rnd = 0; rnd < (L < f.nz ? cells.rounds() : 0); ++rnd) {
    const int e = threadIdx.x + rnd * kResThreads;
    int t = e / kResCells;
    const int cell = e - t * kResCells;
    const bool stored = !Cells::kRunTime || t < cells.slabs();
    if constexpr (Cells::kRunTime) t = min(t, cells.slabs() - 1);
    const int cx = x0 + cell % kResTile, cy = y0 + cell / kResTile;
    int dv[4], shift;
    cells.slab(f, s_slabs, t, dv, shift);
    // cells past the row or layer end feed no node (nor columns past N)
    bool valid = cx < f.sy && cy < f.ny;
    int c;
    if constexpr (Cells::kRunTime) {
      const int col = cx + f.sy * cy + f.sz * L + shift;
      valid = valid && col < f.n;
      c = valid ? col : 0;
    } else {
      c = valid ? cx + f.sy * cy + f.sz * L : 0;
    }

    ResInputs x;
    const float* g = f.geom + static_cast<size_t>(t) * 19 * N + c;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int a = 0; a < 4; ++a) x.sh[i][a] = g[(i * 4 + a) * N];
    x.det = g[12 * N];
    x.m00 = g[13 * N];
    x.m01 = g[14 * N];
    x.m02 = g[15 * N];
    x.m11 = g[16 * N];
    x.m12 = g[17 * N];
    x.m22 = g[18 * N];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int v = c + dv[a];
      const bool in = v < f.n;  // reads past N are zero, as the plain version's padded state
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        x.u[i][a] = in ? f.wa[i * N + v] : 0.f;
        x.du[i][a] = in ? f.dwa[i * N + v] : 0.f;
      }
      x.p[a] = in ? f.dwa[3 * N + v] : 0.f;
      x.phi[a] = in ? f.wa[4 * N + v] : 0.f;
      x.tem[a] = in ? f.wa[5 * N + v] : 0.f;
      x.dphi[a] = in ? f.dwa[4 * N + v] : 0.f;
      x.dtem[a] = in ? f.dwa[5 * N + v] : 0.f;
      x.src[a] = (in && f.src != nullptr) ? f.src[v] : 0.f;
    }
    float r[4][6];
    res_values(x, prm, r);
    if (stored) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 6; ++k)
          __stcg(slot + ((t * 4 + a) * 6 + k) * kResCells + cell, valid ? r[a][k] : 0.f);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(f.produced + item, epoch);

  // node layer Lc = L - 1 reads cell layers Lc and Lc - 1 of this tile and
  // of its left, lower and lower-left neighbours: items a layer or two back
  const int Lc = L - 1;
  __shared__ int s_cell[Cells::kRunTime ? 8 : 1][kResCells];
  if (threadIdx.x < 8) {
    const int j = threadIdx.x, lr = Lc - (j >> 2);
    const int ux = tx - (j & 1), uy = ty - ((j >> 1) & 1);
    if (lr >= 0 && ux >= 0 && uy >= 0)
      if (!wait_flag(f.produced + lr * f.tiles + uy * f.tiles_x + ux, epoch)) s_fault = 1;
  }
  if constexpr (Cells::kRunTime) {
    // A corner known only at run time: the ring offset of the cell that
    // corner c gives each node of the tile, once a block (-1 left of the
    // lattice, below it or below layer 0), for the sums below to look up.
    for (int i = threadIdx.x; i < 8 * kResCells; i += kResThreads) {
      const int c = i / kResCells, nd = i - c * kResCells;
      const int sx = nd % kResTile - (c & 1), sy = nd / kResTile - ((c >> 1) & 1), cz = c >> 2;
      const int dx = sx < 0 ? 1 : 0, dy = sy < 0 ? 1 : 0;
      const int layer = (L + f.ring_layers - 1 - cz) % f.ring_layers;
      s_cell[c][nd] = tx >= dx && ty >= dy && Lc >= cz
                          ? (layer * f.tiles + T - dx - dy * f.tiles_x) * cells.slot() +
                                (sx & 7) + (sy & 7) * kResTile
                          : -1;
    }
  }
  __syncthreads();

  // the thread's node and its components k0, k0 + 2, k0 + 4
  const int node = threadIdx.x % kResCells, k0 = threadIdx.x / kResCells;
  const int lx = node % kResTile, ly = node / kResTile;
  float acc[3] = {0.f, 0.f, 0.f};
  if constexpr (Cells::kRunTime) {
#pragma unroll
    for (int t = 0; t < Cells::kMax; ++t) {
      if (t >= cells.slabs()) break;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int o = s_cell[cells.corner(t, a)][node];
        const float* p = f.ring + (o >= 0 ? o : 0) + ((t * 4 + a) * 6 + k0) * kResCells;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float v = __ldcg(p + 2 * j * kResCells);
          acc[j] += o >= 0 ? v : 0.f;
        }
      }
    }
  } else {
    // this tile's cell layers Lc and Lc - 1 in the ring (layers below 0: never read)
    const float* layer_base[2] = {
        f.ring + (static_cast<size_t>((L + f.ring_layers - 1) % f.ring_layers) * f.tiles + T) *
                     cells.slot(),
        f.ring + (static_cast<size_t>((L + f.ring_layers - 2) % f.ring_layers) * f.tiles + T) *
                     cells.slot()};
#pragma unroll
    for (int t = 0; t < Cells::kMax; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ca = cells.corner(t, a);
        const int sx = lx - (ca & 1), sy = ly - ((ca >> 1) & 1), cz = ca >> 2;
        const int dx = sx < 0 ? 1 : 0, dy = sy < 0 ? 1 : 0;
        // left of the lattice, below it or below layer 0: the plain version adds a
        // dead cell's +-0 or nothing
        const bool ok = tx >= dx && ty >= dy && Lc >= cz;
        const int off = ((dx + dy * f.tiles_x) * -cells.slot()) +
                        (t * 4 + a) * 6 * kResCells + (sx & 7) + (sy & 7) * kResTile;
        const float* p = layer_base[cz] + (ok ? off : 0);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float v = __ldcg(p + (k0 + 2 * j) * kResCells);
          acc[j] += ok ? v : 0.f;
        }
      }
  }
  const int x = x0 + lx, y = y0 + ly;
  if (Lc >= 0 && x < f.sy && y < f.ny) {
    const size_t r = static_cast<size_t>(x) + static_cast<size_t>(f.sy) * y +
                     static_cast<size_t>(f.sz) * Lc;
#pragma unroll
    for (int j = 0; j < 3; ++j) f.out[(k0 + 2 * j) * N + r] = acc[j];
  }
  __syncthreads();  // every read of the ring is done
  if (threadIdx.x == 0) {
    atomicExch(f.consumed + item, epoch);
    if (s_fault) __trap();  // a wait timed out: fail the launch
  }
}

}  // namespace dedflow

// The tiling this build was compiled with, for the wrapper to check against
// fem/lattice.py's RES_FUSED_* tables (the ones tests/ emulate): out[0..3] =
// tile (nodes a side), threads a block, blocks an SM, floats of a tile's
// cell layer in the ring; out[4..27] = kuhn(t, a), t-major. cap: ints in
// out (at least 28).
extern "C" int dedflow_lattice_residual_layout(int* out, int cap) {
  using namespace dedflow;
  if (out == nullptr || cap < 4 + 4 * kSlabs) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kResTile;
  out[1] = kResThreads;
  out[2] = kResBlocksPerSM;
  out[3] = kResSlot;
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) out[4 + t * 4 + a] = kuhn(t, a);
  return 0;
}

namespace dedflow {

// The arguments both entries share; false if they are not a lattice's.
bool res_args(ResArgs* f, const void* geom, const void* wa, const void* dwa, const void* src,
              void* out, void* ring, int ring_layers, void* sync, int n, int sy, int ny, int nz) {
  if (n <= 0 || sy < 1 || ny < 1 || nz < 1 || sy * ny * nz != n || ring == nullptr ||
      ring_layers < 4 || sync == nullptr || (reinterpret_cast<size_t>(sync) & 7) != 0)
    return false;
  f->geom = static_cast<const float*>(geom);
  f->wa = static_cast<const float*>(wa);
  f->dwa = static_cast<const float*>(dwa);
  f->src = static_cast<const float*>(src);
  f->out = static_cast<float*>(out);
  f->ring = static_cast<float*>(ring);
  f->ring_layers = ring_layers;
  f->n = n;
  f->sy = sy;
  f->sz = sy * ny;
  f->ny = ny;
  f->nz = nz;
  f->tiles_x = (sy + kResTile - 1) / kResTile;
  f->tiles = f->tiles_x * ((ny + kResTile - 1) / kResTile);
  f->items = f->tiles * (nz + 1);
  f->counter = static_cast<unsigned long long*>(sync);
  f->produced = static_cast<int*>(sync) + 2;
  f->consumed = f->produced + f->items;
  return true;
}

}  // namespace dedflow

// The lattice is (sy, ny, nz) nodes, x fastest: sy nodes a row, ny rows a
// layer, nz layers. deltas: (6, 4) vertex offsets, which must be the Kuhn
// corners' (checked). src: the (n,) nodal heat source, or null for none.
// ring: ring_layers (at least 4) * tiles * kResSlot floats of scratch; the
// fewer layers, the sooner an item waits for a slot to be read. sync: the
// context's
// workspace, 2 + 2 * items int32 (a 64-bit ticket counter, then the
// produced and consumed flags), zero when the context was built and left
// to the kernel since; items = tiles * (nz + 1), tiles = ceil(sy/8) *
// ceil(ny/8).
extern "C" int dedflow_lattice_residual(const void* geom, const void* wa, const void* dwa,
                                        const void* src, void* out, void* ring, int ring_layers,
                                        void* sync, int n, int sy, int ny, int nz,
                                        const int* deltas,
                                        double rho, double mu, double cp, double kappa,
                                        double fb0, double fb1, double fb2, double dt,
                                        void* stream) {
  using namespace dedflow;
  ResArgs f;
  if (!res_args(&f, geom, wa, dwa, src, out, ring, ring_layers, sync, n, sy, ny, nz))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < kSlabs; ++t)
    for (int a = 0; a < 4; ++a) {
      const int c = kuhn(t, a);
      f.dl.d[t][a] = deltas[t * 4 + a];
      if (f.dl.d[t][a] != (c & 1) + sy * ((c >> 1) & 1) + f.sz * (c >> 2))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  residual_fused_kernel<KuhnCells><<<f.items, kResThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, KuhnCells{}, prm);
  return static_cast<int>(cudaGetLastError());
}

// K1c in one pass: the same items over a table of nt <= 8 slabs placed on
// the lattice (fem/lattice.py::grid_tables): slab t's element at column c
// is the cell c - shifts[t], its vertex a node c + deltas[t][a], which must
// be the cell's corner corners[t][a] (0..7, bits x, y, z; checked). ring:
// ring_layers * tiles * 24 * nt * 64 floats; sync: as K1's (a context's
// workspace serves both, calls in order on one stream). On the Kuhn table
// it sums in K1's order: the same output bit for bit.
extern "C" int dedflow_lattice_residual_grid(const void* geom, const void* wa, const void* dwa,
                                             const void* src, void* out, void* ring,
                                             int ring_layers, void* sync, int n, int sy, int ny,
                                             int nz, int nt, const int* deltas,
                                             const int* corners, const int* shifts, double rho,
                                             double mu, double cp, double kappa, double fb0,
                                             double fb1, double fb2, double dt, void* stream) {
  using namespace dedflow;
  ResArgs f;
  if (!res_args(&f, geom, wa, dwa, src, out, ring, ring_layers, sync, n, sy, ny, nz) || nt < 1 ||
      nt > kMaxSlabs)
    return static_cast<int>(cudaErrorInvalidValue);
  GridCells cells{};
  cells.nt = nt;
  cells.slot_floats = 24 * nt * kResCells;
  for (int t = 0; t < nt; ++t) {
    cells.shift[t] = shifts[t];
    if (shifts[t] < 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int a = 0; a < 4; ++a) {
      const int c = corners[t * 4 + a];
      cells.corners[t][a] = c;
      cells.delta[t][a] = deltas[t * 4 + a];
      if (c < 0 || c > 7 ||
          deltas[t * 4 + a] + shifts[t] != (c & 1) + sy * ((c >> 1) & 1) + f.sz * (c >> 2))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const RowsResParams prm{rho, mu, cp, kappa, fb0, fb1, fb2, dt};
  residual_fused_kernel<GridCells><<<f.items, kResThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f, cells, prm);
  return static_cast<int>(cudaGetLastError());
}
