// The projection's Jacobi solve in one persistent launch: phase 1 (the
// divergence) and all `iters` sweeps of phase 2 of project.cuh, for K3 and,
// through K3's entry, K2, K2s and K2o, wherever kernels/resident.solve_tiles
// finds a tiling (the caller decides before the launch; elsewhere the
// per-sweep kernel of project.cuh runs).  K8 and K14 (full_step.cuh) run the
// same program of a tile (solve_tile) inside their one launch.
//
// Replaces: fluidsim_tpu/pallas/resident.py:341 _solve_loop with block 1,
// as _project_body (:741) runs it inside _project_kernel (:894) and
// _project_obst_kernel (:907) (K3) and _project_advect_kernel (:1155),
// _project_advect_src_kernel (:1219) and _project_advect_obst_kernel
// (:1226) (K2, K2s, K2o), which ping-pong the iterate between two VMEM
// volumes (pb0, pb1) and never leave the chip between sweeps.
//
// The grid of n^3 cells is cut into gx * gy * gz tiles of 3 to 32 cells
// along x and y and at most 32 along z (tile t of g along y or z holding
// [t*n/g, (t+1)*n/g); along x the inner bounds rounded to the parity of
// n); one block owns a tile for the whole solve.  A thread owns a pair of
// neighbouring columns (tile cells x = 2k, 2k + 1 of a row), or one half of
// the pair's z extent where the block holds two threads a pair.  A block
// keeps in shared memory two copies of its tile of the iterate, each padded
// by one cell on every side (the halo), and its rhs; the solid bits stay in
// registers.  A sweep reads the previous copy and writes the other:
//   p'[cell] = round_T((rhs + ((xs + ys) + zs)) * coef)
// at the cell's interior cell c (boundary.cuh): a border row reads the row
// its y clamps to, cell 0 takes cell 1's value and cell n - 1 cell n - 2's
// (each pair of a tile at an x wall holds both), a z wall cell takes the
// value its column computed at z = 1 or n - 2.  That is sweep_cell's
// arithmetic in its order (project.cuh).  Jacobi reads only the previous
// iterate, so the order of cells and tiles cannot change a bit: the result
// is bitwise the per-sweep kernel's and the twin's.  Since a tile is at
// least 3 cells wide, a border cell's interior cell lies in its own tile
// and the 7-point stencil reads only the 6 face neighbours: a tile trades
// its 6 faces and no edge or corner.
//
// The trade, after each sweep s < iters: the block synchronises and
// copies its new faces into its slot of a global face buffer
// (double-buffered by the parity of s; consecutive lanes move consecutive
// values of a face, no thread more than a few), synchronises again, and
// one thread stores s into the block's flag with release semantics (the
// flags 128 bytes apart; the barrier before it orders every thread's face
// stores).  Up to 6 threads then each spin until one face neighbour's flag
// reads >= s and load it once more with acquire semantics.  After a
// barrier the block loads its neighbours' faces into the halo of the copy
// it just wrote (L2 loads, __ldcg: L1 is not coherent across SMs; a
// thread's loads all in flight before its first store), and a last
// barrier opens the next sweep.  A block writes slot s % 2 again only at
// sweep s + 2, after its neighbours have published s + 1, so they have
// finished reading it: the parity slots are race-free.  The launch is
// cooperative (every block co-resident, or the launch is refused), since a
// block spins on its neighbours.
//
// What bounds it on an H100: shared-memory bandwidth and the trade.  A
// sweep moves 7 shared values a cell (the y and z neighbours, the rhs and
// the new value as aligned pairs, the two x neighbours outside the pair;
// the pair's own and lower values stay in registers): about 7 x 16,384 for
// a 32 x 16 x 32 tile at 128^3.  The faces (4,096 cells a tile) go through
// L2 once each way, and each sweep waits on four block barriers, a flag's
// trip through L2 and one round of halo loads (tools/torch_solve_phases.py
// measures the cycles by phase).  The rhs, the mask and the
// iterate never touch device memory between the divergence and the final
// iterate, which is written once for the gradient.
//
// What the design does about it: one tile per SM with the working set on
// chip, 32-bit indices, x across threadIdx.x, two cells a thread moved as
// one 4- or 8-byte access, z marched in registers by up to 512 threads,
// face moves without index division and a thread's halo loads in flight at
// once, and synchronisation with the face neighbours only (no grid-wide
// barrier; K8's grid.sync() costs more than a launch a sweep).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "boundary.cuh"
#include "sweep_block.cuh"

namespace fsk {

// The tiling of one tiled solve, decided by the caller, and its scratch:
// flags, kFlagStride ints a tile, zero at the launch; faces, 2 parities x 6
// faces x TileShape::face values of the solve type a tile.
struct SolveTiles {
  int gx, gy, gz;
  int* flags;
  void* faces;
};

constexpr int kTileThreads = 512;  // the most threads a block has
constexpr int kTileMaxRow = 32;    // the most cells a tile has along x and y
constexpr int kTileMaxZ = 32;      // the most cells a column has
constexpr int kFlagStride = 32;    // ints between two tiles' flags (128 bytes)
constexpr int kHaloBatch = 4;      // halo values of a face a thread loads at once
constexpr int kLoadBatch = 4;     // items a thread loads before it stores them
constexpr int kBlockThreads = 256; // the most threads a block of block_tile has (255 registers)

__host__ __device__ __forceinline__ int tile_lo(int t, int n, int g) {
  return static_cast<int>(static_cast<long long>(t) * n / g);
}

// Along x the inner bounds are t*n/g rounded down to the parity of n, so
// that a tile's column pairs (its cells 2k, 2k + 1) put cells n - 2 and
// n - 1 in one pair, as they put cells 0 and 1.
__host__ __device__ __forceinline__ int tile_lo_x(int t, int n, int g) {
  if (t <= 0) return 0;
  if (t >= g) return n;
  const int p = n & 1;
  return ((tile_lo(t, n, g) - p) & ~1) + p;
}

// The largest tile's extent along y or z of n cells cut into g tiles.
__host__ __device__ __forceinline__ int tile_span(int n, int g) { return (n + g - 1) / g; }

// The largest tile's shape, and what its block needs.
struct TileShape {
  int mx, my, mz;     // the largest extents
  int hx;             // the most column pairs along x: blockDim.x
  int split;          // threads a column pair (2 where the block holds them)
  int face;           // values a face slot holds: the largest face, even
  size_t smem;        // bytes of shared memory: two padded copies, the rhs
};

// Values of a padded copy: (mz + 2) planes of (my + 2) rows of 2 hx + 2
// (cells -1 .. 2 hx), and 2 values of slack before it (the first row's
// cell -1 lies in the row before: rows share their halo slots' neighbours).
__host__ __device__ __forceinline__ int padded_values(int hx, int my, int mz) {
  return (2 * hx + 2) * (my + 2) * (mz + 2) + 2;
}

// The shape of the tiling of an n^3 grid into gx * gy * gz tiles for a
// solve type of `bytes` bytes, or false when the kernel cannot take it:
// fewer than 3 cells along an axis, more than kTileMaxRow along x or y,
// kTileThreads pairs or kTileMaxZ cells a column; an odd n in one x tile.
__host__ inline bool tile_shape(int n, int gx, int gy, int gz, int bytes, TileShape* out) {
  if (gx < 1 || gy < 1 || gz < 1 || n / gy < 3 || n / gz < 3 || ((n & 1) && gx < 2)) {
    return false;
  }
  TileShape s;
  s.mx = 0;
  for (int t = 0; t < gx; ++t) {
    const int w = tile_lo_x(t + 1, n, gx) - tile_lo_x(t, n, gx);
    if (w < 3) return false;
    s.mx = w > s.mx ? w : s.mx;
  }
  s.hx = (s.mx + 1) / 2;
  s.my = tile_span(n, gy);
  s.mz = tile_span(n, gz);
  if (s.mx > kTileMaxRow || s.my > kTileMaxRow || s.hx * s.my > kTileThreads ||
      s.mz > kTileMaxZ) {
    return false;
  }
  s.split = 2 * s.hx * s.my <= kTileThreads ? 2 : 1;
  const int rrow = 2 * s.hx, fx = s.my * s.mz, fy = rrow * s.mz, fz = rrow * s.my;
  s.face = ((fx > fy ? (fx > fz ? fx : fz) : (fy > fz ? fy : fz)) + 1) & ~1;
  s.smem = (2 + 2 * static_cast<size_t>(padded_values(s.hx, s.my, s.mz)) +
            2 * static_cast<size_t>(s.hx) * s.my * s.mz) * bytes;
  *out = s;
  return true;
}

// Face values through L2 only (the raw bits of a bfloat16).
__device__ __forceinline__ void store_cg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void store_cg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Phase 1's value from the three central differences along x, y and z, in
// float32: shared with K7e (project_slab.cu), whose z neighbours may lie in
// a neighbour shard's plane.
__device__ __forceinline__ float divergence_of(float dx, float dy, float dz, int n) {
  return (-0.5f * ((dx + dy) + dz)) / float(n);
}

// Phase 1's value at interior cell i: -0.5*((dvx + dvy) + dvz) / n in
// float32 (divergence_cell rounds it to the solve type).  FRESH: the
// velocity was written earlier in the same launch by other blocks (K8, K14),
// so it is read at L2 (L1 is not coherent across SMs).
template <typename S, bool FRESH = false>
__device__ __forceinline__ float divergence_value(const S* vel, int n, long long i) {
  const long long sn = n, plane = sn * sn, vol = plane * sn;
  const auto v = [&](long long k) {
    if constexpr (FRESH) {
      return ld(load_cg(vel + k));
    } else {
      return ld(vel[k]);
    }
  };
  const float dx = v(i + 1) - v(i - 1);
  const float dy = v(vol + i + sn) - v(vol + i - sn);
  const float dz = v(2 * vol + i + plane) - v(2 * vol + i - plane);
  return divergence_of(dx, dy, dz, n);
}

// Two neighbouring values along x (an aligned pair) as float32, and two
// rounded values stored as a pair.
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// An aligned pair of values as raw bits: copied between shared memory and
// the face buffer (through L2) without a conversion.
template <typename T>
struct PairBits;
template <>
struct PairBits<float> {
  using type = float2;
};
template <>
struct PairBits<__nv_bfloat16> {
  using type = unsigned int;
};
template <typename T>
using Bits2 = typename PairBits<T>::type;
template <typename T>
__device__ __forceinline__ Bits2<T> get2(const T* p) {
  return *reinterpret_cast<const Bits2<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void put2(T* p, Bits2<T> v) {
  *reinterpret_cast<Bits2<T>*>(p) = v;
}
template <typename T>
__device__ __forceinline__ Bits2<T> load2_cg(const T* p) {
  return __ldcg(reinterpret_cast<const Bits2<T>*>(p));
}
template <typename T>
__device__ __forceinline__ void store2_cg(T* p, Bits2<T> v) {
  __stcg(reinterpret_cast<Bits2<T>*>(p), v);
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <typename T, typename S>
struct TiledArgs {
  const S* vel;
  const uint8_t* mask;
  T* p;       // the final iterate, (n, n, n)
  int* flags;
  T* faces;
  int n, iters, gx, gy, gz;
  TileShape shape;
};

// --- K5 and K4 on the tiles ------------------------------------------------
//
// block_tile (below) is the tile program of K5's sweep-blocked solve
// (blk.block = T >= 2, sweep_block.cuh) inside K2, K3 and K8, and of K4's
// general sweeps (GEN: the start x, the rhs x0, a, the b faces' signs, the
// mask's frozen start; blk.block 1 for sequential sweeps, T >= 2 for K4's
// K5 blocks), on the tiling, the face slots and the flags of the tiled solve
// above, at most kBlockThreads threads a block (two a column pair where they
// fit).  A block keeps in shared memory the iterate P in the solve type and
// one (T <= 2) or two (T >= 3) float32 chain buffers, each padded by one
// cell (block_layout), x1 or X where it also fits, and with K5's mask the
// solid bits of its padded tile.  Each of K5's stages is a pass over the
// tile's cells (march: the pair's z neighbours in registers):
//   T = 2: U = N(P) into W0; then x1 + a2ic2*N(U) at every cell into P, the
//     corrections on the first interior plane of each wall (a pass of their
//     own over those planes' cells, x0 from L2 a few cells a thread at once),
//     and the walls (each wall cell its clamped cell's value);
//   T >= 3: h_0 = N(P), h_s = N(C*h_{s-1}) into W0, W1 in turn, each with
//     the shell's level s + 1 at a wall tile in the global scratch s0/s1
//     (shell_column: a thread a wall column), then the shell's last level,
//     X + aT*C*N(C*h_{T-2}) at every cell into the buffer h_{T-2} is not in,
//     the shell's value on planes 1..T-1 of the walls, and the walls;
// and after every stage but the solve's last the one-cell face trade of the
// tiled solve (parity slots, release/acquire flags, the face neighbours
// only).  A block of T sweeps is T trades.  Once a solve: the rhs (the
// projection: phase 1's divergence, stored to x0 for the corrections, the
// shell and the sweeps left over) and its halo, computed directly, then x1
// (T = 2) or g_1..g_{T-1} and X (T >= 3, a trade after each g that a later
// one reads).  The iters % T sweeps left over, and K4's sequential sweeps,
// are sweeps of the tiled solve's arithmetic at each column's clamped cell,
// with K4's general terms, into the other buffer.
//
// The torus: N wraps at the walls.  At T = 2 U at a wall plane reads the
// opposite wall's iterate, and the corrections cancel it only in exact
// arithmetic, so a tile at a wall trades its wall faces with the tile at the
// opposite wall (itself where it is alone along the axis).  At T >= 3 a
// wrapped read reaches only planes 1..T-1 of the walls, which take the
// shell's value: the halo past a wall is never traded (it holds zero), and
// tests/test_torch_sweep_tiles.py poisons it with NaN to show it dead.
//
// What bounds it on an H100 (tools/torch_block_phases.py): the stage passes
// issue about 130 cycles of instructions a cell with 256 threads an SM, a
// T = 2 block (two passes, the corrections, two trades) about twice a
// tiled-solve sweep; the corrections and the shell's O(n^2) levels through
// L2 fall on the wall tiles, which the others wait for at the next trade.
// What the design does about it: the chain never leaves the chip, a block of
// T sweeps is T trades and no launch, column pairs move as one 4- or 8-byte
// access, the L2 work is spread over a block's threads with its loads ahead
// of its stores, and the slots and flags are the tiled solve's.

template <typename T, typename S>
struct BlockTiledArgs {
  const S* vel;         // the projection's velocity (phase 1); null for K4
  const float* x;       // K4: the start, with a mask also x_init; null: the zero start
  T* x0;                // the rhs (n, n, n): K4's x0 (read only), or the projection's,
                        // which phase 1 writes at each tile's cells
  const uint8_t* mask;  // (n, n, n), nonzero = solid, or null
  T* p;                 // the final iterate (n, n, n)
  int* flags;
  float* faces;         // 2 parities x tiles x 6 slots of shape.face float32 values
  SolveBlock blk;       // K5's block (x1; T >= 3: s0, s1), or block 1: sweeps only
  int n, iters, gx, gy, gz, b;
  float a, inv_c;
  TileShape shape;
  int x_chip;           // x1/X in shared memory (block_shape), else in blk.x1
};

__host__ __device__ __forceinline__ size_t round16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Words of the solid bits of a padded tile (a bit a padded cell).
__host__ __device__ __forceinline__ int padded_words(int hx, int my, int mz) {
  return ((2 * hx + 2) * (my + 2) * (mz + 2) + 31) / 32;
}

// Byte offsets of block_tile's shared memory, regions rounded to 16 bytes:
// P (padded_values of the solve type), W0 and, for T >= 3, W1 (float32, the
// same layout; a float32 solve's W1 is P, dead from a block's stage 1 until
// its last stage writes it), the tile's cells (block 1, K4's sequential
// sweeps: the rhs; x_chip: x1 or X in float32, else read from global
// memory), the solid bits (K5 with a mask).
struct BlockLayout {
  size_t p, w0, w1, rhs, bits, total;
};

__host__ __device__ inline BlockLayout block_layout(const TileShape& s, int tbytes, int tb,
                                                    bool mask, bool x_chip) {
  const size_t pv = padded_values(s.hx, s.my, s.mz);
  const size_t pb = round16(pv * tbytes), wb = round16(pv * 4);
  BlockLayout l;
  l.p = 0;
  l.w0 = pb;
  l.w1 = l.w0;
  size_t end = pb + wb;
  if (tb >= 3) {
    if (tbytes == 4) {
      l.w1 = l.p;
    } else {
      l.w1 = end;
      end += wb;
    }
  }
  l.rhs = end;
  if (tb == 1) end += round16(static_cast<size_t>(2 * s.hx) * s.my * s.mz * tbytes);
  if (tb >= 2 && x_chip) end += round16(static_cast<size_t>(2 * s.hx) * s.my * s.mz * 4);
  l.bits = end;
  if (mask && tb >= 2) end += round16(static_cast<size_t>(padded_words(s.hx, s.my, s.mz)) * 4);
  l.total = end;
  return l;
}

// Whether the tiles at the walls hold T >= 3's shell: 2T - 1 planes or more
// along each axis (level 1 reads planes 0..2T-1 from a wall, the last in the
// halo).
__host__ __device__ inline bool shell_fits(int n, int gx, int gy, int gz, int tb) {
  if (tb < 3) return true;
  const int d = 2 * tb - 1;
  return tile_lo_x(1, n, gx) >= d && n - tile_lo_x(gx - 1, n, gx) >= d &&
         tile_lo(1, n, gy) >= d && n - tile_lo(gy - 1, n, gy) >= d && tile_lo(1, n, gz) >= d &&
         n - tile_lo(gz - 1, n, gz) >= d;
}

// The shape of block_tile for block tb on the tiling (gx, gy, gz) of an n^3
// solve in a type of tbytes bytes (at most kBlockThreads column pairs, two
// threads a pair where they fit), whether x1/X stays on chip (where a block
// of the current device may opt in to that much shared memory) and the
// shared memory, or false where it cannot take it (tile_shape's rules;
// T >= 3: shell_fits; the least layout over the opt-in).
__host__ inline bool block_shape(int n, int gx, int gy, int gz, int tbytes, int tb, bool mask,
                                 TileShape* shape, int* x_chip, size_t* smem) {
  int dev = 0, optin = 0;
  if (!tile_shape(n, gx, gy, gz, tbytes, shape) || !shell_fits(n, gx, gy, gz, tb) ||
      shape->hx * shape->my > kBlockThreads || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  shape->split = 2 * shape->hx * shape->my <= kBlockThreads ? 2 : 1;
  *x_chip = tb >= 2 && block_layout(*shape, tbytes, tb, mask, true).total <= size_t(optin);
  *smem = block_layout(*shape, tbytes, tb, mask, *x_chip != 0).total;
  return *smem <= size_t(optin);
}

// Internal linkage, as in boundary.cuh.
namespace {

// Face slots: f = 0, 1 the x faces (low, high; value y * mz + j), 2, 3 the
// y faces (j * 2hx + x), 4, 5 the z faces (y * 2hx + x), in tile-local
// coordinates (z = j).  Thread (lx, ly) moves the x face values at y = ly,
// j = lx, lx + hx, ...; the y face values of its pair at j = ly, ly + ty,
// ...; the z face values of its pair: values in consecutive lanes are
// consecutive in a slot.
//
// solve_tile is the whole program of block b (its tile) over the block's
// dynamic shared memory `smem` (TileShape::smem bytes): the rhs, the
// `iters` sweeps with their face trades and the final iterate's store to
// a.p.  solve_tiled_kernel runs it on a grid of the tiles (K2, K3);
// full_step.cuh's tiled kernel runs it between its advection phases (K8,
// K14), with FRESH since its velocity was written earlier in that launch.
// Every block of the grid must run it, the grid being exactly the tiles.
template <typename T, typename S, bool MASK, bool FRESH>
__device__ __forceinline__ void solve_tile(unsigned char* smem, const TiledArgs<T, S>& a,
                                           int b) {
  const int n = a.n, hx = a.shape.hx, my = a.shape.my, mz = a.shape.mz;
  const int face = a.shape.face, ntiles = a.gx * a.gy * a.gz;
  const int px = 2 * hx + 2, pplane = px * (my + 2), pvol = padded_values(hx, my, mz);
  // Padded copy (x, y, z), cells -1 .. tile + 1 along each axis, at
  // (z + 1) * pplane + (y + 1) * px + x.
  T* src = reinterpret_cast<T*>(smem) + 2;
  T* dst = src + pvol;
  T* rhs = dst + pvol;  // (mz, my, 2 hx), at the cells' own places
  const int rrow = 2 * hx, rplane = rrow * my;

  const int bx = b % a.gx, by = (b / a.gx) % a.gy, bz = b / (a.gx * a.gy);
  const int x0 = tile_lo_x(bx, n, a.gx), tx = tile_lo_x(bx + 1, n, a.gx) - x0;
  const int y0 = tile_lo(by, n, a.gy), ty = tile_lo(by + 1, n, a.gy) - y0;
  const int z0 = tile_lo(bz, n, a.gz), tz = tile_lo(bz + 1, n, a.gz) - z0;
  const int lx = threadIdx.x, ly = threadIdx.y, lz = threadIdx.z;
  const int tid = (lz * blockDim.y + ly) * blockDim.x + lx;
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  // The pair's cells j in [jlo, jhi): with two threads a pair (split 2)
  // and 4 cells or more along z, each takes a half, the wall cell's
  // neighbour in the same half; else thread lz = 0 takes them all.  Threads
  // lz >= split (a block larger than the solve needs: K8's) take none.
  const int split = a.shape.split;
  const int half = split == 2 && tz >= 4 ? tz / 2 : tz;
  const int jlo = lz == 0 ? 0 : half, jhi = lz == 0 ? half : (lz < split ? tz : half);
  // This thread's column pair: cells xa and xa + 1 of row ly (cell xa + 1
  // past the tile's end in a tile of odd width: it then computes a value
  // that lands in the halo, which the next halo load overwrites).
  const int xa = 2 * lx;
  const bool active = xa < tx && ly < ty && jlo < jhi, has_b = xa + 1 < tx;
  // The face moves are thread lz = 0's.
  const bool face_pair = lz == 0 && xa < tx && ly < ty, face_row = lz == 0 && ly < ty;
  const int gxa = x0 + xa, gyc = y0 + ly;
  // The row the pair's stencil reads (clamped to the interior); at the x
  // walls cell 0 takes cell 1's value and cell n - 1 cell n - 2's.
  const int ry = clamp_interior(gyc, n) - y0;
  const bool wall_a = gxa == 0, wall_b = gxa + 1 == n - 1;
  const int own = (ly + 1) * px + xa, col = (ry + 1) * px + xa, rown = ly * rrow + xa;
  // The neighbour tile across face f (-1 at a wall).
  const auto nb = [&](int f) {
    switch (f) {
      case 0: return bx > 0 ? b - 1 : -1;
      case 1: return bx < a.gx - 1 ? b + 1 : -1;
      case 2: return by > 0 ? b - a.gx : -1;
      case 3: return by < a.gy - 1 ? b + a.gx : -1;
      case 4: return bz > 0 ? b - a.gx * a.gy : -1;
      default: return bz < a.gz - 1 ? b + a.gx * a.gy : -1;
    }
  };

  // The zero start: both padded copies (their halos stay zero at the walls).
  // Not the rhs: a thread writes every rhs value its sweeps read, and a zero
  // stored there by another thread could land after it (a race seen once in
  // K8 at 128^3, where the divergence reads adv from L2).
  for (int i = tid; i < 2 + 2 * pvol; i += nthreads) {
    reinterpret_cast<T*>(smem)[i] = st<T>(0.0f);
  }
  // The rhs (phase 1, rounded to T) and the solid bits, at the interior z
  // of each cell; a wall cell's are never used.
  uint32_t solid_a = 0, solid_b = 0;
  if (active) {
    for (int j = jlo; j < jhi; ++j) {
      const int z = z0 + j;
      T ra = st<T>(0.0f), rb = st<T>(0.0f);
      if (z >= 1 && z <= n - 2) {
        const long long row = (static_cast<long long>(z) * n + (y0 + ry)) * n + gxa;
        if (!wall_a) {
          ra = st<T>(divergence_value<S, FRESH>(a.vel, n, row));
          if (MASK && a.mask[row] != 0) solid_a |= 1u << j;
        }
        if (has_b && !wall_b) {
          rb = st<T>(divergence_value<S, FRESH>(a.vel, n, row + 1));
          if (MASK && a.mask[row + 1] != 0) solid_b |= 1u << j;
        }
      }
      rhs[j * rplane + rown] = ra;
      rhs[j * rplane + rown + 1] = rb;
    }
  }
  __syncthreads();

  const bool lo_x = nb(0) >= 0, hi_x = nb(1) >= 0, lo_y = nb(2) >= 0, hi_y = nb(3) >= 0;
  const bool lo_z = nb(4) >= 0, hi_z = nb(5) >= 0;
  const float inv6 = 1.0f / 6.0f;
  for (int s = 1;; ++s) {
    if (active) {
      // z marched upwards: (am, bm) and (ac, bc) hold the pair's values at
      // j - 1 and j; cell a's x + 1 neighbour is bc, cell b's x - 1 is ac.
      float am, bm, ac, bc;
      ld2(src + jlo * pplane + col, am, bm);
      ld2(src + (jlo + 1) * pplane + col, ac, bc);
#pragma unroll
      for (int j = 0; j < kTileMaxZ; ++j) {
        if (j >= jlo && j < jhi) {
          const int c = (j + 1) * pplane + col;
          float ap, bp, ayl, byl, ayh, byh, ra, rb;
          ld2(src + c + pplane, ap, bp);
          ld2(src + c - px, ayl, byl);
          ld2(src + c + px, ayh, byh);
          ld2(rhs + j * rplane + rown, ra, rb);
          const float axl = ld(src[c - 1]), bxh = ld(src[c + 2]);
          const float ca = (MASK && ((solid_a >> j) & 1u)) ? 0.0f : inv6;
          const float cb = (MASK && ((solid_b >> j) & 1u)) ? 0.0f : inv6;
          T va = st<T>((ra + (((bc + axl) + (ayh + ayl)) + (ap + am))) * ca);
          T vb = st<T>((rb + (((bxh + ac) + (byh + byl)) + (bp + bm))) * cb);
          if (wall_a) va = vb;
          if (wall_b) vb = va;
          st2(dst + (j + 1) * pplane + own, va, vb);
          am = ac;
          bm = bc;
          ac = ap;
          bc = bp;
        }
      }
      if (z0 == 0 && jlo == 0) {
        st2(dst + pplane + own, dst[2 * pplane + own], dst[2 * pplane + own + 1]);
      }
      if (z0 + tz == n && jhi == tz) {
        st2(dst + tz * pplane + own, dst[(tz - 1) * pplane + own],
            dst[(tz - 1) * pplane + own + 1]);
      }
    }
    if (s == a.iters) break;
    __syncthreads();
    // The tile's new faces into its slot of this parity (pairs as they lie
    // in the copy; a partial pair's second value lands past the face).
    T* slot = a.faces + (static_cast<long long>((s & 1) * ntiles + b) * 6) * face;
    if (face_pair) {
      const int zr = ly * rrow + xa;
      if (lo_z) store2_cg(slot + 4 * face + zr, get2(dst + pplane + own));
      if (hi_z) store2_cg(slot + 5 * face + zr, get2(dst + tz * pplane + own));
      for (int j = ly; j < tz; j += ty) {
        const int c = (j + 1) * pplane + xa, g = j * rrow + xa;
        if (lo_y) store2_cg(slot + 2 * face + g, get2(dst + c + px));
        if (hi_y) store2_cg(slot + 3 * face + g, get2(dst + c + ty * px));
      }
    }
    if (face_row) {
      for (int j = lx; j < tz; j += hx) {
        const int c = (j + 1) * pplane + (ly + 1) * px;
        if (lo_x) store_cg(slot + ly * mz + j, dst[c]);
        if (hi_x) store_cg(slot + face + ly * mz + j, dst[c + tx - 1]);
      }
    }
    __syncthreads();
    if (tid == 0) store_release(a.flags + b * kFlagStride, s);
    if (tid < 6 && nb(tid) >= 0) {
      while (load_relaxed(a.flags + nb(tid) * kFlagStride) < s) {
      }
      load_acquire(a.flags + nb(tid) * kFlagStride);
    }
    __syncthreads();
    // The halo of dst: neighbour nb(f)'s opposite face f ^ 1 of this
    // parity; each thread's first kHaloBatch values of every face all
    // loaded before its first store.
    const T* in = a.faces + static_cast<long long>((s & 1) * ntiles) * 6 * face;
    const auto from = [&](int f) {
      return in + (static_cast<long long>(nb(f)) * 6 + (f ^ 1)) * face;
    };
    const int zr = ly * rrow + xa;
    Bits2<T> z_lo, z_hi, y_lo[kHaloBatch], y_hi[kHaloBatch];
    T x_lo[kHaloBatch], x_hi[kHaloBatch];
    if (face_pair) {
      if (lo_z) z_lo = load2_cg(from(4) + zr);
      if (hi_z) z_hi = load2_cg(from(5) + zr);
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = ly + t * ty;
        if (j < tz && lo_y) y_lo[t] = load2_cg(from(2) + j * rrow + xa);
        if (j < tz && hi_y) y_hi[t] = load2_cg(from(3) + j * rrow + xa);
      }
    }
    if (face_row) {
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = lx + t * hx;
        if (j < tz && lo_x) x_lo[t] = load_cg(from(0) + ly * mz + j);
        if (j < tz && hi_x) x_hi[t] = load_cg(from(1) + ly * mz + j);
      }
    }
    if (face_pair) {
      if (lo_z) put2(dst + own, z_lo);
      if (hi_z) put2(dst + (tz + 1) * pplane + own, z_hi);
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = ly + t * ty, c = (j + 1) * pplane + xa;
        if (j < tz && lo_y) put2(dst + c, y_lo[t]);
        if (j < tz && hi_y) put2(dst + c + (ty + 1) * px, y_hi[t]);
      }
      // Thin tiles: the values past the first batch, one pair at a time.
      for (int j = ly + kHaloBatch * ty; j < tz; j += ty) {
        const int c = (j + 1) * pplane + xa, g = j * rrow + xa;
        if (lo_y) put2(dst + c, load2_cg(from(2) + g));
        if (hi_y) put2(dst + c + (ty + 1) * px, load2_cg(from(3) + g));
      }
    }
    if (face_row) {
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = lx + t * hx, c = (j + 1) * pplane + (ly + 1) * px;
        if (j < tz && lo_x) dst[c - 1] = x_lo[t];
        if (j < tz && hi_x) dst[c + tx] = x_hi[t];
      }
      for (int j = lx + kHaloBatch * hx; j < tz; j += hx) {
        const int c = (j + 1) * pplane + (ly + 1) * px;
        if (lo_x) dst[c - 1] = load_cg(from(0) + ly * mz + j);
        if (hi_x) dst[c + tx] = load_cg(from(1) + ly * mz + j);
      }
    }
    __syncthreads();
    T* t = src;
    src = dst;
    dst = t;
  }
  if (active) {
    for (int j = jlo; j < jhi; ++j) {
      const long long i = (static_cast<long long>(z0 + j) * n + gyc) * n + gxa;
      a.p[i] = dst[(j + 1) * pplane + own];
      if (has_b) a.p[i + 1] = dst[(j + 1) * pplane + own + 1];
    }
  }
}

template <typename T, typename S, bool MASK>
__global__ void __launch_bounds__(kTileThreads, 1) solve_tiled_kernel(TiledArgs<T, S> a) {
  extern __shared__ __align__(16) unsigned char fs_tile_smem[];
  solve_tile<T, S, MASK, false>(fs_tile_smem, a, blockIdx.x);
}

// A block of the tiling of `shape`: hx column pairs by my rows by `split`
// threads a pair (each half the column).
__host__ inline dim3 tile_block(const TileShape& shape) {
  return dim3(shape.hx, shape.my, shape.split);
}

// The divergence of vel and `iters` sweeps from zero into p (n, n, n) in
// the solve type T, in one cooperative launch on `s` over the tiling t.
// Returns cudaErrorInvalidValue for a tiling the kernel cannot take (see
// tile_shape) or whose block needs more shared memory than it may opt in
// to, the launch's error otherwise (cudaErrorCooperativeLaunchTooLarge when
// the tiles cannot all be resident at once).
template <typename T, typename S>
cudaError_t solve_tiled(const S* vel, const uint8_t* mask, T* p, int n, int iters,
                        const SolveTiles& t, cudaStream_t s) {
  TileShape shape;
  if (!tile_shape(n, t.gx, t.gy, t.gz, sizeof(T), &shape) || t.flags == nullptr ||
      t.faces == nullptr) {
    return cudaErrorInvalidValue;
  }
  const void* kernel = mask != nullptr ? (const void*)solve_tiled_kernel<T, S, true>
                                       : (const void*)solve_tiled_kernel<T, S, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shape.smem));
  if (err != cudaSuccess) return err;
  TiledArgs<T, S> args{vel, mask, p, t.flags, static_cast<T*>(t.faces),
                       n, iters, t.gx, t.gy, t.gz, shape};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(t.gx * t.gy * t.gz), tile_block(shape), params,
                                    shape.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The neighbour sums of a column pair (cells c, c + 1 of a padded copy, x,
// y, z strides 1, px, pplane): each cell's two x operands and its y and z
// sums, each operand op(index, value), and the pair's own values; a() and
// b() are N in the twin's add order.
struct PairSums {
  float xpa, xma, ysa, zsa, xpb, xmb, ysb, zsb, oa, ob;
  __device__ __forceinline__ float a() const { return ((xpa + xma) + ysa) + zsa; }
  __device__ __forceinline__ float b() const { return ((xpb + xmb) + ysb) + zsb; }
};

// The z march of the column pair at padded row offset `base` ((y + 1) * px +
// x) over planes [jlo, jhi) of the padded copy v, as solve_tile's sweep: the
// pair's values at j - 1 and j ride in registers, and fn(j, c, sums) gets
// each plane's PairSums (c the pair's padded index).  v is read only, so fn
// writes elsewhere.  (On an H100 a march costs about 130 cycles a cell with
// 256 threads an SM, as much unrolled by 2 or marching two halves of the
// column at once; unrolled over kTileMaxZ planes, as solve_tile's, the
// program's eight marches spilled kilobytes a thread.)
template <typename V, typename Op, typename F>
__device__ __forceinline__ void march(const V* __restrict__ v, int base, int jlo, int jhi,
                                      int px, int pplane, Op op, F fn) {
  float am, bm, ac, bc;
  ld2(v + jlo * pplane + base, am, bm);
  ld2(v + (jlo + 1) * pplane + base, ac, bc);
  for (int j = jlo; j < jhi; ++j) {
    const int c = (j + 1) * pplane + base;
    float ap, bp, ayl, byl, ayh, byh;
    ld2(v + c + pplane, ap, bp);
    ld2(v + c - px, ayl, byl);
    ld2(v + c + px, ayh, byh);
    const float axl = ld(v[c - 1]), bxh = ld(v[c + 2]);
    PairSums p;
    p.xpa = op(c + 1, bc);
    p.xma = op(c - 1, axl);
    p.ysa = op(c + px, ayh) + op(c - px, ayl);
    p.zsa = op(c + pplane, ap) + op(c - pplane, am);
    p.xpb = op(c + 2, bxh);
    p.xmb = op(c, ac);
    p.ysb = op(c + 1 + px, byh) + op(c + 1 - px, byl);
    p.zsb = op(c + 1 + pplane, bp) + op(c + 1 - pplane, bm);
    p.oa = ac;
    p.ob = bc;
    fn(j, c, p);
    am = ac;
    bm = bc;
    ac = ap;
    bc = bp;
  }
}

// Items first, first + stride, ... < count, B at a time: load(i) for each of
// the B (its reads, from L2 among them, all issued before any store), then
// store(i, loaded) for each.
template <int B, typename Load, typename Store>
__device__ __forceinline__ void batched(int first, int count, int stride, Load load,
                                        Store store) {
  for (int i0 = first; i0 < count; i0 += B * stride) {
    decltype(load(0)) r[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      if (i0 + q * stride < count) r[q] = load(i0 + q * stride);
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
      if (i0 + q * stride < count) store(i0 + q * stride, r[q]);
    }
  }
}

// One wall column of a shell level (sweep_block.cuh's shell_item at planes
// 1..depth of one in-plane cell): level 1 reads the iterate P at padded
// index l0 + jj * ls (plane jj from the wall; in-plane steps lu, lv), later
// levels the last level `prev` at q0 + jj * nn (plane 0 read as plane 1; in-
// plane steps n, 1); the rhs x0 at g0 + j * gs; the coefficient at l0 + j *
// ls (the solid bits where MASK).  `order` is the wall's axis: it fixes the
// add order of the along-axis (A), u (U) and v (V) sums.  Pointers restrict:
// a plane's loads may run ahead of the last plane's store.
template <typename T, typename X, bool MASK>
__device__ __forceinline__ void shell_column(const T* __restrict__ P,
                                             const float* __restrict__ prev,
                                             float* __restrict__ cur, const X* __restrict__ x0,
                                             const uint32_t* __restrict__ bits, float ic, float a,
                                             bool first, bool lo, int axis, int depth, int l0,
                                             int ls, int lu, int lv, long long q0, long long nn,
                                             int n, long long o0, int g0, int gs) {
#pragma unroll 4
  for (int j = 1; j <= depth; ++j) {
    float up, dn, u, v;
    const int l = l0 + j * ls;
    if (first) {
      up = ld(P[l + ls]), dn = ld(P[l - ls]);
      u = ld(P[l + lu]) + ld(P[l - lu]);
      v = ld(P[l + lv]) + ld(P[l - lv]);
    } else {
      const long long q = q0 + j * nn;
      up = __ldcg(prev + q + nn), dn = __ldcg(prev + (j == 1 ? q : q - nn));
      u = __ldcg(prev + q + n) + __ldcg(prev + q - n);
      v = __ldcg(prev + q + 1) + __ldcg(prev + q - 1);
    }
    const float al = lo ? up + dn : dn + up;
    const float nbr = axis == 0 ? (v + u) + al : (axis == 1 ? (v + al) + u : (al + v) + u);
    float c = ic;
    if constexpr (MASK) {
      const int t = l + 1;
      if ((bits[t >> 5] >> (t & 31)) & 1u) c = 0.0f;
    }
    cur[o0 + j * nn] = shell_value(ld(load_cg(x0 + g0 + j * gs)), a, nbr, c);
  }
}

// The whole program of block b (its tile) over the block's dynamic shared
// memory (block_layout): see "K5 and K4 on the tiles" above.  FRESH: the
// velocity was written earlier in the same launch by other blocks (K8).
// Every block of the grid must run it, the grid being exactly the tiles.
template <typename T, typename S, bool MASK, bool FRESH, bool GEN>
__device__ __forceinline__ void block_tile(unsigned char* smem, const BlockTiledArgs<T, S>& a,
                                           int b) {
  const int n = a.n, hx = a.shape.hx, my = a.shape.my, mz = a.shape.mz;
  const int face = a.shape.face, ntiles = a.gx * a.gy * a.gz;
  const int px = 2 * hx + 2, pplane = px * (my + 2), pvol = padded_values(hx, my, mz);
  const int rrow = 2 * hx, rplane = rrow * my;
  const SolveBlock& k = a.blk;
  const int tb = k.block;
  const long long nn = static_cast<long long>(n) * n;
  const BlockLayout lay = block_layout(a.shape, sizeof(T), tb, MASK, a.x_chip != 0);
  // Padded copies, cells -1 .. tile + 1 along each axis at
  // (z + 1) * pplane + (y + 1) * px + x, after 2 values of slack.
  T* P = reinterpret_cast<T*>(smem + lay.p) + 2;
  float* wa = reinterpret_cast<float*>(smem + lay.w0) + 2;
  float* wb = reinterpret_cast<float*>(smem + lay.w1) + 2;
  T* rhs = reinterpret_cast<T*>(smem + lay.rhs);  // (mz, my, 2 hx), block 1 only
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + lay.bits);

  const int bx = b % a.gx, by = (b / a.gx) % a.gy, bz = b / (a.gx * a.gy);
  const int ox = tile_lo_x(bx, n, a.gx), tx = tile_lo_x(bx + 1, n, a.gx) - ox;
  const int oy = tile_lo(by, n, a.gy), ty = tile_lo(by + 1, n, a.gy) - oy;
  const int oz = tile_lo(bz, n, a.gz), tz = tile_lo(bz + 1, n, a.gz) - oz;
  const int lx = threadIdx.x, ly = threadIdx.y, lz = threadIdx.z;
  const int tid = (lz * blockDim.y + ly) * blockDim.x + lx;
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  // The columns of a thread, as solve_tile's.
  const int split = a.shape.split;
  const int half = split == 2 && tz >= 4 ? tz / 2 : tz;
  const int jlo = lz == 0 ? 0 : half, jhi = lz == 0 ? half : (lz < split ? tz : half);
  const int xa = 2 * lx;
  const bool active = xa < tx && ly < ty && jlo < jhi, has_b = xa + 1 < tx;
  const bool face_pair = lz == 0 && xa < tx && ly < ty, face_row = lz == 0 && ly < ty;
  const int gxa = ox + xa, gyc = oy + ly;
  // The row a sweep computes (the row's y clamped to the interior).
  const int ry = clamp_interior(gyc, n) - oy, cy = oy + ry;
  const bool wall_a = gxa == 0, wall_b = gxa + 1 == n - 1;
  const int own = (ly + 1) * px + xa, col = (ry + 1) * px + xa, rown = ly * rrow + xa;
  // Global indices of the pair's cell a at plane 0 (its row and the row it
  // computes), plane j at + j * n2.
  const int n2 = n * n;
  const int g_own = (oz * n + gyc) * n + gxa, g_col = (oz * n + cy) * n + gxa;

  // The neighbour tile across face f: on the torus at T = 2 (the tile at
  // the opposite wall; itself where it is alone along the axis), else -1
  // at a wall.
  const bool torus = tb == 2;
  const int gp = a.gx * a.gy;
  const auto nb = [&](int f) -> int {
    switch (f) {
      case 0: return bx > 0 ? b - 1 : (torus ? b + a.gx - 1 : -1);
      case 1: return bx < a.gx - 1 ? b + 1 : (torus ? b - (a.gx - 1) : -1);
      case 2: return by > 0 ? b - a.gx : (torus ? b + (a.gy - 1) * a.gx : -1);
      case 3: return by < a.gy - 1 ? b + a.gx : (torus ? b - (a.gy - 1) * a.gx : -1);
      case 4: return bz > 0 ? b - gp : (torus ? b + (a.gz - 1) * gp : -1);
      default: return bz < a.gz - 1 ? b + gp : (torus ? b - (a.gz - 1) * gp : -1);
    }
  };
  const auto wrap = [&](int c) { return c < 0 ? c + n : (c >= n ? c - n : c); };
  const auto gidx = [&](int z, int y, int x) { return (z * n + y) * n + x; };
  const auto pidx = [&](int x, int y, int z) { return (z + 1) * pplane + (y + 1) * px + x; };
  const auto inside = [&](int z, int y, int x) {
    return z >= 1 && z <= n - 2 && y >= 1 && y <= n - 2 && x >= 1 && x <= n - 2;
  };
  // C at padded index i (K5: the solid bits of the padded tile; ic without
  // a mask).
  const auto coef = [&](int i) -> float {
    if constexpr (MASK) {
      const int t = i + 1;
      return ((bits[t >> 5] >> (t & 31)) & 1u) ? 0.0f : k.ic;
    } else {
      return k.ic;
    }
  };
  const auto cop = [&](int i, float v) { return coef(i) * v; };
  const auto plain = [](int, float v) { return v; };
  // The rhs at global cell g: K4's x0, or the projection's, which this
  // block wrote earlier in the launch (read at L2).
  const auto x0_at = [&](int g) -> float {
    if constexpr (GEN) {
      return ld(a.x0[g]);
    } else {
      return ld(load_cg(a.x0 + g));
    }
  };
  // The face trade of buf (the solve type or float32) after a stage: the
  // tiled solve's, with slots of float32 size whatever the type, so that
  // the two parities never overlap.
  int s = 0;  // trades so far: the flag value of the last
  const auto slot = [&](int parity, int tile, int f) {
    return a.faces + (static_cast<long long>(parity * ntiles + tile) * 6 + f) * face;
  };
  const auto trade = [&](auto* buf) {
    using V = std::remove_pointer_t<decltype(buf)>;
    ++s;
    const int par = s & 1;
    __syncthreads();
    const auto out = [&](int f) { return reinterpret_cast<V*>(slot(par, b, f)); };
    if (face_pair) {
      const int zr = ly * rrow + xa;
      if (nb(4) >= 0) store2_cg(out(4) + zr, get2(buf + pplane + own));
      if (nb(5) >= 0) store2_cg(out(5) + zr, get2(buf + tz * pplane + own));
      for (int j = ly; j < tz; j += ty) {
        const int c = (j + 1) * pplane + xa, g = j * rrow + xa;
        if (nb(2) >= 0) store2_cg(out(2) + g, get2(buf + c + px));
        if (nb(3) >= 0) store2_cg(out(3) + g, get2(buf + c + ty * px));
      }
    }
    if (face_row) {
      for (int j = lx; j < tz; j += hx) {
        const int c = (j + 1) * pplane + (ly + 1) * px;
        if (nb(0) >= 0) store_cg(out(0) + ly * mz + j, buf[c]);
        if (nb(1) >= 0) store_cg(out(1) + ly * mz + j, buf[c + tx - 1]);
      }
    }
    __syncthreads();
    if (tid == 0) store_release(a.flags + b * kFlagStride, s);
    if (tid < 6 && nb(tid) >= 0) {
      while (load_relaxed(a.flags + nb(tid) * kFlagStride) < s) {
      }
      load_acquire(a.flags + nb(tid) * kFlagStride);
    }
    __syncthreads();
    const auto from = [&](int f) {
      return reinterpret_cast<const V*>(slot(par, nb(f), f ^ 1));
    };
    const int zr = ly * rrow + xa;
    Bits2<V> z_lo, z_hi, y_lo[kHaloBatch], y_hi[kHaloBatch];
    V x_lo[kHaloBatch], x_hi[kHaloBatch];
    if (face_pair) {
      if (nb(4) >= 0) z_lo = load2_cg(from(4) + zr);
      if (nb(5) >= 0) z_hi = load2_cg(from(5) + zr);
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = ly + t * ty;
        if (j < tz && nb(2) >= 0) y_lo[t] = load2_cg(from(2) + j * rrow + xa);
        if (j < tz && nb(3) >= 0) y_hi[t] = load2_cg(from(3) + j * rrow + xa);
      }
    }
    if (face_row) {
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = lx + t * hx;
        if (j < tz && nb(0) >= 0) x_lo[t] = load_cg(from(0) + ly * mz + j);
        if (j < tz && nb(1) >= 0) x_hi[t] = load_cg(from(1) + ly * mz + j);
      }
    }
    if (face_pair) {
      if (nb(4) >= 0) put2(buf + own, z_lo);
      if (nb(5) >= 0) put2(buf + (tz + 1) * pplane + own, z_hi);
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = ly + t * ty, c = (j + 1) * pplane + xa;
        if (j < tz && nb(2) >= 0) put2(buf + c, y_lo[t]);
        if (j < tz && nb(3) >= 0) put2(buf + c + (ty + 1) * px, y_hi[t]);
      }
      for (int j = ly + kHaloBatch * ty; j < tz; j += ty) {
        const int c = (j + 1) * pplane + xa, g = j * rrow + xa;
        if (nb(2) >= 0) put2(buf + c, load2_cg(from(2) + g));
        if (nb(3) >= 0) put2(buf + c + (ty + 1) * px, load2_cg(from(3) + g));
      }
    }
    if (face_row) {
#pragma unroll
      for (int t = 0; t < kHaloBatch; ++t) {
        const int j = lx + t * hx, c = (j + 1) * pplane + (ly + 1) * px;
        if (j < tz && nb(0) >= 0) buf[c - 1] = x_lo[t];
        if (j < tz && nb(1) >= 0) buf[c + tx] = x_hi[t];
      }
      for (int j = lx + kHaloBatch * hx; j < tz; j += hx) {
        const int c = (j + 1) * pplane + (ly + 1) * px;
        if (nb(0) >= 0) buf[c - 1] = load_cg(from(0) + ly * mz + j);
        if (nb(1) >= 0) buf[c + tx] = load_cg(from(1) + ly * mz + j);
      }
    }
    __syncthreads();
  };

  // The zero working set below the solid bits, then the solid bits of the
  // padded tile (K5 with a mask; past a wall the torus's), before any store.
  for (int i = tid; i < static_cast<int>(lay.bits / 4); i += nthreads) {
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  }
  if constexpr (MASK) {
    if (tb >= 2) {
      const int words = padded_words(hx, my, mz), cells = pplane * (mz + 2);
      for (int w = tid; w < words; w += nthreads) {
        uint32_t v = 0;
        for (int q = 0; q < 32 && w * 32 + q < cells; ++q) {
          const int t = w * 32 + q, row = t / px;
          const int x = wrap(ox + t % px - 1), y = wrap(oy + row % (my + 2) - 1);
          const int z = wrap(oz + row / (my + 2) - 1);
          if (a.mask[gidx(z, y, x)] != 0) v |= 1u << q;
        }
        bits[w] = v;
      }
    }
  }
  __syncthreads();

  // Tile cells as items: the tile's own cells, and its halo's six faces.
  const int owns = tx * ty * tz;
  const auto own_cell = [&](int i, int& x, int& y, int& z) {
    x = i % tx;
    y = (i / tx) % ty;
    z = i / (tx * ty);
  };
  const int hfx = ty * tz, hfy = tx * tz, hfz = tx * ty, halos = 2 * (hfx + hfy + hfz);
  const auto halo_cell = [&](int i, int& x, int& y, int& z) {
    if (i < 2 * hfx) {
      const bool hi = i >= hfx;
      i -= hi ? hfx : 0;
      x = hi ? tx : -1, y = i % ty, z = i / ty;
    } else if (i < 2 * (hfx + hfy)) {
      i -= 2 * hfx;
      const bool hi = i >= hfy;
      i -= hi ? hfy : 0;
      x = i % tx, y = hi ? ty : -1, z = i / tx;
    } else {
      i -= 2 * (hfx + hfy);
      const bool hi = i >= hfz;
      i -= hi ? hfz : 0;
      x = i % tx, y = i / tx, z = hi ? tz : -1;
    }
  };
  struct Cell0 {
    int i, g;
    float v;
  };

  // Phase 1: the rhs.  K4's sequential sweeps (block 1): at the row each
  // column computes, into the rhs, with the mask's bits of its frozen start
  // (solid; x_init read from global where solid or not finite: m*x_init;
  // its sign otherwise: 0*x_init).  K5 (T >= 2): at every cell of the tile
  // and its halo into W0 (T >= 3: g_0 = C*x0), the projection computing it
  // from the divergence and storing its own cells to x0.
  uint32_t solid_a = 0, solid_b = 0, keep_a = 0, keep_b = 0, neg_a = 0, neg_b = 0;
  if (tb == 1 && active) {
    for (int j0 = jlo; j0 < jhi; j0 += kLoadBatch) {
      float r[kLoadBatch][2], xi[kLoadBatch][2];
      bool m[kLoadBatch][2];
#pragma unroll
      for (int q = 0; q < kLoadBatch; ++q) {
        if (j0 + q < jhi) {
          const int gc = gidx(oz + j0 + q, cy, gxa);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gh = h == 1 && !has_b ? gc : gc + h;
            r[q][h] = ld(a.x0[gh]);
            if constexpr (GEN && MASK) {
              xi[q][h] = a.x[gh];
              m[q][h] = a.mask[gh] != 0;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kLoadBatch; ++q) {
        const int j = j0 + q;
        if (j < jhi) {
          rhs[j * rplane + rown] = st<T>(r[q][0]);
          rhs[j * rplane + rown + 1] = st<T>(r[q][1]);
          if constexpr (GEN && MASK) {
            const uint32_t bit = 1u << j;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (m[q][h]) (h ? solid_b : solid_a) |= bit;
              if (m[q][h] || !(fabsf(xi[q][h]) <= 3.402823466e38f)) (h ? keep_b : keep_a) |= bit;
              if (__float_as_uint(xi[q][h]) >> 31) (h ? neg_b : neg_a) |= bit;
            }
          }
        }
      }
    }
  }
  if (tb >= 2) {
    const auto rhs_at = [&](int x, int y, int z) -> float {
      const int gz_ = oz + z, gy_ = oy + y, gx_ = ox + x;
      if constexpr (GEN) {
        return ld(a.x0[gidx(wrap(gz_), wrap(gy_), wrap(gx_))]);
      } else {
        return inside(gz_, gy_, gx_)
                   ? ld(st<T>(divergence_value<S, FRESH>(a.vel, n, gidx(gz_, gy_, gx_))))
                   : 0.0f;
      }
    };
    const auto put = [&](int, const Cell0& c) {
      wa[c.i] = tb >= 3 ? coef(c.i) * c.v : c.v;
      if constexpr (!GEN) {
        if (c.g >= 0) a.x0[c.g] = st<T>(c.v);
      }
    };
    batched<kLoadBatch>(tid, owns, nthreads, [&](int i) {
      int x, y, z;
      own_cell(i, x, y, z);
      return Cell0{pidx(x, y, z), gidx(oz + z, oy + y, ox + x), rhs_at(x, y, z)};
    }, put);
    batched<kLoadBatch>(tid, halos, nthreads, [&](int i) {
      int x, y, z;
      halo_cell(i, x, y, z);
      return Cell0{pidx(x, y, z), -1, rhs_at(x, y, z)};
    }, put);
  }
  __syncthreads();

  // x1 (T = 2) or X (T >= 3) at plane j, tile row `row`, cell h of a column
  // pair, global index g: on chip where it fits, else in blk.x1 (read at L2).
  float* xs = reinterpret_cast<float*>(smem + lay.rhs);
  const auto x_at = [&](int j, int row, int h, int g) -> float {
    return a.x_chip ? xs[j * rplane + row * rrow + xa + h] : load_cg(k.x1 + g);
  };
  const auto x_put = [&](int j, int h, int g, float v) {
    if (a.x_chip) {
      xs[j * rplane + rown + h] = v;
    } else {
      k.x1[g] = v;
    }
  };

  // Once a solve: x1 (T = 2) or g_1..g_{T-1} and X (T >= 3), at the tile's
  // cells.
  if (tb == 2 && active) {
    const auto x1_pair = [&](int j, int c, const PairSums& p) {
      const int g = g_own + j * n2;
      x_put(j, 0, g, x1_delta_value(MASK, k.ic, k.aicic, k.a, coef(c), wa[c], p.a()));
      if (has_b) {
        x_put(j, 1, g + 1, x1_delta_value(MASK, k.ic, k.aicic, k.a, coef(c + 1), wa[c + 1], p.b()));
      }
    };
    if constexpr (MASK) {
      march(wa, own, jlo, jhi, px, pplane, cop, x1_pair);
    } else {
      march(wa, own, jlo, jhi, px, pplane, plain, x1_pair);
    }
  }
  if (tb >= 3) {
    float* gin = wa;
    float* gout = wb;
    float pw = 1.0f;
    for (int q = 1; q < tb; ++q) {
      pw = pw * k.a;
      if (active) {
        march(gin, own, jlo, jhi, px, pplane, plain, [&](int j, int c, const PairSums& p) {
          const int g = g_own + j * n2;
          const float ga = coef(c) * p.a(), gb = coef(c + 1) * p.b();
          st2(gout + c, ga, gb);
          x_put(j, 0, g, (q == 1 ? gin[c] : x_at(j, ly, 0, g)) + pw * ga);
          if (has_b) x_put(j, 1, g + 1, (q == 1 ? gin[c + 1] : x_at(j, ly, 1, g + 1)) + pw * gb);
        });
      }
      if (q <= tb - 2) {
        trade(gout);
      } else {
        __syncthreads();
      }
      float* t = gin;
      gin = gout;
      gout = t;
    }
  }

  // The start: K4's x with its halo (past a wall, the torus's), or zero.
  if constexpr (GEN) {
    const auto put = [&](int, const Cell0& c) { P[c.i] = st<T>(c.v); };
    batched<kLoadBatch>(tid, owns, nthreads, [&](int i) {
      int x, y, z;
      own_cell(i, x, y, z);
      return Cell0{pidx(x, y, z), 0, a.x[gidx(oz + z, oy + y, ox + x)]};
    }, put);
    batched<kLoadBatch>(tid, halos, nthreads, [&](int i) {
      int x, y, z;
      halo_cell(i, x, y, z);
      return Cell0{pidx(x, y, z), 0, a.x[gidx(wrap(oz + z), wrap(oy + y), wrap(ox + x))]};
    }, put);
  } else {
    for (int i = tid; i < pvol; i += nthreads) P[i - 2] = st<T>(0.0f);
  }
  __syncthreads();

  const int blocks = tb >= 2 ? a.iters / tb : 0;
  const int left = tb >= 2 ? a.iters % tb : a.iters;
  const int stages = blocks * tb + left;
  int stage = 0;
  // After each stage but the solve's last, the trade of what it wrote.
  const auto next = [&](auto* buf) {
    if (++stage < stages) {
      trade(buf);
    } else {
      __syncthreads();
    }
  };
  // A z wall cell takes the value its column computed at z = 1 or n - 2
  // (negated where the faces negate across z): the sweeps' walls.
  const auto z_walls = [&](T* dst, bool negate) {
    const auto sv = [&](T v) { return negate ? st<T>(-ld(v)) : v; };
    if (oz == 0 && jlo == 0) {
      st2(dst + pplane + own, sv(dst[2 * pplane + own]), sv(dst[2 * pplane + own + 1]));
    }
    if (oz + tz == n && jhi == tz) {
      st2(dst + tz * pplane + own, sv(dst[(tz - 1) * pplane + own]),
          sv(dst[(tz - 1) * pplane + own + 1]));
    }
  };
  // K5's walls (b = 0): every cell of the tile's faces at a wall takes the
  // value of its clamped cell, an interior cell of the tile.
  const auto wall_pass = [&](T* dst) {
    for (int f = 0; f < 6; ++f) {
      const int axis = f / 2;
      const bool lo = f % 2 == 0;
      const int o = axis == 0 ? oz : (axis == 1 ? oy : ox);
      const int t = axis == 0 ? tz : (axis == 1 ? ty : tx);
      if (lo ? o != 0 : o + t != n) continue;
      const int tu = axis == 0 ? ty : tz, tv = axis == 2 ? ty : tx;
      for (int i = tid; i < tu * tv; i += nthreads) {
        const int u = i / tv, v = i % tv, w = lo ? 0 : t - 1;
        int x = v, y = u, z = w;
        if (axis == 1) x = v, y = w, z = u;
        if (axis == 2) x = w, y = v, z = u;
        const int cx = clamp_interior(ox + x, n) - ox, cyy = clamp_interior(oy + y, n) - oy;
        const int cz = clamp_interior(oz + z, n) - oz;
        dst[pidx(x, y, z)] = dst[pidx(cx, cyy, cz)];
      }
    }
  };
  // The tile's interior cells on planes [lo, hi] (global, clipped to the
  // tile and the interior) of `axis`: count and the cell of item i, the
  // in-plane axes over the tile's interior cells.
  struct Slab {
    int axis, lo, hi, ulo, ul, vlo, vl;
  };
  const auto slab = [&](int axis, int lo, int hi) {
    const int o = axis == 0 ? oz : (axis == 1 ? oy : ox);
    const int t = axis == 0 ? tz : (axis == 1 ? ty : tx);
    const int ou = axis == 0 ? oy : oz, tu = axis == 0 ? ty : tz;
    const int ov = axis == 2 ? oy : ox, tv = axis == 2 ? ty : tx;
    Slab sl;
    sl.axis = axis;
    sl.lo = lo > o ? lo : o;
    sl.hi = hi < o + t - 1 ? hi : o + t - 1;
    sl.ulo = ou > 1 ? ou : 1;
    sl.ul = (ou + tu < n - 1 ? ou + tu : n - 1) - sl.ulo;
    sl.vlo = ov > 1 ? ov : 1;
    sl.vl = (ov + tv < n - 1 ? ov + tv : n - 1) - sl.vlo;
    if (sl.hi < sl.lo || sl.ul <= 0 || sl.vl <= 0) sl.hi = sl.lo - 1;
    return sl;
  };
  const auto slab_count = [](const Slab& sl) { return (sl.hi - sl.lo + 1) * sl.ul * sl.vl; };
  const auto slab_cell = [](const Slab& sl, int i, int& z, int& y, int& x) {
    const int w = sl.lo + i / (sl.ul * sl.vl), r = i % (sl.ul * sl.vl);
    const int u = sl.ulo + r / sl.vl, v = sl.vlo + r % sl.vl;
    z = w, y = u, x = v;
    if (sl.axis == 1) z = u, y = w, x = v;
    if (sl.axis == 2) z = u, y = v, x = w;
  };
  struct CellT {
    int i;
    T v;
  };
  // Planes 1..T-1 of each wall: the shell's level `level` at the wall tiles'
  // in-plane cells, one thread a column of them (shell_column), level 1
  // from P, later ones from the last level in global memory (the in-plane
  // neighbours' parts stored before their flags).
  const auto shell = [&](int level) {
    const float* prev = level % 2 == 0 ? k.s1 : k.s0;
    float* cur = level % 2 == 0 ? k.s0 : k.s1;
    const int depth = 2 * tb - 1 - level;
    for (int side = 0; side < 6; ++side) {
      const int axis = side / 2;
      const bool lo = side % 2 == 0;
      const int t = axis == 0 ? bz : (axis == 1 ? by : bx);
      const int g = axis == 0 ? a.gz : (axis == 1 ? a.gy : a.gx);
      if (t != (lo ? 0 : g - 1)) continue;
      const int u0 = axis == 0 ? oy : oz, tu = axis == 0 ? ty : tz;
      const int v0 = axis == 2 ? oy : ox, tv = axis == 2 ? ty : tx;
      const long long base = static_cast<long long>(side) * 2 * tb;
      // Steps along the axis (from the wall inwards), u and v: in the
      // padded copy and in the grid.
      const int sa = axis == 0 ? pplane : (axis == 1 ? px : 1);
      const int ga = axis == 0 ? n * n : (axis == 1 ? n : 1);
      const int lu = axis == 0 ? px : pplane, lv = axis == 2 ? px : 1;
      const int gu = axis == 0 ? n : n * n, gv = axis == 2 ? n : 1;
      const int wall = lo ? 0 : n - 1;  // plane 0's coordinate along the axis
      const int wl = wall - (axis == 0 ? oz : (axis == 1 ? oy : ox));
      for (int i = tid; i < tu * tv; i += nthreads) {
        const int u = u0 + i / tv, v = v0 + i % tv;
        const int cu = clamp_interior(u, n), cv = clamp_interior(v, n);
        // Plane 0 (the wall) at the clamped in-plane cell.
        int lz = 0, lyy = 0, lxx = 0;
        if (axis == 0) lz = wl, lyy = cu - oy, lxx = cv - ox;
        if (axis == 1) lz = cu - oz, lyy = wl, lxx = cv - ox;
        if (axis == 2) lz = cu - oz, lyy = cv - oy, lxx = wl;
        const int l0 = pidx(lxx, lyy, lz);
        const int g0 = wall * ga + cu * gu + cv * gv;
        shell_column<T, T, MASK>(P, prev, cur, a.x0, bits, k.ic, k.a, level == 1, lo, axis, depth,
                                 l0, lo ? sa : -sa, lu, lv,
                                 base * nn + static_cast<long long>(cu) * n + cv, nn, n,
                                 base * nn + static_cast<long long>(u) * n + v, g0,
                                 lo ? ga : -ga);
      }
    }
  };
  // Where T >= 3's last stage takes the shell at cell (z, y, x): the last
  // of z lo, z hi, y lo, y hi, x lo, x hi whose planes 1..T-1 hold it, as an
  // index of the shell's level T; -1 elsewhere.
  const auto band = [&](int c) { return c <= tb - 1 || c >= n - tb; };
  const auto shell_at = [&](int z, int y, int x) -> long long {
    int side, j, u, v;
    if (band(x)) {
      side = x <= tb - 1 ? 4 : 5, j = x <= tb - 1 ? x : n - 1 - x, u = z, v = y;
    } else if (band(y)) {
      side = y <= tb - 1 ? 2 : 3, j = y <= tb - 1 ? y : n - 1 - y, u = z, v = x;
    } else if (band(z)) {
      side = z <= tb - 1 ? 0 : 1, j = z <= tb - 1 ? z : n - 1 - z, u = y, v = x;
    } else {
      return -1;
    }
    return (static_cast<long long>(side) * 2 * tb + j) * nn + static_cast<long long>(u) * n + v;
  };
  const float* last = tb % 2 == 0 ? k.s0 : k.s1;  // the shell's level T
  // T >= 3's overrides: each interior cell of the tile on planes 1..T-1 of
  // a wall takes the shell's value (the x bands first, then the y bands'
  // other cells, then the z bands').
  const auto overrides = [&](T* dst) {
    for (int axis = 2; axis >= 0; --axis) {
      for (int side = 0; side < 2; ++side) {
        const Slab sl = side == 0 ? slab(axis, 1, tb - 1) : slab(axis, n - tb, n - 2);
        batched<kLoadBatch>(tid, slab_count(sl), nthreads, [&](int i) {
          int z, y, x;
          slab_cell(sl, i, z, y, x);
          if ((axis < 2 && band(x)) || (axis == 0 && band(y))) return CellT{-1, T{}};
          return CellT{pidx(x - ox, y - oy, z - oz), st<T>(load_cg(last + shell_at(z, y, x)))};
        }, [&](int, const CellT& c) {
          if (c.i >= 0) dst[c.i] = c.v;
        });
      }
    }
  };
  // T = 2's corrections: each interior cell of the tile on plane 1 or
  // n - 2 of an axis, v = st(v + mul*(raw[c] - raw[wall])) for z, then y,
  // then x (a cell on several planes takes all of them at its first).
  const auto corrections = [&]() {
    const auto edge = [&](int c) { return c == 1 || c == n - 2; };
    for (int axis = 0; axis < 3; ++axis) {
      for (int side = 0; side < 2; ++side) {
        const int pl = side == 0 ? 1 : n - 2;
        if (side == 1 && pl == 1) continue;
        const Slab sl = slab(axis, pl, pl);
        batched<kLoadBatch>(tid, slab_count(sl), nthreads, [&](int i) {
          int z, y, x;
          slab_cell(sl, i, z, y, x);
          if ((axis > 0 && edge(z)) || (axis == 2 && edge(y))) return CellT{-1, T{}};
          const int ci = pidx(x - ox, y - oy, z - oz), g = gidx(z, y, x);
          const float cc = coef(ci);
          const float raw_c = raw_value(k.a, x0_at(g), wa[ci], cc);
          const float mul = MASK ? k.a * cc : k.aic;
          T v = P[ci];
          const auto fix = [&](int coord, int ls, int gs) {
            if (coord == 1) {
              v = corrected(v, mul, raw_c,
                            raw_value(k.a, x0_at(g - gs), wa[ci - ls], coef(ci - ls)));
            }
            if (coord == n - 2) {
              v = corrected(v, mul, raw_c,
                            raw_value(k.a, x0_at(g + gs), wa[ci + ls], coef(ci + ls)));
            }
          };
          fix(z, pplane, n * n);
          fix(y, px, n);
          fix(x, 1, 1);
          return CellT{ci, v};
        }, [&](int, const CellT& c) {
          if (c.i >= 0) P[c.i] = c.v;
        });
      }
    }
  };
  // A sweep's value at cell h (the tiled solve's arithmetic with K4's a,
  // frozen start and signs), from its neighbour sum nb.
  const bool yneg = a.b == 2 && gyc != cy;
  const auto sweep_cell = [&](int j, int h, int ci, int g, float nb) -> T {
    const float r0 = tb == 1 ? ld(rhs[j * rplane + rown + h]) : x0_at(g);
    const float r = r0 + (a.a == 1.0f ? nb : a.a * nb);
    float u;
    if constexpr (GEN && MASK) {
      const uint32_t bit = 1u << j;
      const float m = ((h ? solid_b : solid_a) & bit) ? 1.0f : 0.0f;
      float fz;
      if ((h ? keep_b : keep_a) & bit) {
        fz = m * a.x[g];
      } else {
        fz = ((h ? neg_b : neg_a) & bit) ? -0.0f : 0.0f;
      }
      u = r * ((1.0f - m) * a.inv_c) + fz;
    } else if constexpr (MASK) {
      u = r * coef(ci);
    } else {
      u = r * a.inv_c;
    }
    return st<T>(yneg ? -u : u);
  };

  // T = 2's blocks: U = N(P) into W0; p' from U at every cell into P (which
  // the stage does not read), the corrections, the walls.
  for (int blk = 0; tb == 2 && blk < blocks; ++blk) {
    if (active) {
      march(P, own, jlo, jhi, px, pplane, plain,
            [&](int, int c, const PairSums& p) { st2(wa + c, p.a(), p.b()); });
    }
    next(wa);
    if (active) {
      const auto delta_pair = [&](int j, int c, const PairSums& p) {
        const int g = g_own + j * n2;
        const T va = st<T>(delta_value(MASK, x_at(j, ly, 0, g), k.a2, k.a2ic2, coef(c), p.a()));
        const T vb = has_b ? st<T>(delta_value(MASK, x_at(j, ly, 1, g + 1), k.a2, k.a2ic2,
                                               coef(c + 1), p.b()))
                           : va;
        st2(P + c, va, vb);
      };
      if constexpr (MASK) {
        march(wa, own, jlo, jhi, px, pplane, cop, delta_pair);
      } else {
        march(wa, own, jlo, jhi, px, pplane, plain, delta_pair);
      }
    }
    __syncthreads();
    corrections();
    __syncthreads();
    wall_pass(P);
    next(P);
  }

  // T >= 3's blocks: the chain's stages with the shell's levels, then the
  // last level and p' into the buffer h_{T-2} is not in, the overrides and
  // the walls.
  for (int blk = 0; tb >= 3 && blk < blocks; ++blk) {
    const float* hin = nullptr;
    for (int q = 0; q < tb; ++q) {
      float* hout = q % 2 == 0 ? wa : wb;
      if (q <= tb - 2) {
        if (active) {
          const auto put = [&](int, int c, const PairSums& p) { st2(hout + c, p.a(), p.b()); };
          if (q == 0) {
            march(P, own, jlo, jhi, px, pplane, plain, put);
          } else {
            march(hin, own, jlo, jhi, px, pplane, cop, put);
          }
        }
        shell(q + 1);
        next(hout);
        hin = hout;
        continue;
      }
      shell(tb);
      T* dst = (sizeof(T) == 4 && hin == wb) ? reinterpret_cast<T*>(wa) : P;
      if (active) {
        march(hin, own, jlo, jhi, px, pplane, cop, [&](int j, int c, const PairSums& p) {
          const int g = g_own + j * n2;
          const T va = st<T>(chain_value(x_at(j, ly, 0, g), k.aT, coef(c), p.a()));
          const T vb =
              has_b ? st<T>(chain_value(x_at(j, ly, 1, g + 1), k.aT, coef(c + 1), p.b())) : va;
          st2(dst + c, va, vb);
        });
      }
      __syncthreads();  // this tile's level T and its values, before the overrides
      overrides(dst);
      __syncthreads();
      wall_pass(dst);
      if (dst != P) {
        // A float32 solve: p' went to W0's region, and P's becomes W0 and W1.
        wa = reinterpret_cast<float*>(P);
        P = dst;
        wb = reinterpret_cast<float*>(P);
      }
      next(P);
    }
  }

  // The sweeps left over (K4: every sweep) into the other buffer: the
  // tiled solve's sweep at each column's clamped cell, with K4's terms (the
  // x face rule in the first sweep's x operands without a mask, a, the
  // frozen start with one, the faces' signs).
  for (int w = 0; w < left; ++w) {
    T* dst = reinterpret_cast<T*>(wa);
    if (active) {
      march(P, col, jlo, jhi, px, pplane, plain, [&](int j, int c, const PairSums& p) {
        const int g = g_col + j * n2;
        float xpa = p.xpa, xma = p.xma, xpb = p.xpb, xmb = p.xmb;
        if constexpr (GEN && !MASK) {
          const float fa = a.b == 1 ? -p.oa : p.oa, fb = a.b == 1 ? -p.ob : p.ob;
          if (gxa == n - 2) xpa = fa;
          if (gxa == 1) xma = fa;
          if (gxa + 1 == n - 2) xpb = fb;
          if (gxa + 1 == 1) xmb = fb;
        }
        T va = sweep_cell(j, 0, c, g, ((xpa + xma) + p.ysa) + p.zsa);
        T vb = has_b ? sweep_cell(j, 1, c + 1, g + 1, ((xpb + xmb) + p.ysb) + p.zsb) : va;
        if (wall_a) va = a.b == 1 ? st<T>(-ld(vb)) : vb;
        if (wall_b) vb = a.b == 1 ? st<T>(-ld(va)) : va;
        st2(dst + (j + 1) * pplane + own, va, vb);
      });
      z_walls(dst, a.b == 3);
    }
    wa = reinterpret_cast<float*>(P);
    P = dst;
    next(P);
  }

  if (active) {
    for (int j = jlo; j < jhi; ++j) {
      const int g = g_own + j * n2, i = (j + 1) * pplane + own;
      a.p[g] = P[i];
      if (has_b) a.p[g + 1] = P[i + 1];
    }
  }
}

template <typename T, typename S, bool MASK, bool GEN>
__global__ void __launch_bounds__(kBlockThreads, 1) block_tiled_kernel(BlockTiledArgs<T, S> a) {
  extern __shared__ __align__(16) unsigned char fs_tile_smem[];
  block_tile<T, S, MASK, false, GEN>(fs_tile_smem, a, blockIdx.x);
}

// K5's solve (a.blk.block >= 2, the projection's phase 1 included) or K4's
// sweeps (GEN) in one cooperative launch on `s` over the tiling t, which
// fills a's tiling, flags, faces and shape.  cudaErrorInvalidValue for a
// tiling block_shape refuses or missing scratch, else the launch's error
// (cudaErrorCooperativeLaunchTooLarge when the tiles cannot all be resident).
template <typename T, typename S, bool GEN>
cudaError_t block_tiled(BlockTiledArgs<T, S> a, const SolveTiles& t, cudaStream_t s) {
  const int tb = a.blk.block;
  const bool mask = a.mask != nullptr;
  size_t smem = 0;
  if (tb < (GEN ? 1 : 2) ||
      !block_shape(a.n, t.gx, t.gy, t.gz, sizeof(T), tb, mask, &a.shape, &a.x_chip, &smem) ||
      t.flags == nullptr || t.faces == nullptr || a.x0 == nullptr || a.p == nullptr ||
      (tb >= 2 && a.blk.x1 == nullptr) ||
      (tb >= 3 && (a.blk.s0 == nullptr || a.blk.s1 == nullptr)) || (GEN && a.x == nullptr) ||
      (!GEN && a.vel == nullptr)) {
    return cudaErrorInvalidValue;
  }
  a.gx = t.gx;
  a.gy = t.gy;
  a.gz = t.gz;
  a.flags = t.flags;
  a.faces = static_cast<float*>(t.faces);
  const void* kernel = mask ? (const void*)block_tiled_kernel<T, S, true, GEN>
                            : (const void*)block_tiled_kernel<T, S, false, GEN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(t.gx * t.gy * t.gz), tile_block(a.shape), params,
                                    smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

}  // namespace fsk
