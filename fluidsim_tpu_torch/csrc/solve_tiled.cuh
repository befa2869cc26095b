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

#include "boundary.cuh"

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
  return (-0.5f * ((dx + dy) + dz)) / float(n);
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

}  // namespace

}  // namespace fsk
