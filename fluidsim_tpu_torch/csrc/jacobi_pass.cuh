// The Jacobi round shared by K6 (jacobi.cu, the whole grid) and K10 / K12
// (jacobi_ext.cu, a halo-extended z-slab of the sharded step): L <= 4 sweeps
// x <- (x0 + a*nbr) * coef in one launch, streamed along z, with
// nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and corrected neighbour reads at
// the walls; the last pass also stores the set_bnd faces and, for K12, the
// shard's edge planes into its neighbours' outputs.
//
// The z extent is a Round's nz planes.  The z walls sit at planes wall_lo and
// wall_hi, known only at run time: the corrected reads fire at wall_lo + 1
// and wall_hi - 1, and a position outside [0, nz) (the sharded step's
// NO_WALL) puts no wall on that side.  Every plane in [0, nz) is updated (the
// wall planes and the ones past them too: nothing inside reads them, and the
// faces overwrite the wall planes), and the planes past the slab's ends read
// as zero at every level, so each sweep erodes one plane of validity from each
// open edge.  K6 is the case nz = n with the walls at 0 and n - 1, whose
// interior planes never read a wall plane or a plane past it.  coef is inv_c,
// or with a mask 0 in solid cells (the pressure solve's coefficient volume,
// the TPU kernel's where(obst, 0, 1/c)).
//
// The design, for an H100.  A block of kThreads threads (one an SM: 32 warps,
// 64 registers a thread) owns a tile of kTileX x (kWY - 2L) columns and a
// z-range; it streams a window of kWX x kWY columns (the tile, 4 columns of
// margin in x and L rows in y, 1.37x the tile at L = 4) from L planes below
// its range to L planes above.  The slab is cut into as many z-ranges as
// fill the card with the tiles (sharded512's slabs and 512^3: one).  Thread
// (tx, ty) keeps the columns (tx, ty + kThreadsY * k), k < kRows.
//
// - Level t (t = 1 .. L) updates plane z - t when input plane z arrives: its
//   z neighbours are level t - 1's planes z - t - 1 (kept in a register from
//   the step before) and z - t + 1 (just computed by the same thread), so the
//   z neighbours never leave registers.  Only the plane a level updates passes
//   through shared memory, for the x and y neighbours, in two buffers a level
//   by step parity: one barrier a step.  x0 and the mask bits of the column
//   travel with the wavefront in registers.  The last level's plane goes to
//   global memory.
// - Input planes of x, x0 and the mask are copied two to five planes ahead
//   (as many as the shared memory holds) into rings in shared memory with
//   cp.async (16 bytes a thread where n % 4 == 0 and the pointers allow; the
//   zero fill gives the zeros past the slab's ends).  A thread on an x or y wall then writes the signed copy of its
//   clamped interior column into the staged plane, and at every level it
//   updates the clamped column's cell and stores it with the wall's sign
//   (boundary.cuh), so interior cells read their neighbours plainly.
// - The last level stores the faces: the thread of an interior cell stores
//   its signed copies on the x and y walls it touches and, at planes
//   wall_lo + 1 and wall_hi - 1, on the z wall planes (the TPU kernel's
//   z -> y -> x face order gives every border cell the signed copy of its
//   clamped cell).  With a keep range (K12) it stores only the shard's planes
//   [keep_lo, keep_hi] of out, pushes the planes [keep_lo, keep_lo + h) and
//   (keep_hi - h, keep_hi] into the neighbours' outputs lz planes up and
//   down, and zeroes its own planes outside the keep range where there is no
//   neighbour (a global end).
// - Offsets are 32-bit: the entry points refuse nz * n^2 >= 2^31.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "boundary.cuh"

namespace fsk {
namespace {

constexpr int kWX = 64, kWY = 48, kPlaneW = kWX * kWY;  // the window
constexpr int kHX = 4, kTileX = kWX - 2 * kHX;          // x margin: 16-byte rows
constexpr int kMaxLevels = 4;                           // sweeps a launch
constexpr int kThreadsX = kWX, kThreadsY = 16, kThreads = kThreadsX * kThreadsY;
constexpr int kRows = kWY / kThreadsY;                  // columns a thread
constexpr int kMinChunk = 8;                            // planes a block owns, at least
constexpr int kMinBlocks = 1;                           // blocks an SM
// Shared memory a block may take so that kMinBlocks run on an SM (228 KB,
// 1 KB of it reserved a block).
constexpr int kSmemBudget = 233472 / kMinBlocks - 1024;

static_assert(kThreadsX == kWX && kWY % kThreadsY == 0, "a thread keeps whole rows");
static_assert(kMaxLevels <= kHX, "the x margin covers every level");
static_assert(kThreadsY >= kMaxLevels, "rows 1 .. kRows - 2 stay inside the window");
static_assert(kRows * kMaxLevels <= 32, "a mask bit a row and level in one word");

// Bit kMaxLevels * k of a mask-bit word for every row k: a row's newest plane.
constexpr uint32_t low_bits() {
  uint32_t bits = 0;
  for (int k = 0; k < kRows; ++k) bits |= 1u << (kMaxLevels * k);
  return bits;
}
constexpr uint32_t kLowBits = low_bits();

// Shared memory of a round of L levels copying `ahead` planes ahead: x's
// ring (ahead + 2 planes: level 1 reads plane z - 1), x0's (ahead + 1), two
// planes for each level below the last, and the mask's ring (as x0's).
__host__ __device__ constexpr int round_smem(int levels, bool masked, int ahead) {
  return (2 * ahead + 3 + 2 * (levels - 1)) * kPlaneW * 4 + (masked ? (ahead + 1) * kPlaneW : 0);
}

// Planes copied ahead: as many as leave room for kMinBlocks blocks an SM
// (at least two, at most five).
__host__ __device__ constexpr int round_ahead(int levels, bool masked) {
  int ahead = 2;
  while (ahead < 5 && round_smem(levels, masked, ahead + 1) <= kSmemBudget) ++ahead;
  return ahead;
}

// One pass: x and x0 (nz, n, n) in, out written; mask one byte a cell
// (nonzero = solid) or null; chunk the planes a block owns (launch_round's).
// Without faces (an earlier pass of a chain) every interior cell of every
// plane is stored plainly.  With faces the last pass stores the result as set out above:
// planes [keep_lo, keep_hi] of out, the edge pushes of depth h into out_lo
// and out_hi (lz planes away; null: none, and zeros in the own halo).
struct Round {
  const float *x, *x0;
  const uint8_t* mask;
  float *out, *out_lo, *out_hi;
  int n, nz, b, chunk, wall_lo, wall_hi;
  float a, inv_c;
  int faces, vec, keep_lo, keep_hi, h, lz;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) from src, or zeros when !ok.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool ok) {
  const int size = ok ? BYTES : 0;
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(size)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(size)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A final value v of plane p at flat index i (plane p's offset included):
// stored where the keep range says, pushed to the neighbours, or zeroed.
__device__ __forceinline__ void put(const Round& q, int p, int i, float v) {
  if (p >= q.keep_lo && p <= q.keep_hi) {
    q.out[i] = v;
    const int shift = q.lz * q.n * q.n;
    if (q.out_lo != nullptr && p < q.keep_lo + q.h) q.out_lo[i + shift] = v;
    if (q.out_hi != nullptr && p > q.keep_hi - q.h) q.out_hi[i - shift] = v;
  } else if ((p < q.keep_lo ? q.out_lo : q.out_hi) == nullptr) {
    q.out[i] = 0.0f;
  }
}

// The interior cell (p, y, x) at flat index i and its signed copies on the x
// and y walls it touches, y before x (the TPU kernel's face order).
__device__ __forceinline__ void put_cell(const Round& q, int p, int i, int y, int x, float sy,
                                         float sx, float v) {
  const int n = q.n;
  put(q, p, i, v);
  if (x == 1) put(q, p, i - 1, sx * v);
  if (x == n - 2) put(q, p, i + 1, sx * v);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (y != (side == 0 ? 1 : n - 2)) continue;
    const int j = side == 0 ? i - n : i + n;
    const float w = sy * v;
    put(q, p, j, w);
    if (x == 1) put(q, p, j - 1, sx * w);
    if (x == n - 2) put(q, p, j + 1, sx * w);
  }
}

// One pass of L sweeps over this block's tile and z-range (q.chunk planes).
// Launched by launch_round, which picks the chunk.
template <int L, bool MASKED>
__global__ void __launch_bounds__(kThreads, kMinBlocks) jacobi_round_kernel(const Round q) {
  constexpr int kAhead = round_ahead(L, MASKED);
  constexpr int kXRing = kAhead + 2, kX0Ring = kAhead + 1;
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                              // kXRing planes of x
  float* const x0s = xs + kXRing * kPlaneW;            // kX0Ring planes of x0
  float* const lv = x0s + kX0Ring * kPlaneW;           // levels 1 .. L-1, by parity
  uint8_t* const ms = reinterpret_cast<uint8_t*>(lv + 2 * (L - 1) * kPlaneW);

  const int n = q.n, nz = q.nz, plane = n * n;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kThreadsX + tx;
  const int gx0 = blockIdx.x * kTileX - kHX;
  const int gy0 = blockIdx.y * (kWY - 2 * L) - L;
  const int zs = blockIdx.z * q.chunk;
  const int ze = min(zs + q.chunk, nz);
  const int zlo = zs - L, zhi = ze + L - 1;
  const float sx = q.b == 1 ? -1.0f : 1.0f, sy = q.b == 2 ? -1.0f : 1.0f;
  const float sz = q.b == 3 ? -1.0f : 1.0f;

  // Copies plane p (p <= zhi) into ring slots (slot_x, slot_0); zeros past
  // the slab's ends and outside the grid.
  auto stage = [&](int p, int slot_x, int slot_0) {
    float* const rx = xs + slot_x * kPlaneW;
    float* const r0 = x0s + slot_0 * kPlaneW;
    uint8_t* const rm = ms + slot_0 * kPlaneW;
    const bool in_slab = p >= 0 && p < nz;
    const int base = in_slab ? p * plane : 0;
    if (q.vec) {
      // 16-byte chunks: four columns; rows of kWX / 4 chunks.
#pragma unroll
      for (int r = 0; r < (kPlaneW / 4 + kThreads - 1) / kThreads; ++r) {
        const int c = tid + r * kThreads;
        if (kPlaneW / 4 % kThreads != 0 && c >= kPlaneW / 4) break;
        const int row = c / (kWX / 4), col = (c % (kWX / 4)) * 4;
        const int cy = gy0 + row, cx = gx0 + col;
        const bool ok = in_slab && cy >= 0 && cy < n && cx >= 0 && cx < n;
        const int g = ok ? base + cy * n + cx : 0;
        copy_async<16>(rx + row * kWX + col, q.x + g, ok);
        copy_async<16>(r0 + row * kWX + col, q.x0 + g, ok);
        if (MASKED) copy_async<4>(rm + row * kWX + col, q.mask + g, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < (kPlaneW + kThreads - 1) / kThreads; ++r) {
        const int e = tid + r * kThreads;
        if (kPlaneW % kThreads != 0 && e >= kPlaneW) break;
        const int row = e / kWX, col = e % kWX;
        const int cy = gy0 + row, cx = gx0 + col;
        const bool ok = in_slab && cy >= 0 && cy < n && cx >= 0 && cx < n;
        const int g = ok ? base + cy * n + cx : 0;
        copy_async<4>(rx + e, q.x + g, ok);
        copy_async<4>(r0 + e, q.x0 + g, ok);
        if (MASKED) rm[e] = ok ? q.mask[g] : 0;
      }
    }
  };

  // This thread's column x and its rows' y (row k at ly = ty + kThreadsY * k).
  // A column on a wall reads and updates its clamped interior column (at);
  // rows outside the grid are not clamped.  Rows 1 .. kRows - 2 lie kThreadsY
  // or more rows from the window's edge, so their neighbour reads stay in the
  // plane whatever they compute; the edge rows compute a level only while it
  // is valid (warp-uniform, as ty is).
  const int gx = gx0 + tx;
  const bool x_in = gx >= 0 && gx < n;
  const int dx = x_in ? clamp_interior(gx, n) - gx : 0;
  const bool x_tile = tx >= kHX && tx < kWX - kHX && x_in && dx == 0;
  const int own0 = ty * kWX + tx;
  int at[kRows];
  uint32_t neg = 0, store_rows = 0;  // bit k: row k's wall sign is -1; row k stores
  int depth_lo, depth_hi;  // the valid levels of rows 0 and kRows - 1
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int ly = ty + kThreadsY * k, gy = gy0 + ly;
    const bool y_in = gy >= 0 && gy < n;
    const int dy = y_in ? clamp_interior(gy, n) - gy : 0;
    at[k] = own0 + kThreadsY * kWX * k + dy * kWX + dx;
    if ((q.b == 1 && dx != 0) || (q.b == 2 && dy != 0)) neg |= 1u << k;
    if (x_tile && y_in && dy == 0 && ly >= L && ly < kWY - L) store_rows |= 1u << k;
    const int cly = ly + dy;
    if (k == 0) depth_lo = y_in ? min(cly, kWY - 1 - cly) : 0;
    if (k == kRows - 1) depth_hi = y_in ? min(cly, kWY - 1 - cly) : 0;
  }

  float below[kRows][L];  // level t-1 at plane z-t-1 of the clamped column
  float x0c[kRows][L];    // x0 at planes z-1 .. z-L
  uint32_t mbits = 0;     // bit kMaxLevels * k + j: row k solid at plane z-1-j
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int t = 0; t < L; ++t) below[k][t] = x0c[k][t] = 0.0f;
  }

#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    stage(zlo + j, j, j);
    copy_commit();
  }
  int sx_now = 0, s0_now = 0;  // ring slots of plane z
  for (int z = zlo; z <= zhi; ++z) {
    copy_wait<kAhead - 1>();
    __syncthreads();
    {
      const int ax = sx_now + kAhead, a0 = s0_now + kAhead;
      if (z + kAhead <= zhi) {
        stage(z + kAhead, ax >= kXRing ? ax - kXRing : ax, a0 >= kX0Ring ? a0 - kX0Ring : a0);
      }
      copy_commit();
    }
    float* const x_now = xs + sx_now * kPlaneW;
    const float* const x_prev = xs + (sx_now == 0 ? kXRing - 1 : sx_now - 1) * kPlaneW;
    const float* const x0_now = x0s + s0_now * kPlaneW;
    const uint8_t* const m_now = ms + s0_now * kPlaneW;
    const int par = z & 1;

    // Level 0: plane z, the wall columns' signed copies into the staged plane.
    float fresh[kRows], x0_new[kRows];
    uint32_t m_new = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int own = own0 + kThreadsY * kWX * k;
      fresh[k] = x_now[at[k]];
      if (at[k] != own) x_now[own] = (neg >> k) & 1u ? -fresh[k] : fresh[k];
      x0_new[k] = x0_now[at[k]];
      if (MASKED && m_now[at[k]] != 0) m_new |= 1u << (kMaxLevels * k);
    }
    // Level t updates plane z - t, every row at once so that the rows'
    // chains interleave.
#pragma unroll
    for (int t = 1; t <= L; ++t) {
      const int p = z - t;
      if (p < 0 || p >= nz) {  // past an end of the slab: zero at every level
#pragma unroll
        for (int k = 0; k < kRows; ++k) below[k][t - 1] = fresh[k] = 0.0f;
        continue;
      }
      const float* const src = t == 1 ? x_prev : lv + (2 * (t - 2) + (par ^ 1)) * kPlaneW;
      float* const dst = lv + (2 * (t - 1) + par) * kPlaneW;
      const bool at_hi = p == q.wall_hi - 1, at_lo = p == q.wall_lo + 1;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if ((k == 0 && t > depth_lo) || (k == kRows - 1 && t > depth_hi)) continue;
        const float* const c = src + at[k];
        const float mid = c[0];
        const float above = at_hi ? sz * mid : fresh[k];
        const float under = at_lo ? sz * mid : below[k][t - 1];
        const float nbr = ((c[1] + c[-1]) + (c[kWX] + c[-kWX])) + (above + under);
        const float coef =
            MASKED && ((mbits >> (kMaxLevels * k + t - 1)) & 1u) ? 0.0f : q.inv_c;
        const float u = (x0c[k][t - 1] + q.a * nbr) * coef;
        below[k][t - 1] = mid;
        fresh[k] = u;
        if (t < L) dst[own0 + kThreadsY * kWX * k] = (neg >> k) & 1u ? -u : u;
      }
      if (t == L && p >= zs && p < ze) {
        // The last level: every interior cell of the tile, with the faces
        // and pushes where the plane or the cell calls for them.  A plain
        // store: no z face at or next to p, no push, no x or y face.
        const bool plane_plain =
            p != q.wall_lo && p != q.wall_hi && p != q.wall_lo + 1 && p != q.wall_hi - 1 &&
            p >= q.keep_lo + q.h && p <= q.keep_hi - q.h;
        const bool x_face = gx == 1 || gx == n - 2;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (!((store_rows >> k) & 1u)) continue;
          const int gy = gy0 + ty + kThreadsY * k;
          const int i = p * plane + gy * n + gx;
          const float u = fresh[k];
          if (!q.faces || (plane_plain && !x_face && gy != 1 && gy != n - 2)) {
            q.out[i] = u;
            continue;
          }
          if (p != q.wall_lo && p != q.wall_hi) put_cell(q, p, i, gy, gx, sy, sx, u);
          if (p == q.wall_lo + 1) put_cell(q, p - 1, i - plane, gy, gx, sy, sx, sz * u);
          if (p == q.wall_hi - 1) put_cell(q, p + 1, i + plane, gy, gx, sy, sx, sz * u);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int t = L - 1; t > 0; --t) x0c[k][t] = x0c[k][t - 1];
      x0c[k][0] = x0_new[k];
    }
    if (MASKED) mbits = ((mbits << 1) & ~kLowBits) | m_new;
    sx_now = sx_now + 1 == kXRing ? 0 : sx_now + 1;
    s0_now = s0_now + 1 == kX0Ring ? 0 : s0_now + 1;
  }
  copy_wait<0>();
}

template <int L, bool MASKED>
cudaError_t launch_round(const Round& q, cudaStream_t s) {
  const int bytes = round_smem(L, MASKED, round_ahead(L, MASKED));
  // The attributes once a device (bit d of `set`): they cost host time a call.
  static unsigned set = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 32 || !((set >> device) & 1u)) {
    err = cudaFuncSetAttribute(jacobi_round_kernel<L, MASKED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(jacobi_round_kernel<L, MASKED>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < 32) set |= 1u << device;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The z-chunks: as many as fill the card's blocks with the x-y tiles
  // (one chunk where the tiles alone fill it), each of kMinChunk planes or
  // more.
  const int tile_y = kWY - 2 * L;
  const int tiles = ((q.n + kTileX - 1) / kTileX) * ((q.n + tile_y - 1) / tile_y);
  const int fill = sms * kMinBlocks / tiles, most = q.nz / kMinChunk;
  const int chunks = fill < 1 || most < 1 ? 1 : (fill < most ? fill : most);
  Round r = q;
  r.chunk = (q.nz + chunks - 1) / chunks;
  const dim3 grid((q.n + kTileX - 1) / kTileX, (q.n + tile_y - 1) / tile_y,
                  (q.nz + r.chunk - 1) / r.chunk);
  jacobi_round_kernel<L, MASKED><<<grid, dim3(kThreadsX, kThreadsY), bytes, s>>>(r);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch_levels(int levels, const Round& q, cudaStream_t s) {
  static_assert(kMaxLevels == 4, "launch_levels instantiates L = 1 .. 4");
  switch (levels) {
    case 1:
      return launch_round<1, MASKED>(q, s);
    case 2:
      return launch_round<2, MASKED>(q, s);
    case 3:
      return launch_round<3, MASKED>(q, s);
    default:
      return launch_round<4, MASKED>(q, s);
  }
}

// True when nz * n^2 fits the kernel's 32-bit offsets.
inline bool offsets_fit(int nz, int n) {
  return static_cast<long long>(nz) * n * n < (1LL << 31);
}

// The passes of `iters` sweeps: ceil(iters / kMaxLevels) launches, the sweeps
// spread evenly over them.  q.x is the input and q's keep range and pushes
// apply to the last pass, which writes `out` and the faces; earlier passes
// write every plane, without faces, alternating back from out through tmp
// or, with `spare` (K12, whose out the neighbours write into), through tmp
// and spare and never out.  Returns the first cudaError_t.
inline cudaError_t run_rounds(Round q, float* out, float* tmp, float* spare, int iters,
                              cudaStream_t s) {
  const int passes = (iters + kMaxLevels - 1) / kMaxLevels;
  const int keep_lo = q.keep_lo, keep_hi = q.keep_hi;
  float* const out_lo = q.out_lo;
  float* const out_hi = q.out_hi;
  const uintptr_t align = reinterpret_cast<uintptr_t>(q.x) | reinterpret_cast<uintptr_t>(q.x0) |
                          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(tmp) |
                          reinterpret_cast<uintptr_t>(spare);
  const uintptr_t mask_align = reinterpret_cast<uintptr_t>(q.mask);
  q.vec = q.n % 4 == 0 && (align & 15) == 0 && (mask_align & 3) == 0;
  int remaining = iters;
  for (int pass = 0; pass < passes; ++pass) {
    const int back = passes - 1 - pass;
    if (spare == nullptr) {
      q.out = back % 2 == 0 ? out : tmp;
    } else {
      q.out = back == 0 ? out : (back % 2 == 1 ? tmp : spare);
    }
    if (q.out == nullptr) return cudaErrorInvalidValue;
    q.faces = back == 0;
    q.keep_lo = back == 0 ? keep_lo : 0;
    q.keep_hi = back == 0 ? keep_hi : q.nz - 1;
    q.out_lo = back == 0 ? out_lo : nullptr;
    q.out_hi = back == 0 ? out_hi : nullptr;
    const int levels = (remaining + back) / (back + 1);
    const cudaError_t err = q.mask != nullptr ? launch_levels<true>(levels, q, s)
                                              : launch_levels<false>(levels, q, s);
    if (err != cudaSuccess) return err;
    q.x = q.out;
    remaining -= levels;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace fsk
