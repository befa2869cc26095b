// The Jacobi pass shared by K6 (jacobi.cu, the whole grid) and K10
// (jacobi_ext.cu, a halo-extended z-slab of the sharded step): L <= 3 sweeps
// x <- (x0 + a*nbr) * coef out of shared memory, streamed along z, with
// nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and corrected neighbour reads at
// the walls, and the set_bnd faces written once at the end.  jacobi.cu's
// header describes the design (the T-level wavefront, the ring slots, the
// signed copies of the x and y wall columns).
//
// The z extent is a Pass's nz planes.  The z walls sit at planes wall_lo and
// wall_hi, known only at run time: the corrected reads fire at wall_lo + 1
// and wall_hi - 1, and a position outside [0, nz) (the sharded step's
// NO_WALL) puts no wall on that side.  K6 is the closed case: nz = n, walls at
// 0 and n - 1, and only the planes between them are updated.  K10 is the open
// case: every plane in [0, nz) is updated (the wall planes and the ones past
// them too: nothing inside reads them, and the faces pass rewrites the wall
// planes), and the planes past the slab's ends read as zero at every level,
// so each sweep erodes one plane of validity from each open edge.  coef is
// inv_c, or with a mask 0 in solid cells (the pressure solve's coefficient
// volume, the TPU kernel's where(obst, 0, 1/c)).
#pragma once

#include <cuda_runtime.h>

#include "boundary.cuh"

namespace fsk {
namespace {

constexpr int kWX = 32, kWY = 32, kPlaneW = kWX * kWY;
constexpr int kChunkZ = 64;
constexpr int kX0Ring = 8;         // planes of x0 kept: 2T + 1 <= 8
constexpr int kBlockIters = 3;     // sweeps a launch: 2T + 1 <= kX0Ring;
                                   // three beat one and two at 256^3 (PERF.md)

// Shared memory of a pass of L levels: four planes for each level below
// the last, and kX0Ring planes of x0.
constexpr size_t pass_smem(int levels) {
  return (4 * levels + kX0Ring) * kPlaneW * sizeof(float);
}

// One pass's operands: x and x0 (nz, n, n) in, out written; mask one byte a
// cell (nonzero = solid) or null, read only by an open pass; chunk the planes
// a block owns; halo the window's margin in x, y and z (>= L).  An open pass
// stores only the planes [keep_lo, keep_hi] of out (K12's last pass: the
// shard's own planes, for its neighbours write the rest).
struct Pass {
  const float *x, *x0;
  const uint8_t* mask;
  float* out;
  int n, nz, b;
  float a, inv_c;
  int halo, chunk, wall_lo, wall_hi;
  int keep_lo = 0, keep_hi = 1 << 30;
};

// One pass: L (<= halo) sweeps of this block's tile, whose window starts
// `halo` cells before the tile in x, y and z, over its z-range.  Writes the
// tile's updated cells of `out`; its wall faces are left as they were.  OPEN
// selects the slab rules above (K10); closed is K6, whose code is the same
// without the mask and the zero planes.
template <int L, bool OPEN>
__global__ void __launch_bounds__(kPlaneW, 2) jacobi_pass_kernel(const Pass q) {
  // Level t's ring (t = 0: the input) is planes 4t .. 4t+3 of smem, plane p
  // in slot (p - zlo) % 4; x0's ring follows, plane p in slot
  // (p - zlo) % kX0Ring.  When plane z arrives, level t computes plane
  // z - 2t: its three planes of level t - 1 were all written in earlier
  // steps, so the levels of one step are independent and need one barrier
  // between steps, not one per level.  The steps are unrolled by
  // kX0Ring, so every ring slot is a constant offset.
  extern __shared__ float smem[];
  const float* __restrict__ const x = q.x;
  const float* __restrict__ const x0 = q.x0;
  const int n = q.n, nz = q.nz, halo = q.halo;
  const float* const x0ring = smem + 4 * L * kPlaneW;
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int gx = blockIdx.x * (kWX - 2 * halo) - halo + lx;
  const int gy = blockIdx.y * (kWY - 2 * halo) - halo + ly;
  const int zs = blockIdx.z * q.chunk;
  const int ze = min(zs + q.chunk, nz);
  const int zlo = zs - halo, zhi = ze + halo - 1;
  const bool in_grid = gx >= 0 && gx < n && gy >= 0 && gy < n;
  // A column on an x or y wall holds, at every level, the signed copy of
  // its clamped interior column (boundary.cuh), so interior cells read
  // their x and y neighbours plainly: the thread of a wall column loads
  // and updates its interior column's cell and stores it with the sign.
  const int cx = in_grid ? clamp_interior(gx, n) : gx;
  const int cy = in_grid ? clamp_interior(gy, n) : gy;
  const int own = ly * kWX + lx;
  const int at = own + (cy - gy) * kWX + (cx - gx);
  const float sgn = face_negates(q.b, 0, gy, gx, 0, cy, cx) ? -1.0f : 1.0f;
  // Level t is valid in this column while t <= depth (the distance of the
  // cell it updates from the window's edge).
  const int ax = lx + cx - gx, ay = ly + cy - gy;
  const int depth = in_grid ? min(min(ax, kWX - 1 - ax), min(ay, kWY - 1 - ay)) : -1;
  const bool writes = cx == gx && cy == gy && lx >= halo && lx < kWX - halo && ly >= halo &&
                      ly < kWY - halo;
  const long long sn = n, plane = sn * sn;
  const long long col = in_grid ? gy * sn + gx : 0, ccol = in_grid ? cy * sn + cx : 0;
  const float sz = q.b == 3 ? -1.0f : 1.0f;
  // The planes a level updates: all of the slab when open, else those
  // strictly between the walls.
  const int plo = OPEN ? 0 : 1, phi = OPEN ? nz - 1 : nz - 2;

  // The loaded column's x (signed) and x0 in plane p; zero outside the
  // slab and the range.
  auto load = [&](int p, float& vx, float& vx0) {
    vx = vx0 = 0.0f;
    if (in_grid && p >= 0 && p < nz && p <= zhi) {
      vx = sgn * x[p * plane + ccol];
      vx0 = x0[p * plane + ccol];
    }
  };
  // Planes z + 1 and z + 2 are in flight while the levels sweep.
  float cur_x, cur_x0, next_x, next_x0;
  load(zlo, cur_x, cur_x0);
  load(zlo + 1, next_x, next_x0);
  const int zend = zhi + L;
  for (int z0 = zlo; z0 <= zend; z0 += kX0Ring) {
#pragma unroll
    for (int j = 0; j < kX0Ring; ++j) {
      const int z = z0 + j, k = z - zlo;  // k % kX0Ring == j
      if (z > zend) break;
      smem[(j & 3) * kPlaneW + own] = cur_x;
      smem[(4 * L + j) * kPlaneW + own] = cur_x0;
      cur_x = next_x;
      cur_x0 = next_x0;
      load(z + 2, next_x, next_x0);
#pragma unroll
      for (int t = 1; t <= L; ++t) {
        // Level t updates plane p = z - 2t, valid from zlo + t to zhi - t.
        const int p = z - 2 * t;
        if (t <= depth && k >= 3 * t && p <= zhi - t) {
          if (p >= plo && p <= phi) {
            const float* const lvl = smem + 4 * (t - 1) * kPlaneW + at;
            const float* const mid = lvl + ((j - 2 * t) & 3) * kPlaneW;
            const float v = mid[0];
            float above = lvl[((j - 2 * t + 1) & 3) * kPlaneW];
            float below = lvl[((j - 2 * t - 1) & 3) * kPlaneW];
            if (p == q.wall_hi - 1) above = sz * v;
            if (p == q.wall_lo + 1) below = sz * v;
            const float nbr = ((mid[1] + mid[-1]) + (mid[kWX] + mid[-kWX])) + (above + below);
            const float coef =
                OPEN && q.mask != nullptr && q.mask[p * plane + ccol] != 0 ? 0.0f : q.inv_c;
            const float u =
                (x0ring[((j - 2 * t) & (kX0Ring - 1)) * kPlaneW + own] + q.a * nbr) * coef;
            if (t < L) {
              smem[(4 * t + ((j - 2 * t) & 3)) * kPlaneW + own] = sgn * u;
            } else if (writes && p >= zs && p < ze &&
                       (!OPEN || (p >= q.keep_lo && p <= q.keep_hi))) {
              q.out[p * plane + col] = u;
            }
          } else if (OPEN && t < L && (p < 0 || p >= nz)) {
            // Past an end of the slab: zero at every level.
            smem[(4 * t + ((j - 2 * t) & 3)) * kPlaneW + own] = 0.0f;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <int L, bool OPEN>
cudaError_t launch_pass(const Pass& q, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_pass_kernel<L, OPEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pass_smem(L)));
  if (err != cudaSuccess) return err;
  const int tile = kWX - 2 * q.halo;
  const dim3 grid((q.n + tile - 1) / tile, (q.n + tile - 1) / tile,
                  (q.nz + q.chunk - 1) / q.chunk);
  jacobi_pass_kernel<L, OPEN><<<grid, dim3(kWX, kWY), pass_smem(L), s>>>(q);
  return cudaGetLastError();
}

// launch_pass<L, OPEN> for L = 1 .. kBlockIters (a last pass may run fewer).
static_assert(kBlockIters == 3, "launch_levels instantiates L = 1, 2, 3");
template <bool OPEN>
cudaError_t launch_levels(int levels, const Pass& q, cudaStream_t s) {
  switch (levels) {
    case 1:
      return launch_pass<1, OPEN>(q, s);
    case 2:
      return launch_pass<2, OPEN>(q, s);
    default:
      return launch_pass<3, OPEN>(q, s);
  }
}

// `iters` sweeps in passes of up to kBlockIters, chained through out and tmp
// (the last pass writes out; tmp may be null for one pass).  q.x is the
// input, q.out is ignored; q's keep range applies to the last pass only.
// With `spare` (K12, whose out the neighbours write into) the earlier passes
// alternate through tmp and spare and never write out.  Returns the first
// cudaError_t.
template <bool OPEN>
cudaError_t run_passes(Pass q, float* out, float* tmp, int iters, cudaStream_t s,
                       float* spare = nullptr) {
  const int passes = (iters + kBlockIters - 1) / kBlockIters;
  const int keep_lo = q.keep_lo, keep_hi = q.keep_hi;
  int remaining = iters;
  for (int pass = 0; pass < passes; ++pass) {
    // The last pass writes `out`; earlier ones alternate back from it.
    const int back = passes - 1 - pass;
    if (spare == nullptr) {
      q.out = back % 2 == 0 ? out : tmp;
    } else {
      q.out = back == 0 ? out : (back % 2 == 1 ? tmp : spare);
    }
    if (q.out == nullptr) return cudaErrorInvalidValue;
    q.keep_lo = back == 0 ? keep_lo : 0;
    q.keep_hi = back == 0 ? keep_hi : q.nz - 1;
    const int sweeps = remaining < kBlockIters ? remaining : kBlockIters;
    const cudaError_t err = launch_levels<OPEN>(sweeps, q, s);
    if (err != cudaSuccess) return err;
    q.x = q.out;
    remaining -= sweeps;
  }
  return cudaSuccess;
}

// set_bnd_3d(b) in place on the (nz, n, n) v with its z walls at planes
// wall_lo and wall_hi (none where outside [0, nz)): every border cell becomes
// the signed copy of its clamped interior cell (boundary.cuh), the z clamp
// moving a wall plane one plane inwards.  blockIdx.z picks the wall (0, 1: z;
// 2, 3: y; 4, 5: x); a cell on an edge or a corner is written by each of its
// walls with the same value.  Reads only interior cells, writes only border
// cells, and only in the planes [keep_lo, keep_hi].
__global__ void faces_kernel(float* __restrict__ v, int n, int nz, int b, int wall_lo,
                             int wall_hi, int keep_lo, int keep_hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const bool high = blockIdx.z & 1;
  int x = i, y = j, z = high ? wall_hi : wall_lo;
  if (blockIdx.z >= 4) {
    x = high ? n - 1 : 0;
    y = i;
    z = j;
  } else if (blockIdx.z >= 2) {
    y = high ? n - 1 : 0;
    z = j;
  }
  if (i >= n || y >= n || z < 0 || z >= nz || z < keep_lo || z > keep_hi) return;
  const int cx = clamp_interior(x, n), cy = clamp_interior(y, n);
  const int cz = z == wall_lo ? wall_lo + 1 : (z == wall_hi ? wall_hi - 1 : z);
  const long long sn = n;
  const float u = v[(cz * sn + cy) * sn + cx];
  v[(z * sn + y) * sn + x] = face_negates(b, z, y, x, cz, cy, cx) ? -u : u;
}

cudaError_t launch_faces(float* v, int n, int nz, int b, int wall_lo, int wall_hi,
                         cudaStream_t s, int keep_lo = 0, int keep_hi = 1 << 30) {
  const int rows = nz > n ? nz : n;
  faces_kernel<<<dim3((n + 31) / 32, (rows + 7) / 8, 6), dim3(32, 8), 0, s>>>(
      v, n, nz, b, wall_lo, wall_hi, keep_lo, keep_hi);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsk
