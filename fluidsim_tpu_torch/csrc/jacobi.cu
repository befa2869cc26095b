// K6: the temporally blocked Jacobi solve of a general (b, x, x0, a, c):
// `iters` sweeps  x <- (x0 + a*nbr) * inv_c  on the interior cells, with
// nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and inv_c = f32(1)/f32(c), then
// the set_bnd_3d(b) faces once.  Each sweep uses corrected neighbour reads:
// an interior cell next to a wall reads s*itself (s = -1 across the wall
// normal to field code b, else +1), which is the value set_bnd would have
// written there, so no wall face in device memory is written between
// sweeps.  The faces of the input are never read, which makes the TPU
// kernel's normalising set_bnd_3d(b, x) on the input implicit.
//
// Replaces: fluidsim_tpu/pallas/jacobi.py::_jacobi_kernel (entry
// jacobi_3d_pallas), the slab route the JAX package takes when three volumes
// do not fit on chip.  The TPU kernel's z-slabs and y-tiles (_pick_block,
// pick_blocking, tile_geometry) are not carried over.
//
// What bounds it on an H100: bytes.  One sweep over a 256^3 float32 grid
// streams the iterate, x0 and the next iterate, 201 MB, which does not fit
// the 50 MB L2, so a sweep per launch costs at least 60 us from HBM.  The
// solve's compulsory traffic is x and x0 in and the result out, once.
//
// What the design does about it: each launch runs up to T = kBlockIters
// sweeps out of shared memory, streaming the grid along z.  A block owns a
// (32-2T) x (32-2T) tile of x-y columns and a z-range of 64 planes; it
// reads a 32 x 32 window (the tile plus a T-deep halo) of x and x0 one
// plane at a time, from T planes below its range to T planes above, and
// keeps four planes of every intermediate sweep level in shared memory.
// When plane z arrives, level t computes its plane z-2t from level t-1's
// planes z-2t-1 .. z-2t+1, all written in earlier steps, so the T levels
// advance as a wavefront two planes behind each other and a step needs one
// barrier: each thread has T independent updates between barriers.  Level
// T's planes inside the tile are written out.  After t sweeps only the
// cells at least t from a window edge are valid (a global wall closes the
// stencil and invalidates nothing), so level t computes only those; the
// tile, T from every edge, is valid at level T.  The loads of the next two
// planes are in flight while a step sweeps.  ceil(iters/T) launches chain
// through two global buffers; a last, partial pass runs the remaining
// sweeps; a last launch writes the faces.
//
// The corrected reads cost no instructions in x and y: a thread whose
// column lies on an x or y wall loads and updates its clamped interior
// column's cell and stores it with the wall's sign, so the wall columns
// of every level hold exactly what the corrected reads would give and
// interior cells read their neighbours plainly (boundary.cuh's signed
// copy).  In z the test is uniform across the block.  The steps are
// unrolled by eight, so every ring slot is a constant offset; x0's ring
// holds eight planes, which allows T <= 3, and T = 3 is used.  HBM
// traffic per pass is x and x0 over windows (32/(32-2T))^2 the tile in x-y
// and (64+2T)/64 the range in z, and the result once: at T = 3 about 4.3
// volumes per three sweeps instead of 3 per sweep.  T = 3 takes 20 planes
// (80 KB) of shared memory, so two blocks of 1024 threads run on each SM.
// It is still bound by instruction issue rather than bytes (about 30
// instructions per cell update by a count of the source, for 8
// operations); keeping each column's z neighbours in registers is the
// next step.
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

// One pass: L (<= halo) sweeps of this block's tile, whose window starts
// `halo` cells before the tile in x and y, over its z-range.  Writes the
// tile's interior cells of `out`; its wall faces are left as they were.
template <int L>
__global__ void __launch_bounds__(kPlaneW, 2)
    jacobi_pass_kernel(const float* __restrict__ x, const float* __restrict__ x0,
                       float* __restrict__ out, int n, int b, float a, float inv_c, int halo) {
  // Level t's ring (t = 0: the input) is planes 4t .. 4t+3 of smem, plane p
  // in slot (p - zlo) % 4; x0's ring follows, plane p in slot
  // (p - zlo) % kX0Ring.  When plane z arrives, level t computes plane
  // z - 2t: its three planes of level t - 1 were all written in earlier
  // steps, so the levels of one step are independent and need one barrier
  // between steps, not one per level.  The steps are unrolled by
  // kX0Ring, so every ring slot is a constant offset.
  extern __shared__ float smem[];
  const float* const x0ring = smem + 4 * L * kPlaneW;
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int gx = blockIdx.x * (kWX - 2 * halo) - halo + lx;
  const int gy = blockIdx.y * (kWY - 2 * halo) - halo + ly;
  const int zs = blockIdx.z * kChunkZ;
  const int ze = min(zs + kChunkZ, n);
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
  const float sgn = face_negates(b, 0, gy, gx, 0, cy, cx) ? -1.0f : 1.0f;
  // Level t is valid in this column while t <= depth (the distance of the
  // cell it updates from the window's edge).
  const int ax = lx + cx - gx, ay = ly + cy - gy;
  const int depth = in_grid ? min(min(ax, kWX - 1 - ax), min(ay, kWY - 1 - ay)) : -1;
  const bool writes = cx == gx && cy == gy && lx >= halo && lx < kWX - halo && ly >= halo &&
                      ly < kWY - halo;
  const long long sn = n, plane = sn * sn;
  const long long col = in_grid ? gy * sn + gx : 0, ccol = in_grid ? cy * sn + cx : 0;
  const float sz = b == 3 ? -1.0f : 1.0f;

  // The loaded column's x (signed) and x0 in plane p; zero outside the
  // grid and the range.
  auto load = [&](int p, float& vx, float& vx0) {
    vx = vx0 = 0.0f;
    if (in_grid && p >= 0 && p < n && p <= zhi) {
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
        if (t <= depth && k >= 3 * t && p <= zhi - t && p >= 1 && p <= n - 2) {
          const float* const lvl = smem + 4 * (t - 1) * kPlaneW + at;
          const float* const mid = lvl + ((j - 2 * t) & 3) * kPlaneW;
          const float v = mid[0];
          float above = lvl[((j - 2 * t + 1) & 3) * kPlaneW];
          float below = lvl[((j - 2 * t - 1) & 3) * kPlaneW];
          if (p == n - 2) above = sz * v;
          if (p == 1) below = sz * v;
          const float nbr = ((mid[1] + mid[-1]) + (mid[kWX] + mid[-kWX])) + (above + below);
          const float u = (x0ring[((j - 2 * t) & (kX0Ring - 1)) * kPlaneW + own] + a * nbr) * inv_c;
          if (t < L) {
            smem[(4 * t + ((j - 2 * t) & 3)) * kPlaneW + own] = sgn * u;
          } else if (writes && p >= zs && p < ze) {
            out[p * plane + col] = u;
          }
        }
      }
      __syncthreads();
    }
  }
}

struct Pass {
  const float *x, *x0;
  float* out;
  int n, b;
  float a, inv_c;
  int halo;
};

template <int L>
cudaError_t launch_pass(const Pass& q, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_pass_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pass_smem(L)));
  if (err != cudaSuccess) return err;
  const int tile = kWX - 2 * q.halo;
  const dim3 grid((q.n + tile - 1) / tile, (q.n + tile - 1) / tile,
                  (q.n + kChunkZ - 1) / kChunkZ);
  jacobi_pass_kernel<L><<<grid, dim3(kWX, kWY), pass_smem(L), s>>>(q.x, q.x0, q.out, q.n, q.b,
                                                                   q.a, q.inv_c, q.halo);
  return cudaGetLastError();
}

// launch_pass<L> for L = 1 .. kBlockIters (a last pass may run fewer).
constexpr cudaError_t (*kLaunchPass[])(const Pass&, cudaStream_t) = {
    launch_pass<1>, launch_pass<2>, launch_pass<3>};
static_assert(sizeof(kLaunchPass) / sizeof(kLaunchPass[0]) == kBlockIters);

// set_bnd_3d(b) in place: every border cell becomes the signed copy of its
// clamped interior cell (boundary.cuh).  blockIdx.z picks the wall (0, 1: z;
// 2, 3: y; 4, 5: x); a cell on an edge or a corner is written by each of its
// walls with the same value.  Reads only interior cells, writes only border
// cells.
__global__ void faces_kernel(float* __restrict__ v, int n, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n || j >= n) return;
  const int wall = (blockIdx.z & 1) ? n - 1 : 0;
  int x = i, y = j, z = wall;
  if (blockIdx.z >= 4) {
    x = wall;
    y = i;
    z = j;
  } else if (blockIdx.z >= 2) {
    y = wall;
    z = j;
  }
  const int cx = clamp_interior(x, n), cy = clamp_interior(y, n), cz = clamp_interior(z, n);
  const long long sn = n;
  const float u = v[(cz * sn + cy) * sn + cx];
  v[(z * sn + y) * sn + x] = face_negates(b, z, y, x, cz, cy, cx) ? -u : u;
}

}  // namespace
}  // namespace fsk

// x, x0, out and tmp (n, n, n) float32 (tmp is scratch), all contiguous on
// the current device, out and tmp distinct from x and x0.  b in 0..3 is the
// field's set_bnd code, a and inv_c = f32(1)/f32(c) the solve's
// coefficients, iters >= 1.  Launches every pass of up to kBlockIters sweeps
// and the faces on `stream` and returns the first cudaError_t.
extern "C" int fs_jacobi(const float* x, const float* x0, float* out, float* tmp, int n, int b,
                         float a, float inv_c, int iters, void* stream) {
  using namespace fsk;
  if (n < 3 || b < 0 || b > 3 || iters < 1 || tmp == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = (iters + kBlockIters - 1) / kBlockIters;
  Pass q{x, x0, nullptr, n, b, a, inv_c, kBlockIters};
  int remaining = iters;
  for (int pass = 0; pass < passes; ++pass) {
    // The last pass writes `out`; earlier ones alternate back from it.
    q.out = (passes - 1 - pass) % 2 == 0 ? out : tmp;
    const int sweeps = remaining < kBlockIters ? remaining : kBlockIters;
    const cudaError_t err = kLaunchPass[sweeps - 1](q, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    q.x = q.out;
    remaining -= sweeps;
  }
  faces_kernel<<<dim3((n + 31) / 32, (n + 7) / 8, 6), dim3(32, 8), 0, s>>>(out, n, b);
  return static_cast<int>(cudaGetLastError());
}
