// K4: the whole-volume Jacobi solve of a general (b, x, x0, a, c) from a
// given start x: `iters` sweeps  x <- (x0 + a*nbr) * inv_c  (x0 + nbr when
// a == 1), with nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and
// inv_c = f32(1)/f32(c), and the set_bnd_3d(b) faces after every sweep.
// With an obstacle mask (b = 0 only) the sweep is
//   x <- rhs * ((1 - m) * inv_c) + m * x_init,   m = 1.0 in solid cells,
// which holds every solid cell at its start value (the copy-through of the
// reference's skip rule) and decides the sign of a zero exactly as the TPU
// kernel's `coef` and `frozen` volumes do.
//
// Replaces: fluidsim_tpu/pallas/resident.py::_jacobi_kernel (no mask) and
// ::_jacobi_obst_kernel (mask), entry jacobi_3d_resident, solve _solve_loop;
// without a mask and with blk (b = 0), the sweeps run in K5's blocks
// (sweep_block.cuh) and the iters % T left over one by one.  Without a mask
// the TPU sweep substitutes the x face rule into its x operands
// (_nbr_sum_selx: an interior cell next to an x wall reads sx * itself) and
// writes the x faces once at the end; with a mask it reads the maintained
// faces.  The two agree from the second sweep on; the first reads the given
// start, so this kernel copies each variant's reads: the substitution
// without a mask, the given x faces with one.
//
// Two routes, decided by the caller before the launch
// (kernels/jacobi.k4_tiles):
//   - tiled: where kernels/resident.solve_tiles finds a float32 tiling for
//     the solve (to 128^3), the whole solve is one persistent launch of the
//     tile program of K5 and K4 (solve_tiled.cuh: block_tile; K4's
//     sequential sweeps with the rhs on chip and the frozen start's mask
//     bits in registers, or K5's blocks);
//   - per sweep (resident_sweep_kernel below): one launch a sweep (a stage
//     of K5's block), one thread a cell, elsewhere.
//
// What bounds it on an H100: each sweep reads the iterate (six neighbours),
// x0 (and the mask byte and x_init) and writes the next iterate.  At 64^3
// and 128^3 the float32 iterates and x0 stay in the 50 MB L2; per sweep the
// per-sweep route pays a launch and an L2 pass, the tiled route a pass over
// shared memory and a face trade with its neighbours.  The compulsory DRAM
// traffic of the call is x, x0 (and the mask) in and the result out, once.
//
// What the design does about it: the tiled route keeps the iterate and the
// rhs on chip for all sweeps; on the per-sweep route border cells recompute
// their interior cell and store it with the face sign (boundary.cuh), which
// is bitwise the TPU kernel's z->y->x face writes, deferred x faces
// included, so no sweep needs a separate faces pass, and two buffers
// ping-pong (the output and one scratch), so the start is never written.
#include <cuda_runtime.h>

#include "boundary.cuh"
#include "solve_tiled.cuh"
#include "sweep_block.cuh"

namespace fsk {
namespace {

template <bool MASK>
__global__ void __launch_bounds__(kThreads)
    resident_sweep_kernel(const float* __restrict__ src, const float* __restrict__ x0,
                          const float* __restrict__ x_init, const uint8_t* __restrict__ mask,
                          float* __restrict__ dst, int n, int b, float a, int a_is_one,
                          float inv_c) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  const long long sn = n, plane = sn * sn, c = k.c;
  float xs;
  if (MASK) {
    xs = src[c + 1] + src[c - 1];
  } else {
    const float own = src[c];
    const float face = b == 1 ? -own : own;
    const float hi = k.cx == n - 2 ? face : src[c + 1];
    const float lo = k.cx == 1 ? face : src[c - 1];
    xs = hi + lo;
  }
  const float ys = src[c + sn] + src[c - sn];
  const float zs = src[c + plane] + src[c - plane];
  const float nbr = (xs + ys) + zs;
  const float rhs = x0[c] + (a_is_one ? nbr : a * nbr);
  float u;
  if (MASK) {
    const float m = mask[c] != 0 ? 1.0f : 0.0f;
    u = rhs * ((1.0f - m) * inv_c) + m * x_init[c];
  } else {
    u = rhs * inv_c;
  }
  dst[k.idx] = face_negates(b, k.z, k.y, k.x, k.cz, k.cy, k.cx) ? -u : u;
}

}  // namespace
}  // namespace fsk

// x, x0 (n, n, n) in; mask (n, n, n) one byte per cell (nonzero = solid) or
// null (with a mask b must be 0); out (n, n, n) out and tmp (n, n, n)
// scratch (the per-sweep route, iters > 1); all float32 apart from the
// mask, contiguous, on the current device; a = f32(a), inv_c = f32(1)/f32(c).
// blk is null (sequential sweeps) or K5's block and scratch (no mask, b = 0;
// see block_valid).  tiles is null (the per-sweep route) or the tiling,
// flags and float32 face slots of the tiled route (solve_tiled.cuh).
// Launches the solve on `stream` without synchronising and returns the
// first cudaError_t (cudaErrorInvalidValue for a tiling block_shape
// refuses).
extern "C" int fs_jacobi_resident(const float* x, const float* x0, const unsigned char* mask,
                                  float* out, float* tmp, int n, int b, float a, float inv_c,
                                  int iters, const fsk::SolveBlock* blk,
                                  const fsk::SolveTiles* tiles, void* stream) {
  using namespace fsk;
  if (n < 3 || b < 0 || b > 3 || iters < 1 || (mask != nullptr && b != 0) ||
      (tiles == nullptr && iters > 1 && tmp == nullptr) ||
      (blk != nullptr &&
       (mask != nullptr || b != 0 || !block_valid(blk, n, iters, 0, tiles != nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles != nullptr) {
    const BlockTiledArgs<float, float> args{nullptr, x, const_cast<float*>(x0), mask, out,
                                            nullptr, nullptr, blk != nullptr ? *blk : SolveBlock{1},
                                            n, iters, 0, 0, 0, b, a, inv_c, TileShape{}, 0};
    return static_cast<int>(block_tiled<float, float, true>(args, *tiles, s));
  }
  const dim3 grid = cell_grid(n), block = cell_block();
  const int a_is_one = a == 1.0f;
  const float* src = x;
  // Each block and each sweep writes one iterate: the last writes `out`,
  // earlier ones alternate back from it.
  const int blocks = blk != nullptr ? iters / blk->block : 0;
  const int sweeps = blk != nullptr ? iters % blk->block : iters;
  const int writes = blocks + sweeps;
  if (blocks > 0) {
    BlockPass<float> bp{nullptr, nullptr, x0, nullptr, *blk, n};
    cudaError_t err = block_precompute<float, false>(bp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int w = 0; w < blocks; ++w) {
      bp.src = src;
      bp.dst = (writes - 1 - w) % 2 == 0 ? out : tmp;
      if ((err = block_step<float, false>(bp, s)) != cudaSuccess) return static_cast<int>(err);
      src = bp.dst;
    }
  }
  for (int it = 0; it < sweeps; ++it) {
    float* dst = (writes - 1 - blocks - it) % 2 == 0 ? out : tmp;
    if (mask != nullptr) {
      resident_sweep_kernel<true><<<grid, block, 0, s>>>(src, x0, x, mask, dst, n, b, a,
                                                         a_is_one, inv_c);
    } else {
      resident_sweep_kernel<false><<<grid, block, 0, s>>>(src, x0, x, mask, dst, n, b, a,
                                                          a_is_one, inv_c);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaSuccess);
}
