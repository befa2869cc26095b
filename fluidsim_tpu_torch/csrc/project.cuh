// The pressure projection's phases, shared by K2 (project_advect.cu, which
// adds the density advection), K3 (project.cu) and K8 (full_step.cu, which
// runs their per-cell bodies in one launch):
//   1. divergence  -0.5*((dvx + dvy) + dvz) / n, rounded to the solve dtype;
//      the iterate starts at zero;
//   2. `iters` Jacobi sweeps  p <- round_sd((rhs + nbr(p)) * coef), with
//      nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and coef = inv6 = f32(1)/f32(6)
//      in fluid cells and 0 in solid ones (the TPU kernel's (1 - m)*inv6:
//      a solid cell holds +-0, its copy-through of the zero start), ping-ponging
//      two solve-dtype buffers; the b=0 faces hold after every sweep;
//   3. per component  v - (0.5*(p[+1] - p[-1]))*n  from the float32 upcast of
//      the final iterate (v itself in solid cells), the component's set_bnd
//      faces, the obstacle mirror when there is a mask, then * damp.
// Counterpart of fluidsim_tpu/pallas/resident.py::_project_body with
// _solve_loop; with a SolveBlock of T >= 2 (sweep_block.cuh, K5) the sweeps
// run in blocks of T, on float32 fields only, as the TPU kernel's x1 lives
// in its float32 pstag volume (the caller decides): on the tiles K5's tile
// program, else one launch a stage.  The velocity, the projected velocity and
// the pressure are in the storage type S (float32 or bfloat16: the TPU
// kernel's vbuf and pstag), the iterates and the rhs in the solve type T; the
// gradient's result is rounded to S before the faces, the mirror computes in
// float32 from the rounded neighbours and rounds again, and damp multiplies
// in S, as the TPU kernel does (resident.py:821, 864-893).  The divergence
// and gradient kernels also serve K7 (project_slab.cu), with float32
// buffers, no zero start (p0 null) and no pressure copy (p_out null).  With
// a SolveTiles (solve_tiled.cuh) phases 1 and 2 are one persistent launch
// that keeps the solve (K5's blocks too) in shared memory; without one, one
// launch per phase
// and per sweep, the launch boundary being the grid-wide barrier between
// sweeps.  Border cells recompute their interior cell (boundary.cuh), which
// is bitwise the TPU kernel's face writes, including its deferred x faces,
// so no sweep needs a separate faces pass.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>
#include <utility>

#include "boundary.cuh"
#include "solve_tiled.cuh"
#include "sweep_block.cuh"

namespace fsk {

// The phases' bodies at one cell, shared by the kernels below and by the
// whole-step kernel (full_step.cu), which loops over cells.  Plain pointers,
// as in advect.cuh.

// Phase 1: the rhs at cell k, and the zero start of the iterate when p0 is
// not null.
template <typename T, typename S>
__device__ __forceinline__ void divergence_cell(const S* vel, T* rhs, T* p0, int n,
                                                const Cell& k) {
  if (p0 != nullptr) p0[k.idx] = st<T>(0.0f);
  // The rhs is only ever read at interior cells; its faces hold zero.
  if (k.idx != k.c) {
    rhs[k.idx] = st<T>(0.0f);
    return;
  }
  rhs[k.idx] = st<T>(divergence_value(vel, n, k.idx));
}

// Phase 2: one Jacobi sweep at cell k (a border cell recomputes its
// interior cell, the b = 0 faces).
template <typename T, bool MASK>
__device__ __forceinline__ void sweep_cell(const T* src, const T* rhs, const uint8_t* mask,
                                           T* dst, int n, float inv6, const Cell& k) {
  const long long sn = n, plane = sn * sn, c = k.c;
  const float coef = (MASK && mask[c] != 0) ? 0.0f : inv6;
  const float xs = ld(src[c + 1]) + ld(src[c - 1]);
  const float ys = ld(src[c + sn]) + ld(src[c - sn]);
  const float zs = ld(src[c + plane]) + ld(src[c - plane]);
  dst[k.idx] = st<T>((ld(rhs[c]) + ((xs + ys) + zs)) * coef);
}

// Phase 3's value of one velocity component v at a cell whose pressure
// neighbours along that component's axis are p_hi and p_lo: the step (held
// where solid), negated across the component's wall, rounded to S, then
// * damp in S.  Shared with K7e (project_slab.cu).
template <typename S>
__device__ __forceinline__ S gradient_value(float v, float p_hi, float p_lo, float nf, bool solid,
                                            bool negate, float damp) {
  const float g = (0.5f * (p_hi - p_lo)) * nf;
  const float u = solid ? v : v - g;
  return st<S>(ld(st<S>(negate ? -u : u)) * damp);
}

// Phase 3 at cell k: the gradient step (held in solid cells) rounded to S,
// the faces, the pressure's copy in S when p_out is not null, then * damp in
// S (damp is a value of S).
template <typename T, typename S, bool MASK>
__device__ __forceinline__ void gradient_cell(const S* vel, const T* p, const uint8_t* mask,
                                              S* vel_out, S* p_out, int n, float damp,
                                              const Cell& k) {
  const long long sn = n, plane = sn * sn, vol = plane * sn, c = k.c;
  const float nf = float(n);
  if (p_out != nullptr) p_out[k.idx] = st<S>(ld(p[k.idx]));
  const bool solid = MASK && mask[c] != 0;
  const long long step[3] = {1, sn, plane};
  const bool negate[3] = {k.x != k.cx, k.y != k.cy, k.z != k.cz};
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    vel_out[comp * vol + k.idx] =
        gradient_value<S>(ld(vel[comp * vol + c]), ld(p[c + step[comp]]), ld(p[c - step[comp]]),
                          nf, solid, negate[comp], damp);
  }
}

// Internal linkage, as in boundary.cuh: K2 and K3 each get their own copy.
namespace {

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    divergence_kernel(const S* __restrict__ vel, T* __restrict__ rhs,
                      T* __restrict__ p0, int n) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  divergence_cell<T, S>(vel, rhs, p0, n, k);
}

template <typename T, bool MASK>
__global__ void __launch_bounds__(kThreads)
    jacobi_sweep_kernel(const T* __restrict__ src, const T* __restrict__ rhs,
                        const uint8_t* __restrict__ mask, T* __restrict__ dst, int n,
                        float inv6) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  sweep_cell<T, MASK>(src, rhs, mask, dst, n, inv6, k);
}

template <typename T, typename S, bool MASK>
__global__ void __launch_bounds__(kThreads)
    gradient_kernel(const S* __restrict__ vel, const T* __restrict__ p,
                    const uint8_t* __restrict__ mask, S* __restrict__ vel_out,
                    S* __restrict__ p_out, int n, float damp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  gradient_cell<T, S, MASK>(vel, p, mask, vel_out, p_out, n, damp, k);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(S* __restrict__ v, long long count, float s) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) v[i] = st<S>(ld(v[i]) * s);
}

// Phases 1-3 on `stream`; mask (one byte per cell, nonzero = solid) may be
// null.  With tiles phases 1 and 2 are one launch into pa: the tiled solve's
// (sequential sweeps) or, with blk, K5's tile program (solve_tiled.cuh:
// block_tile, which stores the rhs to rhs for its own use).  Returns the
// first cudaError_t.
template <typename T, typename S>
cudaError_t project_phases(const S* vel, const uint8_t* mask, S* vel_out, S* p_out, T* pa,
                           T* pb, T* rhs, int n, int iters, float damp, const SolveBlock* blk,
                           const SolveTiles* tiles, cudaStream_t s) {
  const dim3 grid = cell_grid(n), block = cell_block();
  const float inv6 = 1.0f / 6.0f;
  cudaError_t err;
  T* src = pa;
  T* dst = pb;
  int sweeps = iters;
  if (tiles != nullptr && blk != nullptr) {
    // K5 blocks float32 fields only (block_valid).
    if constexpr (std::is_same<S, float>::value) {
      const BlockTiledArgs<T, S> args{vel, nullptr, rhs, mask, pa, nullptr, nullptr, *blk, n,
                                      iters, 0, 0, 0, 0, 1.0f, inv6, TileShape{}, 0};
      if ((err = block_tiled<T, S, false>(args, *tiles, s)) != cudaSuccess) return err;
      sweeps = 0;
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (tiles != nullptr) {
    if ((err = solve_tiled<T, S>(vel, mask, pa, n, iters, *tiles, s)) != cudaSuccess) return err;
    sweeps = 0;
  } else {
    divergence_kernel<T, S><<<grid, block, 0, s>>>(vel, rhs, pa, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (tiles == nullptr && blk != nullptr && blk->block >= 2) {
    // K5 (sweep_block.cuh): iters / T blocks, then the sweeps left over.
    BlockPass<T> bp{nullptr, nullptr, rhs, mask, *blk, n};
    err = mask != nullptr ? block_precompute<T, true>(bp, s) : block_precompute<T, false>(bp, s);
    if (err != cudaSuccess) return err;
    for (int b = 0; b < iters / blk->block; ++b) {
      bp.src = src;
      bp.dst = dst;
      err = mask != nullptr ? block_step<T, true>(bp, s) : block_step<T, false>(bp, s);
      if (err != cudaSuccess) return err;
      std::swap(src, dst);
    }
    sweeps = iters % blk->block;
  }
  for (int it = 0; it < sweeps; ++it) {
    if (mask != nullptr) {
      jacobi_sweep_kernel<T, true><<<grid, block, 0, s>>>(src, rhs, mask, dst, n, inv6);
    } else {
      jacobi_sweep_kernel<T, false><<<grid, block, 0, s>>>(src, rhs, mask, dst, n, inv6);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    std::swap(src, dst);
  }
  if (mask == nullptr) {
    gradient_kernel<T, S, false><<<grid, block, 0, s>>>(vel, src, mask, vel_out, p_out, n,
                                                         damp);
    return cudaGetLastError();
  }
  // The mirror reads the post-face values of its neighbours, so it follows
  // the gradient as its own launch; damp comes after the mirror.
  gradient_kernel<T, S, true><<<grid, block, 0, s>>>(vel, src, mask, vel_out, p_out, n, 1.0f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mirror_obstacles_kernel<S><<<grid, block, 0, s>>>(vel_out, mask, n, Slab{n, 0}, 3, 1, 2, 3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (damp != 1.0f) {
    const long long count = 3LL * n * n * n;
    scale_kernel<S><<<flat_blocks(count), kThreads, 0, s>>>(vel_out, count, damp);
    err = cudaGetLastError();
  }
  return err;
}

// The entry points take the buffers as void*; this picks the solve type T
// (bfloat16 when solve_bf16, else float32) and the storage type S (bfloat16
// when field_bf16) and calls run(T*, S*) with null pointers of those types.
template <typename F>
cudaError_t with_dtypes(int solve_bf16, int field_bf16, F&& run) {
  using B = __nv_bfloat16;
  if (solve_bf16) {
    return field_bf16 ? run(static_cast<B*>(nullptr), static_cast<B*>(nullptr))
                      : run(static_cast<B*>(nullptr), static_cast<float*>(nullptr));
  }
  return field_bf16 ? run(static_cast<float*>(nullptr), static_cast<B*>(nullptr))
                    : run(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
}

}  // namespace

}  // namespace fsk
