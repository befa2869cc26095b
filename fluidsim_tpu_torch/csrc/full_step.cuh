// K8's kernel templates (see full_step.cu): the whole step of an
// obstacle-free config in one cooperative launch, for a solve type T, a
// storage type S and a window of K cells (kWinAny: FullStepArgs::window >=
// 4, advect.cuh's runtime-K body), on one of two routes: the tiled solve's
// tiles (full_step_tiled_kernel) or a grid-stride grid with a grid barrier
// a sweep (full_step_kernel).  Without the density phase (DENS false) it is
// K14, the self-advection and the projection in one launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "advect.cuh"
#include "project.cuh"

namespace fsk {

struct FullStepArgs {
  const void* vel;   // (3, n, n, n) in, S
  const void* dens;  // (n, n, n) in, S
  void* adv;         // (3, n, n, n) scratch, S
  void* vel_out;     // (3, n, n, n) out, S
  void* p_out;       // (n, n, n) out, S
  void* dens_out;    // (n, n, n) out, S
  void *pa, *pb, *rhs;  // (n, n, n) solve scratch, T (the tiled route: pa only)
  float *tmp0, *tmp1;   // (3, n, n, n) float32 scratch (bfloat16 fields only)
  int n, iters, n_sub;
  float dt0_sub, damp, dens_damp;
  int window;
};

// K8 on float32 fields (full_step.cu) and on bfloat16 fields
// (full_step_bf16.cu), for a bfloat16 solve when solve_bf16 and a window of
// K >= 1 (4 and more: a.window): *blocks gets the cooperative grid (the
// tiled route: the tiles; the grid-stride route: every block the card holds
// at once), and with launch the kernel is launched on `s` as well.  tiles
// is the tiled solve's tiling and scratch (the tiled route) or null (the
// grid-stride route); blk is K5's block and scratch (blk.block 1:
// sequential sweeps), on either route.
cudaError_t full_step_f32(const FullStepArgs& a, const SolveBlock& blk, const SolveTiles* tiles,
                          int solve_bf16, int window, bool launch, int* blocks, cudaStream_t s);
cudaError_t full_step_bf16(const FullStepArgs& a, const SolveBlock& blk, const SolveTiles* tiles,
                           int solve_bf16, int window, bool launch, int* blocks, cudaStream_t s);
// K14 (float32 fields and solve, no density phase) for a window of K >= 1,
// on the route of tiles as K8's.
cudaError_t advect_project_f32(const FullStepArgs& a, const SolveTiles* tiles, int window,
                               bool launch, int* blocks, cudaStream_t s);

namespace {

namespace cg = cooperative_groups;

// Blocks per SM the grid-stride kernel asks the compiler to fit (registers
// <= 64).
constexpr int kFullStepMinBlocks = 4;

// The buffer that substep `sub` of `n_sub` writes (sub = -1: the input
// `in`, which substep 0 reads).  The last writes `out`; float32 (WIDE): the
// earlier ones alternate back from it through `other`; bfloat16: they write
// float32 into tmp0 and tmp1 in turn.  Each substep's source and target are
// functions of its index.  With the source carried from one substep to the
// next in a Substep (s.src = s.dst after the barrier), the build with
// SolveBlock inside FullStepArgs ran every substep from `in`, whatever the
// grid size or register cap (H100, tools/torch_k8_args_probe.py).
template <bool WIDE>
__device__ __forceinline__ void* substep_buf(int sub, int n_sub, const void* in, void* out,
                                             void* other, float* tmp0, float* tmp1) {
  if (sub < 0) return const_cast<void*>(in);
  if (WIDE) return (n_sub - 1 - sub) % 2 == 0 ? out : other;
  if (sub == n_sub - 1) return out;
  return sub % 2 == 0 ? tmp0 : tmp1;
}

// Phase 1 over the grid's threads (first, stride; two cells a loop trip,
// advect_pair): the self-advection, the last substep writing adv.
// float32: the earlier ones alternate back from it through vel_out;
// bfloat16: they write float32 into tmp0 and tmp1 in turn.  One grid
// barrier after each substep.
template <typename S, int K>
__device__ __forceinline__ void self_advect_phase(const FullStepArgs& a, cg::grid_group& grid,
                                                  int first, int stride) {
  constexpr bool wide = std::is_same<S, float>::value;
  const int n = a.n, vol = n * n * n;
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep s{substep_buf<wide>(sub - 1, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    a.vel, nullptr, nullptr, nullptr,
                    substep_buf<wide>(sub, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    n, Slab{n, 0}, 1, 2, 3, a.dt0_sub, 1.0f, Buoyancy{}, a.window};
    for (int i = first; i < vol; i += 2 * stride) {
      const bool two = i + stride < vol;
      advect_pair_role<3, K, false, S>(s, cell_at(n, i), cell_at(n, two ? i + stride : i), two,
                                       sub == 0, last);
    }
    grid.sync();
  }
}

// Phase 4: the gradient from the final iterate p, the faces and damp.
template <typename T, typename S>
__device__ __forceinline__ void gradient_phase(const FullStepArgs& a, const T* p, int first,
                                               int stride) {
  const int n = a.n, vol = n * n * n;
  for (int i = first; i < vol; i += stride) {
    gradient_cell<T, S, false>(static_cast<const S*>(a.adv), p, nullptr,
                               static_cast<S*>(a.vel_out), static_cast<S*>(a.p_out), n, a.damp,
                               cell_at(n, i));
  }
}

// Phase 5 (two cells a loop trip): the density, the last substep writing
// dens_out.  float32: the earlier ones alternate back from it through adv's
// first volume; bfloat16: they write float32 into tmp0 and tmp1 in turn.  A
// grid barrier between substeps.
template <typename S, int K>
__device__ __forceinline__ void density_phase(const FullStepArgs& a, cg::grid_group& grid,
                                              int first, int stride) {
  constexpr bool wide = std::is_same<S, float>::value;
  const int n = a.n, vol = n * n * n;
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep d{
        substep_buf<wide>(sub - 1, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        a.vel_out, nullptr, nullptr, nullptr,
        substep_buf<wide>(sub, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        n, Slab{n, 0}, 0, 0, 0, a.dt0_sub, last ? a.dens_damp : 1.0f, Buoyancy{}, a.window};
    for (int i = first; i < vol; i += 2 * stride) {
      const bool two = i + stride < vol;
      advect_pair_role<1, K, false, S>(d, cell_at(n, i), cell_at(n, two ? i + stride : i), two,
                                       sub == 0, last);
    }
    if (!last) grid.sync();
  }
}

// The grid-stride route: every phase a grid-stride loop over the cells of
// a grid as large as the card holds at once, the solve's sweeps (and K5's
// stages) separated by grid barriers.  It serves the grids no tiling fits
// (for K5's block, block_shape's).
template <typename T, typename S, int K, bool DENS>
__global__ void __launch_bounds__(kThreads, kFullStepMinBlocks)
    full_step_kernel(const FullStepArgs a, const SolveBlock blk) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int vol = n * n * n;
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection into adv.
  self_advect_phase<S, K>(a, grid, first, stride);

  // 2. Divergence and the zero start.
  const S* adv = static_cast<const S*>(a.adv);
  T* rhs = static_cast<T*>(a.rhs);
  for (int i = first; i < vol; i += stride) {
    divergence_cell<T, S>(adv, rhs, static_cast<T*>(a.pa), n, cell_at(n, i));
  }
  grid.sync();

  // 3. The sweeps: K5's blocks of T first where blk asks for them
  //    (sweep_block.cuh, each stage a grid-stride loop), then the sweeps
  //    left over one by one.
  const float inv6 = 1.0f / 6.0f;
  T* src = static_cast<T*>(a.pa);
  T* dst = static_cast<T*>(a.pb);
  int sweeps = a.iters;
  const int tb = blk.block;
  if (tb >= 2) {
    BlockPass<T> bp{nullptr, nullptr, rhs, nullptr, blk, n};
    for (int stage = 0; stage < pre_stages(tb); ++stage) {
      for (int i = first; i < vol; i += stride) pre_stage_item<T, false>(bp, stage, i);
      grid.sync();
    }
    for (int b = 0; b < a.iters / tb; ++b) {
      bp.src = src;
      bp.dst = dst;
      for (int stage = 0; stage < block_stages(tb); ++stage) {
        const long long items = block_stage_items(n, tb, stage);
        for (long long it = first; it < items; it += stride) {
          block_stage_item<T, false>(bp, stage, it);
        }
        grid.sync();
      }
      T* t = src;
      src = dst;
      dst = t;
    }
    sweeps = a.iters % tb;
  }
  for (int it = 0; it < sweeps; ++it) {
    for (int i = first; i < vol; i += stride) {
      sweep_cell<T, false>(src, rhs, nullptr, dst, n, inv6, cell_at(n, i));
    }
    grid.sync();
    T* t = src;
    src = dst;
    dst = t;
  }

  // 4. Gradient, faces, damp.
  gradient_phase<T, S>(a, src, first, stride);
  if (!DENS) return;
  grid.sync();

  // 5. Density into dens_out.
  density_phase<S, K>(a, grid, first, stride);
}

// The tiled route: one block a tile of the tiled solve (solve_tiled.cuh),
// one an SM, of kTileThreads threads (BLOCK, K5's program: kBlockThreads;
// hx x my x as many as fit: more than the tile's solve takes where the tile
// is small).  The advection phases
// and the gradient are grid-stride loops over every thread of the tiles'
// blocks (walking a block's own tile instead ran slower on an H100);
// between the self-advection and the gradient each block runs the tiled
// solve of its tile (divergence of adv, every sweep in its shared memory,
// the final iterate stored to t.p = pa; with K5's block, kb.blk.block >= 2,
// K5's tile program block_tile on float32 fields), which synchronises a
// tile with its face neighbours only: no grid barrier inside the solve.
// Grid barriers: one a self-advection substep, one after the solve, one
// before the density and one between density substeps.
template <typename T, typename S, int K, bool DENS, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? kBlockThreads : kTileThreads, 1)
    full_step_tiled_kernel(const FullStepArgs a, const TiledArgs<T, S> t,
                           const BlockTiledArgs<T, S> kb) {
  extern __shared__ __align__(16) unsigned char fs_tile_smem[];
  cg::grid_group grid = cg::this_grid();
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection into adv (a barrier after each substep orders adv
  //    before the divergence reads it).
  self_advect_phase<S, K>(a, grid, first, stride);

  // 2-3. Divergence and every sweep of this block's tile, into pa (BLOCK:
  //      K5's program, an instantiation of its own so that the sequential
  //      one keeps its registers).
  if constexpr (BLOCK) {
    block_tile<T, S, false, true, false>(fs_tile_smem, kb, blockIdx.x);
  } else {
    solve_tile<T, S, false, true>(fs_tile_smem, t, blockIdx.x);
  }
  grid.sync();

  // 4. Gradient, faces, damp.
  gradient_phase<T, S>(a, t.p, first, stride);
  if (!DENS) return;
  grid.sync();

  // 5. Density into dens_out.
  density_phase<S, K>(a, grid, first, stride);
}

template <typename T, typename S, int K, bool DENS = true>
cudaError_t full_step_run(const FullStepArgs& a, const SolveBlock& blk, bool launch,
                          int* blocks, cudaStream_t s) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, full_step_kernel<T, S, K, DENS>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (!launch) return cudaSuccess;
  FullStepArgs args = a;
  SolveBlock block = blk;
  void* params[] = {&args, &block};
  err = cudaLaunchCooperativeKernel((const void*)full_step_kernel<T, S, K, DENS>, dim3(*blocks),
                                    dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tiled route's launch over the tiling `tiles` (every tile's block
// resident at once, or cudaErrorCooperativeLaunchTooLarge): *blocks gets
// the tile count, and with launch the kernel is launched on `s` as well.
// With K5's block (blk.block >= 2, float32 fields) the tiles run K5's tile
// program, with its shared memory.  cudaErrorInvalidValue for a tiling the
// tiled solve (tile_shape) or K5's program (block_shape) cannot take or,
// with launch, without its flags and faces (K5: its rhs, x1 and shell
// scratch).
template <typename T, typename S, int K, bool DENS = true>
cudaError_t full_step_tiled_run(const FullStepArgs& a, const SolveBlock& blk,
                                const SolveTiles& tiles, bool launch, int* blocks,
                                cudaStream_t s) {
  TileShape shape;
  size_t smem = 0;
  int x_chip = 0;
  const bool blocked = blk.block >= 2;
  if (blocked) {
    if (!(std::is_same<S, float>::value && DENS) ||
        !block_shape(a.n, tiles.gx, tiles.gy, tiles.gz, sizeof(T), blk.block, false, &shape,
                     &x_chip, &smem) ||
        (launch && (a.rhs == nullptr || blk.x1 == nullptr ||
                    (blk.block >= 3 && (blk.s0 == nullptr || blk.s1 == nullptr))))) {
      return cudaErrorInvalidValue;
    }
  } else {
    if (!tile_shape(a.n, tiles.gx, tiles.gy, tiles.gz, sizeof(T), &shape)) {
      return cudaErrorInvalidValue;
    }
    smem = shape.smem;
  }
  if (launch && (tiles.flags == nullptr || tiles.faces == nullptr)) return cudaErrorInvalidValue;
  constexpr bool kBlocks = std::is_same<S, float>::value && DENS;  // K5 blocks float32 fields
  const void* kernel = blocked ? (const void*)full_step_tiled_kernel<T, S, K, DENS, kBlocks>
                               : (const void*)full_step_tiled_kernel<T, S, K, DENS, false>;
  // The tile's block, grown along z to kTileThreads threads (K5's program:
  // kBlockThreads) for the advection phases (the solve leaves threads
  // lz >= split idle).
  const int threads = blocked ? kBlockThreads : kTileThreads;
  const dim3 block(shape.hx, shape.my, threads / (shape.hx * shape.my));
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, static_cast<int>(block.x * block.y * block.z), smem);
  }
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int count = tiles.gx * tiles.gy * tiles.gz;
  if (per_sm * sms < count) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = count;
  if (!launch) return cudaSuccess;
  FullStepArgs args = a;
  TiledArgs<T, S> targs{static_cast<const S*>(a.adv), nullptr, static_cast<T*>(a.pa),
                        tiles.flags, static_cast<T*>(tiles.faces), a.n, a.iters,
                        tiles.gx, tiles.gy, tiles.gz, shape};
  BlockTiledArgs<T, S> kargs{static_cast<const S*>(a.adv), nullptr, static_cast<T*>(a.rhs),
                             nullptr, static_cast<T*>(a.pa), tiles.flags,
                             static_cast<float*>(tiles.faces), blk, a.n, a.iters, tiles.gx,
                             tiles.gy, tiles.gz, 0, 1.0f, 1.0f / 6.0f, shape, x_chip};
  void* params[] = {&args, &targs, &kargs};
  err = cudaLaunchCooperativeKernel(kernel, dim3(count), block, params, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One route for the solve type T: the tiled one where tiles is not null
// (with K5's block too), else the grid-stride one.
template <typename T, typename S, int K, bool DENS>
cudaError_t full_step_route(const FullStepArgs& a, const SolveBlock& blk,
                            const SolveTiles* tiles, bool launch, int* blocks, cudaStream_t s) {
  if (tiles == nullptr) return full_step_run<T, S, K, DENS>(a, blk, launch, blocks, s);
  return full_step_tiled_run<T, S, K, DENS>(a, blk, *tiles, launch, blocks, s);
}

// full_step_route for the storage type S and the density phase DENS (false:
// K14), dispatched over the solve type and the window (every window >= 4 to
// the runtime-K instantiation, which reads a.window).  K14 is float32
// throughout, so only its float32 solve is instantiated.
template <typename S, bool DENS = true>
cudaError_t full_step_dispatch(const FullStepArgs& a, const SolveBlock& blk,
                               const SolveTiles* tiles, int solve_bf16, int window, bool launch,
                               int* blocks, cudaStream_t s) {
  using B = typename std::conditional<DENS, __nv_bfloat16, float>::type;
  if (!DENS && solve_bf16) return cudaErrorInvalidValue;
  if (window >= 4) {
    if (a.window != window) return cudaErrorInvalidValue;
    return solve_bf16 ? full_step_route<B, S, kWinAny, DENS>(a, blk, tiles, launch, blocks, s)
                      : full_step_route<float, S, kWinAny, DENS>(a, blk, tiles, launch, blocks, s);
  }
  switch (window * 2 + (solve_bf16 ? 1 : 0)) {
    case 2: return full_step_route<float, S, 1, DENS>(a, blk, tiles, launch, blocks, s);
    case 3: return full_step_route<B, S, 1, DENS>(a, blk, tiles, launch, blocks, s);
    case 4: return full_step_route<float, S, 2, DENS>(a, blk, tiles, launch, blocks, s);
    case 5: return full_step_route<B, S, 2, DENS>(a, blk, tiles, launch, blocks, s);
    case 6: return full_step_route<float, S, 3, DENS>(a, blk, tiles, launch, blocks, s);
    case 7: return full_step_route<B, S, 3, DENS>(a, blk, tiles, launch, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace fsk
