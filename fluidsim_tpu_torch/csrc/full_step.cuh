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
  int* votes;  // K >= 2: kVoteInts ints of scratch (the vote below); else unread
};

// The vote of the advection phases at a window K >= 2.  A cell of a substep
// takes the <= 8-tap sum (advect.cuh's advect_cell_eight) where every value
// of the substep's source is finite and its displacement is not NaN, else
// the full (2K+1)^3 sum, so that a field with a non-finite value stays
// bitwise the twin (advect_window.cuh says why the two sums agree on finite
// windows).  The sources are voted on whole: the inputs in one pass before
// the first substep (vote_inputs: a.vel, and a.dens for the density phase),
// and each substep's result by the threads that store it (advect_put's
// return).  A block ANDs its threads' votes (__syncthreads_and) into a slot
// of its own; after the grid barrier that ends the phase every block ANDs
// all blocks' slots (votes_hold).  Slots: kVoteVel, kVoteDens, then the
// substeps' results by parity (kVoteSubstep + (sub & 1)): substep s writes
// its parity's slots while s + 1 reads the other's, and a barrier lies
// between a slot's readers and its next writer.  Every slot read in a launch
// was written earlier in it, so nothing is reset, nothing carries over from
// another launch, and the host reads nothing.  votes: [0] the grid's block
// count, then kVoteCounts unsigned ints a block (the cells the advection
// phases summed by 8 taps and by the full sum, for the route counts,
// kernels/resident.tap_routes), then kVoteSets slots a block.
constexpr int kVoteMaxBlocks = 2048;
constexpr int kVoteCounts = 2;
constexpr int kVoteSets = 4;
constexpr int kVoteInts = 1 + (kVoteCounts + kVoteSets) * kVoteMaxBlocks;
constexpr int kVoteVel = 0;
constexpr int kVoteDens = 1;
constexpr int kVoteSubstep = 2;

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

__device__ __forceinline__ int block_thread() {
  return static_cast<int>(threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z));
}

__device__ __forceinline__ bool finite_value(float v) {
  return fabsf(v) <= 3.40282347e38f;  // not inf, not NaN
}

__device__ __forceinline__ int* vote_slots(int* votes) {
  return votes + 1 + kVoteCounts * kVoteMaxBlocks;
}

// This block's vote into slot `set`: every thread's `finite` (a block
// barrier).
__device__ __forceinline__ void vote(int* votes, int set, bool finite) {
  const int all = __syncthreads_and(finite);
  if (block_thread() == 0) vote_slots(votes)[set * gridDim.x + blockIdx.x] = all;
}

// Whether every block's vote in slot `set`, stored before the last grid
// barrier, holds (a block barrier).  __ldcg reads the slots at L2.
__device__ __forceinline__ bool votes_hold(int* votes, int set) {
  const int* slot = vote_slots(votes) + set * gridDim.x;
  const int threads = static_cast<int>(blockDim.x * blockDim.y * blockDim.z);
  bool all = true;
  for (int b = block_thread(); b < static_cast<int>(gridDim.x); b += threads) {
    all = all && __ldcg(slot + b) != 0;
  }
  return __syncthreads_and(all) != 0;
}

// This block's count of cells by sum ([eight, full], both phases'): zeroed
// by its thread 0 before the self-advection's first barrier (count_start),
// added to by every thread at each phase's end (count_add).
__device__ __forceinline__ unsigned* block_count(int* votes) {
  return reinterpret_cast<unsigned*>(votes + 1 + kVoteCounts * blockIdx.x);
}

__device__ __forceinline__ void count_start(int* votes) {
  if (block_thread() == 0) {
    unsigned* c = block_count(votes);
    c[0] = 0u;
    c[1] = 0u;
  }
}

__device__ __forceinline__ void count_add(int* votes, const unsigned (&cells)[2]) {
  unsigned* c = block_count(votes);
  if (cells[0] != 0u) atomicAdd(c, cells[0]);
  if (cells[1] != 0u) atomicAdd(c + 1, cells[1]);
}

// The vote on the inputs (K >= 2): a.vel and, with the density phase,
// a.dens, over the grid's threads in one pass; then a grid barrier.
template <typename S, bool DENS>
__device__ __forceinline__ void vote_inputs(const FullStepArgs& a, cg::grid_group& grid,
                                            int first, int stride) {
  const long long vol = static_cast<long long>(a.n) * a.n * a.n;
  const S* vel = static_cast<const S*>(a.vel);
  bool finite = true;
  for (long long i = first; i < 3 * vol; i += stride) {
    finite = finite_value(ld(vel[i])) && finite;
  }
  vote(a.votes, kVoteVel, finite);
  if constexpr (DENS) {
    const S* dens = static_cast<const S*>(a.dens);
    finite = true;
    for (long long i = first; i < vol; i += stride) finite = finite_value(ld(dens[i])) && finite;
    vote(a.votes, kVoteDens, finite);
  }
  if (blockIdx.x == 0 && block_thread() == 0) a.votes[0] = static_cast<int>(gridDim.x);
  grid.sync();
}

// One cell of a substep at a window K >= 2 by the vote: the <= 8-tap sum
// where `eight` (the substep's whole source finite) and the displacement
// is not NaN, else advect_values' full sum; counted (when `count`) in
// cells[0] or cells[1].
template <int F, int K, typename TF, typename TV>
__device__ __forceinline__ void values_voted(const Substep& a, const Cell& k, bool eight,
                                             float (&v)[F], unsigned (&cells)[2], bool count) {
  const int kw = K == kWinAny ? a.window : K;
  if (eight && advect_cell_eight<F>(static_cast<const TF*>(a.src), static_cast<const TV*>(a.vel),
                                    a.n, a.dt0, kw, k.cz, k.cy, k.cx, v)) {
    cells[0] += count ? 1u : 0u;
    return;
  }
  advect_values<F, false, false, false, kSrcNone, K, TF, TV>(a, k, v);
  cells[1] += count ? 1u : 0u;
}

// advect_pair by the vote; returns whether every value stored is finite.
template <int F, int K, typename TF, typename TV, typename TO>
__device__ __forceinline__ bool pair_voted(const Substep& a, const Cell& k0, const Cell& k1,
                                           bool two, bool eight, unsigned (&cells)[2]) {
  float v0[F], v1[F];
  values_voted<F, K, TF, TV>(a, k0, eight, v0, cells, true);
  values_voted<F, K, TF, TV>(a, k1, eight, v1, cells, two);
  const bool finite = advect_put<F, TO>(a, k0, v0);
  return two ? advect_put<F, TO>(a, k1, v1) && finite : finite;
}

// pair_voted in the substep's role, as advect_pair_role.
template <int F, int K, typename S>
__device__ __forceinline__ bool advect_pair_voted(const Substep& a, const Cell& k0,
                                                  const Cell& k1, bool two, bool first,
                                                  bool to_s, bool eight, unsigned (&cells)[2]) {
  if constexpr (std::is_same<S, float>::value) {
    return pair_voted<F, K, float, float, float>(a, k0, k1, two, eight, cells);
  } else if (first) {
    return to_s ? pair_voted<F, K, S, S, S>(a, k0, k1, two, eight, cells)
                : pair_voted<F, K, S, S, float>(a, k0, k1, two, eight, cells);
  } else {
    return to_s ? pair_voted<F, K, float, S, S>(a, k0, k1, two, eight, cells)
                : pair_voted<F, K, float, S, float>(a, k0, k1, two, eight, cells);
  }
}

// One advection substep over the grid's threads (two cells a loop trip):
// at K = 1 advect_pair_role's two-tap form; at K >= 2 by the vote, reading
// slot `reads` and (unless the substep is the last) voting on what it
// stores into slot `writes`.
template <int F, int K, typename S>
__device__ __forceinline__ void substep_cells(const FullStepArgs& a, const Substep& s,
                                              int first, int stride, bool sub0, bool last,
                                              int reads, int writes, unsigned (&cells)[2]) {
  const int n = a.n, vol = n * n * n;
  if constexpr (K == 1) {
    for (int i = first; i < vol; i += 2 * stride) {
      const bool two = i + stride < vol;
      advect_pair_role<F, K, false, S>(s, cell_at(n, i), cell_at(n, two ? i + stride : i), two,
                                       sub0, last);
    }
  } else {
    const bool eight = votes_hold(a.votes, reads);
    bool finite = true;
    for (int i = first; i < vol; i += 2 * stride) {
      const bool two = i + stride < vol;
      const bool stored = advect_pair_voted<F, K, S>(
          s, cell_at(n, i), cell_at(n, two ? i + stride : i), two, sub0, last, eight, cells);
      finite = stored && finite;
    }
    if (!last) vote(a.votes, writes, finite);
  }
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
  const int n = a.n;
  unsigned cells[2] = {0u, 0u};
  if (K != 1) count_start(a.votes);
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep s{substep_buf<wide>(sub - 1, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    a.vel, nullptr, nullptr, nullptr,
                    substep_buf<wide>(sub, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    n, Slab{n, 0}, 1, 2, 3, a.dt0_sub, 1.0f, Buoyancy{}, a.window};
    substep_cells<3, K, S>(a, s, first, stride, sub == 0, last,
                           sub == 0 ? kVoteVel : kVoteSubstep + ((sub - 1) & 1),
                           kVoteSubstep + (sub & 1), cells);
    grid.sync();
  }
  if (K != 1) count_add(a.votes, cells);
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
  const int n = a.n;
  unsigned cells[2] = {0u, 0u};
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep d{
        substep_buf<wide>(sub - 1, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        a.vel_out, nullptr, nullptr, nullptr,
        substep_buf<wide>(sub, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        n, Slab{n, 0}, 0, 0, 0, a.dt0_sub, last ? a.dens_damp : 1.0f, Buoyancy{}, a.window};
    substep_cells<1, K, S>(a, d, first, stride, sub == 0, last,
                           sub == 0 ? kVoteDens : kVoteSubstep + ((sub - 1) & 1),
                           kVoteSubstep + (sub & 1), cells);
    if (!last) grid.sync();
  }
  if (K != 1) count_add(a.votes, cells);
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

  // 1. Self-advection into adv (K >= 2: after the vote on the inputs).
  if constexpr (K != 1) vote_inputs<S, DENS>(a, grid, first, stride);
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
// Grid barriers: at K >= 2 one after the vote on the inputs, then one a
// self-advection substep, one after the solve, one before the density and
// one between density substeps.
template <typename T, typename S, int K, bool DENS, bool BLOCK>
__global__ void __launch_bounds__(BLOCK ? kBlockThreads : kTileThreads, 1)
    full_step_tiled_kernel(const FullStepArgs a, const TiledArgs<T, S> t,
                           const BlockTiledArgs<T, S> kb) {
  extern __shared__ __align__(16) unsigned char fs_tile_smem[];
  cg::grid_group grid = cg::this_grid();
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection into adv (a barrier after each substep orders adv
  //    before the divergence reads it; K >= 2: after the vote on the
  //    inputs).
  if constexpr (K != 1) vote_inputs<S, DENS>(a, grid, first, stride);
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
  if (K != 1 && (a.votes == nullptr || *blocks > kVoteMaxBlocks)) return cudaErrorInvalidValue;
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
  if (K != 1 && (a.votes == nullptr || count > kVoteMaxBlocks)) return cudaErrorInvalidValue;
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
