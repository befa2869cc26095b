// K8: the whole hot step of an obstacle-free config in one cooperative
// launch, five phases:
//   1. velocity self-advection (K1's F = 3 code, b = 1, 2, 3), one grid
//      barrier per substep;
//   2. divergence, which zeroes the start iterate;
//   3. `iters` Jacobi sweeps;
//   4. gradient + faces + damp;
//   5. density advection through the projected velocity (K1's F = 1 code,
//      b = 0), one barrier between substeps, the last times dens_damp.
// Returns (vel', p as the final iterate in the storage type, density'),
// bitwise K1 (self-advection) followed by K2: every phase calls the same
// per-cell device code as those kernels (advect.cuh, project.cuh), and the
// solve K2's tiled solve (solve_tiled.cuh).
//
// Replaces: fluidsim_tpu/pallas/resident.py::_full_step_kernel (entry
// full_step_3d_resident), with K5's sweep blocking on float32 fields
// (sweep_block.cuh), at any window K >= 1 in both advections and on float32
// or bfloat16 fields.  Without the density phase the same templates are
// K14, fluidsim_tpu/pallas/resident.py::_advect_project_kernel (entry
// advect_project_3d_resident): float32, no mask, sequential sweeps, bitwise
// K1 followed by K3 by construction (fs_advect_project below).  The TPU
// kernel is one grid-less program whose phases run in order; here the
// phases run on every block of a cooperative grid (every block resident at
// once, launched with cudaLaunchCooperativeKernel), and cooperative_groups'
// grid barrier takes the place of the launch boundaries that separate K1's
// substeps and K2's phases.
//
// Two routes, chosen by the caller before the launch as K2's solve is
// (kernels/resident.solve_tiles):
//   - tiled (full_step_tiled_kernel): one block of up to 512 threads a tile
//     of the tiled solve, one an SM.  Phases 2-3 are solve_tiled.cuh's
//     program of the block's tile: the divergence of the self-advected
//     velocity (read at L2), every sweep in shared memory, the tile's faces
//     traded with its six neighbours through flags.  No grid barrier inside
//     the solve: n_sub + 2 + (n_sub - 1) grid barriers a step (K >= 2:
//     one more, after the vote on the inputs).
//     With K5's block (sweep_block >= 2, float32 fields) the tiles run
//     K5's tile program (solve_tiled.cuh: block_tile) instead, each of its
//     stages a pass on chip with a face trade, no grid barrier either.
//   - grid-stride (full_step_kernel): where no tiling fits (a float32 solve
//     above 128^3, a bfloat16 one above 160^3; K5's program's own budget):
//     as many blocks of 256 threads as the card
//     holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs),
//     each phase a grid-stride loop over the cells, a grid barrier after
//     every sweep (and every K5 stage).
//
// What bounds it on an H100: the solve.  The compulsory DRAM traffic
// (velocity and density in; velocity, pressure and density out) is 9
// volumes; a grid-stride sweep passes over an L2-resident working set
// (12.6 MB at 128^3 with bfloat16 solve buffers) and then waits on a grid
// barrier (13.8 us a sweep at bench128 on an H100, chip_smoke.py), where the
// tiled solve keeps the iterate in shared memory and waits on its face
// neighbours only (K2: 5.4 us a sweep).
//
// What the design does about it: the tiled route runs K2's tiled solve
// inside the launch, so a step waits on 2 n_sub grid barriers and not on
// one a sweep; the advection phases and the gradient stay grid-stride
// loops over the tiles' threads (a quarter of the threads the grid-stride
// route has at 128^3).  No thread returns before a barrier (every loop runs
// over the whole grid's cells, and every block runs its tile's solve); the
// buffers that a phase writes and a later phase reads are plain pointers,
// so no read goes through the read-only cache.  The self-advected velocity
// lives in `adv`.
//
// At a window K >= 2 the advection phases sum only the <= 8 taps the clamp
// leaves with weight (advect.cuh's advect_cell_eight, the windowed tiles'
// sum, advect_window.cuh) where a whole-field vote inside the launch finds
// the substep's source finite, and the full (2K+1)^3 hat sum elsewhere
// (full_step.cuh: the vote): 8 taps a cell where the per-cell body read 729
// at K = 4 and 1331 at K = 5, each a gather at L2.
//
// On float32 fields vel_out serves as the other buffer of
// the self-advection's substeps and adv's first volume as the density's, so
// the scratch is one velocity volume; on bfloat16 fields the substeps
// before the last are float32 (as the TPU kernel keeps them in VMEM) in two
// float32 velocity volumes, tmp0 and tmp1, which the density's substeps
// reuse.  The kernel templates are in full_step.cuh; this source
// instantiates them for float32 fields and full_step_bf16.cu for bfloat16,
// so the two compile side by side.
#include <cuda_runtime.h>

#include "full_step.cuh"

namespace fsk {

cudaError_t full_step_f32(const FullStepArgs& a, const SolveBlock& blk, const SolveTiles* tiles,
                          int solve_bf16, int window, bool launch, int* blocks, cudaStream_t s) {
  return full_step_dispatch<float>(a, blk, tiles, solve_bf16, window, launch, blocks, s);
}

cudaError_t advect_project_f32(const FullStepArgs& a, const SolveTiles* tiles, int window,
                               bool launch, int* blocks, cudaStream_t s) {
  return full_step_dispatch<float, false>(a, SolveBlock{1}, tiles, 0, window, launch, blocks, s);
}

}  // namespace fsk

// The number of blocks fs_full_step launches on the current device for the
// solve type (bfloat16 when solve_bf16, else float32), the storage type
// (bfloat16 when field_bf16), the window, K5's block (1: sequential
// sweeps) and the route: the tiled route over gx * gy * gz tiles of an n^3
// grid when gx > 0 (the tile count, once the card is checked to hold them
// all at once with the block's shared memory), else the grid-stride route
// (every block the card holds at once); or minus the cudaError_t that
// prevents the launch.
extern "C" int fs_full_step_blocks(int solve_bf16, int field_bf16, int window, int n, int gx,
                                   int gy, int gz, int block) {
  using namespace fsk;
  int blocks = 0;
  FullStepArgs none{};
  none.window = window;
  none.n = n;
  const SolveBlock seq{block};
  const SolveTiles tiling{gx, gy, gz, nullptr, nullptr};
  const SolveTiles* tiles = gx > 0 ? &tiling : nullptr;
  const cudaError_t err =
      field_bf16
          ? full_step_bf16(none, seq, tiles, solve_bf16, window, false, &blocks, nullptr)
          : full_step_f32(none, seq, tiles, solve_bf16, window, false, &blocks, nullptr);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// vel (3, n, n, n) and dens (n, n, n) in; adv (3, n, n, n) scratch; vel_out
// (3, n, n, n), p_out (n, n, n) and dens_out (n, n, n) out; all in the
// storage type (bfloat16 when field_bf16, else float32).  tmp0 and tmp1 are
// (3, n, n, n) float32 scratch, for bfloat16 fields only: tmp0 when n_sub >
// 1, tmp1 when n_sub > 2 (else null).  p_a, p_b and rhs are (n, n, n)
// scratch in the solve type (bfloat16 when solve_bf16, else float32); the
// tiled route needs p_a only.
// dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2); window >= 1
// (n >= 2 * window + 1); damp and dens_damp are values of the storage
// type; blk is null (sequential sweeps) or K5's block and scratch (float32
// fields; see block_valid); tiles is null (the grid-stride route) or the
// tiled solve's tiling and scratch (the tiled route; with blk, K5's tile
// program: float32 face slots, and rhs its scratch).  All
// contiguous on the current device; n <= 1024.  votes is kVoteInts ints of
// scratch for window >= 2 (full_step.cuh's vote; unread at window 1, may be
// null there).  Launches on `stream`
// without synchronising and returns the first cudaError_t (a grid the card
// cannot hold at once is cudaErrorCooperativeLaunchTooLarge).
extern "C" int fs_full_step(const void* vel, const void* dens, void* adv, void* vel_out,
                            void* p_out, void* dens_out, float* tmp0, float* tmp1, void* p_a,
                            void* p_b, void* rhs, int n, int iters, int solve_bf16,
                            int field_bf16, float dt0_sub, int n_sub, int window, float damp,
                            float dens_damp, const fsk::SolveBlock* blk,
                            const fsk::SolveTiles* tiles, int* votes, void* stream) {
  using namespace fsk;
  if (n < 3 || n > 1024 || iters < 1 || n_sub < 1 || window < 1 || n < 2 * window + 1 ||
      !block_valid(blk, n, iters, field_bf16, tiles != nullptr) || p_a == nullptr ||
      (tiles == nullptr && (p_b == nullptr || rhs == nullptr)) ||
      (field_bf16 && ((n_sub > 1 && tmp0 == nullptr) || (n_sub > 2 && tmp1 == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FullStepArgs a{vel, dens, adv, vel_out, p_out, dens_out, p_a, p_b, rhs, tmp0, tmp1,
                       n, iters, n_sub, dt0_sub, damp, dens_damp, window, votes};
  const SolveBlock block = blk != nullptr ? *blk : SolveBlock{1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  return static_cast<int>(
      field_bf16 ? full_step_bf16(a, block, tiles, solve_bf16, window, true, &blocks, s)
                 : full_step_f32(a, block, tiles, solve_bf16, window, true, &blocks, s));
}

// K14: vel (3, n, n, n) in; adv (3, n, n, n) scratch (the self-advected
// velocity); vel_out (3, n, n, n) and p_out (n, n, n) out; p_a, p_b and rhs
// (n, n, n) solve scratch (the tiled route: p_a only); all float32,
// contiguous on the current device, n <= 1024.  dt0_sub = f32(dt0 / n_sub)
// with dt0 = f32(dt) * f32(n - 2); window >= 1 (n >= 2 * window + 1); tiles
// and votes as fs_full_step's.  Self-advects vel (b = 1, 2, 3) in n_sub
// substeps and projects the result with `iters` sequential sweeps, in one
// cooperative launch on `stream`; returns the first cudaError_t.
extern "C" int fs_advect_project(const float* vel, float* adv, float* vel_out, float* p_out,
                                 float* p_a, float* p_b, float* rhs, int n, int iters,
                                 float dt0_sub, int n_sub, int window,
                                 const fsk::SolveTiles* tiles, int* votes, void* stream) {
  using namespace fsk;
  if (n < 3 || n > 1024 || iters < 1 || n_sub < 1 || window < 1 || n < 2 * window + 1 ||
      p_a == nullptr || (tiles == nullptr && (p_b == nullptr || rhs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FullStepArgs a{vel, nullptr, adv, vel_out, p_out, nullptr, p_a, p_b, rhs, nullptr,
                       nullptr, n, iters, n_sub, dt0_sub, 1.0f, 1.0f, window, votes};
  int blocks = 0;
  return static_cast<int>(
      advect_project_f32(a, tiles, window, true, &blocks, static_cast<cudaStream_t>(stream)));
}
