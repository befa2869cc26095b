// K8: the whole hot step of an obstacle-free config in one cooperative
// launch, five phases separated by grid-wide barriers:
//   1. velocity self-advection (K1's F = 3 code, b = 1, 2, 3), one barrier
//      per substep;
//   2. divergence, which zeroes the start iterate;
//   3. `iters` Jacobi sweeps, one barrier each;
//   4. gradient + faces + damp;
//   5. density advection through the projected velocity (K1's F = 1 code,
//      b = 0), one barrier between substeps, the last times dens_damp.
// Returns (vel', p as the final iterate in the storage type, density'),
// bitwise K1 (self-advection) followed by K2: every phase calls the same
// per-cell device code as those kernels (advect.cuh, project.cuh).
//
// Replaces: fluidsim_tpu/pallas/resident.py::_full_step_kernel (entry
// full_step_3d_resident), with K5's sweep blocking on float32 fields
// (sweep_block.cuh: each stage a grid-stride loop, grid.sync() between
// stages), at any window K >= 1 in both advections and on float32 or
// bfloat16 fields.  Without the density phase the same template is K14,
// fluidsim_tpu/pallas/resident.py::_advect_project_kernel (entry
// advect_project_3d_resident): float32, no mask, sequential sweeps, bitwise
// K1 followed by K3 by construction (fs_advect_project below).  The TPU kernel is one
// grid-less program whose phases run in order; here the phases run on every
// block of a grid that is exactly as large as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, launched with
// cudaLaunchCooperativeKernel), each a grid-stride loop over the cells, and
// cooperative_groups' grid barrier takes the place of the launch boundary
// that separates K1's substeps and K2's phases and sweeps.
//
// What bounds it on an H100: as K2, the sweeps, each a pass over an L2
// resident working set (12.6 MB at 128^3 with bfloat16 solve buffers); the
// compulsory DRAM traffic (velocity and density in; velocity, pressure and
// density out) is 9 volumes.  bench128 takes 63 barriers in one launch
// where K1 + K2 take 64 launches: the barrier's cost against a launch's is
// what this kernel measures.
//
// What the design does about it: nothing yet beyond the one launch.  No
// thread returns before a barrier (every loop runs over the whole grid's
// cells); the buffers that a phase writes and a later phase reads are plain
// pointers, so no read goes through the read-only cache.  The self-advected
// velocity lives in `adv`.  On float32 fields vel_out serves as the other
// buffer of the self-advection's substeps and adv's first volume as the
// density's, so the scratch is one velocity volume; on bfloat16 fields the
// substeps before the last are float32 (as the TPU kernel keeps them in
// VMEM) in two float32 velocity volumes, tmp0 and tmp1, which the density's
// substeps reuse.  The kernel template is in full_step.cuh; this source
// instantiates it for float32 fields and full_step_bf16.cu for bfloat16, so
// the two compile side by side.
#include <cuda_runtime.h>

#include "full_step.cuh"

namespace fsk {

cudaError_t full_step_f32(const FullStepArgs& a, const SolveBlock& blk, int solve_bf16,
                          int window, bool launch, int* blocks, cudaStream_t s) {
  return full_step_dispatch<float>(a, blk, solve_bf16, window, launch, blocks, s);
}

cudaError_t advect_project_f32(const FullStepArgs& a, int window, bool launch, int* blocks,
                               cudaStream_t s) {
  return full_step_dispatch<float, false>(a, SolveBlock{1}, 0, window, launch, blocks, s);
}

}  // namespace fsk

// The number of blocks fs_full_step launches for the solve type (bfloat16
// when solve_bf16, else float32), the storage type (bfloat16 when
// field_bf16) and the window on the current device, or minus the
// cudaError_t that prevents the launch.
extern "C" int fs_full_step_blocks(int solve_bf16, int field_bf16, int window) {
  using namespace fsk;
  int blocks = 0;
  FullStepArgs none{};
  none.window = window;
  const SolveBlock seq{1};
  const cudaError_t err =
      field_bf16 ? full_step_bf16(none, seq, solve_bf16, window, false, &blocks, nullptr)
                 : full_step_f32(none, seq, solve_bf16, window, false, &blocks, nullptr);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// vel (3, n, n, n) and dens (n, n, n) in; adv (3, n, n, n) scratch; vel_out
// (3, n, n, n), p_out (n, n, n) and dens_out (n, n, n) out; all in the
// storage type (bfloat16 when field_bf16, else float32).  tmp0 and tmp1 are
// (3, n, n, n) float32 scratch, for bfloat16 fields only: tmp0 when n_sub >
// 1, tmp1 when n_sub > 2 (else null).  p_a, p_b and rhs are (n, n, n)
// scratch in the solve type (bfloat16 when solve_bf16, else float32).
// dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2); window >= 1
// (n >= 2 * window + 1); damp and dens_damp are values of the storage
// type; blk is null (sequential sweeps) or K5's block and scratch (float32
// fields; see block_valid).  All contiguous on the current device; n <=
// 1024.  Launches on `stream` without synchronising and returns the first
// cudaError_t (a grid the card cannot hold at once is
// cudaErrorCooperativeLaunchTooLarge).
extern "C" int fs_full_step(const void* vel, const void* dens, void* adv, void* vel_out,
                            void* p_out, void* dens_out, float* tmp0, float* tmp1, void* p_a,
                            void* p_b, void* rhs, int n, int iters, int solve_bf16,
                            int field_bf16, float dt0_sub, int n_sub, int window, float damp,
                            float dens_damp, const fsk::SolveBlock* blk, void* stream) {
  using namespace fsk;
  if (n < 3 || n > 1024 || iters < 1 || n_sub < 1 || window < 1 || n < 2 * window + 1 ||
      !block_valid(blk, n, iters, field_bf16) ||
      (field_bf16 && ((n_sub > 1 && tmp0 == nullptr) || (n_sub > 2 && tmp1 == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FullStepArgs a{vel, dens, adv, vel_out, p_out, dens_out, p_a, p_b, rhs, tmp0, tmp1,
                       n, iters, n_sub, dt0_sub, damp, dens_damp, window};
  const SolveBlock block = blk != nullptr ? *blk : SolveBlock{1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  return static_cast<int>(field_bf16
                              ? full_step_bf16(a, block, solve_bf16, window, true, &blocks, s)
                              : full_step_f32(a, block, solve_bf16, window, true, &blocks, s));
}

// K14: vel (3, n, n, n) in; adv (3, n, n, n) scratch (the self-advected
// velocity); vel_out (3, n, n, n) and p_out (n, n, n) out; p_a, p_b and rhs
// (n, n, n) solve scratch; all float32, contiguous on the current device, n
// <= 1024.  dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2);
// window >= 1 (n >= 2 * window + 1).  Self-advects vel (b = 1, 2, 3) in
// n_sub substeps and projects the result with `iters` sequential sweeps, in
// one cooperative launch on `stream`; returns the first cudaError_t.
extern "C" int fs_advect_project(const float* vel, float* adv, float* vel_out, float* p_out,
                                 float* p_a, float* p_b, float* rhs, int n, int iters,
                                 float dt0_sub, int n_sub, int window, void* stream) {
  using namespace fsk;
  if (n < 3 || n > 1024 || iters < 1 || n_sub < 1 || window < 1 || n < 2 * window + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FullStepArgs a{vel, nullptr, adv, vel_out, p_out, nullptr, p_a, p_b, rhs, nullptr,
                       nullptr, n, iters, n_sub, dt0_sub, 1.0f, 1.0f, window};
  int blocks = 0;
  return static_cast<int>(
      advect_project_f32(a, window, true, &blocks, static_cast<cudaStream_t>(stream)));
}
