// K2: pressure projection fused with density advection, with its emitter
// (K2s) and obstacle (K2o) variants, four phases run in sequence on one
// stream by fs_project_advect_density:
//   1-3. the projection of project.cuh (divergence, `iters` Jacobi sweeps,
//      gradient + faces + damp; with a mask the coefficient, the gradient
//      held in solid cells and the obstacle mirror before damp), which K3
//      shares;
//   4. the density backtraced through the damped projected velocity in
//      n_sub substeps with a window of K >= 1 cells (K1's F = 1 code
//      through its entry, b = 0, no buoyancy): with a mask every substep
//      zeroes the solid cells before the faces (no mirror for a scalar);
//      with the emitter the first substep adds it to every density value it
//      reads; the last multiplies by dens_damp.
// Returns (vel', p as the final iterate in the storage type, density').
//
// Replaces: fluidsim_tpu/pallas/resident.py::_project_advect_kernel (K2),
// ::_project_advect_src_kernel (K2s) and ::_project_advect_obst_kernel (K2o)
// (entry project_advect_density_3d_resident; phases _project_body,
// _solve_loop and _density_phase at any k_win >= 1), with K5's sweep
// blocking on float32 fields, on float32 or bfloat16 fields (the emitter on
// float32 only).
// The TPU kernel's phases are one program; here they are the launches of
// K3's entry (project.cu) and then K1's (advect.cu) on one stream, since each
// phase needs the whole result of the one before.
//
// What bounds it on an H100: the sweeps, a chain in which each needs the
// whole previous iterate.  Where kernels/resident.solve_tiles finds a tiling
// (every preset's K2, up to 128^3), the divergence and all sweeps are one
// persistent launch (solve_tiled.cuh) that keeps a tile of the iterate, the
// rhs and the mask on each SM: a sweep is bound by shared-memory bandwidth
// and by the wait for the face neighbours' flags.  Elsewhere each sweep is a
// launch over the L2-resident iterates and rhs (12.6 MB at 128^3 in
// bfloat16), bound by L2 bandwidth and the launch.  Gradient and each
// density substep are one pass each; a density substep at K = 3 reads 343
// taps a cell and is bound by operations.
//
// What the design does about it: the tiled solve trades only tile faces
// through L2 and synchronises each block with its face neighbours only; the
// per-sweep route keeps one thread per cell with x across threadIdx.x, the
// launch boundary as the barrier between sweeps.  Border cells recompute
// their interior cell, which is bitwise the TPU kernel's face writes
// (including its deferred x faces), so no sweep needs a separate faces pass.
// The emitter costs a distance test per density read and the add only
// inside the ball's box.  full_step.cu runs the same phases in one
// cooperative launch, with grid-wide barriers between them.
#include <cuda_runtime.h>

#include "advect.cuh"
#include "entries.h"

// vel (3, n, n, n) and dens (n, n, n) in; vel_out, p_out (n, n, n) and
// dens_out out; all in the storage type (bfloat16 when field_bf16, else
// float32).  mask (n, n, n) one byte per cell (nonzero = solid) or null;
// emitter (5,) float32 or null (not with a mask, not with bfloat16 fields);
// tmp0 and tmp1 (n, n, n) float32 scratch of the density substeps (see
// advect_substeps for when each may be null).  p_a, p_b and rhs are (n, n,
// n) scratch in the solve type (bfloat16 when solve_bf16, else float32).
// dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2); window >= 1
// (n >= 2 * window + 1); damp and dens_damp are values of the storage type;
// blk and tiles as fs_project's.
// All contiguous on the current device.  Launches every phase on `stream` without
// synchronising and returns the first cudaError_t.
extern "C" int fs_project_advect_density(const void* vel, const void* dens,
                                         const unsigned char* mask, const float* emitter,
                                         void* vel_out, void* p_out, void* dens_out, float* tmp0,
                                         float* tmp1, void* p_a, void* p_b, void* rhs, int n,
                                         int iters, int solve_bf16, int field_bf16,
                                         float dt0_sub, int n_sub, int window, float damp,
                                         float dens_damp, const fsk::SolveBlock* blk,
                                         const fsk::SolveTiles* tiles, void* stream) {
  using namespace fsk;
  if (n < 3 || iters < 1 || (mask != nullptr && emitter != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = fs_project(vel, mask, vel_out, p_out, p_a, p_b, rhs, n, iters, solve_bf16,
                             field_bf16, damp, blk, tiles, stream);
  if (err != 0) return err;
  return fs_advect_k1(dens, vel_out, nullptr, mask, emitter, kSrcFields, dens_out, tmp0, tmp1,
                      n, 1, 0, 0, 0, dt0_sub, n_sub, window, 0, 0.0f, 0.0f, 0.0f, 0.0f,
                      dens_damp, field_bf16, stream);
}
