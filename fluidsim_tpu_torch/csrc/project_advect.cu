// K2: pressure projection fused with density advection, with its emitter
// (K2s) and obstacle (K2o) variants, four phases run in sequence on one
// stream by fs_project_advect_density:
//   1-3. the projection of project.cuh (divergence, `iters` Jacobi sweeps,
//      gradient + faces + damp; with a mask the coefficient, the gradient
//      held in solid cells and the obstacle mirror before damp), which K3
//      shares;
//   4. the density backtraced through the damped projected velocity in
//      n_sub substeps (advect.cuh's advect_substeps, K1's F = 1 code, b = 0,
//      no buoyancy): with a mask every substep zeroes the solid cells before
//      the faces (no mirror for a scalar); with the emitter the first
//      substep adds it to every density value it reads; the last multiplies
//      by dens_damp.
// Returns (vel', p as the float32 upcast of the final iterate, density').
//
// Replaces: fluidsim_tpu/pallas/resident.py::_project_advect_kernel (K2),
// ::_project_advect_src_kernel (K2s) and ::_project_advect_obst_kernel (K2o)
// (entry project_advect_density_3d_resident; phases _project_body,
// _solve_loop and _density_phase), without sweep blocking.
//
// What bounds it on an H100: the sweeps.  Each reads the iterate (six
// neighbours) and the rhs and writes the next iterate: at 128^3 with bfloat16
// solve buffers the two iterates and the rhs are 12.6 MB, which stays in the
// 50 MB L2, so a sweep is bound by L2 bandwidth and by the fixed cost of a
// launch; the sweeps are a chain, each needs the whole previous iterate.
// Divergence, gradient and each density substep are one pass each.
//
// What the design does about it: one launch per sweep (the launch boundary is
// the grid-wide barrier between sweeps), one thread per cell with x across
// threadIdx.x, and the whole solve working set kept small enough for L2.
// Border cells recompute their interior cell, which is bitwise the TPU
// kernel's face writes (including its deferred x faces), so no sweep needs a
// separate faces pass.  The emitter costs a distance test per density read
// and the add only inside the ball's box.  full_step.cu runs the same phases
// in one cooperative launch, with grid-wide barriers between them.
#include <cuda_runtime.h>

#include "advect.cuh"
#include "project.cuh"

// vel (3, n, n, n) and dens (n, n, n) in; mask (n, n, n) one byte per cell
// (nonzero = solid) or null; emitter (5,) or null (not with a mask); vel_out,
// p_out (n, n, n) and dens_out out; dens_tmp (n, n, n) scratch, may be null
// when n_sub == 1; all float32 apart from the mask.  p_a, p_b and rhs are
// (n, n, n) scratch in the solve dtype (bfloat16 when solve_bf16, else
// float32).  dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2).
// All contiguous on the current device.  Launches every phase on `stream`
// without synchronising and returns the first cudaError_t.
extern "C" int fs_project_advect_density(const float* vel, const float* dens,
                                         const unsigned char* mask, const float* emitter,
                                         float* vel_out, float* p_out, float* dens_out,
                                         float* dens_tmp, void* p_a, void* p_b, void* rhs, int n,
                                         int iters, int solve_bf16, float dt0_sub, int n_sub,
                                         float damp, float dens_damp, void* stream) {
  using namespace fsk;
  if (n < 3 || iters < 1 || (mask != nullptr && emitter != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_solve_dtype(solve_bf16, p_a, p_b, rhs, [&](auto* pa, auto* pb, auto* r) {
    return project_phases(vel, mask, vel_out, p_out, pa, pb, r, n, iters, damp, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const Substep a{dens, vel_out, nullptr, mask, emitter, nullptr, n, 0, 0, 0, dt0_sub, 1.0f,
                  Buoyancy{}};
  return static_cast<int>(advect_substeps(a, 1, n_sub, false,
                                          emitter != nullptr ? kSrcFields : kSrcNone, dens_out,
                                          dens_tmp, dens_damp, s));
}
