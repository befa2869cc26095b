// K2: pressure projection fused with density advection, four phases run in
// sequence on one stream by fs_project_advect_density:
//   1-3. the projection of project.cuh without a mask (divergence, `iters`
//      Jacobi sweeps, gradient + faces + damp), which K3 shares;
//   4. the density backtraced through the damped projected velocity (the
//      shared K=1 device code, b = 0, no buoyancy), faces, then * dens_damp.
// Returns (vel', p as the float32 upcast of the final iterate, density').
//
// Replaces: fluidsim_tpu/pallas/resident.py::_project_advect_kernel (entry
// project_advect_density_3d_resident; phases _project_body, _solve_loop and
// _density_phase), without obstacle mask, folded emitter or sweep blocking.
//
// What bounds it on an H100: the sweeps.  Each reads the iterate (six
// neighbours) and the rhs and writes the next iterate: at 128^3 with bfloat16
// solve buffers the two iterates and the rhs are 12.6 MB, which stays in the
// 50 MB L2, so a sweep is bound by L2 bandwidth and by the fixed cost of a
// launch; the sweeps are a chain, each needs the whole previous iterate.
// Divergence, gradient and the density phase are one pass each.
//
// What the design does about it: one launch per sweep (the launch boundary is
// the grid-wide barrier between sweeps), one thread per cell with x across
// threadIdx.x, and the whole solve working set kept small enough for L2.
// Border cells recompute their interior cell, which is bitwise the TPU
// kernel's face writes (including its deferred x faces), so no sweep needs a
// separate faces pass.  Temporal blocking in shared memory, a persistent
// kernel or a CUDA graph over the 63 launches are the next steps.
#include <cuda_runtime.h>

#include "advect.cuh"
#include "project.cuh"

namespace fsk {

__global__ void __launch_bounds__(kThreads)
    density_advect_kernel(const float* __restrict__ dens, const float* __restrict__ vel,
                          float* __restrict__ out, int n, float dt0, float dens_damp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  float v[1];
  advect_cell_k1<1, false, false>(dens, vel, nullptr, Buoyancy{}, n, dt0, k.cz, k.cy, k.cx, v);
  out[k.idx] = v[0] * dens_damp;
}

}  // namespace fsk

// vel (3, n, n, n) and dens (n, n, n) in; vel_out, p_out (n, n, n) and
// dens_out out; all float32.  p_a, p_b and rhs are (n, n, n) scratch in the
// solve dtype (bfloat16 when solve_bf16, else float32).  dt0 = f32(dt) *
// f32(n - 2).  All contiguous on the current device.  Launches every phase
// on `stream` without synchronising and returns the first cudaError_t.
extern "C" int fs_project_advect_density(const float* vel, const float* dens, float* vel_out,
                                         float* p_out, float* dens_out, void* p_a, void* p_b,
                                         void* rhs, int n, int iters, int solve_bf16,
                                         float dt0, float damp, float dens_damp,
                                         void* stream) {
  using namespace fsk;
  if (n < 3 || iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_solve_dtype(solve_bf16, p_a, p_b, rhs, [&](auto* pa, auto* pb, auto* r) {
    return project_phases(vel, nullptr, vel_out, p_out, pa, pb, r, n, iters, damp, s);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  density_advect_kernel<<<cell_grid(n), cell_block(), 0, s>>>(dens, vel_out, dens_out, n, dt0,
                                                              dens_damp);
  return static_cast<int>(cudaGetLastError());
}
