// K7: the divergence and the gradient of the projection's slab route, each a
// kernel of its own, with K6 (jacobi.cu) between them:
//   divergence  -0.5*((dvx + dvy) + dvz) / n on the interior cells, zero on
//     the wall faces (which the solve never reads);
//   gradient    v - (0.5*(p[+1] - p[-1]))*n on the interior cells, then the
//     set_bnd faces of each component, z -> y -> x.
// Both are project.cuh's phases 1 and 3 (which K2 and K3 share) in float32.
//
// Replaces: fluidsim_tpu/pallas/project.py::_div_kernel and ::_grad_kernel
// (entry project_3d_pallas), which the JAX package runs when the whole
// projection does not fit on chip.  The TPU kernels' z-slabs with a one-plane
// halo are not carried over: one thread per cell reads its taps from global
// memory, and neighbouring threads share them through L1.
//
// What bounds them on an H100: bytes.  The divergence reads the velocity (3
// volumes) and writes one; the gradient reads the velocity and the pressure
// (4) and writes the velocity (3); about 7 and 15 float32 operations per
// cell are far below the card's rate.
//
// What the design does about it: x across threadIdx.x, so each row of taps
// is one coalesced load per warp, and the taps of a block's neighbours come
// from L1 and L2; border cells recompute their interior cell (boundary.cuh),
// so the faces cost no second pass.
#include <cuda_runtime.h>

#include "project.cuh"

// vel (3, n, n, n) in, div (n, n, n) out; float32, contiguous on the current
// device.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int fs_divergence(const float* vel, float* div, int n, void* stream) {
  using namespace fsk;
  if (n < 3) return static_cast<int>(cudaErrorInvalidValue);
  divergence_kernel<float, float><<<cell_grid(n), cell_block(), 0, static_cast<cudaStream_t>(stream)>>>(
      vel, div, nullptr, n);
  return static_cast<int>(cudaGetLastError());
}

// vel (3, n, n, n) and p (n, n, n) in, vel_out (3, n, n, n) out; float32,
// contiguous on the current device.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int fs_gradient(const float* vel, const float* p, float* vel_out, int n,
                           void* stream) {
  using namespace fsk;
  if (n < 3) return static_cast<int>(cudaErrorInvalidValue);
  gradient_kernel<float, float, false><<<cell_grid(n), cell_block(), 0, static_cast<cudaStream_t>(stream)>>>(
      vel, p, nullptr, vel_out, nullptr, n, 1.0f);
  return static_cast<int>(cudaGetLastError());
}
