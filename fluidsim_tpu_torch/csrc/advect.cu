// K1: K=1 semi-Lagrangian advection of F fields (F = 3: velocity
// self-advection, optionally with buoyancy folded in; F = 1: a scalar).
//
// Replaces: fluidsim_tpu/pallas/advect.py::_advect_kernel (entry
// advect_multi_3d_pallas, core _substep_window_vals), k_win = 1, n_sub = 1,
// no obstacle mask, no folded emitter.
//
// What bounds it on an H100: every output cell reads 27 taps of each field
// (plus 27 density taps for the buoyant y component), about 108 loads per
// thread in self-advection, against roughly 32 bytes per cell of compulsory
// DRAM traffic (3 velocity + 1 density read, 3 velocity writes, float32).
// The taps of neighbouring cells overlap, so the work is bound by L1/L2 load
// throughput and issue rate, not by DRAM bandwidth.
//
// What the design does about it: one thread per cell with x across
// threadIdx.x, so that each tap row is one coalesced 128-byte load per warp
// and the overlapping taps of a block hit in L1; the velocity at the cell
// and its backtrace fractions are computed once and shared by all fields.
// Border cells recompute their interior cell (see advect.cuh), so the output
// contract (fresh zero, then set_bnd faces z->y->x) needs no second pass.
// A shared-memory tile of the planes a block reads is the next step.
#include <cuda_runtime.h>

#include "advect.cuh"

namespace fsk {

template <int F, bool BUOY>
__global__ void __launch_bounds__(kBlockX* kBlockY* kBlockZ)
    advect_k1_kernel(const float* __restrict__ fields, const float* __restrict__ vel,
                     const float* __restrict__ dens, float* __restrict__ out, int n,
                     int b0, int b1, int b2, float dt0, Buoyancy bp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  if (x >= n || y >= n || z >= n) return;
  const int cx = clamp_interior(x, n), cy = clamp_interior(y, n), cz = clamp_interior(z, n);
  float v[F];
  advect_cell_k1<F, BUOY>(fields, vel, dens, bp, n, dt0, cz, cy, cx, v);
  const long long sn = n, vol = sn * sn * sn;
  const long long idx = (z * sn + y) * sn + x;
  const int bs[3] = {b0, b1, b2};
#pragma unroll
  for (int c = 0; c < F; ++c) {
    out[c * vol + idx] = face_negates(bs[c], z, y, x, cz, cy, cx) ? -v[c] : v[c];
  }
}

}  // namespace fsk

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fields (n_fields, n, n, n), vel (3, n, n, n), dens (n, n, n) or null, out
// like fields; all float32, contiguous, on the current device.  dt0 =
// f32(dt) * f32(n - 2).  With has_buoy the fields must be the velocity.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int fs_advect_k1(const float* fields, const float* vel, const float* dens,
                            float* out, int n, int n_fields, int b0, int b1, int b2,
                            float dt0, int has_buoy, float buoy_dt, float buoyancy,
                            float ambient, float gravity, void* stream) {
  using namespace fsk;
  if (n < 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buoyancy bp{buoy_dt, buoyancy, ambient, gravity};
  const dim3 grid = cell_grid(n), block = cell_block();
  if (n_fields == 3 && has_buoy) {
    advect_k1_kernel<3, true><<<grid, block, 0, s>>>(fields, vel, dens, out, n, b0, b1, b2, dt0, bp);
  } else if (n_fields == 3) {
    advect_k1_kernel<3, false><<<grid, block, 0, s>>>(fields, vel, dens, out, n, b0, b1, b2, dt0, bp);
  } else if (n_fields == 1 && !has_buoy) {
    advect_k1_kernel<1, false><<<grid, block, 0, s>>>(fields, vel, dens, out, n, b0, b1, b2, dt0, bp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
