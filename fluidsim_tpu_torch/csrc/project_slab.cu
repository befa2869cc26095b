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
//
// K7e: the same two kernels on one shard of the sharded step (entries
// fs_divergence_ext, fs_gradient_ext).  A shard owns lz z-planes of the n^3
// grid; the one plane of each neighbour that its stencils read along z is
// read in place, from the neighbour's own storage: the divergence reads the
// shard's velocity (each component's lz planes contiguous, the components
// cstride floats apart: the sharded step passes K11's kept planes, a view of
// its extended result, without a copy) and the z component's planes lo
// (below) and hi (above),
// the gradient the shard's velocity, its pressure and the pressure's planes
// lo and hi, and each writes the shard's lz planes.  The global z walls lie at
// the shard's planes wall_lo and wall_hi (0 on the first shard, lz - 1 on the
// last, <= -2 where the shard holds none: kernels/halo.rank_walls at halo
// 0); only there is a plane a border plane, whose interior plane is the next
// one inwards, so the face order is z -> y -> x as on the whole grid, and no
// cell reads past a global wall (lo or hi is null there).  The per-cell
// arithmetic is divergence_of and gradient_value, K7's own, so K7e is
// bitwise K7 on the shard's planes.
//
// Replaces, per shard: fluidsim_tpu/pallas/project.py::_div_kernel and
// ::_grad_kernel, which the JAX package's sharded step does not run (XLA's
// partitioner splits its plain divergence and gradient instead).
#include <cuda_runtime.h>

#include "entries.h"
#include "project.cuh"

namespace {

using fsk::kThreads;

// The cell of this thread on the shard's planes: (x, y, z) with z in
// [0, lz), and its interior cell (cx, cy, cz).
struct ExtCell {
  int x, y, z, cx, cy, cz;
  long long idx, c, yx;  // idx and c on the shard's planes; yx: c within its plane
};

__device__ __forceinline__ bool ext_cell_of_thread(int n, int lz, int wall_lo, int wall_hi,
                                                   ExtCell& k) {
  k.x = blockIdx.x * blockDim.x + threadIdx.x;
  k.y = blockIdx.y * blockDim.y + threadIdx.y;
  k.z = blockIdx.z * blockDim.z + threadIdx.z;
  if (k.x >= n || k.y >= n || k.z >= lz) return false;
  k.cx = fsk::clamp_interior(k.x, n);
  k.cy = fsk::clamp_interior(k.y, n);
  k.cz = k.z == wall_lo ? k.z + 1 : (k.z == wall_hi ? k.z - 1 : k.z);
  const long long sn = n;
  k.idx = (k.z * sn + k.y) * sn + k.x;
  k.yx = k.cy * sn + k.cx;
  k.c = k.cz * sn * sn + k.yx;
  return true;
}

// A field's value at (z, yx) for z in [-1, lz]: plane lo below the shard's
// planes, hi above them.  The plane is selected before the one load, so the
// load goes out with the cell's others rather than inside a branch.
__device__ __forceinline__ float plane_value(const float* own, const float* lo, const float* hi,
                                             int z, int lz, long long plane, long long yx) {
  const float* row = z < 0 ? lo : (z >= lz ? hi : own + z * plane);
  return row[yx];
}

__global__ void __launch_bounds__(kThreads)
    divergence_ext_kernel(const float* __restrict__ vel, long long cstride,
                          const float* __restrict__ vz_lo, const float* __restrict__ vz_hi,
                          float* __restrict__ div, int n, int lz, int wall_lo, int wall_hi) {
  ExtCell k;
  if (!ext_cell_of_thread(n, lz, wall_lo, wall_hi, k)) return;
  // Zero on the faces, as K7's divergence: the solve never reads them.
  if (k.x != k.cx || k.y != k.cy || k.z != k.cz) {
    div[k.idx] = 0.0f;
    return;
  }
  const long long sn = n, plane = sn * sn, i = k.idx;
  const float* vz = vel + 2 * cstride;
  const float dx = vel[i + 1] - vel[i - 1];
  const float dy = vel[cstride + i + sn] - vel[cstride + i - sn];
  const float dz = plane_value(vz, vz_lo, vz_hi, k.z + 1, lz, plane, k.yx) -
                   plane_value(vz, vz_lo, vz_hi, k.z - 1, lz, plane, k.yx);
  div[i] = fsk::divergence_of(dx, dy, dz, n);
}

__global__ void __launch_bounds__(kThreads)
    gradient_ext_kernel(const float* __restrict__ vel, long long cstride,
                        const float* __restrict__ p, const float* __restrict__ p_lo,
                        const float* __restrict__ p_hi, float* __restrict__ vel_out, int n,
                        int lz, int wall_lo, int wall_hi) {
  ExtCell k;
  if (!ext_cell_of_thread(n, lz, wall_lo, wall_hi, k)) return;
  const long long sn = n, plane = sn * sn, vol = plane * lz, c = k.c;
  const float nf = float(n);
  const float p_hi_val[3] = {p[c + 1], p[c + sn],
                             plane_value(p, p_lo, p_hi, k.cz + 1, lz, plane, k.yx)};
  const float p_lo_val[3] = {p[c - 1], p[c - sn],
                             plane_value(p, p_lo, p_hi, k.cz - 1, lz, plane, k.yx)};
  const bool negate[3] = {k.x != k.cx, k.y != k.cy, k.z != k.cz};
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    vel_out[comp * vol + k.idx] = fsk::gradient_value<float>(
        vel[comp * cstride + c], p_hi_val[comp], p_lo_val[comp], nf, false, negate[comp], 1.0f);
  }
}

// The walls and halo planes a K7e call takes: each wall at its end plane or
// <= -2, and a halo plane on each side without a wall.
int ext_args_valid(int n, int lz, long long cstride, int wall_lo, int wall_hi, const float* lo,
                   const float* hi) {
  const bool lo_ok = wall_lo == 0 || (wall_lo <= -2 && lo != nullptr);
  const bool hi_ok = wall_hi == lz - 1 || (wall_hi <= -2 && hi != nullptr);
  const long long sn = n;
  return n >= 3 && lz >= 2 && cstride >= lz * sn * sn && lo_ok && hi_ok;
}

}  // namespace

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

// K7e's divergence: vel (3, lz, n, n), its components cstride >= lz n^2
// floats apart, and the z component's halo planes vz_lo, vz_hi (n, n) in,
// div (lz, n, n) out; float32 on the current device, contiguous but for
// cstride, but for a halo plane, which may lie on a neighbour shard's card
// (read through its peer pointer once the mesh turned peer access on); the
// global z walls at the shard's planes wall_lo (0 or <= -2) and wall_hi
// (lz - 1 or <= -2), a halo plane null where its side has the wall.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int fs_divergence_ext(const float* vel, long long cstride, const float* vz_lo,
                                 const float* vz_hi, float* div, int n, int lz, int wall_lo,
                                 int wall_hi, void* stream) {
  if (!ext_args_valid(n, lz, cstride, wall_lo, wall_hi, vz_lo, vz_hi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  divergence_ext_kernel<<<fsk::cell_grid_slab(n, lz), fsk::cell_block(), 0,
                          static_cast<cudaStream_t>(stream)>>>(vel, cstride, vz_lo, vz_hi, div,
                                                               n, lz, wall_lo, wall_hi);
  return static_cast<int>(cudaGetLastError());
}

// K7e's gradient: vel (3, lz, n, n) with its components cstride floats
// apart, p (lz, n, n) and the pressure's halo planes p_lo, p_hi (n, n) in,
// vel_out (3, lz, n, n) out, contiguous; float32 on the current device; the
// walls and halo planes as fs_divergence_ext's.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int fs_gradient_ext(const float* vel, long long cstride, const float* p,
                               const float* p_lo, const float* p_hi, float* vel_out, int n,
                               int lz, int wall_lo, int wall_hi, void* stream) {
  if (!ext_args_valid(n, lz, cstride, wall_lo, wall_hi, p_lo, p_hi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gradient_ext_kernel<<<fsk::cell_grid_slab(n, lz), fsk::cell_block(), 0,
                        static_cast<cudaStream_t>(stream)>>>(vel, cstride, p, p_lo, p_hi,
                                                             vel_out, n, lz, wall_lo, wall_hi);
  return static_cast<int>(cudaGetLastError());
}
