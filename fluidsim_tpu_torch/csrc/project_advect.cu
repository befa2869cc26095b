// K2: pressure projection fused with density advection, four phases run in
// sequence on one stream by fs_project_advect_density:
//   1. divergence  -0.5*((dvx + dvy) + dvz) / n, rounded to the solve dtype;
//      the iterate starts at zero;
//   2. `iters` Jacobi sweeps  p <- round_sd((rhs + nbr(p)) * inv6), inv6 =
//      f32(1)/f32(6), nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-), ping-ponging
//      two solve-dtype buffers with the b=0 faces kept after every sweep;
//   3. per component  v - (0.5*(p[+1] - p[-1]))*n  from the float32 upcast of
//      the final iterate, the component's set_bnd faces, then * damp;
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

#include "advect.cuh"

namespace fsk {

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T st(float v);
template <>
__device__ __forceinline__ float st<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

struct Cell {
  int x, y, z, cx, cy, cz;
  long long idx, c;  // flat index of the cell and of its interior cell
};

__device__ __forceinline__ bool cell_of_thread(int n, Cell& k) {
  k.x = blockIdx.x * blockDim.x + threadIdx.x;
  k.y = blockIdx.y * blockDim.y + threadIdx.y;
  k.z = blockIdx.z * blockDim.z + threadIdx.z;
  if (k.x >= n || k.y >= n || k.z >= n) return false;
  k.cx = clamp_interior(k.x, n);
  k.cy = clamp_interior(k.y, n);
  k.cz = clamp_interior(k.z, n);
  const long long sn = n;
  k.idx = (k.z * sn + k.y) * sn + k.x;
  k.c = (k.cz * sn + k.cy) * sn + k.cx;
  return true;
}

constexpr int kThreads = kBlockX * kBlockY * kBlockZ;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    divergence_kernel(const float* __restrict__ vel, T* __restrict__ rhs,
                      T* __restrict__ p0, int n) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  p0[k.idx] = st<T>(0.0f);
  // The rhs is only ever read at interior cells.
  if (k.idx != k.c) return;
  const long long sn = n, plane = sn * sn, vol = plane * sn;
  const long long i = k.idx;
  const float dx = vel[i + 1] - vel[i - 1];
  const float dy = vel[vol + i + sn] - vel[vol + i - sn];
  const float dz = vel[2 * vol + i + plane] - vel[2 * vol + i - plane];
  rhs[i] = st<T>((-0.5f * ((dx + dy) + dz)) / float(n));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi_sweep_kernel(const T* __restrict__ src, const T* __restrict__ rhs,
                        T* __restrict__ dst, int n, float inv6) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  const long long sn = n, plane = sn * sn, c = k.c;
  const float xs = ld(src[c + 1]) + ld(src[c - 1]);
  const float ys = ld(src[c + sn]) + ld(src[c - sn]);
  const float zs = ld(src[c + plane]) + ld(src[c - plane]);
  dst[k.idx] = st<T>((ld(rhs[c]) + ((xs + ys) + zs)) * inv6);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gradient_kernel(const float* __restrict__ vel, const T* __restrict__ p,
                    float* __restrict__ vel_out, float* __restrict__ p_out, int n,
                    float damp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  const long long sn = n, plane = sn * sn, vol = plane * sn, c = k.c;
  const float nf = float(n);
  p_out[k.idx] = ld(p[k.idx]);
  const long long step[3] = {1, sn, plane};
  const bool negate[3] = {k.x != k.cx, k.y != k.cy, k.z != k.cz};
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    const float g = (0.5f * (ld(p[c + step[comp]]) - ld(p[c - step[comp]]))) * nf;
    const float u = vel[comp * vol + c] - g;
    vel_out[comp * vol + k.idx] = (negate[comp] ? -u : u) * damp;
  }
}

__global__ void __launch_bounds__(kThreads)
    density_advect_kernel(const float* __restrict__ dens, const float* __restrict__ vel,
                          float* __restrict__ out, int n, float dt0, float dens_damp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  float v[1];
  advect_cell_k1<1, false>(dens, vel, nullptr, Buoyancy{}, n, dt0, k.cz, k.cy, k.cx, v);
  out[k.idx] = v[0] * dens_damp;
}

template <typename T>
int run(const float* vel, const float* dens, float* vel_out, float* p_out, float* dens_out,
        T* pa, T* pb, T* rhs, int n, int iters, float dt0, float damp, float dens_damp,
        cudaStream_t s) {
  const dim3 grid = cell_grid(n), block = cell_block();
  const float inv6 = 1.0f / 6.0f;
  divergence_kernel<T><<<grid, block, 0, s>>>(vel, rhs, pa, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  T* src = pa;
  T* dst = pb;
  for (int it = 0; it < iters; ++it) {
    jacobi_sweep_kernel<T><<<grid, block, 0, s>>>(src, rhs, dst, n, inv6);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    std::swap(src, dst);
  }
  gradient_kernel<T><<<grid, block, 0, s>>>(vel, src, vel_out, p_out, n, damp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  density_advect_kernel<<<grid, block, 0, s>>>(dens, vel_out, dens_out, n, dt0, dens_damp);
  return static_cast<int>(cudaGetLastError());
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
  if (solve_bf16) {
    return run<__nv_bfloat16>(vel, dens, vel_out, p_out, dens_out,
                              static_cast<__nv_bfloat16*>(p_a), static_cast<__nv_bfloat16*>(p_b),
                              static_cast<__nv_bfloat16*>(rhs), n, iters, dt0, damp,
                              dens_damp, s);
  }
  return run<float>(vel, dens, vel_out, p_out, dens_out, static_cast<float*>(p_a),
                    static_cast<float*>(p_b), static_cast<float*>(rhs), n, iters, dt0, damp,
                    dens_damp, s);
}
