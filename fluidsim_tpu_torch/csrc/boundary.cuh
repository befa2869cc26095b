// The thread layout and the boundary rules shared by every kernel.
//
// One thread per cell of an n^3 grid stored [z, y, x], x across threadIdx.x
// so that each row of taps is one coalesced load per warp.
//
// Walls: the TPU kernels write a fresh buffer and then the set_bnd faces
// z->y->x (later write wins at shared edges and corners).  That makes every
// border cell a signed copy of the cell with its coordinates clamped to
// [1, n-2], negated when the field's normal axis is one of the border axes.
// So a border thread computes its interior cell and applies the sign: no
// second pass over the faces.
//
// Obstacles: the set_bnd obstacle mirror (ops/boundary._mirror_obstacles_axis)
// writes each interior solid cell of a velocity component from its fluid
// neighbours along the component's own axis, as total / max(count, 1), after
// the faces.
//
// Storage: a field is float32 or bfloat16 in memory (the storage type S);
// every kernel loads it with ld(), computes in float32 and rounds with st<S>()
// (round to nearest even) only where its twin rounds.
//
// Slabs: a kernel of the sharded step (K11) runs on a z-slab of nz planes
// whose plane 0 is global plane zoff of the n^3 grid, with open z edges.
// Only a plane at a global z wall (global z 0 or n-1) is a border plane; its
// interior plane is the slab's next plane inwards.  z neighbours are read at
// indices wrapped modulo nz, so no access leaves the slab (the planes the
// wrap feeds lie in the erosion margin the caller drops).  The whole grid is
// the slab {n, 0}, on which every rule reduces to the one above.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fsk {

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T st(float v);
template <>
__device__ __forceinline__ float st<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kBlockX = 32, kBlockY = 4, kBlockZ = 2;
constexpr int kThreads = kBlockX * kBlockY * kBlockZ;

inline dim3 cell_block() { return dim3(kBlockX, kBlockY, kBlockZ); }

inline dim3 cell_grid(int n) {
  return dim3((n + kBlockX - 1) / kBlockX, (n + kBlockY - 1) / kBlockY,
              (n + kBlockZ - 1) / kBlockZ);
}

__device__ __forceinline__ int clamp_interior(int i, int n) {
  return i < 1 ? 1 : (i > n - 2 ? n - 2 : i);
}

// Planes [0, nz) of a z-slab whose plane 0 is global plane zoff.
struct Slab {
  int nz, zoff;
};

// z wrapped into [0, nz), for z in [-nz, 2 nz).
__device__ __forceinline__ int wrap_plane(int z, int nz) {
  return z < 0 ? z + nz : (z >= nz ? z - nz : z);
}

inline dim3 cell_grid_slab(int n, int nz) {
  return dim3((n + kBlockX - 1) / kBlockX, (n + kBlockY - 1) / kBlockY,
              (nz + kBlockZ - 1) / kBlockZ);
}

// True when the set_bnd face rule negates field code b at a border cell whose
// interior cell is (cz, cy, cx): b = 1 negates across x walls, 2 across y
// walls, 3 across z walls, 0 never.
__device__ __forceinline__ bool face_negates(int b, int z, int y, int x,
                                             int cz, int cy, int cx) {
  return (b == 1 && x != cx) || (b == 2 && y != cy) || (b == 3 && z != cz);
}

struct Cell {
  int x, y, z, cx, cy, cz;
  long long idx, c;  // flat index of the cell and of its interior cell
};

__device__ __forceinline__ void fill_cell(int n, Cell& k) {
  k.cx = clamp_interior(k.x, n);
  k.cy = clamp_interior(k.y, n);
  k.cz = clamp_interior(k.z, n);
  const long long sn = n;
  k.idx = (k.z * sn + k.y) * sn + k.x;
  k.c = (k.cz * sn + k.cy) * sn + k.cx;
}

// fill_cell on a slab: the z clamp applies at the global z walls only.
__device__ __forceinline__ void fill_cell_slab(int n, const Slab& sl, Cell& k) {
  k.cx = clamp_interior(k.x, n);
  k.cy = clamp_interior(k.y, n);
  const int zg = k.z + sl.zoff;
  k.cz = zg == 0 ? wrap_plane(k.z + 1, sl.nz) : (zg == n - 1 ? wrap_plane(k.z - 1, sl.nz) : k.z);
  const long long sn = n;
  k.idx = (k.z * sn + k.y) * sn + k.x;
  k.c = (k.cz * sn + k.cy) * sn + k.cx;
}

__device__ __forceinline__ bool cell_of_thread_slab(int n, const Slab& sl, Cell& k) {
  k.x = blockIdx.x * blockDim.x + threadIdx.x;
  k.y = blockIdx.y * blockDim.y + threadIdx.y;
  k.z = blockIdx.z * blockDim.z + threadIdx.z;
  if (k.x >= n || k.y >= n || k.z >= sl.nz) return false;
  fill_cell_slab(n, sl, k);
  return true;
}

__device__ __forceinline__ bool cell_of_thread(int n, Cell& k) {
  k.x = blockIdx.x * blockDim.x + threadIdx.x;
  k.y = blockIdx.y * blockDim.y + threadIdx.y;
  k.z = blockIdx.z * blockDim.z + threadIdx.z;
  if (k.x >= n || k.y >= n || k.z >= n) return false;
  fill_cell(n, k);
  return true;
}

// The cell at flat index i < n^3 < 2^31 (x fastest), for the grid-stride
// loops of a persistent kernel (full_step.cu).
__device__ __forceinline__ Cell cell_at(int n, int i) {
  Cell k;
  const int row = i / n;
  k.x = i - row * n;
  k.y = row % n;
  k.z = row / n;
  fill_cell(n, k);
  return k;
}

// Internal linkage: every translation unit that launches these kernels gets
// its own copy, so the launch stubs of separately compiled units never clash.
namespace {

// The obstacle mirror, in place, on the n_fields components of v whose codes
// b0, b1, b2 are velocity codes (b = 1: x axis, 2: y, 3: z; 0: no mirror), on
// the slab `sl` of an n^3 grid ({n, 0}: the whole grid).  mask is one byte per
// cell, nonzero = solid.  A thread writes only its own cell, and only if that
// cell is interior (not a border cell) and solid; it reads a neighbour only
// if the neighbour is fluid, z neighbours at wrapped planes.  No cell is both
// written and read, so the pass has no race.  The mirror computes in float32
// and rounds once to S.
template <typename S>
__global__ void __launch_bounds__(kThreads)
    mirror_obstacles_kernel(S* __restrict__ v, const uint8_t* __restrict__ mask,
                            int n, Slab sl, int n_fields, int b0, int b1, int b2) {
  Cell k;
  if (!cell_of_thread_slab(n, sl, k) || k.idx != k.c || mask[k.idx] == 0) return;
  const long long sn = n, plane = sn * sn, vol = plane * sl.nz;
  const int bs[3] = {b0, b1, b2};
  for (int c = 0; c < n_fields; ++c) {
    const int b = bs[c];
    if (b < 1 || b > 3) continue;
    long long prev = k.idx - (b == 1 ? 1 : sn), next = k.idx + (b == 1 ? 1 : sn);
    if (b == 3) {
      prev = k.idx + (wrap_plane(k.z - 1, sl.nz) - k.z) * plane;
      next = k.idx + (wrap_plane(k.z + 1, sl.nz) - k.z) * plane;
    }
    S* f = v + c * vol;
    const bool prev_fluid = mask[prev] == 0;
    const bool next_fluid = mask[next] == 0;
    float lo = 0.0f, hi = 0.0f;
    if (prev_fluid) lo = -ld(f[prev]);
    if (next_fluid) hi = -ld(f[next]);
    const float total = lo + hi;
    const float count = float(prev_fluid) + float(next_fluid);
    f[k.idx] = st<S>(count > 0.0f ? total / (count < 1.0f ? 1.0f : count) : 0.0f);
  }
}

// out[i] = st<S>(in[i]) for i < count: the one rounding of a result that was
// finished in float32.
template <typename S>
__global__ void __launch_bounds__(kThreads)
    store_kernel(const float* __restrict__ in, S* __restrict__ out, long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = st<S>(in[i]);
}

inline unsigned flat_blocks(long long count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

}  // namespace

}  // namespace fsk
