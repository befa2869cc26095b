// The halo exchange of the explicit sharded step as plane moves on one
// device, K13's (halo_exchange.cu: build every shard's extended arrays; K12
// pushes its edge planes from its own last sweep, jacobi_pass.cuh).
//
// A shard's extended array is (C, lz + 2h, n, n): its lz planes in the
// middle, h planes of each neighbour's edge around them, zeros past the
// global ends (parallel/halo.halo_exchange_z followed by a cat).  A shard
// moves its own planes: its lz local planes into the middle of its own
// output, its bottom h planes into the top halo of the lower neighbour's
// output (planes [lz + h, lz + 2h)), its top h planes into the bottom halo of
// the upper neighbour's output (planes [0, h)); at a global end, where that
// neighbour is missing, it zeroes its own halo on that side instead.  So
// every plane of every output has exactly one writer, and the shards'
// launches need no order among themselves.  The neighbours' outputs arrive
// as plain device pointers (null at a global end): on one card they are the
// neighbour shards' buffers; across cards they would be peer pointers.
//
// A plane is moved as bytes, so one code serves every element size (4:
// float32, 2: bfloat16, 1: the bool mask): 16 bytes a thread and step where
// both ends and the plane's size are 16-byte aligned, else one byte.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fsk {

constexpr int kMaxArrays = 4;
constexpr int kMoveThreads = 256;

// One array of an exchange.  src holds the shard's local planes, channel c's
// lz planes starting src_cstride values after channel c - 1's; out is its
// (channels, lz + 2h, n, n) extended output, out_lo and out_hi the lower and
// upper neighbours' (null at a global end); elem is the bytes of a value.
struct HaloArray {
  const void* src;
  void* out;
  void* out_lo;
  void* out_hi;
  long long src_cstride;
  int channels, elem;
};

struct Exchange {
  HaloArray a[kMaxArrays];
  int n_arrays, lz, h, n;
};

namespace {

// `bytes` bytes from src to dst (src null: zeros), shared by the blocks of
// one blockIdx.y.
__device__ __forceinline__ void move_plane(const unsigned char* src, unsigned char* dst,
                                           long long bytes) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(bytes);
  if ((align & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = first; i < bytes / 16; i += step) {
      d[i] = src != nullptr ? s[i] : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (long long i = first; i < bytes; i += step) {
      dst[i] = src != nullptr ? src[i] : static_cast<unsigned char>(0);
    }
  }
}

// The planes one shard moves, blockIdx.y (striding by gridDim.y) picking the
// plane: per array and channel, lz planes of the middle, then h planes
// pushed down (or zeroed below) and h pushed up (or zeroed above).
__global__ void __launch_bounds__(kMoveThreads)
    exchange_kernel(const __grid_constant__ Exchange e) {
  const int lz = e.lz, h = e.h;
  const int per_channel = lz + 2 * h;
  const long long cells = static_cast<long long>(e.n) * e.n;
  long long total = 0;
  for (int j = 0; j < e.n_arrays; ++j) {
    total += static_cast<long long>(e.a[j].channels) * per_channel;
  }
  for (long long task = blockIdx.y; task < total; task += gridDim.y) {
    long long t = task;
    int j = 0;
    while (t >= static_cast<long long>(e.a[j].channels) * per_channel) {
      t -= static_cast<long long>(e.a[j].channels) * per_channel;
      ++j;
    }
    const HaloArray& a = e.a[j];
    const long long plane = cells * a.elem;
    const int c = static_cast<int>(t / per_channel);
    int i = static_cast<int>(t % per_channel);
    const unsigned char* src =
        static_cast<const unsigned char*>(a.src) + c * a.src_cstride * a.elem;
    const long long cout = static_cast<long long>(c) * (lz + 2 * h) * plane;
    unsigned char* const own = static_cast<unsigned char*>(a.out) + cout;
    unsigned char* const lo = static_cast<unsigned char*>(a.out_lo);
    unsigned char* const hi = static_cast<unsigned char*>(a.out_hi);
    const unsigned char* from;
    unsigned char* to;
    if (i < lz) {
      from = src + i * plane;
      to = own + (h + i) * plane;
    } else {
      i -= lz;
      if (i < h) {  // my bottom plane i: the lower shard's top halo
        from = lo != nullptr ? src + i * plane : nullptr;
        to = lo != nullptr ? lo + cout + (lz + h + i) * plane : own + i * plane;
      } else {  // my top plane lz - h + i: the upper shard's bottom halo
        i -= h;
        from = hi != nullptr ? src + (lz - h + i) * plane : nullptr;
        to = hi != nullptr ? hi + cout + i * plane : own + (lz + h + i) * plane;
      }
    }
    move_plane(from, to, plane);
  }
}

// Launches exchange_kernel for `e` on `s`.
cudaError_t launch_exchange(const Exchange& e, cudaStream_t s) {
  if (e.n_arrays < 1 || e.n_arrays > kMaxArrays || e.h < 0 || e.h > e.lz || e.n < 1) {
    return cudaErrorInvalidValue;
  }
  long long total = 0, widest = 0;
  for (int j = 0; j < e.n_arrays; ++j) {
    const HaloArray& a = e.a[j];
    if (a.src == nullptr || a.out == nullptr || a.channels < 1 ||
        (a.elem != 1 && a.elem != 2 && a.elem != 4)) {
      return cudaErrorInvalidValue;
    }
    total += static_cast<long long>(a.channels) * (e.lz + 2 * e.h);
    const long long bytes = static_cast<long long>(e.n) * e.n * a.elem;
    widest = bytes > widest ? bytes : widest;
  }
  if (total == 0) return cudaSuccess;
  // About 8 16-byte moves a thread on the widest plane.
  const long long per_block = 16LL * kMoveThreads * 8;
  const int gx = static_cast<int>((widest + per_block - 1) / per_block);
  const dim3 grid(gx < 1 ? 1 : (gx > 64 ? 64 : gx),
                  static_cast<unsigned>(total < 65535 ? total : 65535));
  exchange_kernel<<<grid, kMoveThreads, 0, s>>>(e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsk
