// Device code shared by the semi-Lagrangian backtrace kernels: the
// self-advection kernel (advect.cu), the density phase of the fused
// projection (project_advect.cu) and the whole-step kernel (full_step.cu).
// It is the counterpart of fluidsim_tpu/pallas/advect.py::_substep_window_vals
// (one substep of it; the caller loops over the substeps), which the TPU
// kernels share the same way.  Only K1 takes windows K > 1.
//
// Arithmetic follows the TPU kernel operation by operation (the build uses
// -fmad=false, so nothing is contracted into an FMA):
//   frac:  t = coord - dt0*v; t = max(t, 0.5); t = min(t, n-1.5);
//          t = clip(t, coord-K, coord+K); f = t - coord
//   K = 1, comb (windowed_sum_k1):  (g0 + wp*(gp - g0)) + wm*(gm - g0), with
//          wp = relu(f) and wm = relu(-f), nested x innermost, then y, then z;
//   K > 1, the hat sum (windowed_sum):  acc += ((hz*hy)*hx)*g over dz, dy,
//          dx in [-K, K] in that order from acc = 0, hat(f, d) =
//          max(0, 1 - |f - d|).
// Only interior cells are ever interpolated (border cells copy theirs, see
// boundary.cuh).  For K = 1 every tap (at most one cell away) lies inside the
// grid.  For K > 1 taps are read at wrapped indices, as the twin's
// torch.roll reads them: the clamp gives every tap outside the grid zero
// weight, and reading it there keeps even a zero weight times a non-finite
// value the twin's.
//
// The device functions take plain pointers: full_step.cu reads, in a later
// phase of the same launch, buffers that an earlier phase wrote, which rules
// out the read-only cache that __restrict__ lets the compiler use.  The
// __global__ kernels mark their own arguments __restrict__.
#pragma once

#include "boundary.cuh"

namespace fsk {

// jnp.maximum(t, lo) / jnp.minimum(t, hi) for a finite bound; a NaN t passes
// through unchanged, as it does in JAX.
__device__ __forceinline__ float max_to(float t, float lo) { return t < lo ? lo : t; }
__device__ __forceinline__ float min_to(float t, float hi) { return t > hi ? hi : t; }

// Buoyancy folded into the y velocity: ops/forces.buoyancy_force, per cell.
struct Buoyancy {
  float dt, b, ambient, gravity;
};

__device__ __forceinline__ float buoyant_vy(float vy, float rho, const Buoyancy& bp) {
  const float accel = bp.b * (rho - bp.ambient) - bp.gravity * rho;
  return vy + bp.dt * accel;
}

// The folded emitter, scene/sources.src_field_add at cell (z, y, x):
// e = [px, py, pz, strength, radius] (centre and radius in cells), and
//   d = sqrt(((x-px)^2 + (y-py)^2) + (z-pz)^2),
//   v + strength * (d <= r ? 1 - d/r : 0).
// More than r + 1 from the centre along any axis the distance exceeds r
// whatever its rounding, so the add is of a zero: skipped (as the TPU
// kernels skip the windows the ball misses, src_window_hit).
__device__ __forceinline__ float emitter_add(float v, const float* e, int z, int y, int x) {
  const float dx = float(x) - e[0], dy = float(y) - e[1], dz = float(z) - e[2];
  const float r = e[4], reach = r + 1.0f;
  if (fabsf(dx) > reach || fabsf(dy) > reach || fabsf(dz) > reach) return v;
  const float d = sqrtf((dx * dx + dy * dy) + dz * dz);
  const float falloff = d <= r ? 1.0f - d / r : 0.0f;
  return v + e[3] * falloff;
}

template <int K>
__device__ __forceinline__ float frac_win(float coord, float v, float dt0, float hi) {
  float t = coord - dt0 * v;
  t = max_to(t, 0.5f);
  t = min_to(t, hi);
  t = min_to(max_to(t, coord - float(K)), coord + float(K));
  return t - coord;
}

__device__ __forceinline__ float hat(float f, int d) {
  return max_to(1.0f - fabsf(f - float(d)), 0.0f);
}

__device__ __forceinline__ float comb(float gm, float g0, float gp, float wp, float wm) {
  return (g0 + wp * (gp - g0)) + wm * (gm - g0);
}

// Where a folded emitter's add goes: nowhere, onto the buoyancy's density
// (K1's self-advection, JAX advect_multi_3d_pallas(buoy=, src=)), or onto the
// advected field itself (the fused projection's density phase, K2s).
enum SrcOn { kSrcNone = 0, kSrcDensity = 1, kSrcFields = 2 };

// The F advected fields at interior cell (z, y, x) of an n^3 grid.  fields is
// (F, n, n, n) and vel (3, n, n, n), both [z, y, x].  BUOY_VEL adds the
// buoyancy of the density at the cell to the y velocity of the backtrace;
// BUOY_TAPS (self-advection: the fields are the velocity itself) also adds
// it to every tap of the y component, from the density at that tap.  SRC
// adds the emitter `e` to the density (or field) value at each point read.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, int SRC>
__device__ __forceinline__ void advect_cell_k1(const float* fields, const float* vel,
                                               const float* dens, const float* e,
                                               const Buoyancy bp, int n, float dt0,
                                               int z, int y, int x, float (&out)[F]) {
  const long long sn = n, plane = sn * sn, vol = plane * sn;
  const long long c0 = (z * sn + y) * sn + x;
  const float vx = vel[c0];
  float vy = vel[vol + c0];
  const float vz = vel[2 * vol + c0];
  if (BUOY_VEL) {
    float rho = dens[c0];
    if (SRC == kSrcDensity) rho = emitter_add(rho, e, z, y, x);
    vy = buoyant_vy(vy, rho, bp);
  }
  const float hi = float(n) - 1.5f;
  const float fx = frac_win<1>(float(x), vx, dt0, hi);
  const float fy = frac_win<1>(float(y), vy, dt0, hi);
  const float fz = frac_win<1>(float(z), vz, dt0, hi);
  const float fxp = max_to(fx, 0.0f), fxm = max_to(-fx, 0.0f);
  const float fyp = max_to(fy, 0.0f), fym = max_to(-fy, 0.0f);
  const float fzp = max_to(fz, 0.0f), fzm = max_to(-fz, 0.0f);

#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float* f = fields + c * vol;
    float zc[3];
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
      float yc[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const long long r = c0 + dz * plane + dy * sn;
        float g[3];
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          g[dx + 1] = f[r + dx];
          if (SRC == kSrcFields) g[dx + 1] = emitter_add(g[dx + 1], e, z + dz, y + dy, x + dx);
          if (BUOY_TAPS && c == 1) {
            float rho = dens[r + dx];
            if (SRC == kSrcDensity) rho = emitter_add(rho, e, z + dz, y + dy, x + dx);
            g[dx + 1] = buoyant_vy(g[dx + 1], rho, bp);
          }
        }
        yc[dy + 1] = comb(g[0], g[1], g[2], fxp, fxm);
      }
      zc[dz + 1] = comb(yc[0], yc[1], yc[2], fyp, fym);
    }
    out[c] = comb(zc[0], zc[1], zc[2], fzp, fzm);
  }
}

// The same for a window of K > 1 cells: the (2K+1)^3-term hat sum, taps at
// wrapped indices (n >= 2K+1).  The x and y hats are computed once, the z
// hat once per plane, and the weights shared by the F fields; the buoyancy
// enters as in advect_cell_k1.  The z loop is not unrolled
// (the unrolled K = 3 body is ~7x the code, and ptxas time with it).
template <int K, int F, bool BUOY_VEL, bool BUOY_TAPS>
__device__ __forceinline__ void advect_cell_win(const float* fields, const float* vel,
                                                const float* dens, const Buoyancy bp, int n,
                                                float dt0, int z, int y, int x,
                                                float (&out)[F]) {
  constexpr int W = 2 * K + 1;
  const long long sn = n, vol = sn * sn * sn;
  const long long c0 = (z * sn + y) * sn + x;
  const float vx = vel[c0];
  float vy = vel[vol + c0];
  const float vz = vel[2 * vol + c0];
  if (BUOY_VEL) vy = buoyant_vy(vy, dens[c0], bp);
  const float hi = float(n) - 1.5f;
  const float fx = frac_win<K>(float(x), vx, dt0, hi);
  const float fy = frac_win<K>(float(y), vy, dt0, hi);
  const float fz = frac_win<K>(float(z), vz, dt0, hi);
  float hx[W], hy[W];
  int xs[W], ys[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    hx[d] = hat(fx, d - K);
    hy[d] = hat(fy, d - K);
    xs[d] = (x + d - K + n) % n;
    ys[d] = (y + d - K + n) % n;
  }
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.0f;
#pragma unroll 1
  for (int dz = 0; dz < W; ++dz) {
    const float wz = hat(fz, dz - K);
    const int tz = (z + dz - K + n) % n;
#pragma unroll
    for (int dy = 0; dy < W; ++dy) {
      const float wzy = wz * hy[dy];
      const long long row = (tz * sn + ys[dy]) * sn;
#pragma unroll
      for (int dx = 0; dx < W; ++dx) {
        const float w = wzy * hx[dx];
        const long long t = row + xs[dx];
#pragma unroll
        for (int c = 0; c < F; ++c) {
          float g = fields[c * vol + t];
          if (BUOY_TAPS && c == 1) g = buoyant_vy(g, dens[t], bp);
          acc[c] = acc[c] + w * g;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) out[c] = acc[c];
}

// One substep's operands.  src (F, n, n, n) is read and dst written; dens is
// the buoyancy's density, mask one byte per cell (nonzero = solid) and
// emitter the (5,) descriptor, each null when unused; b0..b2 the fields'
// boundary codes; scale multiplies every output value after the faces.
struct Substep {
  const float *src, *vel, *dens;
  const uint8_t* mask;
  const float* emitter;
  float* dst;
  int n, b0, b1, b2;
  float dt0, scale;
  Buoyancy bp;
};

// One substep at cell k: the backtrace (a solid interior cell is zero
// instead), then the set_bnd face sign of each field's code, then the scale.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, int K = 1>
__device__ __forceinline__ void advect_store(const Substep& a, const Cell& k) {
  float v[F];
  if (MASK && a.mask[k.c] != 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = 0.0f;
  } else if constexpr (K == 1) {
    advect_cell_k1<F, BUOY_VEL, BUOY_TAPS, SRC>(a.src, a.vel, a.dens, a.emitter, a.bp, a.n,
                                                 a.dt0, k.cz, k.cy, k.cx, v);
  } else {
    static_assert(SRC == kSrcNone || K == 1, "the emitter folds only into K = 1");
    advect_cell_win<K, F, BUOY_VEL, BUOY_TAPS>(a.src, a.vel, a.dens, a.bp, a.n, a.dt0, k.cz,
                                               k.cy, k.cx, v);
  }
  const long long vol = static_cast<long long>(a.n) * a.n * a.n;
  const int bs[3] = {a.b0, a.b1, a.b2};
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float u = face_negates(bs[c], k.z, k.y, k.x, k.cz, k.cy, k.cx) ? -v[c] : v[c];
    a.dst[c * vol + k.idx] = u * a.scale;
  }
}

// Internal linkage, as in boundary.cuh: every source that launches K1's
// kernel gets its own copy.
namespace {

template <int K, int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC>
__global__ void __launch_bounds__(kThreads)
    advect_kernel(const float* __restrict__ src, const float* __restrict__ vel,
                  const float* __restrict__ dens, const uint8_t* __restrict__ mask,
                  const float* __restrict__ emitter, float* __restrict__ dst, int n, int b0,
                  int b1, int b2, float dt0, float scale, Buoyancy bp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  advect_store<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, K>(
      Substep{src, vel, dens, mask, emitter, dst, n, b0, b1, b2, dt0, scale, bp}, k);
}

template <int K, int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC>
cudaError_t launch(const Substep& a, cudaStream_t s) {
  advect_kernel<K, F, BUOY_VEL, BUOY_TAPS, MASK, SRC><<<cell_grid(a.n), cell_block(), 0, s>>>(
      a.src, a.vel, a.dens, a.mask, a.emitter, a.dst, a.n, a.b0, a.b1, a.b2, a.dt0, a.scale,
      a.bp);
  return cudaGetLastError();
}

// The variants the port runs, for one window K: buoyancy only in velocity
// self-advection without a mask, with the emitter on its density only for
// K = 1 (the fold needs the fused K2s, which takes K = 1); the emitter on
// the field only for a scalar without a mask (K2s's density phase).
template <int K>
cudaError_t launch_window(const Substep& a, int n_fields, bool buoy_vel, bool buoy_taps,
                          int src, cudaStream_t s) {
  const bool masked = a.mask != nullptr;
  if (n_fields == 3 && buoy_vel && !masked) {
    if (K == 1 && src == kSrcDensity) {
      return buoy_taps ? launch<1, 3, true, true, false, kSrcDensity>(a, s)
                       : launch<1, 3, true, false, false, kSrcDensity>(a, s);
    }
    if (src == kSrcNone) {
      return buoy_taps ? launch<K, 3, true, true, false, kSrcNone>(a, s)
                       : launch<K, 3, true, false, false, kSrcNone>(a, s);
    }
    return cudaErrorInvalidValue;
  }
  if (buoy_vel) return cudaErrorInvalidValue;
  if (K == 1 && n_fields == 1 && src == kSrcFields && !masked) {
    return launch<1, 1, false, false, false, kSrcFields>(a, s);
  }
  if (src != kSrcNone) return cudaErrorInvalidValue;
  if (n_fields == 3) {
    return masked ? launch<K, 3, false, false, true, kSrcNone>(a, s)
                  : launch<K, 3, false, false, false, kSrcNone>(a, s);
  }
  if (n_fields == 1) {
    return masked ? launch<K, 1, false, false, true, kSrcNone>(a, s)
                  : launch<K, 1, false, false, false, kSrcNone>(a, s);
  }
  return cudaErrorInvalidValue;
}


// n_sub substeps of a.src through a.vel with a window of K cells (a
// template parameter, so that only K1's source instantiates K > 1), one
// launch each, the last into out
// and the earlier ones alternating back from it with tmp (which may be null
// when n_sub == 1), so the input is never written.  With a mask, velocity
// codes get the obstacle mirror after every substep, as a second launch in
// place.  The buoyancy (and the emitter on its density) enters every
// substep's backtrace velocity and the first substep's taps; an emitter on
// the fields enters the first substep only, whose input it is.  `scale`
// multiplies the last substep's output (not with a mirror, which would have
// to come first).  Returns the first cudaError_t.
template <int K = 1>
cudaError_t advect_substeps(Substep a, int n_fields, int n_sub, bool buoy, int src,
                            float* out, float* tmp, float scale, cudaStream_t s) {
  if (n_sub < 1 || (n_sub > 1 && tmp == nullptr)) return cudaErrorInvalidValue;
  const int bs[3] = {a.b0, a.b1, a.b2};
  bool mirror = false;
  for (int c = 0; c < n_fields && c < 3; ++c) {
    mirror = mirror || (a.mask != nullptr && bs[c] >= 1 && bs[c] <= 3);
  }
  if (mirror && scale != 1.0f) return cudaErrorInvalidValue;
  for (int sub = 0; sub < n_sub; ++sub) {
    a.dst = (n_sub - 1 - sub) % 2 == 0 ? out : tmp;
    a.scale = sub == n_sub - 1 ? scale : 1.0f;
    const int sub_src = (src == kSrcFields && sub > 0) ? kSrcNone : src;
    cudaError_t err = launch_window<K>(a, n_fields, buoy, buoy && sub == 0, sub_src, s);
    if (err != cudaSuccess) return err;
    if (mirror) {
      mirror_obstacles_kernel<<<cell_grid(a.n), cell_block(), 0, s>>>(a.dst, a.mask, a.n,
                                                                      n_fields, a.b0, a.b1,
                                                                      a.b2);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    a.src = a.dst;
  }
  return cudaSuccess;
}

}  // namespace

}  // namespace fsk
