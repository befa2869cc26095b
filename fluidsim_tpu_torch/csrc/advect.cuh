// Device code shared by the K=1 semi-Lagrangian backtrace kernels: the
// self-advection kernel (advect.cu) and the density phase of the fused
// projection (project_advect.cu).  It is the counterpart of
// fluidsim_tpu/pallas/advect.py::_substep_window_vals with k_win = 1 (one
// substep of it; the caller loops over the substeps), which the TPU kernels
// share the same way.
//
// Arithmetic follows the TPU kernel operation by operation (the build uses
// -fmad=false, so nothing is contracted into an FMA):
//   frac:  t = coord - dt0*v; t = max(t, 0.5); t = min(t, n-1.5);
//          t = clip(t, coord-1, coord+1); f = t - coord
//   comb:  (g0 + wp*(gp - g0)) + wm*(gm - g0), with wp = relu(f) and
//          wm = relu(-f), nested x innermost, then y, then z.
// Only interior cells are ever interpolated (border cells copy theirs, see
// boundary.cuh), so every tap (at most one cell away) lies inside the grid:
// no wrapped or clamped reads are needed.
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

__device__ __forceinline__ float frac_k1(float coord, float v, float dt0, float hi) {
  float t = coord - dt0 * v;
  t = max_to(t, 0.5f);
  t = min_to(t, hi);
  t = min_to(max_to(t, coord - 1.0f), coord + 1.0f);
  return t - coord;
}

__device__ __forceinline__ float comb(float gm, float g0, float gp, float wp, float wm) {
  return (g0 + wp * (gp - g0)) + wm * (gm - g0);
}

// The F advected fields at interior cell (z, y, x) of an n^3 grid.  fields is
// (F, n, n, n) and vel (3, n, n, n), both [z, y, x].  BUOY_VEL adds the
// buoyancy of the density at the cell to the y velocity of the backtrace;
// BUOY_TAPS (self-advection: the fields are the velocity itself) also adds
// it to every tap of the y component, from the density at that tap.
template <int F, bool BUOY_VEL, bool BUOY_TAPS>
__device__ __forceinline__ void advect_cell_k1(const float* __restrict__ fields,
                                               const float* __restrict__ vel,
                                               const float* __restrict__ dens,
                                               const Buoyancy bp, int n, float dt0,
                                               int z, int y, int x, float (&out)[F]) {
  const long long sn = n, plane = sn * sn, vol = plane * sn;
  const long long c0 = (z * sn + y) * sn + x;
  const float vx = vel[c0];
  float vy = vel[vol + c0];
  const float vz = vel[2 * vol + c0];
  if (BUOY_VEL) vy = buoyant_vy(vy, dens[c0], bp);
  const float hi = float(n) - 1.5f;
  const float fx = frac_k1(float(x), vx, dt0, hi);
  const float fy = frac_k1(float(y), vy, dt0, hi);
  const float fz = frac_k1(float(z), vz, dt0, hi);
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
          if (BUOY_TAPS && c == 1) g[dx + 1] = buoyant_vy(g[dx + 1], dens[r + dx], bp);
        }
        yc[dy + 1] = comb(g[0], g[1], g[2], fxp, fxm);
      }
      zc[dz + 1] = comb(yc[0], yc[1], yc[2], fyp, fym);
    }
    out[c] = comb(zc[0], zc[1], zc[2], fzp, fzm);
  }
}

}  // namespace fsk
