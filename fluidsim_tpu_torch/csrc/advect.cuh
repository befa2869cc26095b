// Device code shared by the semi-Lagrangian backtrace kernels: the
// self-advection kernel (advect.cu), the density phase of the fused
// projection (project_advect.cu), the whole-step kernel (full_step.cu) and
// the sharded step's slab kernel (advect_ext.cu, K11).
// It is the counterpart of fluidsim_tpu/pallas/advect.py::_substep_window_vals
// (one substep of it; the caller loops over the substeps), which the TPU
// kernels share the same way.  Every kernel that backtraces takes a window of
// any K >= 1 cells: K = 1, 2 and 3 are compile-time bodies, every K >= 4 one
// body with a runtime K (kWinAny).  A launch of a K = 1 substep (K1, K2's
// density phase, K11) runs advect_tiled.cuh's kernel, which stages each tap
// once a tile and is bitwise advect_cell_k1; a launch at any K >= 2 runs
// advect_window.cuh's, which stages a tile widened by K and sums only the
// <= 8 taps the clamp leaves with weight where every tap of the window is
// finite: every other hat is +0, and adding (+0) * g for a finite g never
// changes the bits of a sum that starts at +0, so it is bitwise the
// (2K+1)^3-term hat sum (else it takes that sum).  Above the K where its ring
// fits, a launch runs one thread a cell with the runtime-K body.  The
// whole-step kernels (K8, K14) call advect_cell_k1 per cell at K = 1; at
// K >= 2 the same <= 8-tap sum (eight_taps, advect_cell_eight) where their
// vote finds the substep's whole source finite, else advect_cell_win(_rt).
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
// Every body runs on a slab `sl` of the grid (boundary.cuh; {n, 0}, the whole
// grid, for every kernel but K11): the backtrace, its clamp and the emitter
// take global z (zoff + z), the taps' z is wrapped modulo nz, and a field's
// volume is n*n*nz.  On the whole grid the wrap never fires for K = 1 and is
// the modulo n above for K > 1.
//
// Storage: the fields and the velocity are read in their storage types (TF,
// TV: float or __nv_bfloat16) and widened to float32; the density of the
// buoyancy and the emitter are float32 (the folds need float32 fields, as in
// the JAX package).  A substep's result is rounded to its output type TO
// once; the substeps in between stay float32, as the TPU kernel keeps them
// in VMEM.
//
// The device functions take plain pointers: full_step.cu reads, in a later
// phase of the same launch, buffers that an earlier phase wrote, which rules
// out the read-only cache that __restrict__ lets the compiler use.  The
// __global__ kernels mark their own arguments __restrict__.
#pragma once

#include <type_traits>

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

// The template argument K of the windowed bodies that stands for a window
// of K >= 4 cells, read at run time from Substep::window.
constexpr int kWinAny = 0;

__device__ __forceinline__ float frac_win(float coord, float v, float dt0, float hi, int k) {
  float t = coord - dt0 * v;
  t = max_to(t, 0.5f);
  t = min_to(t, hi);
  t = min_to(max_to(t, coord - float(k)), coord + float(k));
  return t - coord;
}

template <int K>
__device__ __forceinline__ float frac_win(float coord, float v, float dt0, float hi) {
  return frac_win(coord, v, dt0, hi, K);
}

__device__ __forceinline__ float hat(float f, int d) {
  return max_to(1.0f - fabsf(f - float(d)), 0.0f);
}

__device__ __forceinline__ float comb(float gm, float g0, float gp, float wp, float wm) {
  return (g0 + wp * (gp - g0)) + wm * (gm - g0);
}

// The <= 8 taps of a window of k >= 2 cells that the clamp leaves with
// weight (advect_window.cuh says why their sum is bitwise the hat sum where
// every tap of the window is finite and no displacement is NaN): on each
// axis the taps at d = min(floor(f), k - 1) and d + 1, and their weights in
// the hat sum's order (dz, then dy, then dx ascending; ((hz * hy) * hx)).
// The windowed tiles (advect_window.cuh) and the whole-step kernels
// (full_step.cuh) both take them from here.
struct EightTaps {
  int ix, iy, iz;
  float w[8];
};

__device__ __forceinline__ EightTaps eight_taps(float fx, float fy, float fz, int k) {
  EightTaps t;
  t.ix = min(int(floorf(fx)), k - 1);
  t.iy = min(int(floorf(fy)), k - 1);
  t.iz = min(int(floorf(fz)), k - 1);
  const float hx0 = hat(fx, t.ix), hx1 = hat(fx, t.ix + 1);
  const float hy0 = hat(fy, t.iy), hy1 = hat(fy, t.iy + 1);
  const float hz0 = hat(fz, t.iz), hz1 = hat(fz, t.iz + 1);
  t.w[0] = (hz0 * hy0) * hx0;
  t.w[1] = (hz0 * hy0) * hx1;
  t.w[2] = (hz0 * hy1) * hx0;
  t.w[3] = (hz0 * hy1) * hx1;
  t.w[4] = (hz1 * hy0) * hx0;
  t.w[5] = (hz1 * hy0) * hx1;
  t.w[6] = (hz1 * hy1) * hx0;
  t.w[7] = (hz1 * hy1) * hx1;
  return t;
}

// The sum of the 8 taps g (g[i] the tap of weight w[i]) from +0, in the hat
// sum's order.
__device__ __forceinline__ float eight_tap_sum(const float (&w)[8], const float (&g)[8]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = acc + w[i] * g[i];
  return acc;
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
template <int F, bool BUOY_VEL, bool BUOY_TAPS, int SRC, typename TF, typename TV>
__device__ __forceinline__ void advect_cell_k1(const TF* fields, const TV* vel,
                                               const float* dens, const float* e,
                                               const Buoyancy bp, int n, const Slab& sl,
                                               float dt0, int z, int y, int x,
                                               float (&out)[F]) {
  const long long sn = n, plane = sn * sn, vol = plane * sl.nz;
  const long long c0 = (z * sn + y) * sn + x;
  const int zg = z + sl.zoff;
  const float vx = ld(vel[c0]);
  float vy = ld(vel[vol + c0]);
  const float vz = ld(vel[2 * vol + c0]);
  if (BUOY_VEL) {
    float rho = dens[c0];
    if (SRC == kSrcDensity) rho = emitter_add(rho, e, zg, y, x);
    vy = buoyant_vy(vy, rho, bp);
  }
  const float hi = float(n) - 1.5f;
  const float fx = frac_win<1>(float(x), vx, dt0, hi);
  const float fy = frac_win<1>(float(y), vy, dt0, hi);
  const float fz = frac_win<1>(float(zg), vz, dt0, hi);
  const float fxp = max_to(fx, 0.0f), fxm = max_to(-fx, 0.0f);
  const float fyp = max_to(fy, 0.0f), fym = max_to(-fy, 0.0f);
  const float fzp = max_to(fz, 0.0f), fzm = max_to(-fz, 0.0f);

#pragma unroll
  for (int c = 0; c < F; ++c) {
    const TF* f = fields + c * vol;
    float zc[3];
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
      const int tz = wrap_plane(z + dz, sl.nz);
      float yc[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const long long r = c0 + (tz - z) * plane + dy * sn;
        float g[3];
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          g[dx + 1] = ld(f[r + dx]);
          if (SRC == kSrcFields) {
            g[dx + 1] = emitter_add(g[dx + 1], e, sl.zoff + tz, y + dy, x + dx);
          }
          if (BUOY_TAPS && c == 1) {
            float rho = dens[r + dx];
            if (SRC == kSrcDensity) rho = emitter_add(rho, e, sl.zoff + tz, y + dy, x + dx);
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
// wrapped indices (n >= 2K+1, nz >= 2K+1).  The x and y hats are computed once, the z
// hat once per plane, and the weights shared by the F fields; the buoyancy
// and the emitter enter as in advect_cell_k1, the emitter at a tap's wrapped
// coordinates (where the twin's torch.roll reads it).  The z loop is not
// unrolled (the unrolled K = 3 body is ~7x the code, and ptxas time with it).
template <int K, int F, bool BUOY_VEL, bool BUOY_TAPS, int SRC, typename TF, typename TV>
__device__ __forceinline__ void advect_cell_win(const TF* fields, const TV* vel,
                                                const float* dens, const float* e,
                                                const Buoyancy bp, int n, const Slab& sl,
                                                float dt0, int z, int y, int x,
                                                float (&out)[F]) {
  constexpr int W = 2 * K + 1;
  const long long sn = n, vol = sn * sn * sl.nz;
  const long long c0 = (z * sn + y) * sn + x;
  const int zg = z + sl.zoff;
  const float vx = ld(vel[c0]);
  float vy = ld(vel[vol + c0]);
  const float vz = ld(vel[2 * vol + c0]);
  if (BUOY_VEL) {
    float rho = dens[c0];
    if (SRC == kSrcDensity) rho = emitter_add(rho, e, zg, y, x);
    vy = buoyant_vy(vy, rho, bp);
  }
  const float hi = float(n) - 1.5f;
  const float fx = frac_win<K>(float(x), vx, dt0, hi);
  const float fy = frac_win<K>(float(y), vy, dt0, hi);
  const float fz = frac_win<K>(float(zg), vz, dt0, hi);
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
    const int tz = (z + dz - K + sl.nz) % sl.nz;
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
          float g = ld(fields[c * vol + t]);
          if (SRC == kSrcFields) g = emitter_add(g, e, sl.zoff + tz, ys[dy], xs[dx]);
          if (BUOY_TAPS && c == 1) {
            float rho = dens[t];
            if (SRC == kSrcDensity) rho = emitter_add(rho, e, sl.zoff + tz, ys[dy], xs[dx]);
            g = buoyant_vy(g, rho, bp);
          }
          acc[c] = acc[c] + w * g;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) out[c] = acc[c];
}

// advect_cell_win for a window of k >= 4 cells known only at run time: the
// same float32 operations in the same order (the full (2k+1)^3 sum, zero
// weights too), with each tap's x and y hat and wrapped index recomputed
// where advect_cell_win reads them from its per-axis arrays, which a runtime
// width cannot keep in registers.  hat() and the wrap are pure functions of
// their operands, so the recomputed values are the same bits.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, int SRC, typename TF, typename TV>
__device__ __forceinline__ void advect_cell_win_rt(const TF* fields, const TV* vel,
                                                   const float* dens, const float* e,
                                                   const Buoyancy bp, int n, const Slab& sl,
                                                   float dt0, int k, int z, int y, int x,
                                                   float (&out)[F]) {
  const int w = 2 * k + 1;
  const long long sn = n, vol = sn * sn * sl.nz;
  const long long c0 = (z * sn + y) * sn + x;
  const int zg = z + sl.zoff;
  const float vx = ld(vel[c0]);
  float vy = ld(vel[vol + c0]);
  const float vz = ld(vel[2 * vol + c0]);
  if (BUOY_VEL) {
    float rho = dens[c0];
    if (SRC == kSrcDensity) rho = emitter_add(rho, e, zg, y, x);
    vy = buoyant_vy(vy, rho, bp);
  }
  const float hi = float(n) - 1.5f;
  const float fx = frac_win(float(x), vx, dt0, hi, k);
  const float fy = frac_win(float(y), vy, dt0, hi, k);
  const float fz = frac_win(float(zg), vz, dt0, hi, k);
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.0f;
#pragma unroll 1
  for (int dz = 0; dz < w; ++dz) {
    const float wz = hat(fz, dz - k);
    const int tz = (z + dz - k + sl.nz) % sl.nz;
#pragma unroll 1
    for (int dy = 0; dy < w; ++dy) {
      const int ty = (y + dy - k + n) % n;
      const float wzy = wz * hat(fy, dy - k);
      const long long row = (tz * sn + ty) * sn;
#pragma unroll 1
      for (int dx = 0; dx < w; ++dx) {
        const int tx = (x + dx - k + n) % n;
        const float wt = wzy * hat(fx, dx - k);
        const long long t = row + tx;
#pragma unroll
        for (int c = 0; c < F; ++c) {
          float g = ld(fields[c * vol + t]);
          if (SRC == kSrcFields) g = emitter_add(g, e, sl.zoff + tz, ty, tx);
          if (BUOY_TAPS && c == 1) {
            float rho = dens[t];
            if (SRC == kSrcDensity) rho = emitter_add(rho, e, sl.zoff + tz, ty, tx);
            g = buoyant_vy(g, rho, bp);
          }
          acc[c] = acc[c] + wt * g;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) out[c] = acc[c];
}

// The whole-step kernels' cell at a window of k >= 2 cells where the caller
// knows every value of `fields` finite (full_step.cuh's vote): the <= 8
// taps with weight (eight_taps), read from the fields in place; no folds,
// the whole n^3 grid.  Returns false and computes nothing where a
// displacement is NaN (the caller takes the full sum).  No tap needs the
// wrap: after the clamp t = coord + f lies in [0.5, n - 1.5] (a clip to
// coord -+ k that moves t lands on coord -+ k, which the other clamp leaves
// inside), and f = t - coord is exact, so coord + d >= floor(t) >= 0 and
// coord + d + 1 <= n - 1.
template <int F, typename TF, typename TV>
__device__ __forceinline__ bool advect_cell_eight(const TF* fields, const TV* vel, int n,
                                                  float dt0, int k, int z, int y, int x,
                                                  float (&out)[F]) {
  const long long sn = n, plane = sn * sn, vol = plane * sn;
  const long long c0 = (z * sn + y) * sn + x;
  const float hi = float(n) - 1.5f;
  const float fx = frac_win(float(x), ld(vel[c0]), dt0, hi, k);
  const float fy = frac_win(float(y), ld(vel[vol + c0]), dt0, hi, k);
  const float fz = frac_win(float(z), ld(vel[2 * vol + c0]), dt0, hi, k);
  if (!(fx == fx && fy == fy && fz == fz)) return false;  // a NaN displacement
  const EightTaps t = eight_taps(fx, fy, fz, k);
  const long long a = c0 + (t.iz * sn + t.iy) * sn + t.ix, b = a + plane;
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const TF* f = fields + c * vol;
    const float g[8] = {ld(f[a]),      ld(f[a + 1]),      ld(f[a + sn]), ld(f[a + sn + 1]),
                        ld(f[b]),      ld(f[b + 1]),      ld(f[b + sn]), ld(f[b + sn + 1])};
    out[c] = eight_tap_sum(t.w, g);
  }
  return true;
}

// One substep's operands.  src (F, nz, n, n) is read and dst written, each in
// the type its launch names; vel is the storage type's; dens is the
// buoyancy's density, mask one byte per cell (nonzero = solid) and emitter
// the (5,) descriptor, each null when unused; slab the z-slab of the n^3 grid
// the arrays hold ({n, 0}: all of it); b0..b2 the fields' boundary codes;
// scale multiplies every output value after the faces, in the output type
// (the TPU kernels' storage-dtype multiply); window is the window K >= 4 of
// the bodies instantiated at kWinAny (unread by the others).
struct Substep {
  const void *src, *vel;
  const float* dens;
  const uint8_t* mask;
  const float* emitter;
  void* dst;
  int n;
  Slab slab;
  int b0, b1, b2;
  float dt0, scale;
  Buoyancy bp;
  int window;
};

// One substep at cell k: the backtrace (a solid interior cell is zero
// instead), then the set_bnd face sign of each field's code, the rounding to
// TO, then the scale (rounded again).  advect_values computes the values,
// advect_put stores them.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, int K, typename TF,
          typename TV>
__device__ __forceinline__ void advect_values(const Substep& a, const Cell& k, float (&v)[F]) {
  const TF* src = static_cast<const TF*>(a.src);
  const TV* vel = static_cast<const TV*>(a.vel);
  if (MASK && a.mask[k.c] != 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = 0.0f;
  } else if constexpr (K == 1) {
    advect_cell_k1<F, BUOY_VEL, BUOY_TAPS, SRC>(src, vel, a.dens, a.emitter, a.bp, a.n, a.slab,
                                                a.dt0, k.cz, k.cy, k.cx, v);
  } else if constexpr (K == kWinAny) {
    advect_cell_win_rt<F, BUOY_VEL, BUOY_TAPS, SRC>(src, vel, a.dens, a.emitter, a.bp, a.n,
                                                    a.slab, a.dt0, a.window, k.cz, k.cy, k.cx,
                                                    v);
  } else {
    advect_cell_win<K, F, BUOY_VEL, BUOY_TAPS, SRC>(src, vel, a.dens, a.emitter, a.bp, a.n,
                                                    a.slab, a.dt0, k.cz, k.cy, k.cx, v);
  }
}

// advect_put returns whether every value it stored is finite (the
// whole-step kernels' vote on what a substep leaves for the next).
template <int F, typename TO>
__device__ __forceinline__ bool advect_put(const Substep& a, const Cell& k, const float (&v)[F]) {
  const long long vol = static_cast<long long>(a.n) * a.n * a.slab.nz;
  const int bs[3] = {a.b0, a.b1, a.b2};
  TO* dst = static_cast<TO*>(a.dst);
  bool finite = true;
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float u = face_negates(bs[c], k.z, k.y, k.x, k.cz, k.cy, k.cx) ? -v[c] : v[c];
    const TO o = st<TO>(ld(st<TO>(u)) * a.scale);
    dst[c * vol + k.idx] = o;
    finite = finite && fabsf(ld(o)) <= 3.40282347e38f;  // not inf, not NaN
  }
  return finite;
}

template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, int K, typename TF,
          typename TV, typename TO>
__device__ __forceinline__ void advect_store(const Substep& a, const Cell& k) {
  float v[F];
  advect_values<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, K, TF, TV>(a, k, v);
  advect_put<F, TO>(a, k, v);
}

// Two cells of one substep without folds, k0 and k1 (stored only when two):
// both cells' values before either store, so that the loads of the two
// overlap (the whole-step kernels' grid-stride loops, whose grids hold few
// threads an SM).
template <int F, int K, bool MASK, typename TF, typename TV, typename TO>
__device__ __forceinline__ void advect_pair(const Substep& a, const Cell& k0, const Cell& k1,
                                            bool two) {
  float v0[F], v1[F];
  advect_values<F, false, false, MASK, kSrcNone, K, TF, TV>(a, k0, v0);
  advect_values<F, false, false, MASK, kSrcNone, K, TF, TV>(a, k1, v1);
  advect_put<F, TO>(a, k0, v0);
  if (two) advect_put<F, TO>(a, k1, v1);
}

// advect_pair on fields of storage type S, by the substep's place in the
// run: the first reads S, the others the float32 result of the one before;
// to_s writes S, else float32.  For S = float every role is one code.
template <int F, int K, bool MASK, typename S>
__device__ __forceinline__ void advect_pair_role(const Substep& a, const Cell& k0, const Cell& k1,
                                                 bool two, bool first, bool to_s) {
  if constexpr (std::is_same<S, float>::value) {
    advect_pair<F, K, MASK, float, float, float>(a, k0, k1, two);
  } else if (first) {
    if (to_s) {
      advect_pair<F, K, MASK, S, S, S>(a, k0, k1, two);
    } else {
      advect_pair<F, K, MASK, S, S, float>(a, k0, k1, two);
    }
  } else if (to_s) {
    advect_pair<F, K, MASK, float, S, S>(a, k0, k1, two);
  } else {
    advect_pair<F, K, MASK, float, S, float>(a, k0, k1, two);
  }
}

}  // namespace fsk

// K = 1's launch: advect_tiled_kernel, on tiles with the taps staged in
// shared memory (launch_tiled below takes it for every K = 1 substep); at
// K >= 2 advect_window_kernel, where win_tiled lets its ring fit.
#include "advect_tiled.cuh"
#include "advect_window.cuh"

namespace fsk {

// Internal linkage, as in boundary.cuh: every source that launches K1's
// kernel gets its own copy.
namespace {

// One thread a cell, the runtime-K body: the route of a window whose ring
// does not fit (advect_window.cuh's win_tiled).
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF, typename TV,
          typename TO>
__global__ void __launch_bounds__(kThreads)
    advect_kernel(const TF* __restrict__ src, const TV* __restrict__ vel,
                  const float* __restrict__ dens, const uint8_t* __restrict__ mask,
                  const float* __restrict__ emitter, TO* __restrict__ dst, int n, Slab sl,
                  int b0, int b1, int b2, float dt0, float scale, Buoyancy bp, int window) {
  Cell k;
  if (!cell_of_thread_slab(n, sl, k)) return;
  advect_store<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, kWinAny, TF, TV, TO>(
      Substep{src, vel, dens, mask, emitter, dst, n, sl, b0, b1, b2, dt0, scale, bp, window},
      k);
}

// One substep's launch: K = 1 on tiles (advect_tiled.cuh); K = kWinAny, a
// window of a.window >= 2 cells, on tiles widened by it (advect_window.cuh)
// where win_tiled holds for the card's shared memory, else one thread a cell
// with the runtime-K body (bitwise advect_cell_win at K = 2 and 3 too).
template <int K, int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF = float,
          typename TV = float, typename TO = float>
cudaError_t launch(const Substep& a, cudaStream_t s) {
  static_assert(K == 1 || K == kWinAny, "launches take K = 1 or the runtime window");
  if constexpr (K == 1) {
    return launch_tiled<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, TF, TV, TO>(a, s);
  } else {
    int optin = 0;
    const cudaError_t err = win_smem_optin(optin);
    if (err != cudaSuccess) return err;
    if (win_tiled(a.window, F, optin)) {
      return launch_window_tiled<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, TF, TV, TO>(a, a.window,
                                                                              optin, s);
    }
    advect_kernel<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, TF, TV, TO>
        <<<cell_grid_slab(a.n, a.slab.nz), cell_block(), 0, s>>>(
            static_cast<const TF*>(a.src), static_cast<const TV*>(a.vel), a.dens, a.mask,
            a.emitter, static_cast<TO*>(a.dst), a.n, a.slab, a.b0, a.b1, a.b2, a.dt0, a.scale,
            a.bp, a.window);
    return cudaGetLastError();
  }
}

// A substep without folds in its role (see advect_pair_role).
template <int K, int F, bool MASK, typename S>
cudaError_t launch_role(const Substep& a, bool first, bool to_s, cudaStream_t s) {
  if constexpr (std::is_same<S, float>::value) {
    return launch<K, F, false, false, MASK, kSrcNone>(a, s);
  } else if (first) {
    return to_s ? launch<K, F, false, false, MASK, kSrcNone, S, S, S>(a, s)
                : launch<K, F, false, false, MASK, kSrcNone, S, S, float>(a, s);
  } else {
    return to_s ? launch<K, F, false, false, MASK, kSrcNone, float, S, S>(a, s)
                : launch<K, F, false, false, MASK, kSrcNone, float, S, float>(a, s);
  }
}

// The variants the port runs, for K = 1 or kWinAny (a.window >= 2) and
// storage type S: buoyancy only in float32 velocity self-advection without a
// mask, with or without the emitter on its density; the emitter on the field
// only for a float32 scalar without a mask (K2s's density phase); otherwise
// F = 1 or 3 with or without a mask, in any role.
template <int K, typename S>
cudaError_t launch_window(const Substep& a, int n_fields, bool buoy_vel, bool buoy_taps,
                          int src, bool first, bool to_s, cudaStream_t s) {
  const bool masked = a.mask != nullptr;
  if constexpr (std::is_same<S, float>::value) {
    if (n_fields == 3 && buoy_vel && !masked) {
      if (src == kSrcDensity) {
        return buoy_taps ? launch<K, 3, true, true, false, kSrcDensity>(a, s)
                         : launch<K, 3, true, false, false, kSrcDensity>(a, s);
      }
      if (src == kSrcNone) {
        return buoy_taps ? launch<K, 3, true, true, false, kSrcNone>(a, s)
                         : launch<K, 3, true, false, false, kSrcNone>(a, s);
      }
      return cudaErrorInvalidValue;
    }
    if (n_fields == 1 && src == kSrcFields && !masked && !buoy_vel) {
      return launch<K, 1, false, false, false, kSrcFields>(a, s);
    }
  }
  if (buoy_vel || src != kSrcNone) return cudaErrorInvalidValue;
  if (n_fields == 3) {
    return masked ? launch_role<K, 3, true, S>(a, first, to_s, s)
                  : launch_role<K, 3, false, S>(a, first, to_s, s);
  }
  if (n_fields == 1) {
    return masked ? launch_role<K, 1, true, S>(a, first, to_s, s)
                  : launch_role<K, 1, false, S>(a, first, to_s, s);
  }
  return cudaErrorInvalidValue;
}

// n_sub substeps of a.src (type S) through a.vel (type S) with a window of K
// = 1 cell or (kWinAny) a.window >= 2 cells on a.slab, one launch each, the
// last into out (type S); the input is never written.  float32: the earlier
// substeps alternate back from out with tmp0 (which may be null when n_sub ==
// 1).  bfloat16: the earlier substeps write float32 into tmp0 and tmp1 in
// turn (each like out in float32, null when unused), and the last rounds into
// out.  With a mask, velocity codes
// get the obstacle mirror after every substep, as a second launch in place on
// the float32 result (bfloat16: the last result is then rounded into out by
// one more launch).  The buoyancy (and the emitter on its density) enters
// every substep's backtrace velocity and the first substep's taps; an
// emitter on the fields enters the first substep only, whose input it is.
// `scale` multiplies the last substep's output in S (not with a mirror,
// which would have to come first).  Returns the first cudaError_t.
template <int K, typename S>
cudaError_t advect_substeps(Substep a, int n_fields, int n_sub, bool buoy, int src, S* out,
                            float* tmp0, float* tmp1, float scale, cudaStream_t s) {
  constexpr bool wide = std::is_same<S, float>::value;
  if (n_sub < 1) return cudaErrorInvalidValue;
  const int bs[3] = {a.b0, a.b1, a.b2};
  bool mirror = false;
  for (int c = 0; c < n_fields && c < 3; ++c) {
    mirror = mirror || (a.mask != nullptr && bs[c] >= 1 && bs[c] <= 3);
  }
  if (mirror && scale != 1.0f) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  for (int sub = 0; sub < n_sub; ++sub) {
    const bool first = sub == 0, last = sub == n_sub - 1;
    bool to_s = true;
    void* dst = out;
    if (wide) {
      if ((n_sub - 1 - sub) % 2 != 0) dst = tmp0;
    } else {
      to_s = last && !mirror;
      if (!to_s) dst = sub % 2 == 0 ? tmp0 : tmp1;
    }
    if (dst == nullptr) return cudaErrorInvalidValue;
    a.dst = dst;
    a.scale = last ? scale : 1.0f;
    const int sub_src = (src == kSrcFields && !first) ? kSrcNone : src;
    err = launch_window<K, S>(a, n_fields, buoy, buoy && first, sub_src, first, to_s, s);
    if (err != cudaSuccess) return err;
    if (mirror) {
      // The mirror works on the float32 result: out itself for float32.
      mirror_obstacles_kernel<float><<<cell_grid_slab(a.n, a.slab.nz), cell_block(), 0, s>>>(
          static_cast<float*>(dst), a.mask, a.n, a.slab, n_fields, a.b0, a.b1, a.b2);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    a.src = dst;
  }
  if (!wide && mirror) {
    const long long count = static_cast<long long>(n_fields) * a.n * a.n * a.slab.nz;
    store_kernel<S><<<flat_blocks(count), kThreads, 0, s>>>(static_cast<const float*>(a.src),
                                                           out, count);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

}  // namespace fsk
