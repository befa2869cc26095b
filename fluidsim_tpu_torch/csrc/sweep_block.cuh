// K5: the sweep-blocked Jacobi solve, T = block >= 2 sweeps per pass, shared
// by the projection's solve (project.cuh: K3 and, through K3's entry, K2),
// K4's solve without a mask (jacobi_resident.cu) and K8's solve phase
// (full_step.cuh).  Two routes, decided by the caller before the launch:
// where kernels/resident.solve_tiles finds a tiling for the block, every
// stage is a pass of the tile program on chip (solve_tiled.cuh:
// block_tile, one persistent launch a solve, a face trade between stages);
// elsewhere every stage below is a per-item device function, one launch a
// stage in the standalone launchers (the launch boundary is the barrier
// between stages) and a grid-stride loop between grid.sync()s in K8.  Both
// routes compute a stage's value with the functions of "The arithmetic"
// below, on operands they read from global memory (the per-stage route) or
// from shared memory (the tiles).
//
// Replaces: fluidsim_tpu/pallas/resident.py::_solve_loop with block >= 2 and
// its helpers _shell_exact_planes and _nbr_sum (the toroidal neighbour sum).
// The twin is kernels/jacobi.py::solve_loop_plain; the arithmetic is the
// same, operation for operation (nvcc -fmad=false):
//
//   N(v)[i] = ((v[x+1] + v[x-1]) + (v[y+1] + v[y-1])) + (v[z+1] + v[z-1]),
//             indices taken mod n (the TPU kernel's roll), so the chain reads
//             wrapped planes at the walls, as the TPU kernel does;
//   C[i]    = ic, or 0 in a solid cell of the mask (the TPU kernel's
//             (1 - m) * inv6 coefficient volume).
//
// T = 2 (the delta form): once per solve
//   x1 = ic*x0 + aicic*N(x0)             (mask: C*x0 + (a*C)*N(C*x0)),
// then per block, U = N(p) over the whole volume (one stage) and
//   p' = st(x1 + a2ic2*N(U))             (mask: st(x1 + (a2*C)*N(C*U))),
// followed, on the first interior plane of each wall (axis 0 lo, hi, then
// axis 1, then axis 2), by p' = st(p' + mul*(raw[j] - raw[wall])) with
// raw = (x0 + a*U)*C and mul = aic (mask: a*C): the intermediate iterate's
// face rule, rounded to the solve type after each correction, so a cell on
// an edge rounds twice.
//
// T >= 3 (the hoisted chain): once per solve
//   X = sum_{k<T} pw_k*g_k,  g_0 = C*x0,  g_k = C*N(g_{k-1}),
// with pw_k = f32(pw_{k-1}*a) (the float32 products numpy makes), then per
// block h_0 = N(p), h_k = N(C*h_{k-1}) and p' = st(X + aT*(C*h_{T-1})),
// except on planes 1..T-1 of each wall, which take the shell recurrence's
// value (the exact sequential sweeps on O(n^2) plane values, level by level,
// in float32, with the in-plane faces; level k's wall plane aliases plane 1),
// the last of z lo, z hi, y lo, y hi, x lo, x hi that holds the cell.
//
// Each block ends with the b = 0 faces: a border cell computes its clamped
// interior cell (boundary.cuh), which is bitwise the TPU kernel's z->y->x
// face writes.  The iters % T sweeps left over run as sequential sweeps.
//
// What bounds the per-stage route on an H100: each stage is a pass over
// float32 scratch volumes (x1, two chain volumes) and the solve's iterate,
// L2 resident at 128^3; a block of T sweeps takes 2 launches (T = 2) or
// T + 1 (T >= 3).  The tile program keeps the chain on chip instead and
// trades one-cell faces between stages (solve_tiled.cuh says what bounds
// it); this route stays for the grids no tiling fits.
#pragma once

#include "boundary.cuh"

namespace fsk {

// --- The arithmetic ------------------------------------------------------
//
// Each stage's value from its operands, the one place both routes take it
// from (the per-stage items below, the tile program in solve_tiled.cuh).

// N from its six operands in the twin's add order.
__device__ __forceinline__ float nbr6(float xp, float xm, float yp, float ym, float zp,
                                      float zm) {
  return ((xp + xm) + (yp + ym)) + (zp + zm);
}

// T = 2's x1 at a cell of coefficient c and rhs x0, nb = N(x0) (mask:
// N(C*x0)).  (Plain functions of the mask: templates on it made nvcc 12.9's
// front end abort at their calls in delta_item.)
__device__ __forceinline__ float x1_delta_value(bool mask, float ic, float aicic, float a, float c,
                                                float x0, float nb) {
  return mask ? c * x0 + (a * c) * nb : ic * x0 + aicic * nb;
}

// T = 2's block value before the corrections: x1 + a2ic2*N(U) (mask:
// x1 + (a2*C)*N(C*U)), nb the neighbour sum, cc the cell's coefficient.
__device__ __forceinline__ float delta_value(bool mask, float x1, float a2, float a2ic2, float cc,
                                             float nb) {
  return mask ? x1 + (a2 * cc) * nb : x1 + a2ic2 * nb;
}

// The intermediate iterate's raw value (x0 + a*U)*C at a cell.
__device__ __forceinline__ float raw_value(float a, float x0, float u, float c) {
  return (x0 + a * u) * c;
}

// One face-rule correction of T = 2's block value v.
template <typename T>
__device__ __forceinline__ T corrected(T v, float mul, float raw_c, float raw_w) {
  return st<T>(ld(v) + mul * (raw_c - raw_w));
}

// T >= 3's block value X + aT*(C*h) away from the shell, h = N(C*h_{T-2}).
__device__ __forceinline__ float chain_value(float x, float aT, float cc, float h) {
  return x + aT * (cc * h);
}

// A shell level's value at a plane cell: (x0 + a*nbr)*C.
__device__ __forceinline__ float shell_value(float x0, float a, float nbr, float c) {
  return (x0 + a * nbr) * c;
}

// The composite's constants (kernels/jacobi.py::block_constants, float32
// values numpy computed) and its float32 scratch: x1 an (n, n, n) volume, w0
// and w1 (n, n, n) chain volumes (w1 for T >= 3 only), s0 and s1 the shell
// levels, 6 * 2T planes of n^2 each (T >= 3 only).
struct SolveBlock {
  int block;
  float a, ic, aic, aicic, a2, a2ic2, aT;
  float *x1, *w0, *w1, *s0, *s1;
};

// The toroidal neighbours of cell (z, y, x).
struct Torus {
  long long xp, xm, yp, ym, zp, zm;
};

__device__ __forceinline__ Torus torus_of(int n, int z, int y, int x) {
  const long long sn = n;
  const int xp = x + 1 == n ? 0 : x + 1, xm = x == 0 ? n - 1 : x - 1;
  const int yp = y + 1 == n ? 0 : y + 1, ym = y == 0 ? n - 1 : y - 1;
  const int zp = z + 1 == n ? 0 : z + 1, zm = z == 0 ? n - 1 : z - 1;
  const long long row = (z * sn + y) * sn;
  return {row + xp, row + xm, (z * sn + yp) * sn + x, (z * sn + ym) * sn + x,
          (zp * sn + y) * sn + x, (zm * sn + y) * sn + x};
}

// N at a cell of its toroidal neighbours, v(i) the operand at flat index i.
template <typename V>
__device__ __forceinline__ float torus_sum(const Torus& t, V v) {
  return ((v(t.xp) + v(t.xm)) + (v(t.yp) + v(t.ym))) + (v(t.zp) + v(t.zm));
}

template <bool MASK>
__device__ __forceinline__ float coef_at(const uint8_t* mask, long long i, float ic) {
  return (MASK && mask[i] != 0) ? 0.0f : ic;
}

// The stages' operands: the pass reads src (the iterate) and writes dst; x0
// is the solve's rhs, mask is null without one.
template <typename T>
struct BlockPass {
  const T* src;
  T* dst;
  const T* x0;
  const uint8_t* mask;
  SolveBlock b;
  int n;
};

// Items of a shell level: 6 sides x 2T planes x n^2.
__host__ __device__ __forceinline__ long long shell_items(int n, int tb) {
  return 6LL * 2 * tb * n * n;
}

// --- Once per solve ------------------------------------------------------

// T = 2: x1 at cell i.
template <typename T, bool MASK>
__device__ __forceinline__ void x1_delta_item(const BlockPass<T>& p, int i) {
  const Cell k = cell_at(p.n, i);
  const Torus t = torus_of(p.n, k.z, k.y, k.x);
  const SolveBlock& b = p.b;
  if (MASK) {
    const float c = coef_at<MASK>(p.mask, i, b.ic);
    const float nb = torus_sum(
        t, [&](long long j) { return coef_at<MASK>(p.mask, j, b.ic) * ld(p.x0[j]); });
    b.x1[i] = x1_delta_value(true, b.ic, b.aicic, b.a, c, ld(p.x0[i]), nb);
  } else {
    const float nb = torus_sum(t, [&](long long j) { return ld(p.x0[j]); });
    b.x1[i] = x1_delta_value(false, b.ic, b.aicic, b.a, b.ic, ld(p.x0[i]), nb);
  }
}

// T >= 3: stage k = 1..T-1 of X at cell i: g_k = C*N(g_{k-1}) into gout
// (g_0 = C*x0 read in place), X += pw*g_k (X = g_0 + pw*g_1 at k = 1).
template <typename T, bool MASK>
__device__ __forceinline__ void x1_chain_item(const BlockPass<T>& p, int k, float pw,
                                              const float* gin, float* gout, int i) {
  const Cell cell = cell_at(p.n, i);
  const Torus t = torus_of(p.n, cell.z, cell.y, cell.x);
  const SolveBlock& b = p.b;
  const float c = coef_at<MASK>(p.mask, i, b.ic);
  float nb;
  if (k == 1) {
    nb = torus_sum(
        t, [&](long long j) { return coef_at<MASK>(p.mask, j, b.ic) * ld(p.x0[j]); });
  } else {
    nb = torus_sum(t, [&](long long j) { return gin[j]; });
  }
  const float g = c * nb;
  gout[i] = g;
  b.x1[i] = (k == 1 ? c * ld(p.x0[i]) : b.x1[i]) + pw * g;
}

// --- Per block -----------------------------------------------------------

// U = N(src) at cell i (T = 2's first stage, T >= 3's h_0).
template <typename T>
__device__ __forceinline__ void nbr_item(const BlockPass<T>& p, float* out, int i) {
  const Cell k = cell_at(p.n, i);
  const Torus t = torus_of(p.n, k.z, k.y, k.x);
  out[i] = torus_sum(t, [&](long long j) { return ld(p.src[j]); });
}

// h_k = N(C*h_{k-1}) at cell i.
template <typename T, bool MASK>
__device__ __forceinline__ void chain_item(const BlockPass<T>& p, const float* hin, float* hout,
                                           int i) {
  const Cell k = cell_at(p.n, i);
  const Torus t = torus_of(p.n, k.z, k.y, k.x);
  hout[i] = torus_sum(
      t, [&](long long j) { return coef_at<MASK>(p.mask, j, p.b.ic) * hin[j]; });
}

// T = 2's last stage at cell k: the block's result at k's clamped interior
// cell, corrections included.  U = N(src).
template <typename T, bool MASK>
__device__ __forceinline__ void delta_item(const BlockPass<T>& p, const float* U, int i) {
  const int n = p.n;
  const Cell k = cell_at(n, i);
  const long long c = k.c;
  const SolveBlock& b = p.b;
  const Torus t = torus_of(n, k.cz, k.cy, k.cx);
  const float cc = coef_at<MASK>(p.mask, c, b.ic);
  float out;
  if (MASK) {
    const float nb =
        torus_sum(t, [&](long long j) { return coef_at<MASK>(p.mask, j, b.ic) * U[j]; });
    out = delta_value(true, b.x1[c], b.a2, b.a2ic2, cc, nb);
  } else {
    const float nb = torus_sum(t, [&](long long j) { return U[j]; });
    out = delta_value(false, b.x1[c], b.a2, b.a2ic2, cc, nb);
  }
  T v = st<T>(out);
  const long long sn = n;
  const long long step[3] = {sn * sn, sn, 1};
  const int coord[3] = {k.cz, k.cy, k.cx};
  const float raw_c = raw_value(b.a, ld(p.x0[c]), U[c], cc);
  const float mul = MASK ? b.a * cc : b.aic;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int j = side == 0 ? 1 : n - 2;
      const int w = side == 0 ? 0 : n - 1;
      if (coord[axis] != j) continue;
      const long long q = c + (w - j) * step[axis];
      const float raw_w = raw_value(b.a, ld(p.x0[q]), U[q], coef_at<MASK>(p.mask, q, b.ic));
      v = corrected(v, mul, raw_c, raw_w);
    }
  }
  p.dst[k.idx] = v;
}

// The flat index of in-plane cell (u, v) of plane `pl` across `axis`: the
// in-plane axes in ascending order.
__device__ __forceinline__ long long plane_cell(int n, int axis, int pl, int u, int v) {
  const long long sn = n;
  if (axis == 0) return (pl * sn + u) * sn + v;
  if (axis == 1) return (u * sn + pl) * sn + v;
  return (u * sn + v) * sn + pl;
}

// Shell level `level` (1..T) at item it of shell_items(n, T): side s (axis
// s / 2, lo when s is even), plane j (1..2T-1-level), in-plane (u, v); the
// value at the clamped (u, v), float32.  prev is level-1's buffer (level 0
// reads src), cur this level's.
template <typename T, bool MASK>
__device__ __forceinline__ void shell_item(const BlockPass<T>& p, int level, const float* prev,
                                           float* cur, long long it) {
  const int n = p.n, tb = p.b.block;
  const long long nn = static_cast<long long>(n) * n;
  const int side = static_cast<int>(it / (2 * tb * nn));
  const long long rem = it - side * (2 * tb * nn);
  const int j = static_cast<int>(rem / nn);
  const int depth = 2 * tb - 1 - level;
  if (j < 1 || j > depth) return;
  const int uv = static_cast<int>(rem - j * nn);
  const int u = uv / n, v = uv - (uv / n) * n;
  const int axis = side / 2;
  const bool lo = side % 2 == 0;
  const int cu = clamp_interior(u, n), cv = clamp_interior(v, n);
  const long long base = static_cast<long long>(side) * 2 * tb;
  auto at = [&](int jj, int uu, int vv) -> float {
    if (level == 1) return ld(p.src[plane_cell(n, axis, lo ? jj : n - 1 - jj, uu, vv)]);
    return prev[(base + (jj == 0 ? 1 : jj)) * nn + static_cast<long long>(uu) * n + vv];
  };
  const int u_axis = axis == 0 ? 1 : 0;
  auto pair = [&](int ax) -> float {
    if (ax == axis) return lo ? at(j + 1, cu, cv) + at(j - 1, cu, cv)
                              : at(j - 1, cu, cv) + at(j + 1, cu, cv);
    if (ax == u_axis) return at(j, cu + 1, cv) + at(j, cu - 1, cv);
    return at(j, cu, cv + 1) + at(j, cu, cv - 1);
  };
  const float nbr = (pair(2) + pair(1)) + pair(0);
  const long long g = plane_cell(n, axis, lo ? j : n - 1 - j, cu, cv);
  cur[(base + j) * nn + static_cast<long long>(u) * n + v] =
      shell_value(ld(p.x0[g]), p.b.a, nbr, coef_at<MASK>(p.mask, g, p.b.ic));
}

// T >= 3's last stage at cell k: the block's result at k's clamped interior
// cell, from h_{T-2} (hin) and shell level T (shell).
template <typename T, bool MASK>
__device__ __forceinline__ void chain_final_item(const BlockPass<T>& p, const float* hin,
                                                 const float* shell, int i) {
  const int n = p.n, tb = p.b.block;
  const Cell k = cell_at(n, i);
  const int coord[3] = {k.cz, k.cy, k.cx};
  const long long nn = static_cast<long long>(n) * n;
  for (int axis = 2; axis >= 0; --axis) {
    const int cc = coord[axis];
    int side = -1, j = 0;
    if (cc <= tb - 1) {
      side = 2 * axis, j = cc;
    } else if (cc >= n - tb) {
      side = 2 * axis + 1, j = n - 1 - cc;
    }
    if (side < 0) continue;
    const int u = axis == 0 ? k.cy : k.cz;
    const int v = axis == 2 ? k.cy : k.cx;
    p.dst[k.idx] = st<T>(shell[(static_cast<long long>(side) * 2 * tb + j) * nn +
                               static_cast<long long>(u) * n + v]);
    return;
  }
  const Torus t = torus_of(n, k.cz, k.cy, k.cx);
  const float h =
      torus_sum(t, [&](long long j) { return coef_at<MASK>(p.mask, j, p.b.ic) * hin[j]; });
  p.dst[k.idx] = st<T>(chain_value(p.b.x1[k.c], p.b.aT, coef_at<MASK>(p.mask, k.c, p.b.ic), h));
}

// The buffers of the chain's stage s (T >= 3): h_s goes to w[s % 2] and reads
// w[(s - 1) % 2]; shell level L goes to s[L % 2] and reads s[(L - 1) % 2].
__host__ __device__ __forceinline__ float* chain_buf(const SolveBlock& b, int s) {
  return s % 2 == 0 ? b.w0 : b.w1;
}
__host__ __device__ __forceinline__ float* shell_buf(const SolveBlock& b, int level) {
  return level % 2 == 0 ? b.s0 : b.s1;
}

// One stage s = 0..T-1 of a T >= 3 block at item it of vol + shell_items:
// the chain's h_s (s <= T-2) on the first vol items, shell level s + 1 on
// the rest.
template <typename T, bool MASK>
__device__ __forceinline__ void chain_stage_item(const BlockPass<T>& p, int s, long long it) {
  const long long vol = static_cast<long long>(p.n) * p.n * p.n;
  if (it < vol) {
    const int i = static_cast<int>(it);
    if (s == 0) {
      nbr_item<T>(p, chain_buf(p.b, 0), i);
    } else if (s <= p.b.block - 2) {
      chain_item<T, MASK>(p, chain_buf(p.b, s - 1), chain_buf(p.b, s), i);
    }
    return;
  }
  shell_item<T, MASK>(p, s + 1, shell_buf(p.b, s), shell_buf(p.b, s + 1), it - vol);
}

// The order of K5's stages, written once for both runners: the launchers
// below (a launch a stage) and K8 (a grid-stride loop a stage, grid.sync()
// between them).  Once per solve, pre_stages(T) stages over the volume
// (T = 2: x1; T >= 3: g_1..g_{T-1} and X); then per block,
// block_stages(T) stages (T = 2: U = N(src), then the delta; T >= 3: the
// chain stages 0..T-1 over vol + shell_items items, then the final).
__host__ __device__ __forceinline__ int pre_stages(int tb) { return tb == 2 ? 1 : tb - 1; }
__host__ __device__ __forceinline__ int block_stages(int tb) { return tb == 2 ? 2 : tb + 1; }
__host__ __device__ __forceinline__ long long block_stage_items(int n, int tb, int s) {
  const long long vol = static_cast<long long>(n) * n * n;
  return tb > 2 && s < tb ? vol + shell_items(n, tb) : vol;
}

// Once-per-solve stage s at cell i.  pw_k = f32(pw_{k-1}*a) for k = s + 1,
// the float32 products the twin takes from numpy.
template <typename T, bool MASK>
__device__ __forceinline__ void pre_stage_item(const BlockPass<T>& p, int s, int i) {
  if (p.b.block == 2) {
    x1_delta_item<T, MASK>(p, i);
    return;
  }
  const int k = s + 1;
  float pw = 1.0f;
  for (int q = 1; q <= k; ++q) pw = pw * p.b.a;
  x1_chain_item<T, MASK>(p, k, pw, chain_buf(p.b, k - 1), chain_buf(p.b, k), i);
}

// Per-block stage s at item it (< block_stage_items), p.src -> p.dst.
template <typename T, bool MASK>
__device__ __forceinline__ void block_stage_item(const BlockPass<T>& p, int s, long long it) {
  const int tb = p.b.block;
  const int i = static_cast<int>(it);
  if (tb == 2) {
    if (s == 0) {
      nbr_item<T>(p, p.b.w0, i);
    } else {
      delta_item<T, MASK>(p, p.b.w0, i);
    }
  } else if (s < tb) {
    chain_stage_item<T, MASK>(p, s, it);
  } else {
    chain_final_item<T, MASK>(p, chain_buf(p.b, tb - 2), shell_buf(p.b, tb), i);
  }
}

// Whether blk (null: sequential sweeps) is a block the kernels take for an
// n^3 solve of `iters` sweeps: T >= 2 with iters >= T, T = 2 or n >= 4T,
// float32 fields (field_bf16 = 0), and its scratch (tiled: on the tile
// program, which keeps the chain on chip and needs x1 and, for T >= 3, the
// shell levels only).
__host__ __forceinline__ bool block_valid(const SolveBlock* blk, int n, int iters,
                                          int field_bf16, bool tiled) {
  if (blk == nullptr) return true;
  const int tb = blk->block;
  if (tb < 2 || iters < tb || (tb > 2 && n < 4 * tb) || field_bf16) return false;
  if (blk->x1 == nullptr || (!tiled && blk->w0 == nullptr)) return false;
  return tb == 2 ||
         ((tiled || blk->w1 != nullptr) && blk->s0 != nullptr && blk->s1 != nullptr);
}

// Internal linkage, as in boundary.cuh.
namespace {

// One stage (PRE: a once-per-solve stage) over `items` items.
template <typename T, bool MASK, bool PRE>
__global__ void __launch_bounds__(kThreads)
    stage_kernel(const BlockPass<T> p, int s, long long items) {
  const long long it = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (it >= items) return;
  if (PRE) {
    pre_stage_item<T, MASK>(p, s, static_cast<int>(it));
  } else {
    block_stage_item<T, MASK>(p, s, it);
  }
}

// x1 (and for T >= 3 the chain's g volumes) on `s`.
template <typename T, bool MASK>
cudaError_t block_precompute(const BlockPass<T>& p, cudaStream_t s) {
  const long long vol = static_cast<long long>(p.n) * p.n * p.n;
  for (int stage = 0; stage < pre_stages(p.b.block); ++stage) {
    stage_kernel<T, MASK, true><<<flat_blocks(vol), kThreads, 0, s>>>(p, stage, vol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One block of T sweeps, p.src -> p.dst, on `s`.
template <typename T, bool MASK>
cudaError_t block_step(const BlockPass<T>& p, cudaStream_t s) {
  for (int stage = 0; stage < block_stages(p.b.block); ++stage) {
    const long long items = block_stage_items(p.n, p.b.block, stage);
    stage_kernel<T, MASK, false><<<flat_blocks(items), kThreads, 0, s>>>(p, stage, items);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

}  // namespace fsk
