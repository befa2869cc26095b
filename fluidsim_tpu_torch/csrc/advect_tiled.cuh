// K1 and K11 at a window of K = 1 on tiles: the kernel that advect.cuh's
// launchers take for every K = 1 substep (advect_substeps: K1's f32 and bf16
// instantiations, K2's density phase through K1's entry, and K11 on a slab).
// Included by advect.cuh after the per-cell bodies whose functions it calls
// (frac_win, comb, buoyant_vy, emitter_add); include advect.cuh, not this.
//
// A block owns a tile of kAdvectTileX x-cells (threadIdx.x) by kAdvectTileY
// y-rows (kAdvectRows a thread along threadIdx.y) and marches over a run of
// z-planes of the slab.  Each thread owns kAdvectRows (y, x) columns of
// output cells, rows y to y + kAdvectRows - 1, and computes them at their
// interior cells as advect_store does (boundary.cuh's Cell): a border cell is
// the signed copy of its interior cell.  A thread's kAdvectRows cells read
// kAdvectRows + 2 staged rows a plane, where one cell alone reads three;
// where two rows have one interior row (a y wall) both take its values.
//
// Staging.  The taps of a tile's interior cells lie in its staged region: the
// columns [clamp(x0) - 1, clamp(x1 - 1) + 1] and rows likewise, at most
// kStageX x kStageY cells and never outside the grid (clamp to [1, n - 2]).
// A plane of that region is loaded once for each field, widened to float32,
// with what advect_cell_k1 adds at every tap applied once to each staged
// value: the emitter on the field (kSrcFields), and for the buoyant y
// component (BUOY_TAPS) buoyant_vy(g, rho) with rho the density plus the
// emitter (kSrcDensity).  These are the same functions of the same operands
// as advect_cell_k1's per-tap ones, so the bits do not change; the
// per-tap body evaluated them 27 times a cell.
//
// The z ring.  An interior cell at plane cz reads planes cz - 1, cz and
// cz + 1, wrapped into the slab (only a slab's open ends wrap).  Along a
// block's run the interior planes never decrease (a global z wall and its
// neighbour share one), so each plane is staged once, into slot p % 4 of four
// keyed by its unwrapped index p: a new interior plane stages the one plane
// it adds, which the thread loaded into registers before the previous
// plane's interpolation, into the slot of the plane read two planes ago, and
// one barrier makes it visible (every thread has passed the previous one, so
// none still reads that slot).  The cells' velocity is loaded one interior
// plane ahead too.  Where an interior plane adds more than one plane (the
// run's first, or a wall at a slab's end) they are loaded then, after a
// barrier.
//
// Runs.  The launch picks the runs along z (advect_runs) from the blocks of
// the instantiation the card holds at once (its occupancy): runs of at most
// kAdvectMaxRun planes, in the count with the least waves x (run length +
// 3), so that no wave runs part full (at 128^3 the 512 blocks of 8-plane
// runs were 1.3 waves of some instantiations).
//
// Everything else is advect_store's: the velocity at the cell and (BUOY_VEL)
// its buoyancy, the backtrace and its clamp in global z (zoff + cz), comb in
// advect_cell_k1's order (x innermost, then y, then z), a solid cell zeroed,
// the face sign, the rounding to TO, then the scale.  Offsets inside a plane
// are 32-bit.
#pragma once

#include "boundary.cuh"

namespace fsk {

constexpr int kAdvectTileX = 32;
constexpr int kAdvectTileY = 16;
constexpr int kAdvectRows = 4;  // y-rows a thread
constexpr int kAdvectThreads = kAdvectTileX * kAdvectTileY / kAdvectRows;
// The longest run of planes a block takes: longer runs were slower on an H100.
constexpr int kAdvectMaxRun = 16;
constexpr int kStageX = kAdvectTileX + 2;
constexpr int kStageY = kAdvectTileY + 2;
// A staged plane of a field in shared memory: kStageY rows and one spare,
// which a thread whose two rows share an interior row reads past the last.
constexpr int kStageRows = kStageY + 1;

inline dim3 advect_tile_block() {
  return dim3(kAdvectTileX, kAdvectTileY / kAdvectRows, 1);
}

inline int advect_tiles_xy(int n) {
  return ((n + kAdvectTileX - 1) / kAdvectTileX) * ((n + kAdvectTileY - 1) / kAdvectTileY);
}

// The runs along z of nz planes for tiles_xy tiles of a plane when the card
// holds `capacity` blocks at once: of the counts with runs of at most
// max_run planes, the one that minimises waves x (run length + lead), the
// lead standing for a run's first planes, staged before it computes (3 at
// K = 1; advect_window.cuh passes 2K + 1); the most runs among equals.
inline int advect_runs(int tiles_xy, int nz, int capacity, int lead = 3,
                       int max_run = kAdvectMaxRun) {
  int best = 1;
  long long best_cost = -1;
  for (int runs = (nz + max_run - 1) / max_run; runs <= nz; ++runs) {
    const int len = (nz + runs - 1) / runs;
    if ((nz + len - 1) / len != runs) continue;  // the same runs as a longer count
    const long long waves = (static_cast<long long>(tiles_xy) * runs + capacity - 1) / capacity;
    const long long cost = waves * (len + lead);
    if (best_cost < 0 || cost <= best_cost) {
      best = runs;
      best_cost = cost;
    }
  }
  return best;
}

// The interior plane of slab plane z before the wrap into the slab
// (fill_cell_slab's cz is wrap_plane of it): z + 1 at global z 0, z - 1 at
// global z n - 1, else z.
__device__ __forceinline__ int interior_plane_unwrapped(int z, int n, const Slab& sl) {
  const int zg = z + sl.zoff;
  return zg == 0 ? z + 1 : (zg == n - 1 ? z - 1 : z);
}

// A staged plane is kStageY rows of kStageX values a field; thread t stages
// its flat cells t, t + kAdvectThreads, ... (at most kStageShare).
constexpr int kStagePlane = kStageX * kStageY;
constexpr int kStageShare = (kStagePlane + kAdvectThreads - 1) / kAdvectThreads;

// Where a thread's share of a staged plane lies: each cell's offset in the
// plane of the grid and in the slot (-1: outside the grid or the region),
// fixed for the block's run.
struct Share {
  int grid[kStageShare], smem[kStageShare];
};

// A thread's share of one plane as loaded (the fields in their storage
// type, the buoyancy's density), before the staging adds.
template <int F, typename TF>
struct PlaneShare {
  TF g[kStageShare][F];
  float rho[kStageShare];
};

// Load this thread's share of plane p of the F fields (and, BUOY_TAPS, of
// the density).
template <int F, bool BUOY_TAPS, typename TF>
__device__ __forceinline__ void load_share(PlaneShare<F, TF>& r, const Share& sh, const TF* src,
                                           const float* dens, long long plane, long long vol,
                                           int p) {
  const long long base = p * plane;
#pragma unroll
  for (int k = 0; k < kStageShare; ++k) {
    if (sh.smem[k] < 0) continue;
#pragma unroll
    for (int c = 0; c < F; ++c) r.g[k][c] = (src + c * vol + base)[sh.grid[k]];
    if (BUOY_TAPS) r.rho[k] = (dens + base)[sh.grid[k]];
  }
}

// Stage a loaded share of plane p (global zg) into `slot`
// ([F][kStageRows][kStageX]): widened to float32, with the emitter on the
// fields (kSrcFields) and the buoyancy on the y component (BUOY_TAPS; the
// emitter on its density with kSrcDensity), as advect_cell_k1 applies them
// at each tap.  The staged region starts at row y0, column x0.
template <int F, bool BUOY_TAPS, int SRC, typename TF>
__device__ __forceinline__ void store_share(const PlaneShare<F, TF>& r, const Share& sh,
                                            float* slot, const float* e, const Buoyancy& bp,
                                            int zg, int y0, int x0) {
#pragma unroll
  for (int k = 0; k < kStageShare; ++k) {
    if (sh.smem[k] < 0) continue;
    const int y = y0 + sh.smem[k] / kStageX, x = x0 + sh.smem[k] % kStageX;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      float g = ld(r.g[k][c]);
      if (SRC == kSrcFields) g = emitter_add(g, e, zg, y, x);
      if (BUOY_TAPS && c == 1) {
        float rho = r.rho[k];
        if (SRC == kSrcDensity) rho = emitter_add(rho, e, zg, y, x);
        g = buoyant_vy(g, rho, bp);
      }
      slot[c * kStageRows * kStageX + sh.smem[k]] = g;
    }
  }
}

// What a thread reads at its interior cells: the velocity, the buoyancy's
// density, the solid flag.
template <typename TV>
struct CellShare {
  TV v[kAdvectRows][3];
  float rho[kAdvectRows];
  uint8_t solid[kAdvectRows];
};

template <bool BUOY_VEL, bool MASK, typename TV>
__device__ __forceinline__ void load_cells(CellShare<TV>& q, const TV* vel, const float* dens,
                                           const uint8_t* mask, long long vol, long long base,
                                           const int (&co)[kAdvectRows]) {
#pragma unroll
  for (int r = 0; r < kAdvectRows; ++r) {
    const long long c0 = base + co[r];
    q.solid[r] = MASK ? mask[c0] : 0;
    if (MASK && q.solid[r] != 0) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) q.v[r][c] = vel[c * vol + c0];
    if (BUOY_VEL) q.rho[r] = dens[c0];
  }
}

namespace {

// A block's run of planes: z0 = blockIdx.z * run, to z0 + run or the
// slab's end (see the z ring above).
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF, typename TV,
          typename TO>
__global__ void __launch_bounds__(kAdvectThreads)
    advect_tiled_kernel(const TF* __restrict__ src, const TV* __restrict__ vel,
                        const float* __restrict__ dens, const uint8_t* __restrict__ mask,
                        const float* __restrict__ emitter, TO* __restrict__ dst, int n, Slab sl,
                        int b0, int b1, int b2, float dt0, float scale, Buoyancy bp,
                        int run) {
  constexpr int kSlot = F * kStageRows * kStageX;
  constexpr int R = kAdvectRows;
  __shared__ float ring[4 * kSlot];
  const long long plane = static_cast<long long>(n) * n, vol = plane * sl.nz;
  const int x0 = blockIdx.x * kAdvectTileX, y0 = blockIdx.y * kAdvectTileY;
  const int z0 = blockIdx.z * run;
  const int z1 = min(z0 + run, sl.nz);
  const int sx0 = clamp_interior(x0, n) - 1, sy0 = clamp_interior(y0, n) - 1;
  const int sw = min(kStageX, n - sx0), sh_rows = min(kStageY, n - sy0);
  Share sh;
#pragma unroll
  for (int k = 0; k < kStageShare; ++k) {
    const int f = threadIdx.y * kAdvectTileX + threadIdx.x + k * kAdvectThreads;
    const int j = f / kStageX, i = f - j * kStageX;
    const bool in = f < kStagePlane && j < sh_rows && i < sw;
    sh.grid[k] = (sy0 + j) * n + sx0 + i;
    sh.smem[k] = in ? j * kStageX + i : -1;
  }
  const int x = x0 + threadIdx.x;
  const int cx = clamp_interior(x, n);
  // The thread's rows ys and their interior rows cys, which are the rows
  // cys[0] + r but at a y wall, where two rows share one.  The interpolation
  // runs at the natural rows nat = cys[0] + r (kept inside the grid) and
  // each row takes the natural row of its interior row.
  int ys[R], cys[R], nat[R], co[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ys[r] = y0 + R * threadIdx.y + r;
    cys[r] = clamp_interior(ys[r], n);
    live[r] = x < n && ys[r] < n;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    nat[r] = min(cys[0] + r, n - 1);
    co[r] = nat[r] * n + cx;
  }
  // Rows ly - 1 .. ly + R of a staged plane are read; a live thread's lie in
  // the staged region or the spare row, and the bound keeps a dead one's in
  // the slot.
  const int lx = cx - sx0, ly = min(cys[0] - sy0, kStageRows - R - 1);
  const float hi = float(n) - 1.5f;
  const float fxc = float(cx);
  const int bs[3] = {b0, b1, b2};
  float v[R][F];

  // The values at interior plane cz from the staged planes cz - 1, cz, cz + 1
  // in slots sl3, with the cells' operands q: the backtrace of each natural
  // row, then the two-tap combinations, the R rows' x taps read once.
  auto interpolate = [&](const int (&sl3)[3], const CellShare<TV>& q, int cz) {
    const int zg = cz + sl.zoff;
    float wxp[R], wxm[R], wyp[R], wym[R], wzp[R], wzm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float vx = ld(q.v[r][0]);
      float vy = ld(q.v[r][1]);
      const float vz = ld(q.v[r][2]);
      if (BUOY_VEL) {
        float rho = q.rho[r];
        if (SRC == kSrcDensity) rho = emitter_add(rho, emitter, zg, nat[r], cx);
        vy = buoyant_vy(vy, rho, bp);
      }
      const float fx = frac_win<1>(fxc, vx, dt0, hi);
      const float fy = frac_win<1>(float(nat[r]), vy, dt0, hi);
      const float fz = frac_win<1>(float(zg), vz, dt0, hi);
      wxp[r] = max_to(fx, 0.0f);
      wxm[r] = max_to(-fx, 0.0f);
      wyp[r] = max_to(fy, 0.0f);
      wym[r] = max_to(-fy, 0.0f);
      wzp[r] = max_to(fz, 0.0f);
      wzm[r] = max_to(-fz, 0.0f);
    }
#pragma unroll
    for (int c = 0; c < F; ++c) {
      float zc[R][3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float* pl = ring + sl3[dz] * kSlot + (c * kStageRows + ly) * kStageX + lx;
        float g[R + 2][3];
#pragma unroll
        for (int j = 0; j < R + 2; ++j) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) g[j][dx] = pl[(j - 1) * kStageX + dx - 1];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float yc[3];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            yc[dy] = comb(g[r + dy][0], g[r + dy][1], g[r + dy][2], wxp[r], wxm[r]);
          }
          zc[r][dz] = comb(yc[0], yc[1], yc[2], wyp[r], wym[r]);
        }
      }
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        w[r] = comb(zc[r][0], zc[r][1], zc[r][2], wzp[r], wzm[r]);
        if (MASK && q.solid[r] != 0) w[r] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r][c] = w[0];
#pragma unroll
        for (int k = 1; k <= r; ++k) {
          if (cys[r] - cys[0] == k) v[r][c] = w[k];
        }
      }
    }
  };
  // Output plane z, whose interior plane is cz: the face signs, the rounding
  // and the scale.
  auto store = [&](int z, int cz) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!live[r]) continue;
      const long long o = z * plane + ys[r] * static_cast<long long>(n) + x;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float u = face_negates(bs[c], z, ys[r], x, cz, cys[r], cx) ? -v[r][c] : v[r][c];
        dst[c * vol + o] = st<TO>(ld(st<TO>(u)) * scale);
      }
    }
  };
  auto stage = [&](const PlaneShare<F, TF>& r, int s, int p) {
    store_share<F, BUOY_TAPS, SRC>(r, sh, ring + s * kSlot, emitter, bp, sl.zoff + p, sy0, sx0);
  };

  PlaneShare<F, TF> next;
  CellShare<TV> cell;
  // top: the highest plane staged; ahead: the plane in `next` (kNone: none);
  // cell_at: the interior plane whose operands `cell` holds.
  constexpr int kNone = -(1 << 30);
  int top = kNone, ahead = kNone, cell_at = kNone, prev = kNone;
  for (int z = z0; z < z1; ++z) {
    const int cu = interior_plane_unwrapped(z, n, sl);
    const int cz = wrap_plane(cu, sl.nz);
    if (cu != prev) {
      // Stage planes max(top + 1, cu - 1) .. cu + 1; more than one may refill
      // a slot the previous interior plane read.
      const int from = max(top + 1, cu - 1);
      if (from < cu + 1 && prev != kNone) __syncthreads();
      for (int p = from; p <= cu + 1; ++p) {
        if (p != ahead) load_share<F, BUOY_TAPS>(next, sh, src, dens, plane, vol,
                                                  wrap_plane(p, sl.nz));
        stage(next, p & 3, wrap_plane(p, sl.nz));
      }
      top = cu + 1;
      __syncthreads();
      prev = cu;
      if (cell_at != cu) load_cells<BUOY_VEL, MASK>(cell, vel, dens, mask, vol, cz * plane, co);
      const CellShare<TV> here = cell;
      // The next interior plane of the run: when it adds one plane, that
      // plane and its cells' operands are loaded now.
      int nu = kNone;
      for (int zn = z + 1; zn < z1 && nu == kNone; ++zn) {
        const int c = interior_plane_unwrapped(zn, n, sl);
        if (c != cu) nu = c;
      }
      ahead = kNone;
      cell_at = kNone;
      if (nu != kNone) {
        if (max(top + 1, nu - 1) == nu + 1) {
          ahead = nu + 1;
          load_share<F, BUOY_TAPS>(next, sh, src, dens, plane, vol, wrap_plane(ahead, sl.nz));
        }
        load_cells<BUOY_VEL, MASK>(cell, vel, dens, mask, vol, wrap_plane(nu, sl.nz) * plane,
                                   co);
        cell_at = nu;
      }
      const int sl3[3] = {(cu - 1) & 3, cu & 3, (cu + 1) & 3};
      interpolate(sl3, here, cz);
    }
    store(z, cz);
  }
}

template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF, typename TV,
          typename TO>
cudaError_t launch_tiled(const Substep& a, cudaStream_t s) {
  const auto kernel = advect_tiled_kernel<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, TF, TV, TO>;
  // The blocks of this instantiation a card holds at once (its SMs times
  // the blocks an SM fits), read once for each device (0: not read yet), so
  // a mesh whose shards switch cards every launch reads it once a card.
  constexpr int kCachedDevices = 32;
  static int cached[kCachedDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int capacity = dev < kCachedDevices ? cached[dev] : 0;
  if (capacity == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAdvectThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    capacity = sms * per_sm;
    if (dev < kCachedDevices) cached[dev] = capacity;
  }
  const int runs = advect_runs(advect_tiles_xy(a.n), a.slab.nz, capacity);
  const int run = (a.slab.nz + runs - 1) / runs;
  const dim3 grid((a.n + kAdvectTileX - 1) / kAdvectTileX,
                  (a.n + kAdvectTileY - 1) / kAdvectTileY, runs);
  kernel<<<grid, advect_tile_block(), 0, s>>>(
      static_cast<const TF*>(a.src), static_cast<const TV*>(a.vel), a.dens, a.mask, a.emitter,
      static_cast<TO*>(a.dst), a.n, a.slab, a.b0, a.b1, a.b2, a.dt0, a.scale, a.bp, run);
  return cudaGetLastError();
}

}  // namespace

}  // namespace fsk
