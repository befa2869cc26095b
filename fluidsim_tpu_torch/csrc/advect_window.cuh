// K1 and K11 at windows K >= 2 on tiles: the kernel that advect.cuh's
// launch takes for every substep of a window K >= 2 where the tile's ring
// fits the shared memory a block may opt in to (win_tiled; above that K one
// thread a cell).  It runs K1's f32 and bf16 instantiations, K2's density
// phase through K1's entry, and K11 on a slab.  Included by advect.cuh after
// the per-cell bodies whose functions it calls (frac_win, hat, buoyant_vy,
// emitter_add) and after advect_tiled.cuh (interior_plane_unwrapped,
// advect_runs); include advect.cuh, not this.
//
// A block owns a tile of kWinTileX x-cells by kWinTileY y-rows, one cell a
// thread, and marches over a run of z-planes of the slab.  Each thread
// computes its cell at its interior cell (boundary.cuh's Cell): a border cell
// is the signed copy of its interior cell, which both threads compute.
//
// Staging.  The taps of the tile's interior cells lie in its staged region:
// the columns [clamp(x0) - K, clamp(x1 - 1) + K] and the rows likewise, at
// most (kWinTileX + 2K) x (kWinTileY + 2K) cells, read at the wrapped
// indices the twin's torch.roll reads (the clamp leaves every tap outside
// the grid at zero weight).  A plane of that region is loaded once for each
// field and widened to float32, with what the per-cell body adds at every
// tap applied once to each staged value: the emitter on the field
// (kSrcFields), and for the buoyant y component (BUOY_TAPS) buoyant_vy(g,
// rho) with rho the density plus the emitter (kSrcDensity), at the value's
// wrapped coordinates, as advect_cell_win applies them.
//
// The z ring.  An interior cell at plane cz reads planes cz - K .. cz + K,
// wrapped into the slab.  Along a block's run the interior planes never
// decrease, so each plane is staged once, into slot p % (2K + 2) of its
// unwrapped index p.  A new interior plane cu stages the plane cu + K it
// adds, loaded into registers before the previous plane's interpolation,
// into the slot of plane cu - K - 2, which only interior planes up to cu - 2
// read: every thread has passed the barrier that published the previous
// plane, so none still reads it.  Where an interior plane adds more planes
// (a run's first: 2K + 1; a global wall inside a slab: two) they are loaded
// then, and each plane's barrier lets the next refill a slot the previous
// interior plane read.
//
// The vote.  The barrier that publishes a plane is __syncthreads_and(every
// value this thread staged is finite): one bit a slot, the same in every
// thread.
//
// The sum.  With the clamp, f lies in [-K, K], and hat(f, d) = max(0, 1 -
// |f - d|) is positive only at d = floor(f) and floor(f) + 1: |f - d| >= 1
// elsewhere, and rounding is monotone, so every other weight is +0.  The
// hat sum starts at +0 and a sum in round-to-nearest is -0 only when both
// addends are, so it never is: adding (+0) * g for a finite g, which is +-0,
// leaves its bits as they are.  So where every tap of a cell's window is
// finite, the 8 taps at d = min(floor(f), K - 1) and d + 1 on each axis,
// summed in the hat sum's own order (dz, then dy, then dx ascending; weight
// ((hz * hy) * hx)), are bitwise the (2K+1)^3-term sum (advect.cuh's
// eight_taps and eight_tap_sum, which K8 and K14 share).  A cell takes that
// sum when the bits of its 2K + 1 planes are all set and none of fx, fy, fz
// is NaN (a NaN displacement makes every weight NaN, and floor gives no
// index); otherwise it takes the full sum, in advect_cell_win's order, from
// the staged planes.
//
// Runs.  The launch picks the runs along z with advect_runs, a run's first
// planes standing for 2K + 1, from the blocks of the instantiation the card
// holds at once with this K's ring (its occupancy).
//
// Everything else is advect_store's: the velocity at the cell and (BUOY_VEL)
// its buoyancy, the backtrace and its clamp in global z (zoff + cz), a solid
// cell zeroed, the face sign, the rounding to TO, then the scale.  Offsets
// inside a plane are 32-bit.
#pragma once

#include "boundary.cuh"

namespace fsk {

constexpr int kWinTileX = 32;
constexpr int kWinTileY = 16;
constexpr int kWinThreads = kWinTileX * kWinTileY;  // one cell a thread
// The longest run of planes a block takes: longer runs share a run's 2K + 1
// first planes among more; at 64 planes K11's slabs ran 4-5% faster than at
// 32 on an H100.
constexpr int kWinMaxRun = 64;

// A staged plane of a field: win_rows(k) rows of win_pitch(k) values.
__host__ __device__ constexpr int win_pitch(int k) { return kWinTileX + 2 * k; }
__host__ __device__ constexpr int win_rows(int k) { return kWinTileY + 2 * k; }
__host__ __device__ constexpr int win_slots(int k) { return 2 * k + 2; }

// The staged values a thread loads a plane (registers: at most
// win_share_max(F) for each field).
__host__ __device__ constexpr int win_share(int k) {
  return (win_pitch(k) * win_rows(k) + kWinThreads - 1) / kWinThreads;
}
__host__ __device__ constexpr int win_share_max(int n_fields) { return n_fields == 1 ? 5 : 3; }

// The ring's bytes: 2K + 2 slots of F float32 planes.
constexpr long long win_ring_bytes(int k, int n_fields) {
  return 4LL * win_slots(k) * n_fields * win_pitch(k) * win_rows(k);
}

// The gate: a window of k >= 2 cells of n_fields fields takes the tiles
// where the ring fits `optin` bytes (the shared memory a block may opt in
// to) and a thread's share of a plane its registers.  On an H100 (227 KB)
// that is K <= 6 for F = 3 and K <= 11 for F = 1.
inline bool win_tiled(int k, int n_fields, long long optin) {
  return k >= 2 && win_share(k) <= win_share_max(n_fields) &&
         win_ring_bytes(k, n_fields) <= optin;
}

// What a thread reads at its interior cell: the velocity, the buoyancy's
// density, the solid flag.
template <typename TV>
struct WinCell {
  TV v[3];
  float rho;
  uint8_t solid;
};

namespace {

// Two blocks an SM where two rings fit its 228 KB (F = 1 up to K = 8, F = 3
// up to K = 4): at most 64 registers a thread, which no instantiation
// spills.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF, typename TV,
          typename TO>
__global__ void __launch_bounds__(kWinThreads, 2)
    advect_window_kernel(const TF* __restrict__ src, const TV* __restrict__ vel,
                         const float* __restrict__ dens, const uint8_t* __restrict__ mask,
                         const float* __restrict__ emitter, TO* __restrict__ dst, int n, Slab sl,
                         int b0, int b1, int b2, float dt0, float scale, Buoyancy bp, int k,
                         int run) {
  constexpr int S = win_share_max(F);
  extern __shared__ float ring[];
  const int pitch = win_pitch(k), slots = win_slots(k);
  const int field_size = win_rows(k) * pitch, slot_size = F * field_size;
  const long long plane = static_cast<long long>(n) * n, vol = plane * sl.nz;
  const int x0 = blockIdx.x * kWinTileX, y0 = blockIdx.y * kWinTileY;
  const int z0 = blockIdx.z * run;
  const int z1 = min(z0 + run, sl.nz);
  const int cx0 = clamp_interior(x0, n), cy0 = clamp_interior(y0, n);
  const int sx0 = cx0 - k, sy0 = cy0 - k;
  const int sw = clamp_interior(min(x0 + kWinTileX, n) - 1, n) - cx0 + 1 + 2 * k;
  const int sh = clamp_interior(min(y0 + kWinTileY, n) - 1, n) - cy0 + 1 + 2 * k;
  // This thread's share of a staged plane: each value's offset in the plane
  // of the grid (wrapped) and in a slot's field (-1: none).
  int grid[S], smem[S];
  const int tid = threadIdx.y * kWinTileX + threadIdx.x;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int f = tid + s * kWinThreads;
    const int j = f / sw, i = f - j * sw;
    const bool in = f < sw * sh;
    grid[s] = in ? wrap_plane(sy0 + j, n) * n + wrap_plane(sx0 + i, n) : 0;
    smem[s] = in ? j * pitch + i : -1;
  }
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool live = x < n && y < n;
  const int cx = clamp_interior(min(x, n - 1), n), cy = clamp_interior(min(y, n - 1), n);
  const int lx = cx - sx0, ly = cy - sy0;
  const int co = cy * n + cx;
  const float hi = float(n) - 1.5f;
  const int bs[3] = {b0, b1, b2};
  const unsigned full = (1u << slots) - 1u;

  auto slot_of = [&](int p) {
    const int r = p % slots;
    return r < 0 ? r + slots : r;
  };
  TF g[S][F];
  float rho[S];
  // Load this thread's share of slab plane pz (wrapped) into g and rho.
  auto load = [&](int pz) {
    const long long base = pz * plane;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (smem[s] < 0) continue;
#pragma unroll
      for (int c = 0; c < F; ++c) g[s][c] = src[c * vol + base + grid[s]];
      if (BUOY_TAPS) rho[s] = dens[base + grid[s]];
    }
  };
  // Stage the loaded share of unwrapped plane p into its slot and vote.
  unsigned bits = 0;
  auto stage = [&](int p) {
    const int slot = slot_of(p);
    const int zg = sl.zoff + wrap_plane(p, sl.nz);
    float* out = ring + slot * slot_size;
    bool finite = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (smem[s] < 0) continue;
      const int ty = grid[s] / n, tx = grid[s] - ty * n;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        float v = ld(g[s][c]);
        if (SRC == kSrcFields) v = emitter_add(v, emitter, zg, ty, tx);
        if (BUOY_TAPS && c == 1) {
          float r = rho[s];
          if (SRC == kSrcDensity) r = emitter_add(r, emitter, zg, ty, tx);
          v = buoyant_vy(v, r, bp);
        }
        out[c * field_size + smem[s]] = v;
        finite = finite && fabsf(v) <= 3.40282347e38f;  // not inf, not NaN
      }
    }
    const unsigned bit = 1u << slot;
    bits = __syncthreads_and(finite) ? (bits | bit) : (bits & ~bit);
  };
  auto load_cell = [&](WinCell<TV>& q, int pz) {
    const long long c0 = pz * plane + co;
    q.solid = MASK ? mask[c0] : 0;
    if (MASK && q.solid != 0) return;
#pragma unroll
    for (int c = 0; c < 3; ++c) q.v[c] = vel[c * vol + c0];
    if (BUOY_VEL) q.rho = dens[c0];
  };

  float v[F];
  // The values at interior plane cu (wrapped: cz) from its 2K + 1 staged
  // planes, with the cell's operands q.
  auto interpolate = [&](const WinCell<TV>& q, int cu, int cz) {
    if (MASK && q.solid != 0) {
#pragma unroll
      for (int c = 0; c < F; ++c) v[c] = 0.0f;
      return;
    }
    const int zg = cz + sl.zoff;
    const float vx = ld(q.v[0]);
    float vy = ld(q.v[1]);
    const float vz = ld(q.v[2]);
    if (BUOY_VEL) {
      float r = q.rho;
      if (SRC == kSrcDensity) r = emitter_add(r, emitter, zg, cy, cx);
      vy = buoyant_vy(vy, r, bp);
    }
    const float fx = frac_win(float(cx), vx, dt0, hi, k);
    const float fy = frac_win(float(cy), vy, dt0, hi, k);
    const float fz = frac_win(float(zg), vz, dt0, hi, k);
    const int s0 = slot_of(cu - k);  // the slot of the window's first plane
    const unsigned need = full & ~(1u << slot_of(cu + k + 1));
    const float* at = ring + ly * pitch + lx;  // the cell's tap in a slot's field
    if (fx == fx && fy == fy && fz == fz && (bits & need) == need) {  // no NaN
      const EightTaps t = eight_taps(fx, fy, fz, k);
      int sa = s0 + t.iz + k;
      sa -= sa >= slots ? slots : 0;
      const int sb = sa + 1 == slots ? 0 : sa + 1;
      const float* pa = at + sa * slot_size + t.iy * pitch + t.ix;
      const float* pb = at + sb * slot_size + t.iy * pitch + t.ix;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float* a = pa + c * field_size;
        const float* b = pb + c * field_size;
        const float g[8] = {a[0], a[1], a[pitch], a[pitch + 1],
                            b[0], b[1], b[pitch], b[pitch + 1]};
        v[c] = eight_tap_sum(t.w, g);
      }
      return;
    }
    // The full sum, zero weights and non-finite taps too.
    float acc[F];
#pragma unroll
    for (int c = 0; c < F; ++c) acc[c] = 0.0f;
    const int wd = 2 * k + 1;
#pragma unroll 1
    for (int dz = 0; dz < wd; ++dz) {
      const float wz = hat(fz, dz - k);
      const int sz = s0 + dz >= slots ? s0 + dz - slots : s0 + dz;
#pragma unroll 1
      for (int dy = 0; dy < wd; ++dy) {
        const float wzy = wz * hat(fy, dy - k);
        const float* row = at + sz * slot_size + (dy - k) * pitch - k;
#pragma unroll 1
        for (int dx = 0; dx < wd; ++dx) {
          const float wt = wzy * hat(fx, dx - k);
#pragma unroll
          for (int c = 0; c < F; ++c) acc[c] = acc[c] + wt * row[c * field_size + dx];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = acc[c];
  };
  // Output plane z, whose interior plane is cz: the face signs, the rounding
  // and the scale.
  auto store = [&](int z, int cz) {
    if (!live) return;
    const long long o = z * plane + static_cast<long long>(y) * n + x;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float u = face_negates(bs[c], z, y, x, cz, cy, cx) ? -v[c] : v[c];
      dst[c * vol + o] = st<TO>(ld(st<TO>(u)) * scale);
    }
  };

  WinCell<TV> cell;
  // top: the highest plane staged; ahead: the plane loaded in g (kNone:
  // none); cell_at: the interior plane whose operands `cell` holds.
  constexpr int kNone = -(1 << 30);
  int top = kNone, ahead = kNone, cell_at = kNone, prev = kNone;
  for (int z = z0; z < z1; ++z) {
    const int cu = interior_plane_unwrapped(z, n, sl);
    const int cz = wrap_plane(cu, sl.nz);
    if (cu != prev) {
      for (int p = top == kNone ? cu - k : max(top + 1, cu - k); p <= cu + k; ++p) {
        if (p != ahead) load(wrap_plane(p, sl.nz));
        stage(p);
      }
      top = cu + k;
      prev = cu;
      if (cell_at != cu) load_cell(cell, cz);
      const WinCell<TV> here = cell;
      // The next interior plane of the run: when it adds one plane, that
      // plane and its cell's operands are loaded now.
      int nu = kNone;
      for (int zn = z + 1; zn < z1 && nu == kNone; ++zn) {
        const int c = interior_plane_unwrapped(zn, n, sl);
        if (c != cu) nu = c;
      }
      ahead = kNone;
      cell_at = kNone;
      if (nu != kNone) {
        if (max(top + 1, nu - k) == nu + k) {
          ahead = nu + k;
          load(wrap_plane(ahead, sl.nz));
        }
        load_cell(cell, wrap_plane(nu, sl.nz));
        cell_at = nu;
      }
      interpolate(here, cu, cz);
    }
    store(z, cz);
  }
}

// Launch attributes are cached for each device index below this (bit d of a
// mask, entry d of an array), so a mesh whose shards switch cards every
// launch reads or sets each once a card; a higher index reads them anew.
constexpr int kWinCachedDevices = 32;

// The shared memory a block may opt in to on the current device, read once
// for each device (0: not read yet).
inline cudaError_t win_smem_optin(int& optin) {
  static int cached[kWinCachedDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int value = dev < kWinCachedDevices ? cached[dev] : 0;
  if (value == 0) {
    err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (dev < kWinCachedDevices) cached[dev] = value;
  }
  optin = value;
  return cudaSuccess;
}

// One substep of window k (win_tiled(k, F, optin) holds) on tiles.
template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK, int SRC, typename TF, typename TV,
          typename TO>
cudaError_t launch_window_tiled(const Substep& a, int k, int optin, cudaStream_t s) {
  const auto kernel = advect_window_kernel<F, BUOY_VEL, BUOY_TAPS, MASK, SRC, TF, TV, TO>;
  const int bytes = static_cast<int>(win_ring_bytes(k, F));
  // The shared-memory attribute, set once a device (bit d of `set`), and
  // the blocks the card holds at once with this k's ring (its SMs times the
  // blocks an SM fits), read once a device and k (0: not read yet).
  constexpr int kMaxK = 16;
  static unsigned set = 0;
  static int cached[kWinCachedDevices][kMaxK];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (k >= kMaxK) return cudaErrorInvalidValue;
  const bool cache = dev < kWinCachedDevices;
  if (!cache || !((set >> dev) & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    if (cache) set |= 1u << dev;
  }
  int uncached[kMaxK] = {};
  int* const capacity = cache ? cached[dev] : uncached;
  if (capacity[k] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWinThreads, bytes);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    capacity[k] = sms * per_sm;
  }
  const int tiles_xy = ((a.n + kWinTileX - 1) / kWinTileX) * ((a.n + kWinTileY - 1) / kWinTileY);
  const int runs = advect_runs(tiles_xy, a.slab.nz, capacity[k], 2 * k + 1, kWinMaxRun);
  const int run = (a.slab.nz + runs - 1) / runs;
  const dim3 grid((a.n + kWinTileX - 1) / kWinTileX, (a.n + kWinTileY - 1) / kWinTileY, runs);
  kernel<<<grid, dim3(kWinTileX, kWinTileY, 1), bytes, s>>>(
      static_cast<const TF*>(a.src), static_cast<const TV*>(a.vel), a.dens, a.mask, a.emitter,
      static_cast<TO*>(a.dst), a.n, a.slab, a.b0, a.b1, a.b2, a.dt0, a.scale, a.bp, k, run);
  return cudaGetLastError();
}

}  // namespace

}  // namespace fsk
