// K9: the whole 2D Jacobi solve of the reference-parity mode in one launch:
// `iters` sweeps on one (n, n) float32 field stored [y, x], each
//   1. the interior update  (rhs + a*(((x[i+1] + x[i-1]) + x[j+1]) + x[j-1])) / c
//      with rhs the current iterate (smooth mode, the reference's DiffuseJob)
//      or x0 (fixed-rhs mode, LinearSolveIterationJob), divided by c in IEEE
//      float32 (nvcc's default -prec-div=true; no reciprocal multiply);
//   2. interior obstacle cells set to x0 (smooth: the reference's stale-buffer
//      quirk) or to the previous iterate (fixed-rhs);
//   3. set_bnd_2d(b): the wall edges (corners excluded) copy their interior
//      neighbour, negated across the x walls for b = 1 and the y walls for
//      b = 2; each corner is 0.5 * (row-wall edge + column-wall edge) of the
//      just-written edges; then, for b = 1 and 2, every interior obstacle
//      cell becomes the negated mean of its fluid neighbours along the
//      component's axis (0 with none), where "fluid" reads the whole mask,
//      border cells included, and the neighbours' values are those after
//      the edge writes.
//
// Replaces: fluidsim_tpu/pallas/resident2d.py::_solve2d_kernel (entry
// lin_solve_2d_resident), which is bitwise the XLA formulation
// (ops/linsolve.diffuse_smooth_2d, lin_solve_2d); the plain twin here is
// that formulation (fluidsim_tpu_torch/ops/linsolve.sweeps_2d).
//
// What bounds it on an H100: nothing the card's rates see.  A 192^2 field is
// 147 KB; the call must move 13 n^2 bytes (x, x0 and the mask in, the result
// out; 9 n^2 for a smoothing solve, whose x is x0), and a sweep is ~6
// float32 operations a cell (0.2 MFLOP at 192^2, 3 ns at the card's float32
// peak).  What costs is that every sweep needs the whole previous iterate:
// 20 cluster-wide dependencies a solve, 160 a step, each a barrier of the
// cluster (fs_cluster_barriers times a launch of barriers alone, the least
// a solve can take).
//
// What the design does about it: one launch per solve on one thread-block
// cluster of `blocks` (1 to 16; the step's 16 a non-portable cluster)
// blocks of 1024 threads, the cluster's
// hardware barrier between sweeps.  Each cell's post-sweep value is a pure
// function of the previous iterate: an edge recomputes the interior cell it
// copies, a corner the interior cell both its edges copy, an obstacle cell
// the fluid neighbours it mirrors (and an edge neighbour's interior cell,
// which may be the obstacle cell's own pre-mirror value).  So a sweep reads
// only the previous iterate and writes only the next, and one barrier a
// sweep is enough.  Two routes, which the caller picks before the launch
// (kernels/resident2d.solve2d_route):
//   - strips (solve2d_strips_kernel), wherever a block's strip fits its
//     shared memory (on an H100 up to n = 507 at 16 blocks, 363 at 8): block r of the
//     cluster owns the rows [r*n/blocks, (r+1)*n/blocks) and keeps both
//     copies of its strip of the iterate, its strip of x0 and of the mask
//     in shared memory for the whole solve, with the rows a sweep of its
//     cells reads past the strip's ends (two of the iterate, one of x0 and
//     the mask).  After each sweep's barrier a block copies the new halo
//     rows of the iterate from their owners' shared memory through the
//     cluster's distributed shared memory (map_shared_rank), so every read
//     of a sweep is a plain shared-memory load.  No value leaves the SMs
//     between the load and the final store of the last sweep's strip to
//     `out`.
//   - L2 (solve2d_kernel), above that: the two iterates ping-pong through
//     global memory, read at L2 (ld.global.cg, never the read-only path,
//     since other blocks of the launch write them); x0 and the mask are
//     read-only for the whole launch.
// Both call the same per-cell functions (swept, edged, updated) on their
// view of the previous iterate, x0 and the mask, so the two are bitwise one
// another.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace fsk2d {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kPortableCluster = 8;  // the largest portable cluster
constexpr int kMaxCluster = 16;      // the largest an H100 takes (non-portable)
// The strips route's halo: rows of the iterate a block holds past each end
// of its strip (a cell's value reads rows up to two away: an obstacle
// mirror reads an edge neighbour's interior cell), and of x0 and the mask
// (one away).
constexpr int kHalo = 2;
constexpr int kMaskHalo = 1;

// The solve's parameters: b and the mode at run time (the L2 route).
struct Solve {
  int n, b;
  float a, c;
  bool smooth;
};

// The same with b and the mode compile-time (the strips route, one kernel
// each).
template <int B, bool SMOOTH>
struct SolveAt {
  static constexpr int b = B;
  static constexpr bool smooth = SMOOTH;
  int n;
  float a, c;
};

// The first row of strip r of n rows cut into `blocks` strips.
__host__ __device__ __forceinline__ int strip_lo(int r, int n, int blocks) {
  return static_cast<int>(static_cast<long long>(r) * n / blocks);
}

// The most rows a strip has.
__host__ __device__ __forceinline__ int strip_rows(int n, int blocks) {
  return (n + blocks - 1) / blocks;
}

// Bytes of shared memory a block of the strips route takes: two float32
// copies of the tallest strip with kHalo rows past each end, and its x0
// (float32) and mask (a byte a cell) with kMaskHalo rows.
__host__ __device__ __forceinline__ size_t strip_smem(int n, int blocks) {
  const size_t rows = strip_rows(n, blocks);
  return (2 * sizeof(float) * (rows + 2 * kHalo) + (sizeof(float) + 1) * (rows + 2 * kMaskHalo)) *
         static_cast<size_t>(n);
}

// The L2 route's view: the previous iterate (written before the last
// barrier by any block of the cluster, so read at L2), x0 and the mask.
struct Global {
  const float* src;
  const float* x0;
  const unsigned char* mask;  // one byte a cell, nonzero = solid; null: none
  int n;
  __device__ __forceinline__ long long at(int j, int i) const {
    return static_cast<long long>(j) * n + i;
  }
  __device__ __forceinline__ float it(int j, int i) const { return __ldcg(src + at(j, i)); }
  __device__ __forceinline__ float x0v(int j, int i) const { return __ldg(x0 + at(j, i)); }
  __device__ __forceinline__ bool solid(int j, int i) const {
    return mask != nullptr && __ldg(mask + at(j, i)) != 0;
  }
};

// The strips route's view: this block's strip [lo, hi) of the previous
// iterate with kHalo rows past each end, and of x0 and the mask with
// kMaskHalo, all in its shared memory (row j of the iterate at local row
// j - lo + kHalo).
template <bool MASK>
struct Strip {
  const float* src;
  const float* x0;
  const unsigned char* mask;  // unused without MASK
  int n, lo;
  __device__ __forceinline__ float it(int j, int i) const {
    return src[(j - lo + kHalo) * n + i];
  }
  __device__ __forceinline__ float x0v(int j, int i) const {
    return x0[(j - lo + kMaskHalo) * n + i];
  }
  __device__ __forceinline__ bool solid(int j, int i) const {
    return MASK && mask[(j - lo + kMaskHalo) * n + i] != 0;
  }
};

__device__ __forceinline__ float negate_if(bool neg, float v) { return neg ? -v : v; }

// Interior cell (j, i) after steps 1 and 2 (before the mirror).
template <typename F, typename P>
__device__ float updated(const F& f, const P& s, int j, int i) {
  if (f.solid(j, i)) return s.smooth ? f.x0v(j, i) : f.it(j, i);
  const float nbr = ((f.it(j, i + 1) + f.it(j, i - 1)) + f.it(j + 1, i)) + f.it(j - 1, i);
  const float rhs = s.smooth ? f.it(j, i) : f.x0v(j, i);
  return (rhs + s.a * nbr) / s.c;
}

// Cell (j, i), not a corner, after the edge writes: an interior cell's update,
// or an edge cell's copy of its interior neighbour.
template <typename F, typename P>
__device__ float edged(const F& f, const P& s, int j, int i) {
  const int n = s.n;
  if (i == 0) return negate_if(s.b == 1, updated(f, s, j, 1));
  if (i == n - 1) return negate_if(s.b == 1, updated(f, s, j, n - 2));
  if (j == 0) return negate_if(s.b == 2, updated(f, s, 1, i));
  if (j == n - 1) return negate_if(s.b == 2, updated(f, s, n - 2, i));
  return updated(f, s, j, i);
}

// Cell (j, i) after the whole sweep.
template <typename F, typename P>
__device__ float swept(const F& f, const P& s, int j, int i) {
  const int n = s.n;
  const bool row_wall = j == 0 || j == n - 1, col_wall = i == 0 || i == n - 1;
  if (row_wall && col_wall) {
    // The row-wall edge next to the corner, then the column-wall edge.
    return 0.5f * (edged(f, s, j, i == 0 ? 1 : n - 2) + edged(f, s, j == 0 ? 1 : n - 2, i));
  }
  if (row_wall || col_wall) return edged(f, s, j, i);
  if (s.b == 0 || !f.solid(j, i)) return updated(f, s, j, i);
  // The obstacle mirror along x (b = 1) or y (b = 2).
  const int dj = s.b == 2 ? 1 : 0, di = s.b == 1 ? 1 : 0;
  const bool lo_fluid = !f.solid(j - dj, i - di), hi_fluid = !f.solid(j + dj, i + di);
  const float total = (lo_fluid ? -edged(f, s, j - dj, i - di) : 0.0f) +
                      (hi_fluid ? -edged(f, s, j + dj, i + di) : 0.0f);
  const float count = (lo_fluid ? 1.0f : 0.0f) + (hi_fluid ? 1.0f : 0.0f);
  return count > 0.0f ? total / fmaxf(count, 1.0f) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    solve2d_kernel(const float* x, const float* x0, const unsigned char* mask, float* out,
                   float* tmp, Solve s, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long cells = static_cast<long long>(s.n) * s.n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const float* src = x;
  for (int it = 0; it < iters; ++it) {
    // The last sweep writes `out`; earlier ones alternate back from it.
    float* dst = (iters - 1 - it) % 2 == 0 ? out : tmp;
    const Global f{src, x0, mask, s.n};
    for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         k < cells; k += stride) {
      const int j = static_cast<int>(k / s.n);
      dst[k] = swept(f, s, j, static_cast<int>(k - static_cast<long long>(j) * s.n));
    }
    if (it + 1 < iters) cluster.sync();
    src = dst;
  }
}

// The strips route.  A block loads its strip and the halo rows of the
// start iterate, x0 and the mask from global memory; each sweep computes
// the strip's own rows into the other copy, then a cluster barrier, then the
// block copies the new copy's halo rows from their owners' shared memory
// (distributed shared memory) before the next sweep reads them.  An owner
// writes its copy again two sweeps later, after a barrier that every
// reader of it passes only once its copy is done: one barrier a sweep.
// The last sweep's barrier also keeps every block's shared memory alive
// until its neighbours' last copies from it; then each block stores its own
// rows to `out`.
template <int B, bool SMOOTH, bool MASK>
__global__ void __launch_bounds__(kThreads)
    solve2d_strips_kernel(const float* x, const float* x0, const unsigned char* mask,
                          float* out, SolveAt<B, SMOOTH> s, int iters) {
  extern __shared__ __align__(16) unsigned char fs_strip_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = s.n, blocks = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int rows = strip_rows(n, blocks);
  const int lo = strip_lo(r, n, blocks), hi = strip_lo(r + 1, n, blocks);
  const int padded = (rows + 2 * kHalo) * n;
  float* prev = reinterpret_cast<float*>(fs_strip_smem);
  float* next = prev + padded;
  float* xs = next + padded;
  unsigned char* ms = reinterpret_cast<unsigned char*>(xs + (rows + 2 * kMaskHalo) * n);
  // Rows [first, last) of the grid that a copy holds, and of x0 and the mask.
  const int first = max(lo - kHalo, 0), last = min(hi + kHalo, n);
  const int xfirst = max(lo - kMaskHalo, 0), xlast = min(hi + kMaskHalo, n);
  for (int k = threadIdx.x; k < (last - first) * n; k += kThreads) {
    prev[(first - lo + kHalo) * n + k] = x[static_cast<long long>(first) * n + k];
  }
  for (int k = threadIdx.x; k < (xlast - xfirst) * n; k += kThreads) {
    const long long g = static_cast<long long>(xfirst) * n + k;
    xs[(xfirst - lo + kMaskHalo) * n + k] = x0[g];
    if (MASK) ms[(xfirst - lo + kMaskHalo) * n + k] = mask[g];
  }
  __syncthreads();
  const int cells = (hi - lo) * n;
  // The halo rows: [first, lo) and [hi, last).
  const int below = lo - first, halo = (below + last - hi) * n;
  // This thread's cells k = threadIdx.x + m * kThreads of the strip, at row
  // lo + j0 + m * dj (+ carries), column i0 + m * di (mod n).
  const int j0 = threadIdx.x / n, i0 = threadIdx.x - j0 * n;
  const int dj = kThreads / n, di = kThreads - dj * n;
  for (int it = 0; it < iters; ++it) {
    const Strip<MASK> f{prev, xs, ms, n, lo};
    int j = lo + j0, i = i0;
    for (int k = threadIdx.x; k < cells; k += kThreads) {
      next[kHalo * n + k] = swept(f, s, j, i);
      j += dj;
      i += di;
      if (i >= n) {
        i -= n;
        ++j;
      }
    }
    cluster.sync();
    if (it + 1 < iters) {
      for (int k = threadIdx.x; k < halo; k += kThreads) {
        const int h = k / n, j = h < below ? first + h : hi + h - below;
        const int o = ((j + 1) * blocks - 1) / n;  // the strip that owns row j
        float* mine = next + (j - lo + kHalo) * n + k - h * n;
        *mine = *cluster.map_shared_rank(next + (j - strip_lo(o, n, blocks) + kHalo) * n +
                                             k - h * n,
                                         o);
      }
      __syncthreads();
    }
    float* t = prev;
    prev = next;
    next = t;
  }
  for (int k = threadIdx.x; k < cells; k += kThreads) {
    out[static_cast<long long>(lo) * n + k] = prev[kHalo * n + k];
  }
}

// `syncs` cluster barriers and nothing else: the floor of a K9 launch.
__global__ void __launch_bounds__(kThreads) cluster_barriers_kernel(int syncs) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < syncs; ++i) cluster.sync();
}

// A launch of `kernel` on one cluster of `blocks` blocks of kThreads with
// `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks, size_t smem,
                           cudaStream_t stream, Args... args) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (blocks > kPortableCluster) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(blocks);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// The strips route's kernel for b, the mode and the mask.
template <int B>
cudaError_t launch_strips(const float* x, const float* x0, const unsigned char* mask,
                          float* out, int n, float a, float c, int iters, bool smooth,
                          int blocks, cudaStream_t st) {
  const size_t smem = strip_smem(n, blocks);
  if (smooth) {
    const SolveAt<B, true> s{n, a, c};
    return mask != nullptr ? launch_cluster(solve2d_strips_kernel<B, true, true>, blocks, smem,
                                            st, x, x0, mask, out, s, iters)
                           : launch_cluster(solve2d_strips_kernel<B, true, false>, blocks, smem,
                                            st, x, x0, mask, out, s, iters);
  }
  const SolveAt<B, false> s{n, a, c};
  return mask != nullptr ? launch_cluster(solve2d_strips_kernel<B, false, true>, blocks, smem,
                                          st, x, x0, mask, out, s, iters)
                         : launch_cluster(solve2d_strips_kernel<B, false, false>, blocks, smem,
                                          st, x, x0, mask, out, s, iters);
}

}  // namespace
}  // namespace fsk2d

// x, x0 (n, n) float32 in; mask (n, n) one byte per cell (nonzero = solid) or
// null; out (n, n) out and tmp (n, n) scratch (the L2 route with iters > 1;
// else null); all contiguous, on the current device, and out and tmp
// distinct from x and x0.  b in {0, 1, 2}; smooth != 0 for the smoothing
// solve; blocks (1 to 16; above 8 a non-portable cluster) the cluster's
// size; strips != 0 for the strips route (strip_smem bytes of shared memory
// a block), else the L2 route.  Launches the whole solve on `stream`
// without synchronising and returns the cudaError_t.
extern "C" int fs_solve_2d(const float* x, const float* x0, const unsigned char* mask,
                           float* out, float* tmp, int n, int b, float a, float c, int iters,
                           int smooth, int blocks, int strips, void* stream) {
  using namespace fsk2d;
  if (n < 3 || b < 0 || b > 2 || iters < 1 || blocks < 1 || blocks > kMaxCluster ||
      (!strips && iters > 1 && tmp == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!strips) {
    const Solve s{n, b, a, c, smooth != 0};
    return static_cast<int>(
        launch_cluster(solve2d_kernel, blocks, 0, st, x, x0, mask, out, tmp, s, iters));
  }
  const auto launch = b == 0 ? launch_strips<0> : b == 1 ? launch_strips<1> : launch_strips<2>;
  return static_cast<int>(launch(x, x0, mask, out, n, a, c, iters, smooth != 0, blocks, st));
}

// One launch on a cluster of `blocks` (1 to 16) blocks of 1024 threads that
// runs `syncs` cluster barriers and nothing else, on `stream`: K9's floor.
extern "C" int fs_cluster_barriers(int blocks, int syncs, void* stream) {
  using namespace fsk2d;
  if (blocks < 1 || blocks > kMaxCluster || syncs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_cluster(cluster_barriers_kernel, blocks, 0,
                                         static_cast<cudaStream_t>(stream), syncs));
}
