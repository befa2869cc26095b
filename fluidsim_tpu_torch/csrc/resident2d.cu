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
// 147 KB: x, x0, the mask and the two iterates (17 n^2 bytes) stay in L2; the
// call must move 13 n^2 bytes (x, x0 and the mask in, the result out; 9 n^2
// for a smoothing solve, whose x is x0), and a sweep is ~6 float32
// operations a cell (0.2 MFLOP at 192^2, 3 ns at the card's float32
// peak).  What costs is that every sweep needs the whole
// previous iterate: 20 grid-wide dependencies a solve, 160 a step.  One
// launch per sweep would pay a launch each (~4 us on an H100, K4); a
// cooperative grid barrier costs ~14 us there (K8).
//
// What the design does about it: one launch per solve on one thread-block
// cluster of 8 blocks of 1024 threads (8 SMs), with the cluster's hardware
// barrier between sweeps and the two iterates ping-ponging through global
// memory (L2).  The cluster spreads a sweep's grid-stride passes over 8 SMs:
// on an H100 a 192^2 sweep takes 5.5 us on 8 blocks and 33.5 us on one
// block of the same code (chip_smoke.py times both; the cluster's size is a
// launch argument).  Each cell's post-sweep value is a pure function of the
// previous iterate: an edge recomputes the interior cell it copies, a
// corner the interior cell both its edges copy, an obstacle cell the fluid
// neighbours it mirrors (and an edge neighbour's interior cell, which may be
// the obstacle cell's own pre-mirror value).  So a sweep reads only the
// previous iterate and writes only the next, and one barrier a sweep is
// enough.  The iterates are written by other blocks of the launch, so they
// are read at L2 (ld.global.cg), never through the read-only path; x0 and the
// mask are read-only for the whole launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace fsk2d {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;  // the largest portable cluster

struct Solve {
  const float* x0;
  const unsigned char* mask;  // one byte a cell, nonzero = solid; null: none
  int n, b;
  float a, c;
  bool smooth;
};

// The previous iterate at flat index k (written before the last barrier by
// any block of the cluster, so read at L2).
__device__ __forceinline__ float prev(const float* src, long long k) {
  return __ldcg(src + k);
}

__device__ __forceinline__ bool solid(const Solve& s, long long k) {
  return s.mask != nullptr && __ldg(s.mask + k) != 0;
}

__device__ __forceinline__ float negate_if(bool neg, float v) { return neg ? -v : v; }

// Interior cell (j, i) after steps 1 and 2 (before the mirror).
__device__ float updated(const float* src, const Solve& s, int j, int i) {
  const long long n = s.n, k = j * n + i;
  if (solid(s, k)) return s.smooth ? __ldg(s.x0 + k) : prev(src, k);
  const float nbr =
      ((prev(src, k + 1) + prev(src, k - 1)) + prev(src, k + n)) + prev(src, k - n);
  const float rhs = s.smooth ? prev(src, k) : __ldg(s.x0 + k);
  return (rhs + s.a * nbr) / s.c;
}

// Cell (j, i), not a corner, after the edge writes: an interior cell's update,
// or an edge cell's copy of its interior neighbour.
__device__ float edged(const float* src, const Solve& s, int j, int i) {
  const int n = s.n;
  if (i == 0) return negate_if(s.b == 1, updated(src, s, j, 1));
  if (i == n - 1) return negate_if(s.b == 1, updated(src, s, j, n - 2));
  if (j == 0) return negate_if(s.b == 2, updated(src, s, 1, i));
  if (j == n - 1) return negate_if(s.b == 2, updated(src, s, n - 2, i));
  return updated(src, s, j, i);
}

// Cell (j, i) after the whole sweep.
__device__ float swept(const float* src, const Solve& s, int j, int i) {
  const int n = s.n;
  const bool row_wall = j == 0 || j == n - 1, col_wall = i == 0 || i == n - 1;
  if (row_wall && col_wall) {
    // The row-wall edge next to the corner, then the column-wall edge.
    return 0.5f * (edged(src, s, j, i == 0 ? 1 : n - 2) +
                   edged(src, s, j == 0 ? 1 : n - 2, i));
  }
  if (row_wall || col_wall) return edged(src, s, j, i);
  const long long k = static_cast<long long>(j) * n + i;
  if (s.b == 0 || !solid(s, k)) return updated(src, s, j, i);
  // The obstacle mirror along x (b = 1) or y (b = 2).
  const int dj = s.b == 2 ? 1 : 0, di = s.b == 1 ? 1 : 0;
  const long long step = static_cast<long long>(dj) * n + di;
  const bool lo_fluid = !solid(s, k - step), hi_fluid = !solid(s, k + step);
  const float total = (lo_fluid ? -edged(src, s, j - dj, i - di) : 0.0f) +
                      (hi_fluid ? -edged(src, s, j + dj, i + di) : 0.0f);
  const float count = (lo_fluid ? 1.0f : 0.0f) + (hi_fluid ? 1.0f : 0.0f);
  return count > 0.0f ? total / fmaxf(count, 1.0f) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    solve2d_kernel(const float* x, float* out, float* tmp, Solve s, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  const long long cells = static_cast<long long>(s.n) * s.n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const float* src = x;
  for (int it = 0; it < iters; ++it) {
    // The last sweep writes `out`; earlier ones alternate back from it.
    float* dst = (iters - 1 - it) % 2 == 0 ? out : tmp;
    for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         k < cells; k += stride) {
      const int j = static_cast<int>(k / s.n);
      dst[k] = swept(src, s, j, static_cast<int>(k - static_cast<long long>(j) * s.n));
    }
    if (it + 1 < iters) cluster.sync();
    src = dst;
  }
}

}  // namespace
}  // namespace fsk2d

// x, x0 (n, n) float32 in; mask (n, n) one byte per cell (nonzero = solid) or
// null; out (n, n) out and tmp (n, n) scratch (null when iters == 1); all
// contiguous, on the current device, and out and tmp distinct from x and x0.
// b in {0, 1, 2}; smooth != 0 for the smoothing solve; blocks (1 to 8) the
// cluster's size.  Launches the whole solve on `stream` without
// synchronising and returns the cudaError_t.
extern "C" int fs_solve_2d(const float* x, const float* x0, const unsigned char* mask,
                           float* out, float* tmp, int n, int b, float a, float c, int iters,
                           int smooth, int blocks, void* stream) {
  using namespace fsk2d;
  if (n < 3 || b < 0 || b > 2 || iters < 1 || (iters > 1 && tmp == nullptr) || blocks < 1 ||
      blocks > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Solve s{x0, mask, n, b, a, c, smooth != 0};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(blocks);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, solve2d_kernel, x, out, tmp, s, iters));
}
