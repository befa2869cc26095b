// K8: the whole hot step of an obstacle-free config in one cooperative
// launch, five phases separated by grid-wide barriers:
//   1. velocity self-advection (K1's F = 3 code, b = 1, 2, 3), one barrier
//      per substep;
//   2. divergence, which zeroes the start iterate;
//   3. `iters` Jacobi sweeps, one barrier each;
//   4. gradient + faces + damp;
//   5. density advection through the projected velocity (K1's F = 1 code,
//      b = 0), one barrier between substeps, the last times dens_damp.
// Returns (vel', p as the float32 upcast of the final iterate, density'),
// bitwise K1 (self-advection) followed by K2: every phase calls the same
// per-cell device code as those kernels (advect.cuh, project.cuh).
//
// Replaces: fluidsim_tpu/pallas/resident.py::_full_step_kernel (entry
// full_step_3d_resident), without sweep blocking.  The TPU kernel is one
// grid-less program whose phases run in order; here the phases run on every
// block of a grid that is exactly as large as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, launched with
// cudaLaunchCooperativeKernel), each a grid-stride loop over the cells, and
// cooperative_groups' grid barrier takes the place of the launch boundary
// that separates K1's substeps and K2's phases and sweeps.
//
// What bounds it on an H100: as K2, the sweeps, each a pass over an L2
// resident working set (12.6 MB at 128^3 with bfloat16 solve buffers); the
// compulsory DRAM traffic (velocity and density in; velocity, pressure and
// density out) is 9 volumes.  bench128 takes 63 barriers in one launch
// where K1 + K2 take 64 launches: the barrier's cost against a launch's is
// what this kernel measures.
//
// What the design does about it: nothing yet beyond the one launch.  No
// thread returns before a barrier (every loop runs over the whole grid's
// cells); the buffers that a phase writes and a later phase reads are plain
// pointers, so no read goes through the read-only cache.  The self-advected
// velocity lives in `adv`; vel_out serves as the other buffer of the
// self-advection's substeps and adv's first volume as the density's, so
// the scratch is one velocity volume.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "advect.cuh"
#include "project.cuh"

namespace cg = cooperative_groups;

namespace fsk {
namespace {

// Blocks per SM the kernel asks the compiler to fit (registers <= 64).
constexpr int kFullStepMinBlocks = 4;

template <typename T>
struct FullStep {
  const float* vel;   // (3, n, n, n) in
  const float* dens;  // (n, n, n) in
  float* adv;         // (3, n, n, n) scratch
  float* vel_out;     // (3, n, n, n) out
  float* p_out;       // (n, n, n) out
  float* dens_out;    // (n, n, n) out
  T *pa, *pb, *rhs;   // (n, n, n) solve scratch in the solve dtype
  int n, iters, n_sub;
  float dt0_sub, damp, dens_damp;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kFullStepMinBlocks)
    full_step_kernel(const FullStep<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int vol = n * n * n;
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection: the last substep writes adv, the earlier ones
  //    alternate back from it through vel_out.
  Substep s{a.vel, a.vel, nullptr, nullptr, nullptr, nullptr, n, 1, 2, 3, a.dt0_sub, 1.0f,
            Buoyancy{}};
  for (int sub = 0; sub < a.n_sub; ++sub) {
    s.dst = (a.n_sub - 1 - sub) % 2 == 0 ? a.adv : a.vel_out;
    for (int i = first; i < vol; i += stride) {
      advect_store<3, false, false, false, kSrcNone>(s, cell_at(n, i));
    }
    grid.sync();
    s.src = s.dst;
  }

  // 2. Divergence and the zero start.
  for (int i = first; i < vol; i += stride) divergence_cell<T>(a.adv, a.rhs, a.pa, n, cell_at(n, i));
  grid.sync();

  // 3. The sweeps.
  const float inv6 = 1.0f / 6.0f;
  T* src = a.pa;
  T* dst = a.pb;
  for (int it = 0; it < a.iters; ++it) {
    for (int i = first; i < vol; i += stride) {
      sweep_cell<T, false>(src, a.rhs, nullptr, dst, n, inv6, cell_at(n, i));
    }
    grid.sync();
    T* t = src;
    src = dst;
    dst = t;
  }

  // 4. Gradient, faces, damp.
  for (int i = first; i < vol; i += stride) {
    gradient_cell<T, false>(a.adv, src, nullptr, a.vel_out, a.p_out, n, a.damp, cell_at(n, i));
  }
  grid.sync();

  // 5. Density: the last substep writes dens_out, the earlier ones
  //    alternate back from it through adv's first volume.
  Substep d{a.dens, a.vel_out, nullptr, nullptr, nullptr, nullptr, n, 0, 0, 0, a.dt0_sub, 1.0f,
            Buoyancy{}};
  for (int sub = 0; sub < a.n_sub; ++sub) {
    d.dst = (a.n_sub - 1 - sub) % 2 == 0 ? a.dens_out : a.adv;
    d.scale = sub == a.n_sub - 1 ? a.dens_damp : 1.0f;
    for (int i = first; i < vol; i += stride) {
      advect_store<1, false, false, false, kSrcNone>(d, cell_at(n, i));
    }
    if (sub + 1 < a.n_sub) grid.sync();
    d.src = d.dst;
  }
}

// The cooperative grid: every block the card holds at once.
template <typename T>
cudaError_t full_step_grid(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, full_step_kernel<T>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_full_step(FullStep<T> a, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = full_step_grid<T>(&blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)full_step_kernel<T>,
                                    dim3(blocks), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsk

// The number of blocks fs_full_step launches for the solve dtype (bfloat16
// when solve_bf16, else float32) on the current device, or minus the
// cudaError_t that prevents the launch.
extern "C" int fs_full_step_blocks(int solve_bf16) {
  using namespace fsk;
  int blocks = 0;
  const cudaError_t err = solve_bf16 ? full_step_grid<__nv_bfloat16>(&blocks)
                                     : full_step_grid<float>(&blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// vel (3, n, n, n) and dens (n, n, n) in; adv (3, n, n, n) scratch; vel_out
// (3, n, n, n), p_out (n, n, n) and dens_out (n, n, n) out; all float32.
// p_a, p_b and rhs are (n, n, n) scratch in the solve dtype (bfloat16 when
// solve_bf16, else float32).  dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) *
// f32(n - 2).  All contiguous on the current device; n <= 1024.  Launches
// on `stream` without synchronising and returns the first cudaError_t (a
// grid the card cannot hold at once is cudaErrorCooperativeLaunchTooLarge).
extern "C" int fs_full_step(const float* vel, const float* dens, float* adv, float* vel_out,
                            float* p_out, float* dens_out, void* p_a, void* p_b, void* rhs,
                            int n, int iters, int solve_bf16, float dt0_sub, int n_sub,
                            float damp, float dens_damp, void* stream) {
  using namespace fsk;
  if (n < 3 || n > 1024 || iters < 1 || n_sub < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_solve_dtype(solve_bf16, p_a, p_b, rhs, [&](auto* pa, auto* pb,
                                                                           auto* r) {
    using T = std::remove_pointer_t<decltype(pa)>;
    return launch_full_step<T>(FullStep<T>{vel, dens, adv, vel_out, p_out, dens_out, pa, pb, r, n,
                                           iters, n_sub, dt0_sub, damp, dens_damp},
                               s);
  }));
}
