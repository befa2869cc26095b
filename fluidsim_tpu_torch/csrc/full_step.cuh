// K8's kernel template (see full_step.cu): the whole step of an
// obstacle-free config in one cooperative launch, for a solve type T, a
// storage type S and a window of K cells.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "advect.cuh"
#include "project.cuh"

namespace fsk {

struct FullStepArgs {
  const void* vel;   // (3, n, n, n) in, S
  const void* dens;  // (n, n, n) in, S
  void* adv;         // (3, n, n, n) scratch, S
  void* vel_out;     // (3, n, n, n) out, S
  void* p_out;       // (n, n, n) out, S
  void* dens_out;    // (n, n, n) out, S
  void *pa, *pb, *rhs;  // (n, n, n) solve scratch, T
  float *tmp0, *tmp1;   // (3, n, n, n) float32 scratch (bfloat16 fields only)
  int n, iters, n_sub;
  float dt0_sub, damp, dens_damp;
};

// K8 on float32 fields (full_step.cu) and on bfloat16 fields
// (full_step_bf16.cu), for a bfloat16 solve when solve_bf16 and a window of 1,
// 2 or 3: *blocks gets the cooperative grid (every block the card holds at
// once), and with launch the kernel is launched on `s` as well.
cudaError_t full_step_f32(const FullStepArgs& a, int solve_bf16, int window, bool launch,
                          int* blocks, cudaStream_t s);
cudaError_t full_step_bf16(const FullStepArgs& a, int solve_bf16, int window, bool launch,
                           int* blocks, cudaStream_t s);

namespace {

namespace cg = cooperative_groups;

// Blocks per SM the kernel asks the compiler to fit (registers <= 64).
constexpr int kFullStepMinBlocks = 4;

template <typename T, typename S, int K>
__global__ void __launch_bounds__(kThreads, kFullStepMinBlocks)
    full_step_kernel(const FullStepArgs a) {
  constexpr bool wide = std::is_same<S, float>::value;
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int vol = n * n * n;
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection: the last substep writes adv.  float32: the earlier
  //    ones alternate back from it through vel_out; bfloat16: they write
  //    float32 into tmp0 and tmp1 in turn.
  Substep s{a.vel, a.vel, nullptr, nullptr, nullptr, nullptr, n, 1, 2, 3, a.dt0_sub, 1.0f,
            Buoyancy{}};
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    if (wide) {
      s.dst = (a.n_sub - 1 - sub) % 2 == 0 ? a.adv : a.vel_out;
    } else {
      s.dst = last ? a.adv : static_cast<void*>(sub % 2 == 0 ? a.tmp0 : a.tmp1);
    }
    for (int i = first; i < vol; i += stride) {
      advect_store_role<3, K, false, S>(s, cell_at(n, i), sub == 0, last);
    }
    grid.sync();
    s.src = s.dst;
  }

  // 2. Divergence and the zero start.
  const S* adv = static_cast<const S*>(a.adv);
  T* rhs = static_cast<T*>(a.rhs);
  for (int i = first; i < vol; i += stride) {
    divergence_cell<T, S>(adv, rhs, static_cast<T*>(a.pa), n, cell_at(n, i));
  }
  grid.sync();

  // 3. The sweeps.
  const float inv6 = 1.0f / 6.0f;
  T* src = static_cast<T*>(a.pa);
  T* dst = static_cast<T*>(a.pb);
  for (int it = 0; it < a.iters; ++it) {
    for (int i = first; i < vol; i += stride) {
      sweep_cell<T, false>(src, rhs, nullptr, dst, n, inv6, cell_at(n, i));
    }
    grid.sync();
    T* t = src;
    src = dst;
    dst = t;
  }

  // 4. Gradient, faces, damp.
  for (int i = first; i < vol; i += stride) {
    gradient_cell<T, S, false>(adv, src, nullptr, static_cast<S*>(a.vel_out),
                               static_cast<S*>(a.p_out), n, a.damp, cell_at(n, i));
  }
  grid.sync();

  // 5. Density: the last substep writes dens_out.  float32: the earlier ones
  //    alternate back from it through adv's first volume; bfloat16: they
  //    write float32 into tmp0 and tmp1 in turn.
  Substep d{a.dens, a.vel_out, nullptr, nullptr, nullptr, nullptr, n, 0, 0, 0, a.dt0_sub, 1.0f,
            Buoyancy{}};
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    if (wide) {
      d.dst = (a.n_sub - 1 - sub) % 2 == 0 ? a.dens_out : a.adv;
    } else {
      d.dst = last ? a.dens_out : static_cast<void*>(sub % 2 == 0 ? a.tmp0 : a.tmp1);
    }
    d.scale = last ? a.dens_damp : 1.0f;
    for (int i = first; i < vol; i += stride) {
      advect_store_role<1, K, false, S>(d, cell_at(n, i), sub == 0, last);
    }
    if (sub + 1 < a.n_sub) grid.sync();
    d.src = d.dst;
  }
}

template <typename T, typename S, int K>
cudaError_t full_step_run(const FullStepArgs& a, bool launch, int* blocks,
                               cudaStream_t s) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, full_step_kernel<T, S, K>,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (!launch) return cudaSuccess;
  FullStepArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)full_step_kernel<T, S, K>, dim3(*blocks),
                                    dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// full_step_run for the storage type S, dispatched over the solve type and
// the window.
template <typename S>
cudaError_t full_step_dispatch(const FullStepArgs& a, int solve_bf16, int window, bool launch,
                               int* blocks, cudaStream_t s) {
  using B = __nv_bfloat16;
  switch (window * 2 + (solve_bf16 ? 1 : 0)) {
    case 2: return full_step_run<float, S, 1>(a, launch, blocks, s);
    case 3: return full_step_run<B, S, 1>(a, launch, blocks, s);
    case 4: return full_step_run<float, S, 2>(a, launch, blocks, s);
    case 5: return full_step_run<B, S, 2>(a, launch, blocks, s);
    case 6: return full_step_run<float, S, 3>(a, launch, blocks, s);
    case 7: return full_step_run<B, S, 3>(a, launch, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace fsk
