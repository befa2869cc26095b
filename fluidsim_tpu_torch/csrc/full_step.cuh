// K8's kernel template (see full_step.cu): the whole step of an
// obstacle-free config in one cooperative launch, for a solve type T, a
// storage type S and a window of K cells (kWinAny: FullStepArgs::window >=
// 4, advect.cuh's runtime-K body); without the density phase (DENS
// false) it is K14, the self-advection and the projection in one launch.
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
  int window;
};

// K8 on float32 fields (full_step.cu) and on bfloat16 fields
// (full_step_bf16.cu), for a bfloat16 solve when solve_bf16 and a window of
// K >= 1 (4 and more: a.window): *blocks gets the cooperative grid (every
// block the card holds at once), and with launch the kernel is launched on
// `s` as well.
// blk is K5's block and scratch (blk.block 1: sequential sweeps).
cudaError_t full_step_f32(const FullStepArgs& a, const SolveBlock& blk, int solve_bf16,
                          int window, bool launch, int* blocks, cudaStream_t s);
cudaError_t full_step_bf16(const FullStepArgs& a, const SolveBlock& blk, int solve_bf16,
                           int window, bool launch, int* blocks, cudaStream_t s);
// K14 (float32 fields and solve, no density phase) for a window of K >= 1.
cudaError_t advect_project_f32(const FullStepArgs& a, int window, bool launch, int* blocks,
                               cudaStream_t s);

namespace {

namespace cg = cooperative_groups;

// Blocks per SM the kernel asks the compiler to fit (registers <= 64).
constexpr int kFullStepMinBlocks = 4;

// The buffer that substep `sub` of `n_sub` writes (sub = -1: the input
// `in`, which substep 0 reads).  The last writes `out`; float32 (WIDE): the
// earlier ones alternate back from it through `other`; bfloat16: they write
// float32 into tmp0 and tmp1 in turn.  Each substep's source and target are
// functions of its index.  With the source carried from one substep to the
// next in a Substep (s.src = s.dst after the barrier), the build with
// SolveBlock inside FullStepArgs ran every substep from `in`, whatever the
// grid size or register cap (H100, tools/torch_k8_args_probe.py).
template <bool WIDE>
__device__ __forceinline__ void* substep_buf(int sub, int n_sub, const void* in, void* out,
                                             void* other, float* tmp0, float* tmp1) {
  if (sub < 0) return const_cast<void*>(in);
  if (WIDE) return (n_sub - 1 - sub) % 2 == 0 ? out : other;
  if (sub == n_sub - 1) return out;
  return sub % 2 == 0 ? tmp0 : tmp1;
}

template <typename T, typename S, int K, bool DENS>
__global__ void __launch_bounds__(kThreads, kFullStepMinBlocks)
    full_step_kernel(const FullStepArgs a, const SolveBlock blk) {
  constexpr bool wide = std::is_same<S, float>::value;
  cg::grid_group grid = cg::this_grid();
  const int n = a.n;
  const int vol = n * n * n;
  const int first = static_cast<int>(grid.thread_rank());
  const int stride = static_cast<int>(grid.size());

  // 1. Self-advection: the last substep writes adv.  float32: the earlier
  //    ones alternate back from it through vel_out; bfloat16: they write
  //    float32 into tmp0 and tmp1 in turn.
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep s{substep_buf<wide>(sub - 1, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    a.vel, nullptr, nullptr, nullptr,
                    substep_buf<wide>(sub, a.n_sub, a.vel, a.adv, a.vel_out, a.tmp0, a.tmp1),
                    n, Slab{n, 0}, 1, 2, 3, a.dt0_sub, 1.0f, Buoyancy{}, a.window};
    for (int i = first; i < vol; i += stride) {
      advect_store_role<3, K, false, S>(s, cell_at(n, i), sub == 0, last);
    }
    grid.sync();
  }

  // 2. Divergence and the zero start.
  const S* adv = static_cast<const S*>(a.adv);
  T* rhs = static_cast<T*>(a.rhs);
  for (int i = first; i < vol; i += stride) {
    divergence_cell<T, S>(adv, rhs, static_cast<T*>(a.pa), n, cell_at(n, i));
  }
  grid.sync();

  // 3. The sweeps: K5's blocks of T first where blk asks for them
  //    (sweep_block.cuh, each stage a grid-stride loop), then the sweeps
  //    left over one by one.
  const float inv6 = 1.0f / 6.0f;
  T* src = static_cast<T*>(a.pa);
  T* dst = static_cast<T*>(a.pb);
  int sweeps = a.iters;
  const int tb = blk.block;
  if (tb >= 2) {
    BlockPass<T> bp{nullptr, nullptr, rhs, nullptr, blk, n};
    for (int stage = 0; stage < pre_stages(tb); ++stage) {
      for (int i = first; i < vol; i += stride) pre_stage_item<T, false>(bp, stage, i);
      grid.sync();
    }
    for (int b = 0; b < a.iters / tb; ++b) {
      bp.src = src;
      bp.dst = dst;
      for (int stage = 0; stage < block_stages(tb); ++stage) {
        const long long items = block_stage_items(n, tb, stage);
        for (long long it = first; it < items; it += stride) {
          block_stage_item<T, false>(bp, stage, it);
        }
        grid.sync();
      }
      T* t = src;
      src = dst;
      dst = t;
    }
    sweeps = a.iters % tb;
  }
  for (int it = 0; it < sweeps; ++it) {
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
  if (!DENS) return;
  grid.sync();

  // 5. Density: the last substep writes dens_out.  float32: the earlier ones
  //    alternate back from it through adv's first volume; bfloat16: they
  //    write float32 into tmp0 and tmp1 in turn.
  for (int sub = 0; sub < a.n_sub; ++sub) {
    const bool last = sub == a.n_sub - 1;
    const Substep d{
        substep_buf<wide>(sub - 1, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        a.vel_out, nullptr, nullptr, nullptr,
        substep_buf<wide>(sub, a.n_sub, a.dens, a.dens_out, a.adv, a.tmp0, a.tmp1),
        n, Slab{n, 0}, 0, 0, 0, a.dt0_sub, last ? a.dens_damp : 1.0f, Buoyancy{}, a.window};
    for (int i = first; i < vol; i += stride) {
      advect_store_role<1, K, false, S>(d, cell_at(n, i), sub == 0, last);
    }
    if (!last) grid.sync();
  }
}

template <typename T, typename S, int K, bool DENS = true>
cudaError_t full_step_run(const FullStepArgs& a, const SolveBlock& blk, bool launch,
                          int* blocks, cudaStream_t s) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, full_step_kernel<T, S, K, DENS>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (!launch) return cudaSuccess;
  FullStepArgs args = a;
  SolveBlock block = blk;
  void* params[] = {&args, &block};
  err = cudaLaunchCooperativeKernel((const void*)full_step_kernel<T, S, K, DENS>, dim3(*blocks),
                                    dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// full_step_run for the storage type S and the density phase DENS (false:
// K14), dispatched over the solve type and the window (every window >= 4 to
// the runtime-K instantiation, which reads a.window).  K14 is float32
// throughout, so only its float32 solve is instantiated.
template <typename S, bool DENS = true>
cudaError_t full_step_dispatch(const FullStepArgs& a, const SolveBlock& blk, int solve_bf16,
                               int window, bool launch, int* blocks, cudaStream_t s) {
  using B = typename std::conditional<DENS, __nv_bfloat16, float>::type;
  if (!DENS && solve_bf16) return cudaErrorInvalidValue;
  if (window >= 4) {
    if (a.window != window) return cudaErrorInvalidValue;
    return solve_bf16 ? full_step_run<B, S, kWinAny, DENS>(a, blk, launch, blocks, s)
                      : full_step_run<float, S, kWinAny, DENS>(a, blk, launch, blocks, s);
  }
  switch (window * 2 + (solve_bf16 ? 1 : 0)) {
    case 2: return full_step_run<float, S, 1, DENS>(a, blk, launch, blocks, s);
    case 3: return full_step_run<B, S, 1, DENS>(a, blk, launch, blocks, s);
    case 4: return full_step_run<float, S, 2, DENS>(a, blk, launch, blocks, s);
    case 5: return full_step_run<B, S, 2, DENS>(a, blk, launch, blocks, s);
    case 6: return full_step_run<float, S, 3, DENS>(a, blk, launch, blocks, s);
    case 7: return full_step_run<B, S, 3, DENS>(a, blk, launch, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace fsk
