// K1: K=1 semi-Lagrangian advection of F fields (F = 3: velocity
// self-advection, optionally with buoyancy folded in; F = 1: a scalar), in
// n_sub substeps of dt0/n_sub through the same velocity, optionally with the
// obstacle contract after every substep.
//
// Replaces: fluidsim_tpu/pallas/advect.py::_advect_kernel (entry
// advect_multi_3d_pallas, core _substep_window_vals), k_win = 1, with or
// without the in-kernel obstacle mask, without a folded emitter.
//
// Each substep is one launch, reading the previous substep's fields (the
// input fields for the first) and writing a fresh buffer:
//   without a mask: the interior cells, and every border cell as the signed
//     copy of its interior cell (the set_bnd faces: between substeps and the
//     fresh-zero + faces contract after the last, which are the same thing);
//   with a mask: the same, with every solid interior cell zeroed before the
//     faces read it (ops/advect._mask_and_bnd_3d), then, for velocity codes,
//     a second launch that applies the obstacle mirror in place.
// The launch boundary is the grid-wide barrier a substep needs: every cell
// reads its neighbours' previous-substep values.  Two buffers ping-pong (the
// output and one scratch), so the input velocity is never written.
//
// What bounds it on an H100: each substep reads 27 taps of each field (plus
// 27 density taps for the buoyant y component), and the backtrace, the 13
// two-tap combinations per field and the buoyancy are about 270 float32
// operations per cell for F = 3 (438 with buoyancy), none of them contracted
// into an FMA.  The compulsory DRAM traffic is 7 f32 volumes for bench128's
// buoyant self-advection and 6 volumes + the byte mask for vortex128's, so
// one substep is bound by bytes, three substeps by operations; the taps of
// neighbouring cells overlap, which L1 and L2 serve.
//
// What the design does about it: one thread per cell with x across
// threadIdx.x, so each tap row is one coalesced 128-byte load per warp and
// the overlapping taps of a block hit in L1; the velocity at the cell and its
// backtrace fractions are computed once and shared by all fields; a solid
// cell skips the interpolation.  Keeping the substeps in shared memory (the
// TPU kernel's halo of n_sub*(K+1) planes) is the next step.
#include <cuda_runtime.h>

#include "advect.cuh"

namespace fsk {

template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK>
__global__ void __launch_bounds__(kThreads)
    advect_k1_kernel(const float* __restrict__ fields, const float* __restrict__ vel,
                     const float* __restrict__ dens, const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int n, int b0, int b1, int b2, float dt0,
                     Buoyancy bp) {
  Cell k;
  if (!cell_of_thread(n, k)) return;
  float v[F];
  if (MASK && mask[k.c] != 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = 0.0f;
  } else {
    advect_cell_k1<F, BUOY_VEL, BUOY_TAPS>(fields, vel, dens, bp, n, dt0, k.cz, k.cy,
                                            k.cx, v);
  }
  const long long vol = static_cast<long long>(n) * n * n;
  const int bs[3] = {b0, b1, b2};
#pragma unroll
  for (int c = 0; c < F; ++c) {
    out[c * vol + k.idx] = face_negates(bs[c], k.z, k.y, k.x, k.cz, k.cy, k.cx) ? -v[c] : v[c];
  }
}

struct Substep {
  const float *src, *vel, *dens;
  const uint8_t* mask;
  float* dst;
  int n, b0, b1, b2;
  float dt0;
  Buoyancy bp;
};

template <int F, bool BUOY_VEL, bool BUOY_TAPS, bool MASK>
cudaError_t launch(const Substep& a, cudaStream_t s) {
  advect_k1_kernel<F, BUOY_VEL, BUOY_TAPS, MASK><<<cell_grid(a.n), cell_block(), 0, s>>>(
      a.src, a.vel, a.dens, a.mask, a.dst, a.n, a.b0, a.b1, a.b2, a.dt0, a.bp);
  return cudaGetLastError();
}

// The variants the port runs: buoyancy only in velocity self-advection and
// only without a mask (the step folds it only then).
cudaError_t launch_substep(const Substep& a, int n_fields, bool buoy_vel, bool buoy_taps,
                           cudaStream_t s) {
  const bool masked = a.mask != nullptr;
  if (n_fields == 3 && buoy_vel && !masked) {
    return buoy_taps ? launch<3, true, true, false>(a, s) : launch<3, true, false, false>(a, s);
  }
  if (buoy_vel) return cudaErrorInvalidValue;
  if (n_fields == 3) return masked ? launch<3, false, false, true>(a, s) : launch<3, false, false, false>(a, s);
  if (n_fields == 1) return masked ? launch<1, false, false, true>(a, s) : launch<1, false, false, false>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace fsk

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fields (n_fields, n, n, n), vel (3, n, n, n), dens (n, n, n) or null, mask
// (n, n, n) one byte per cell (nonzero = solid) or null, out like fields, tmp
// like fields (scratch; may be null when n_sub == 1); all float32 apart from
// the mask, contiguous, on the current device.  dt0_sub = f32(dt0 / n_sub)
// with dt0 = f32(dt) * f32(n - 2).  With has_buoy the fields must be the
// velocity and there must be no mask.  Launches on `stream` and returns the
// first cudaError_t.
extern "C" int fs_advect_k1(const float* fields, const float* vel, const float* dens,
                            const unsigned char* mask, float* out, float* tmp, int n,
                            int n_fields, int b0, int b1, int b2, float dt0_sub, int n_sub,
                            int has_buoy, float buoy_dt, float buoyancy, float ambient,
                            float gravity, void* stream) {
  using namespace fsk;
  if (n < 3 || n_sub < 1 || (n_sub > 1 && tmp == nullptr) || (has_buoy && dens == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bs[3] = {b0, b1, b2};
  bool mirror = false;
  for (int c = 0; c < n_fields && c < 3; ++c) {
    mirror = mirror || (mask != nullptr && bs[c] >= 1 && bs[c] <= 3);
  }
  Substep a{fields, vel, dens, mask, nullptr, n, b0, b1, b2, dt0_sub,
            Buoyancy{buoy_dt, buoyancy, ambient, gravity}};
  for (int sub = 0; sub < n_sub; ++sub) {
    // The last substep writes `out`; earlier ones alternate back from it.
    a.dst = (n_sub - 1 - sub) % 2 == 0 ? out : tmp;
    cudaError_t err = launch_substep(a, n_fields, has_buoy != 0, has_buoy != 0 && sub == 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (mirror) {
      mirror_obstacles_kernel<<<cell_grid(n), cell_block(), 0, s>>>(a.dst, mask, n, n_fields,
                                                                    b0, b1, b2);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    a.src = a.dst;
  }
  return static_cast<int>(cudaSuccess);
}
