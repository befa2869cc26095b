// K1: semi-Lagrangian advection of F fields (F = 3: velocity
// self-advection, optionally with buoyancy folded in and the folded emitter
// on the buoyancy's density; F = 1: a scalar, optionally with the emitter on
// the field, K2's density phase) with the backtrace clamped to a window of
// K >= 1 cells, in n_sub substeps of dt0/n_sub through the same
// velocity, optionally with the obstacle contract after every substep, on
// float32 or (without the folds) bfloat16 storage.
//
// Replaces: fluidsim_tpu/pallas/advect.py::_advect_kernel (entry
// advect_multi_3d_pallas, core _substep_window_vals: windowed_sum_k1 for
// k_win = 1, windowed_sum for k_win > 1), with or without the in-kernel
// obstacle mask, with or without the folded emitter (`src`, which rides the
// buoyancy's density reads: advect.py:415-428), float32 or bfloat16 storage
// (the TPU kernel loads its windows in the field dtype and computes in
// float32: advect.py:392-398, 453).  For n_sub = 1 with a mask the TPU entry
// applies the output contract on the host (advect.py:728-741); this kernel
// applies the same contract in the launch.
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
// reads its neighbours' previous-substep values.  The input is never written
// (advect.cuh's advect_substeps, which K2's density phase shares).  On
// bfloat16 storage the substeps between the first read and the last write
// are float32, as the TPU kernel keeps them in VMEM, and a velocity's mirror
// runs on the float32 result before the one rounding (advect_bf16.cu).
//
// What bounds it on an H100, K = 1: each cell interpolates 27 taps of each
// field; the backtrace and the 13 two-tap combinations per field are about
// 270 float32 operations per cell for F = 3, none of them contracted into an
// FMA, and the buoyancy 6 more per staged value and at the cell.  The
// compulsory DRAM traffic is 7 f32 volumes for bench128's buoyant
// self-advection and 6 volumes + the byte mask for vortex128's, so one
// substep is bound by bytes, three substeps by operations.  bfloat16 storage
// halves the bytes and leaves the operations.  The folded emitter adds a
// distance, a square root and a division per density value inside the
// ball's box (and three compares outside it) in place of a full-grid pass
// over the density.  K > 1: the hat sum has (2K+1)^3 taps a field (343 at
// plume64's K = 3), but after the clamp only 8 carry weight: the backtrace,
// six hats, 12 weight products and a multiply and an add a tap and field,
// so a substep is bound by bytes, as at K = 1.
//
// What the design does about it.  K = 1 (advect_tiled.cuh): a block stages a
// tile's planes in shared memory once, each value with the buoyancy and the
// emitter already applied (advect_cell_k1 applied them at each of 27 taps),
// marches along z loading each plane once and one plane ahead, and a thread
// computes four cells of a column from six staged rows.  K > 1
// (advect_window.cuh): the same march with the tile widened by K and a ring
// of 2K + 2 planes, each plane's publishing barrier a vote on whether every
// staged value is finite; a cell sums the 8 taps with weight where its 2K + 1
// planes are finite and its displacement is not NaN (bitwise the hat sum:
// advect.cuh), else every tap, from shared memory.  Where the ring does not
// fit the card's shared memory (F = 3 above K = 6, F = 1 above K = 11 on an
// H100) one thread computes a cell's whole hat sum from global memory.
// Keeping the substeps in shared memory (the TPU kernel's halo of
// n_sub*(K+1) planes) is the next step.
#include <cuda_runtime.h>

#include "advect.cuh"
#include "entries.h"

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fields (n_fields, n, n, n) and vel (3, n, n, n) in the storage type
// (bfloat16 when field_bf16, else float32); dens (n, n, n) float32 or null;
// mask (n, n, n) one byte per cell (nonzero = solid) or null; emitter (5,)
// float32 or null, added to the buoyancy's density (src_on = 1, needs
// has_buoy) or to the F = 1 field's first reads (src_on = 2); out like
// fields; tmp0 and tmp1 (n_fields, n, n, n) float32 scratch (advect_substeps
// says when each may be null); all contiguous on the current device.
// dt0_sub = f32(dt0 / n_sub) with dt0 = f32(dt) * f32(n - 2); window >= 1
// (n >= 2 * window + 1; 2 and more take advect_window.cuh's tiles, or the
// runtime-K body where their ring does not fit).  With has_buoy the fields
// must be the velocity and there must be no mask; the folds take float32
// only.  `scale` multiplies the last substep's output in the storage type.
// Launches on `stream` and returns the first cudaError_t.
extern "C" int fs_advect_k1(const void* fields, const void* vel, const float* dens,
                            const unsigned char* mask, const float* emitter, int src_on,
                            void* out, float* tmp0, float* tmp1, int n, int n_fields, int b0,
                            int b1, int b2, float dt0_sub, int n_sub, int window, int has_buoy,
                            float buoy_dt, float buoyancy, float ambient, float gravity,
                            float scale, int field_bf16, void* stream) {
  using namespace fsk;
  const int src = emitter == nullptr ? kSrcNone : src_on;
  // A window of K reads taps K cells away, wrapped: the grid must hold 2K + 1.
  if (window < 1 || n < 2 * window + 1 || (has_buoy && dens == nullptr) ||
      (emitter != nullptr && src_on != kSrcDensity && src_on != kSrcFields) ||
      (src == kSrcDensity && !has_buoy) || (field_bf16 && (has_buoy || src != kSrcNone))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Substep a{fields, vel, dens, mask, emitter, nullptr, n, Slab{n, 0}, b0, b1, b2, dt0_sub,
                  1.0f, Buoyancy{buoy_dt, buoyancy, ambient, gravity}, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (field_bf16) {
    return static_cast<int>(
        advect_substeps_bf16(a, n_fields, n_sub, window, out, tmp0, tmp1, scale, s));
  }
  const bool buoy = has_buoy != 0;
  float* o = static_cast<float*>(out);
  if (window == 1) {
    return static_cast<int>(advect_substeps<1, float>(a, n_fields, n_sub, buoy, src, o, tmp0,
                                                      tmp1, scale, s));
  }
  return static_cast<int>(advect_substeps<kWinAny, float>(a, n_fields, n_sub, buoy, src, o,
                                                          tmp0, tmp1, scale, s));
}
