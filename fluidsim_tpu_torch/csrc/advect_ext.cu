// K11: the windowed semi-Lagrangian advection of F fields on one shard's
// halo-extended z-slab, the per-shard compute of the explicit halo-exchange
// sharded step (parallel/halo.advect_multi_3d_sharded).  The slab is
// (F, nz, n, n) with nz = lz + 2h, h = window * n_sub (n_sub * (window + 1)
// with a mask): the shard's lz planes between h planes of each neighbour's
// edge; its plane 0 is global plane zoff = rank * lz - h.  It is K1's
// substep advection (advect.cuh) on that slab: the backtrace, its clamp to
// [0.5, n - 1.5] and the window clamp in global z; between substeps and after
// the last, the set_bnd faces with the global z faces at slab planes -zoff and
// n - 1 - zoff (only a plane at a global z wall is a border plane, never the
// slab's open ends); with a mask the solid cells zeroed before the faces and,
// for velocity codes, the obstacle mirror after them, every substep.  Taps
// and mirror neighbours past the slab's ends are read at wrapped planes: they
// lie in the h-plane margin that each substep erodes and the caller drops,
// so only planes [h, h + lz) are the global computation's.
//
// Replaces: fluidsim_tpu/pallas/halo_kernel.py::_ext_advect_kernel (entry
// advect_ext_pallas, core pallas/advect.py::_substep_window_vals with
// start = zoff + the window's start), with or without the int8 mask.  The
// TPU kernel's windows roll inside VMEM, so its edge planes read other
// garbage; its z-windows and y-tiles (_pick_ext_advect, tile_geometry,
// window_origin) are not carried over.
//
// What bounds it on an H100: as K1, per slab: F + 3 volumes of nz planes in
// and F out a substep's worth of bytes (the substeps between pass through the
// scratch), and about 270 float32 operations a cell for F = 3 at K = 1, so a
// two-substep call is bound by operations.
//
// What the design does about it: K1's kernels, unchanged but for the slab
// (boundary.cuh's Slab): at K = 1 the tiled kernel of advect_tiled.cuh (the
// slab's planes staged once, taps past its ends read at wrapped planes), at
// K > 1 the windowed tiles of advect_window.cuh (z wrapped modulo the slab)
// where they fit, else one thread per cell; one launch per substep (and one
// per mirror), float32 ping-pong through out and tmp0 so that self-advection
// never writes the buffer it reads.
//
// bfloat16 slabs take K1's bfloat16 instantiations (advect_bf16.cu), which
// carry the slab as every K1 body does: the first substep loads bfloat16,
// the substeps run in float32 through tmp0 and tmp1, and the last (or, with
// a velocity's mirror, one more launch) rounds once, as the TPU kernel loads
// its windows to float32 and casts at the store (its face writes after the
// store are sign copies, exact in bfloat16).
#include <cuda_runtime.h>

#include "advect.cuh"
#include "entries.h"

// fields (n_fields, nz, n, n) and vel (3, nz, n, n) float32, or both bfloat16
// when field_bf16 (fields may be vel, for self-advection); mask (nz, n, n) one
// byte a cell (nonzero = solid) or null; out like fields, distinct from both;
// tmp0 and tmp1 float32 (n_fields, nz, n, n) scratch: float32 needs tmp0 when
// n_sub > 1, bfloat16 tmp0 and tmp1 for the float32 results before the
// rounding one (advect_substeps), null when unused; all contiguous on the
// current device.  n is the global grid size, zoff the global z of slab
// plane 0, b0..b2 the fields' set_bnd codes, dt0_sub = f32(dt0 / n_sub) with
// dt0 = f32(dt) * f32(n - 2), window >= 1 (n and nz >= 2 * window + 1; 2 and
// more take advect_window.cuh's tiles, or the runtime-K body).
// Launches on `stream` and returns the first cudaError_t.
extern "C" int fs_advect_ext(const void* fields, const void* vel, const unsigned char* mask,
                             void* out, float* tmp0, float* tmp1, int n, int nz, int zoff,
                             int n_fields, int b0, int b1, int b2, float dt0_sub, int n_sub,
                             int window, int field_bf16, void* stream) {
  using namespace fsk;
  if (window < 1 || n < 2 * window + 1 || nz < 2 * window + 1 || n_sub < 1 ||
      (n_fields != 1 && n_fields != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Substep a{fields, vel, nullptr, mask, nullptr, nullptr, n, Slab{nz, zoff}, b0, b1, b2,
                  dt0_sub, 1.0f, Buoyancy{}, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (field_bf16) {
    return static_cast<int>(advect_substeps_bf16(a, n_fields, n_sub, window, out, tmp0, tmp1,
                                                 1.0f, s));
  }
  float* const o = static_cast<float*>(out);
  if (window == 1) {
    return static_cast<int>(advect_substeps<1, float>(a, n_fields, n_sub, false, kSrcNone, o,
                                                      tmp0, nullptr, 1.0f, s));
  }
  return static_cast<int>(advect_substeps<kWinAny, float>(a, n_fields, n_sub, false, kSrcNone, o,
                                                          tmp0, nullptr, 1.0f, s));
}
