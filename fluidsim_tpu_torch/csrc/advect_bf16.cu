// K1 on bfloat16 storage: advect.cu's kernel with S = __nv_bfloat16, in a
// source of its own so that its instantiations (F = 1 and 3, with and
// without a mask, window 1 and the runtime window K >= 2, four roles:
// bfloat16 or float32 in and out) compile beside the rest.  The folds never
// meet bfloat16 fields (the JAX package's fold_buoy and emitter_foldable need
// float32), so none is instantiated here.
#include <cuda_runtime.h>

#include "advect.cuh"
#include "entries.h"

namespace fsk {

cudaError_t advect_substeps_bf16(const Substep& a, int n_fields, int n_sub, int window,
                                 void* out, float* tmp0, float* tmp1, float scale,
                                 cudaStream_t s) {
  using S = __nv_bfloat16;
  S* o = static_cast<S*>(out);
  if (window == 1) {
    return advect_substeps<1, S>(a, n_fields, n_sub, false, kSrcNone, o, tmp0, tmp1, scale, s);
  }
  if (window < 2 || a.window != window) return cudaErrorInvalidValue;
  return advect_substeps<kWinAny, S>(a, n_fields, n_sub, false, kSrcNone, o, tmp0, tmp1, scale,
                                     s);
}

}  // namespace fsk
