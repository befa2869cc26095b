// K8 on bfloat16 fields: full_step.cuh's kernels with S = __nv_bfloat16 for
// both solve types, windows 1-3 and K >= 4 and both routes, in a source of
// its own so that it compiles beside the float32 instantiations
// (full_step.cu), which hold the entry points.
#include <cuda_runtime.h>

#include "full_step.cuh"

namespace fsk {

cudaError_t full_step_bf16(const FullStepArgs& a, const SolveBlock& blk, const SolveTiles* tiles,
                           int solve_bf16, int window, bool launch, int* blocks, cudaStream_t s) {
  return full_step_dispatch<__nv_bfloat16>(a, blk, tiles, solve_bf16, window, launch, blocks, s);
}

}  // namespace fsk
