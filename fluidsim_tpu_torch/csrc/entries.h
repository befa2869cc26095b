// Entry points that one source calls in another: K2 (project_advect.cu) runs
// K3's projection (project.cu) and then K1's density advection (advect.cu),
// and K1 hands bfloat16 storage to advect_bf16.cu; peer.cu's entries are
// declared here too, so their definitions are checked against them.  All are
// linked into the one library; see each definition for the arguments.
#pragma once

#include <cuda_runtime.h>

#include "sweep_block.cuh"

namespace fsk {
struct SolveTiles;  // solve_tiled.cuh
}  // namespace fsk

extern "C" int fs_project(const void* vel, const unsigned char* mask, void* vel_out, void* p_out,
                          void* p_a, void* p_b, void* rhs, int n, int iters, int solve_bf16,
                          int field_bf16, float damp, const fsk::SolveBlock* blk,
                          const fsk::SolveTiles* tiles, void* stream);

// K7e (project_slab.cu): the divergence and the gradient on one shard's
// planes, the z neighbours' halo planes read in place.
extern "C" int fs_divergence_ext(const float* vel, long long cstride, const float* vz_lo,
                                 const float* vz_hi, float* div, int n, int lz, int wall_lo,
                                 int wall_hi, void* stream);
extern "C" int fs_gradient_ext(const float* vel, long long cstride, const float* p,
                               const float* p_lo, const float* p_hi, float* vel_out, int n,
                               int lz, int wall_lo, int wall_hi, void* stream);

// The mesh's plumbing (peer.cu): peer access from one card to another, the
// device this library's runtime sees as current, and a copy of rows of bytes
// that may cross cards, on a stream.
extern "C" int fs_enable_peer(int device, int peer);
extern "C" int fs_current_device();
extern "C" int fs_copy_rows(void* dst, long long dpitch, const void* src, long long spitch,
                            long long width, int height, void* stream);

extern "C" int fs_advect_k1(const void* fields, const void* vel, const float* dens,
                            const unsigned char* mask, const float* emitter, int src_on,
                            void* out, float* tmp0, float* tmp1, int n, int n_fields, int b0,
                            int b1, int b2, float dt0_sub, int n_sub, int window, int has_buoy,
                            float buoy_dt, float buoyancy, float ambient, float gravity,
                            float scale, int field_bf16, void* stream);

namespace fsk {

struct Substep;

// K1 on bfloat16 fields and velocity (advect_bf16.cu): advect_substeps with
// S = __nv_bfloat16 for any window >= 1 (2 and more: a.window, the
// windowed tiles or the runtime-K body).  out is __nv_bfloat16.
cudaError_t advect_substeps_bf16(const Substep& a, int n_fields, int n_sub, int window,
                                 void* out, float* tmp0, float* tmp1, float scale,
                                 cudaStream_t s);

}  // namespace fsk
