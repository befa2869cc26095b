// K3: the pressure projection on its own (no density phase), with or
// without an obstacle mask: divergence, `iters` Jacobi sweeps, gradient with
// faces, the obstacle mirror, damp (project.cuh).  Returns (vel', p as the
// final iterate in the storage type).  Without a mask it computes exactly
// K2's first three phases, which K2 runs through this entry.
//
// Replaces: fluidsim_tpu/pallas/resident.py::_project_kernel (no mask) and
// ::_project_obst_kernel (mask), entry project_3d_resident, body
// _project_body, on float32 or bfloat16 fields; with blk (T >= 2, float32
// fields) the solve is K5's (sweep_block.cuh), on the tiles where a tiling
// is given (solve_tiled.cuh: block_tile).
//
// What bounds it on an H100: the sweeps, 20 of them in vortex128, 60 in
// bench128 unfused.  Where kernels/resident.solve_tiles finds a tiling (up
// to 128^3, with or without the mask), the divergence and every sweep are
// one persistent launch (solve_tiled.cuh) bound by shared-memory bandwidth
// and the wait for the face neighbours; elsewhere each sweep is a launch
// that reads the iterate (six neighbours), the rhs and the mask byte from
// L2 and writes the next iterate (14.7 MB at 128^3 in bfloat16, inside the
// 50 MB L2), bound by L2 bandwidth and the launch.  The compulsory DRAM
// traffic of the call (velocity and mask in, velocity and pressure out:
// 60.8 MB at 128^3, half of it for bfloat16 fields) is the floor; the
// arithmetic (about 160 float32 operations per cell) is not.
//
// What the design does about it: the tiled solve keeps each tile of the
// iterate, its rhs and its solid bits on one SM for all sweeps and trades
// only its faces with its neighbours; the per-sweep route is one thread per
// cell with x across threadIdx.x.  The mask folds into the sweep's
// coefficient.  The gradient and the mirror stay a launch each (the mirror
// writes only the solid interior cells).
#include <cuda_runtime.h>

#include "entries.h"
#include "project.cuh"

// vel (3, n, n, n) in; vel_out (3, n, n, n) and p_out (n, n, n) out; all in
// the storage type (bfloat16 when field_bf16, else float32).  mask (n, n, n)
// one byte per cell (nonzero = solid) or null.  p_a, p_b and rhs are (n, n,
// n) scratch in the solve type (bfloat16 when solve_bf16, else float32).
// damp is a value of the storage type.  blk is null (sequential sweeps) or
// K5's block and scratch (sweep_block.cuh; float32 fields, T = 2 or n >= 4T,
// iters >= T).  tiles is null (the per-sweep or per-stage launches) or the
// tiled solve's tiling and scratch (solve_tiled.cuh; with blk, K5's tile
// program: faces of float32 slots, rhs its scratch, blk's chain volumes
// unused).  All contiguous on the
// current device.  Launches every phase on `stream` without synchronising
// and returns the first cudaError_t (cudaErrorInvalidValue for a tiling the
// tiled solve cannot take).
extern "C" int fs_project(const void* vel, const unsigned char* mask, void* vel_out, void* p_out,
                          void* p_a, void* p_b, void* rhs, int n, int iters, int solve_bf16,
                          int field_bf16, float damp, const fsk::SolveBlock* blk,
                          const fsk::SolveTiles* tiles, void* stream) {
  using namespace fsk;
  if (n < 3 || iters < 1 || !block_valid(blk, n, iters, field_bf16, tiles != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_dtypes(solve_bf16, field_bf16, [&](auto* t, auto* f) {
    using T = std::remove_pointer_t<decltype(t)>;
    using S = std::remove_pointer_t<decltype(f)>;
    return project_phases<T, S>(static_cast<const S*>(vel), mask, static_cast<S*>(vel_out),
                                static_cast<S*>(p_out), static_cast<T*>(p_a),
                                static_cast<T*>(p_b), static_cast<T*>(rhs), n, iters, damp, blk, tiles,
                                s);
  }));
}

// The shared memory a block may opt in to on the current device (the tiled
// solve's limit), or minus the cudaError_t of the query.
extern "C" int fs_smem_optin() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err == cudaSuccess ? optin : -static_cast<int>(err);
}
