// K6: the temporally blocked Jacobi solve of a general (b, x, x0, a, c):
// `iters` sweeps  x <- (x0 + a*nbr) * inv_c  on the interior cells, with
// nbr = ((x+ + x-) + (y+ + y-)) + (z+ + z-) and inv_c = f32(1)/f32(c), then
// the set_bnd_3d(b) faces once.  Each sweep uses corrected neighbour reads:
// an interior cell next to a wall reads s*itself (s = -1 across the wall
// normal to field code b, else +1), which is the value set_bnd would have
// written there, so no wall face in device memory is written between
// sweeps.  The faces of the input are never read, which makes the TPU
// kernel's normalising set_bnd_3d(b, x) on the input implicit.
//
// Replaces: fluidsim_tpu/pallas/jacobi.py::_jacobi_kernel (entry
// jacobi_3d_pallas), the slab route the JAX package takes when three volumes
// do not fit on chip.  The TPU kernel's z-slabs and y-tiles (_pick_block,
// pick_blocking, tile_geometry) are not carried over.
//
// What bounds it on an H100: bytes.  One sweep over a 256^3 float32 grid
// streams the iterate, x0 and the next iterate, 201 MB, which does not fit
// the 50 MB L2, so a sweep per launch costs at least 60 us from HBM.  The
// solve's compulsory traffic is x and x0 in and the result out, once.
//
// What the design does about it: each launch runs up to T = kBlockIters
// sweeps out of shared memory, streaming the grid along z.  A block owns a
// (32-2T) x (32-2T) tile of x-y columns and a z-range of 64 planes; it
// reads a 32 x 32 window (the tile plus a T-deep halo) of x and x0 one
// plane at a time, from T planes below its range to T planes above, and
// keeps four planes of every intermediate sweep level in shared memory.
// When plane z arrives, level t computes its plane z-2t from level t-1's
// planes z-2t-1 .. z-2t+1, all written in earlier steps, so the T levels
// advance as a wavefront two planes behind each other and a step needs one
// barrier: each thread has T independent updates between barriers.  Level
// T's planes inside the tile are written out.  After t sweeps only the
// cells at least t from a window edge are valid (a global wall closes the
// stencil and invalidates nothing), so level t computes only those; the
// tile, T from every edge, is valid at level T.  The loads of the next two
// planes are in flight while a step sweeps.  ceil(iters/T) launches chain
// through two global buffers; a last, partial pass runs the remaining
// sweeps; a last launch writes the faces.
//
// The corrected reads cost no instructions in x and y: a thread whose
// column lies on an x or y wall loads and updates its clamped interior
// column's cell and stores it with the wall's sign, so the wall columns
// of every level hold exactly what the corrected reads would give and
// interior cells read their neighbours plainly (boundary.cuh's signed
// copy).  In z the test is uniform across the block.  The steps are
// unrolled by eight, so every ring slot is a constant offset; x0's ring
// holds eight planes, which allows T <= 3, and T = 3 is used.  HBM
// traffic per pass is x and x0 over windows (32/(32-2T))^2 the tile in x-y
// and (64+2T)/64 the range in z, and the result once: at T = 3 about 4.3
// volumes per three sweeps instead of 3 per sweep.  T = 3 takes 20 planes
// (80 KB) of shared memory, so two blocks of 1024 threads run on each SM.
// It is still bound by instruction issue rather than bytes (about 30
// instructions per cell update by a count of the source, for 8
// operations); keeping each column's z neighbours in registers is the
// next step.
#include <cuda_runtime.h>

#include "jacobi_pass.cuh"

// x, x0, out and tmp (n, n, n) float32 (tmp is scratch), all contiguous on
// the current device, out and tmp distinct from x and x0.  b in 0..3 is the
// field's set_bnd code, a and inv_c = f32(1)/f32(c) the solve's
// coefficients, iters >= 1.  Launches every pass of up to kBlockIters sweeps
// (jacobi_pass.cuh) and the faces on `stream` and returns the first
// cudaError_t.
extern "C" int fs_jacobi(const float* x, const float* x0, float* out, float* tmp, int n, int b,
                         float a, float inv_c, int iters, void* stream) {
  using namespace fsk;
  if (n < 3 || b < 0 || b > 3 || iters < 1 || tmp == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pass q{x, x0, nullptr, nullptr, n, n, b, a, inv_c, kBlockIters, kChunkZ, 0, n - 1};
  const cudaError_t err = run_passes<false>(q, out, tmp, iters, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_faces(out, n, n, b, 0, n - 1, s));
}
