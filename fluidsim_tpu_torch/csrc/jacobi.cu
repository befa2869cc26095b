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
// solve's compulsory traffic is x and x0 in and the result out, once.  Next
// to bytes, a pass spends shared-memory accesses: five loads and a store a
// cell update.
//
// What the design does about it: each launch runs up to four sweeps out of
// shared memory and registers, streaming the grid along z
// (jacobi_pass.cuh): a block of 1024 threads (one an SM) owns a 56 x
// (48 - 2T) tile of x-y columns and a z-range (the grid cut into as many as
// fill the card: one at 512^3, three at 256^3), and reads a 64 x 48 window
// of x and x0 one plane at a time, copied up to five planes ahead with
// cp.async.  When plane z arrives, level t updates plane z - t: its z
// neighbours are in the thread's registers, its x and y neighbours in one
// shared plane a level (double-buffered, one barrier a step).  After t
// sweeps only the cells at least t from a window edge are valid (a global
// wall closes the stencil and invalidates nothing); the tile, T from every
// edge, is valid at level T.  ceil(iters/4) launches chain through two
// global buffers, the sweeps spread evenly over them (20 sweeps: five
// launches of four); the last launch stores the faces with the result, so
// no launch writes them alone.  HBM traffic per pass is x and x0 over
// windows 64 x 48 / (56 x (48 - 2T)) the tile (1.37 at T = 4) and the
// z-range's 2T extra planes, and the result once.
//
// The corrected reads cost no instructions in x and y: a thread whose
// column lies on an x or y wall updates its clamped interior column's cell
// and keeps it with the wall's sign, so the wall columns of every level hold
// exactly what the corrected reads would give and interior cells read their
// neighbours plainly (boundary.cuh's signed copy).  In z the test is
// uniform across the block.  The sweep covers every plane (nz = n, the z
// walls at 0 and n - 1, zeros past them): the wall planes' updates are never
// read by an interior plane and the faces overwrite them.
#include <cuda_runtime.h>

#include "jacobi_pass.cuh"

// x, x0 and out (n, n, n) float32, tmp like out (scratch, may be null when
// iters <= 4), all contiguous on the current device, out and tmp distinct
// from x and x0; n^3 < 2^31.  b in 0..3 is the field's set_bnd code, a and
// inv_c = f32(1)/f32(c) the solve's coefficients, iters >= 1.  Launches
// every pass of up to four sweeps (jacobi_pass.cuh), the last with the
// faces, on `stream` and returns the first cudaError_t.
extern "C" int fs_jacobi(const float* x, const float* x0, float* out, float* tmp, int n, int b,
                         float a, float inv_c, int iters, void* stream) {
  using namespace fsk;
  if (n < 3 || b < 0 || b > 3 || iters < 1 || !offsets_fit(n, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Round q{};
  q.x = x;
  q.x0 = x0;
  q.n = q.nz = n;
  q.b = b;
  q.a = a;
  q.inv_c = inv_c;
  q.wall_lo = 0;
  q.wall_hi = n - 1;
  q.keep_lo = 0;
  q.keep_hi = n - 1;
  return static_cast<int>(run_rounds(q, out, tmp, nullptr, iters,
                                     static_cast<cudaStream_t>(stream)));
}
