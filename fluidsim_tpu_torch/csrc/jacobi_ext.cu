// K10: T Jacobi sweeps of the pressure solve on one shard's halo-extended
// z-slab, the per-shard compute of the explicit halo-exchange sharded step
// (parallel/halo.jacobi_3d_sharded).  The slab is (nz, n, n) with nz = lz + 2T:
// the shard's lz planes between T planes of each neighbour's edge.  Each sweep
// is  x <- (x0 + a*nbr) * coef  on every plane of the slab, with open z edges
// (the planes past them read as zero, so validity erodes one plane a sweep
// and the caller keeps the middle lz), the corrected reads of K6 in x and y,
// and in z only next to the global walls, which sit at run-time planes
// (wall_lo, wall_hi) of the slab: T on the first shard, T + lz - 1 on the
// last, NO_WALL (-5, no plane) elsewhere.  Then the set_bnd faces: the z
// faces where a wall plane lies in the slab, y and x on every plane, every
// border cell the signed copy of its clamped interior cell (the z -> y -> x
// order of the TPU kernel gives the same values).  With a mask the coefficient
// is 0 in solid cells (the pressure solve's iterate is zero there).
//
// Replaces: fluidsim_tpu/pallas/halo_kernel.py::_ext_jacobi_kernel (entry
// jacobi_ext_pallas, body _ext_window_body), with its run-time wall
// positions from SMEM and the int8 mask expanded to a coefficient window.
// The TPU kernel's z-windows and y-tiles (_pick_ext_block, tile_geometry,
// window_origin) are not carried over.
//
// What bounds it on an H100: bytes.  A round reads xp and x0_ext and writes
// the slab once, 3 * 4 * nz * n^2 bytes: 226 MB a shard at 512^3 on 8 shards
// with T = 4, 68 us at 3.35 TB/s, against 8 operations a cell a sweep (9 us
// of float32 issue for the 4 sweeps at 67 TFLOP/s).
//
// What the design does about it: it is K6's pass (jacobi_pass.cuh) on the
// slab, T <= 3 sweeps per launch out of shared memory with a T-level
// wavefront in z; T = 4 takes a pass of three sweeps and a pass of one,
// which is exact because the slab's T-deep halo covers T sweeps whatever the
// split.  A block owns at most 64 planes: the slab is cut into equal chunks
// (two of 36 at nz = 72), so no chunk is mostly halo.  A last launch writes
// the faces.
#include <cuda_runtime.h>

#include "halo_copy.cuh"
#include "jacobi_pass.cuh"

// x, x0 and out (nz, n, n) float32, out distinct from x and x0; tmp like out
// (scratch, may be null when t_iters <= 3); mask (nz, n, n) one byte a cell
// (nonzero = solid) or null; all contiguous on the current device.  b in 0..3
// is the field's set_bnd code, a and inv_c = f32(1)/f32(c) the solve's
// coefficients, t_iters >= 1 the sweeps.  wall_lo and wall_hi are the slab
// planes of the global z walls: wall_lo in [0, nz - 2] or below -1 (none),
// wall_hi in [1, nz - 1] or below -1 (none).  Launches every pass and the
// faces on `stream` and returns the first cudaError_t.
extern "C" int fs_jacobi_ext(const float* x, const float* x0, const unsigned char* mask,
                             float* out, float* tmp, int nz, int n, int b, float a, float inv_c,
                             int t_iters, int wall_lo, int wall_hi, void* stream) {
  using namespace fsk;
  const bool lo_ok = wall_lo <= -2 || (wall_lo >= 0 && wall_lo <= nz - 2);
  const bool hi_ok = wall_hi <= -2 || (wall_hi >= 1 && wall_hi <= nz - 1);
  if (n < 3 || nz < 1 || b < 0 || b > 3 || t_iters < 1 || !lo_ok || !hi_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (nz + kChunkZ - 1) / kChunkZ;
  const Pass q{x, x0, mask, nullptr, n, nz, b, a, inv_c, kBlockIters,
               (nz + chunks - 1) / chunks, wall_lo, wall_hi};
  const cudaError_t err = run_passes<true>(q, out, tmp, t_iters, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_faces(out, n, nz, b, wall_lo, wall_hi, s));
}

// K12: one round of the solve with the halo exchange in the same entry, so
// that rounds chain with no other launch between them: K10's passes on the
// slab, then an exchange stage that stores the shard's fresh edge planes
// [T, 2T) and [lz, lz + T) into the halos of its neighbours' outputs and
// zeroes its own halo at a global end.  `out` is then, once every shard's
// round has run, the complete next extended slab: the sweep results in
// [T, T + lz), the neighbours' edge planes around them, zeros past the
// global ends (the JAX contract).
//
// Replaces: fluidsim_tpu/pallas/halo_kernel.py::_rdma_jacobi_kernel (entry
// jacobi_ext_rdma): its n_win window programs are K10's passes here, its
// epilogue program (read back the edges, the entry barrier, the remote
// copies, the landing or zeroing of the halos) the exchange stage.  On one
// card a remote copy is a store through the neighbour shard's out pointer
// and the barrier is stream order; no launch waits on a flag.
//
// The neighbours write into this shard's out while it may still be sweeping,
// so its stores keep off their planes: the last pass and the faces store only
// [T, T + lz), and the earlier passes go through tmp and spare, never out.
// Its own kept planes are K10's, bitwise.
//
// What bounds it: K10's bytes and operations.  The next extended slab's lz
// own planes and the 2T planes pushed into the neighbours are the writes of
// (lz + 2T) planes that K10 counts.  This design's exchange stage reads its
// 2T edge planes back out of out and stores them again: 4T planes (16 MiB a
// round at 512^3 and T = 4) that a kernel storing the edges to the
// neighbours straight from its last pass would not move.
//
// Arguments as fs_jacobi_ext, with nz = lz + 2 t_iters; out_lo and out_hi
// the lower and upper neighbours' outputs of this round (null at a global
// end), distinct from every input; tmp (t_iters > 3) and spare
// (t_iters > 6) like out.
extern "C" int fs_jacobi_ext_rdma(const float* x, const float* x0, const unsigned char* mask,
                                  float* out, float* tmp, float* spare, float* out_lo,
                                  float* out_hi, int nz, int n, int b, float a, float inv_c,
                                  int t_iters, int wall_lo, int wall_hi, void* stream) {
  using namespace fsk;
  const int lz = nz - 2 * t_iters;
  const bool lo_ok = wall_lo <= -2 || (wall_lo >= 0 && wall_lo <= nz - 2);
  const bool hi_ok = wall_hi <= -2 || (wall_hi >= 1 && wall_hi <= nz - 1);
  if (n < 3 || b < 0 || b > 3 || t_iters < 1 || lz < t_iters || !lo_ok || !hi_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (nz + kChunkZ - 1) / kChunkZ;
  Pass q{x, x0, mask, nullptr, n, nz, b, a, inv_c, kBlockIters,
         (nz + chunks - 1) / chunks, wall_lo, wall_hi};
  const int keep_lo = t_iters, keep_hi = t_iters + lz - 1;
  q.keep_lo = keep_lo;
  q.keep_hi = keep_hi;
  cudaError_t err = run_passes<true>(q, out, tmp, t_iters, s, spare);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_faces(out, n, nz, b, wall_lo, wall_hi, s, keep_lo, keep_hi);
  if (err != cudaSuccess) return static_cast<int>(err);
  Exchange e{};
  e.a[0] = HaloArray{out + static_cast<long long>(t_iters) * n * n, out, out_lo, out_hi, 0, 1,
                     static_cast<int>(sizeof(float))};
  e.n_arrays = 1;
  e.lz = lz;
  e.h = t_iters;
  e.n = n;
  return static_cast<int>(launch_exchange<false>(e, s));
}
