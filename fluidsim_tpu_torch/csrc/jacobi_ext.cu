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
// of float32 issue for the 4 sweeps at 67 TFLOP/s).  A window's halo adds
// about half again to the reads (jacobi.cu).
//
// What the design does about it: it is K6's round (jacobi_pass.cuh) on the
// slab: T <= 4 sweeps in one launch, streamed along z with the z neighbours
// in registers, the x0 and the mask copied ahead with the iterate, and the
// faces stored by the last level, so a round is one launch.  A T > 4 call
// chains passes of at most four sweeps, which is exact because the slab's
// T-deep halo covers T sweeps whatever the split.  sharded512's 72- and
// 68-plane slabs are one z-range a tile: their 130 and 120 tiles of 56 x
// (48 - 2T) columns fill the card's 132 SMs.
#include <cuda_runtime.h>

#include "jacobi_pass.cuh"

namespace {

bool walls_ok(int wall_lo, int wall_hi, int nz) {
  const bool lo_ok = wall_lo <= -2 || (wall_lo >= 0 && wall_lo <= nz - 2);
  const bool hi_ok = wall_hi <= -2 || (wall_hi >= 1 && wall_hi <= nz - 1);
  // Two walls one plane apart would read each other's face.
  return lo_ok && hi_ok && (wall_lo <= -2 || wall_hi <= -2 || wall_hi >= wall_lo + 2);
}

fsk::Round slab_round(const float* x, const float* x0, const unsigned char* mask, int nz, int n,
                      int b, float a, float inv_c, int wall_lo, int wall_hi) {
  fsk::Round q{};
  q.x = x;
  q.x0 = x0;
  q.mask = mask;
  q.n = n;
  q.nz = nz;
  q.b = b;
  q.a = a;
  q.inv_c = inv_c;
  q.wall_lo = wall_lo;
  q.wall_hi = wall_hi;
  q.keep_lo = 0;
  q.keep_hi = nz - 1;
  return q;
}

}  // namespace

// x, x0 and out (nz, n, n) float32, out distinct from x and x0; tmp like out
// (scratch, may be null when t_iters <= 4); mask (nz, n, n) one byte a cell
// (nonzero = solid) or null; all contiguous on the current device, and
// nz * n^2 < 2^31.  b in 0..3 is the field's set_bnd code, a and inv_c =
// f32(1)/f32(c) the solve's coefficients, t_iters >= 1 the sweeps.  wall_lo
// and wall_hi are the slab planes of the global z walls: wall_lo in
// [0, nz - 2] or below -1 (none), wall_hi in [1, nz - 1] or below -1 (none),
// at least two planes apart.  Launches every pass on `stream` (one for
// t_iters <= 4) and returns the first cudaError_t.
extern "C" int fs_jacobi_ext(const float* x, const float* x0, const unsigned char* mask,
                             float* out, float* tmp, int nz, int n, int b, float a, float inv_c,
                             int t_iters, int wall_lo, int wall_hi, void* stream) {
  using namespace fsk;
  if (n < 3 || nz < 1 || b < 0 || b > 3 || t_iters < 1 || !walls_ok(wall_lo, wall_hi, nz) ||
      !offsets_fit(nz, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Round q = slab_round(x, x0, mask, nz, n, b, a, inv_c, wall_lo, wall_hi);
  return static_cast<int>(
      run_rounds(q, out, tmp, nullptr, t_iters, static_cast<cudaStream_t>(stream)));
}

// K12: one round of the solve with the halo exchange in the same launch, so
// that rounds chain with no other launch between them: K10's round on the
// slab, whose last level also stores the shard's fresh edge planes [T, 2T)
// and [lz, lz + T) into the halos of its neighbours' outputs and zeroes its
// own halo at a global end.  `out` is then, once every shard's round has
// run, the complete next extended slab: the sweep results in [T, T + lz), the
// neighbours' edge planes around them, zeros past the global ends (the JAX
// contract).
//
// Replaces: fluidsim_tpu/pallas/halo_kernel.py::_rdma_jacobi_kernel (entry
// jacobi_ext_rdma): its n_win window programs are K10's round here, its
// epilogue program (read back the edges, the entry barrier, the remote
// copies, the landing or zeroing of the halos) the last level's stores.  A
// remote copy is a store through the neighbour shard's out pointer (a peer
// pointer where the neighbour is on another card) and the barrier is the
// events between the shards' streams (parallel/streams.ShardOrder): a
// shard's next round waits on both neighbours' rounds; no launch waits on a
// flag.
//
// The neighbours write into this shard's out while it may still be sweeping,
// so its stores keep off their planes: the last pass stores only
// [T, T + lz) of out (and zeros past a global end), and the earlier passes
// of a T > 4 round go through tmp and spare, never out.  Its own kept planes
// are K10's, bitwise.
//
// What bounds it: K10's bytes and operations.  The next extended slab's lz
// own planes and the 2T planes pushed into the neighbours are the writes of
// (lz + 2T) planes that K10 counts; the pushes are stored from the registers
// that hold the result, so no plane is read back.
//
// Arguments as fs_jacobi_ext, with nz = lz + 2 t_iters; out_lo and out_hi
// the lower and upper neighbours' outputs of this round (null at a global
// end), distinct from every input; tmp (t_iters > 4) and spare
// (t_iters > 8) like out.
extern "C" int fs_jacobi_ext_rdma(const float* x, const float* x0, const unsigned char* mask,
                                  float* out, float* tmp, float* spare, float* out_lo,
                                  float* out_hi, int nz, int n, int b, float a, float inv_c,
                                  int t_iters, int wall_lo, int wall_hi, void* stream) {
  using namespace fsk;
  const int lz = nz - 2 * t_iters;
  if (n < 3 || b < 0 || b > 3 || t_iters < 1 || lz < t_iters ||
      !walls_ok(wall_lo, wall_hi, nz) || !offsets_fit(nz, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Round q = slab_round(x, x0, mask, nz, n, b, a, inv_c, wall_lo, wall_hi);
  q.keep_lo = t_iters;
  q.keep_hi = t_iters + lz - 1;
  q.h = t_iters;
  q.lz = lz;
  q.out_lo = out_lo;
  q.out_hi = out_hi;
  return static_cast<int>(
      run_rounds(q, out, tmp, spare, t_iters, static_cast<cudaStream_t>(stream)));
}
