// K13: the halo exchange of the explicit sharded step as a kernel of its
// own: one launch per shard builds that shard's share of every extended
// array of the call (parallel/halo: the solve's priming of x, its rhs and the
// mask; the advection's fields, velocity and mask).  halo_copy.cuh says which
// planes a shard moves: its lz local planes into the middle of its own
// output, its bottom and top h planes into the neighbours' outputs, and
// zeros into its own halo at a global end.  Every plane has one writer, so
// the shards' launches need no order among themselves: each runs on its own
// shard's stream and card, and the next kernel that reads a shard's outputs
// comes after its stream waited on both neighbours' launches
// (parallel/streams.ShardOrder).
//
// Replaces: fluidsim_tpu/pallas/halo_kernel.py::_halo_exchange_kernel (entry
// halo_exchange_rdma), where the edge slabs travel between chips as remote
// DMAs behind an entry barrier.  Here a "remote" store is a store into the
// neighbour shard's buffer through its device pointer (a peer pointer where
// the neighbour is on another card): the barrier becomes the events between
// the shards' streams.  The TPU kernel's VMEM comm buffers and its VMEM budget check
// (exchange_comm_bytes) have no counterpart: the planes move HBM to HBM.
// The bool mask moves as its bytes (one a cell), where the JAX package sends
// int8 in the solve and one float32 channel in the advection: the values are
// the same.
//
// What bounds it on an H100: bytes.  Each local plane is read once (twice at
// a shard's edges) and each output plane written once: at 512^3 on 8 shards,
// (lz + 2h) + lz planes of 1 MiB a channel and array.
//
// What the design does about it: one launch carries every array of the call
// (the TPU kernel's "all arrays ride one call"), one block row per output
// plane, 16-byte moves where a plane is aligned.
#include <cuda_runtime.h>

#include "halo_copy.cuh"

// arrays[0 .. n_arrays) (n_arrays <= 4): one shard's arrays of one call, each
// with its source planes, its own output and its neighbours' (see
// fsk::HaloArray); lz the local planes, h <= lz the halo depth, n the plane's
// side.  Sources and the shard's own outputs on the current device, the
// neighbours' outputs on theirs (peer access on); outputs distinct from
// sources.
// Launches on `stream` and returns the first cudaError_t.
extern "C" int fs_halo_exchange(const fsk::HaloArray* arrays, int n_arrays, int lz, int h,
                                int n, void* stream) {
  using namespace fsk;
  if (arrays == nullptr || n_arrays < 1 || n_arrays > kMaxArrays) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Exchange e{};
  for (int j = 0; j < n_arrays; ++j) e.a[j] = arrays[j];
  e.n_arrays = n_arrays;
  e.lz = lz;
  e.h = h;
  e.n = n;
  return static_cast<int>(launch_exchange(e, static_cast<cudaStream_t>(stream)));
}
