// The mesh's plumbing between cards: peer access for the kernels that store
// into, or read from, a neighbour shard's buffers on another card (K12 and
// K13 push their edge planes into the neighbours' outputs, K7e reads the
// neighbours' halo planes in place), a copy of a shard's planes onto another
// card on the reading shard's stream (the "pallas" exchanges' counterpart of
// a ppermute), and the device this library's runtime sees as current.
//
// The library links nvcc's static CUDA runtime, which keeps no device state of
// its own beyond the thread's current context: it sees the device that
// PyTorch's runtime made current (fs_current_device checks this once a
// device), and a peer mapping enabled here is the primary context's, which
// PyTorch's runtime shares.
#include <cuda_runtime.h>

#include "entries.h"

// Lets kernels on `device` access memory on `peer` through its device
// pointers (unified addressing).  Access that is already on (PyTorch's own
// cross-device copies may have turned it on) counts as success, and its
// error is cleared.  The thread's current device is restored.
extern "C" int fs_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

// The device current on the calling thread as this library's runtime sees
// it, or -error.
extern "C" int fs_current_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? dev : -static_cast<int>(err);
}

// `height` rows of `width` bytes from src (rows `spitch` bytes apart) to dst
// (rows `dpitch` apart), on `stream`; src and dst may lie on different cards
// (unified addressing; a peer copy where access is on).  Returns the first
// cudaError_t.
extern "C" int fs_copy_rows(void* dst, long long dpitch, const void* src, long long spitch,
                            long long width, int height, void* stream) {
  if (height < 1 || width < 1) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaMemcpy2DAsync(dst, static_cast<size_t>(dpitch), src,
                                            static_cast<size_t>(spitch),
                                            static_cast<size_t>(width),
                                            static_cast<size_t>(height), cudaMemcpyDefault,
                                            static_cast<cudaStream_t>(stream)));
}
