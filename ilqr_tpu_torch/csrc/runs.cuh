// Runs of floats between device and shared memory at any 4-byte alignment.
//
// A bulk copy (async_copy.cuh) moves 16-byte aligned blocks.  A run of n
// floats that starts anywhere in device memory is placed in shared memory
// at the same address modulo 16 bytes (its phase, 0-3 floats, into a
// region with 16 bytes to spare and a 16-byte aligned start): its aligned
// middle then moves as one bulk copy and its head and tail by plain loads
// and stores.  Used by the chain kernels (chain_rollout.cu) and the batched
// Riccati kernel (batched_riccati.cu), whose instance rows start b N F
// floats into a batch.
#pragma once

#include <cstdint>

#include "async_copy.cuh"

namespace ilqr {

// The shift, in floats, of the address p modulo 16 bytes.
__device__ __forceinline__ int phase(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// A run of n floats at p split at its 16-byte boundaries: `head` floats
// before the first, then `mid` floats in whole 16-byte blocks.
struct Pieces {
  int head, mid;
  __device__ __forceinline__ Pieces(const float* p, int n) {
    const int h = (4 - phase(p)) & 3;
    head = h < n ? h : n;
    mid = (n - head) & ~3;
  }
};

// n floats device -> the region at dst0 (placed at src's phase): the head
// and tail by plain loads; returns the bytes of the bulk middle.
__device__ __forceinline__ uint32_t load_ends(float* dst0, const float* src,
                                              int n) {
  float* dst = dst0 + phase(src);
  const Pieces sp(src, n);
  for (int i = 0; i < sp.head; ++i) dst[i] = src[i];
  for (int i = sp.head + sp.mid; i < n; ++i) dst[i] = src[i];
  return 4u * sp.mid;
}

__device__ __forceinline__ void load_mid(float* dst0, const float* src, int n,
                                         uint64_t* bar) {
  float* dst = dst0 + phase(src);
  const Pieces sp(src, n);
  if (sp.mid > 0) bulk_load(dst + sp.head, src + sp.head, 4u * sp.mid, bar);
}

// n floats from the region at src0 (placed at dst's phase) -> device: the
// middle by bulk store, head and tail by plain stores.
__device__ __forceinline__ void store_rows(float* dst, const float* src0,
                                           int n) {
  const float* src = src0 + phase(dst);
  const Pieces sp(dst, n);
  if (sp.mid > 0) bulk_store(dst + sp.head, src + sp.head, 4u * sp.mid);
  for (int i = 0; i < sp.head; ++i) dst[i] = src[i];
  for (int i = sp.head + sp.mid; i < n; ++i) dst[i] = src[i];
}

}  // namespace ilqr
