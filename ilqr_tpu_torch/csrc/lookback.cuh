// Decoupled look-back: a carry across the tiles of one launch.
//
// Shared by the fused backward pass (fused_riccati.cu, B1), the affine
// prefix scan (affine_scan.cu, B3) and the Riccati suffix scan
// (suffix_scan.cu, B6/B7).  The TPU kernels they replace walk their blocks
// in order on a sequential grid and carry the boundary element in SMEM;
// blocks of a CUDA grid run in no order, and this is the CUDA form of that
// carry, in the same launch:
//   1. A block takes its tile from a global ticket in the order blocks
//      start (take_tile), from the left end for a prefix or the right end
//      for a suffix.  So a tile's predecessors (the tiles between it and
//      the end the carry starts from) took their tickets earlier: they are
//      running or done, and a tile only ever waits on running tiles.
//   2. The tile scans itself, writes its aggregate and publishes it
//      (status kAggregate).
//   3. find_inclusive polls the status words of the predecessors, one a
//      thread, blockDim.x a round, for the nearest whose inclusive value
//      (the carry through its own end) is out.  Every tile in between has
//      its aggregate out.
//   4. fold walks the aggregates from that tile to this one, this tile's
//      own last, staged kStage at a time in shared memory, and hands each
//      to the kernel's fold on the threads that carry the value.  The value
//      before the last step is the carry into this tile; the kernel
//      publishes the result as this tile's inclusive value (status
//      kInclusive).  A kernel folds at this one call site: every inclusive
//      value is the same chain of folds on the same inputs, wherever a
//      look-back stops, so a repeated call gives the same bits.
//   5. arrive counts the tiles that are done with the status words; the
//      last resets the ticket, the count and the status words (reset), so
//      the next launch needs no memset.
// Counters: [ticket, done, status (n_tiles)], ints, zeroed once by the
// wrapper; payloads (aggregates, inclusive values) are the kernel's own.
// A launch over a batch of independent sequences (the suffix scan's
// batched entry) takes its tickets by take_batched_tile: instance-major,
// each instance's tiles from direction D's end, so a tile's predecessors
// (in its own instance) still hold earlier tickets; the status words are
// then (instance, tile), and find_inclusive reads an instance's row.
#pragma once

#include <cuda_runtime.h>

namespace ilqr {
namespace lookback {

// Prefix scans carry from the left end, suffix scans from the right.
enum Direction { kFromLeft, kFromRight };

enum TileStatus : int { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

// Ints of the counters at n_tiles tiles.
constexpr int counter_ints(int n_tiles) { return 2 + n_tiles; }

// The block's shared words.
struct Slots {
  int tile;      // this block's tile
  int nearest;   // the nearest predecessor with its inclusive value out
  int last;      // this block arrived last
  int instance;  // this block's instance (take_batched_tile)
};

// "No predecessor has its inclusive value out": the value before the end.
template <Direction D>
__device__ __forceinline__ int none(int n_tiles) {
  return D == kFromRight ? n_tiles : -1;
}

// Device-scope publication between blocks: payload stores, a fence, then
// the status word; readers poll the word, fence, and read the payload from
// L2 (__ldcg: L1 is not coherent across SMs).  A payload written by other
// threads than the publisher is fenced by each writer, then a barrier.
__device__ __forceinline__ void publish(int* word, int value) {
  __threadfence();
  atomicExch(word, value);
}

__device__ __forceinline__ int poll(const int* word) {
  const int v = *reinterpret_cast<const volatile int*>(word);
  __threadfence();
  return v;
}

// Block-wide: this block's tile, in start order from direction D's end.
template <Direction D>
__device__ __forceinline__ int take_tile(int* counters, int n_tiles,
                                         Slots* s) {
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counters, 1);
    s->tile = D == kFromRight ? n_tiles - 1 - t : t;
    s->nearest = none<D>(n_tiles);
  }
  __syncthreads();
  return s->tile;
}

// Block-wide: this block's tile in a launch over sequences of n_tiles
// tiles each.  Ticket t is instance t / n_tiles (left in s->instance) and
// that instance's tile t % n_tiles in start order from direction D's end:
// every predecessor of a tile in its own instance took an earlier ticket.
// With one instance, take_tile's order.
template <Direction D>
__device__ __forceinline__ int take_batched_tile(int* counters, int n_tiles,
                                                 Slots* s) {
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counters, 1);
    const int r = t % n_tiles;
    s->instance = t / n_tiles;
    s->tile = D == kFromRight ? n_tiles - 1 - r : r;
    s->nearest = none<D>(n_tiles);
  }
  __syncthreads();
  return s->tile;
}

// Block-wide: the nearest predecessor of tile p whose inclusive value is
// out, or none<D>(n_tiles), among its sequence's n_tiles status words at
// `status`.  Starts with a barrier, so what the block wrote before (its
// own aggregate) is visible to every thread after it.
template <Direction D>
__device__ __forceinline__ int find_inclusive(const int* status, int p,
                                              int n_tiles, Slots* s) {
  const int n_pred = D == kFromRight ? n_tiles - 1 - p : p;
  __syncthreads();
  for (int base = 0; base < n_pred; base += blockDim.x) {
    const int i = base + threadIdx.x;
    if (i < n_pred) {
      const int j = D == kFromRight ? p + 1 + i : p - 1 - i;
      int st;
      do {
        st = poll(status + j);
      } while (st == kEmpty);
      if (st == kInclusive) {
        if (D == kFromRight) {
          atomicMin(&s->nearest, j);
        } else {
          atomicMax(&s->nearest, j);
        }
      }
    }
    __syncthreads();
    const bool found = s->nearest != none<D>(n_tiles);
    __syncthreads();
    if (found) break;
  }
  return s->nearest;
}

// Block-wide: fn(agg) on the threads where `active` holds, for each tile
// from q's neighbour to p, p included, in that order; agg points to the
// tile's F aggregate floats, staged kStage tiles at a time in `stage`
// (kStage F floats of shared memory) by the whole block.  Only the active
// threads loop, so the fold's chain runs without divergence.  Tile p's own
// aggregate comes last: the value carried into it is the one at the tile's
// edge.  Ends with a barrier.
template <Direction D, int kStage, typename Fold>
__device__ __forceinline__ void fold(const float* aggs, int F, int p, int q,
                                     float* stage, bool active, Fold&& fn) {
  const int count = D == kFromRight ? q - p : p - q;
  for (int done = 0; done < count; done += kStage) {
    const int m = min(kStage, count - done);
    // The m tiles of this round lie at lo .. lo + m - 1 in memory.
    const int lo = D == kFromRight ? q - done - m : q + 1 + done;
    for (int i = threadIdx.x; i < m * F; i += blockDim.x)
      stage[i] = __ldcg(aggs + (size_t)lo * F + i);
    __syncthreads();
    if (active) {
      for (int i = 0; i < m; ++i) {
        const int r = D == kFromRight ? m - 1 - i : i;
        fn(stage + r * F);
      }
    }
    __syncthreads();
  }
}

// Block-wide: count this tile done with the status words (its look-back
// over); true in the block that arrives last.  n_tiles counts every tile
// of the launch, over all its instances.
__device__ __forceinline__ bool arrive(int* counters, int n_tiles,
                                       Slots* s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s->last = atomicAdd(counters + 1, 1) == n_tiles - 1;
  }
  __syncthreads();
  return s->last != 0;
}

// Block-wide, in the last block to arrive: zero the ticket, the count and
// the status words (n_tiles of them: every tile of the launch) for the
// next launch (every block has stopped polling).
__device__ __forceinline__ void reset(int* counters, int n_tiles) {
  if (threadIdx.x == 0) {
    counters[0] = 0;
    counters[1] = 0;
  }
  for (int j = threadIdx.x; j < n_tiles; j += blockDim.x)
    counters[2 + j] = kEmpty;
}

}  // namespace lookback
}  // namespace ilqr
