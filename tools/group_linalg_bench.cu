// Cycles per call of csrc/group_linalg.cuh's primitives on one SM: the
// combine of B6w/B7w and B1w, apply_value (B1w's look-back and closure),
// one level of B3w's product tree (a product, its store and the block's
// barrier), the Gauss-Jordan inverse, the products and sym, each by one
// warp alone (W = 1) and with W warps of a block at once, and the
// latency of the warp collectives and of a shared-memory round trip that
// the inverse's steps chain (100 dependent calls each).  Inputs are fixed
// well-conditioned elements; the times do not depend on the values.
//
// Build and run from the repository root on a machine with an H100:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -I ilqr_tpu_torch/csrc tools/group_linalg_bench.cu -o _scratch/glb
//   _scratch/glb
// (_scratch/ is git-ignored; make it first with mkdir -p.)
#include <cstdio>

#include <cuda_runtime.h>

#include "group_linalg.cuh"

using namespace ilqr;

enum What { kCombine, kApply, kTree, kInv, kMm, kMtm, kMmt, kSym, kShfl,
            kRedux, kVote, kSmem };

template <int P, int WHAT>
__global__ void bench(int n, int iters, long long* out) {
  using E = grp::Elem<P>;
  constexpr int LD = grp::Mat<P>::LD;
  extern __shared__ __align__(16) float sm[];
  const int q = threadIdx.x / 32;
  float* ej = sm;   // the later operand, read by every warp
  float* ei = sm + E::F + q * (2 * E::F + E::WORK);
  float* o = ei + E::F;
  float* w = o + E::F;
  const grp::Lane ln;
  for (int i = ln.l; i < 2 * E::F + E::WORK; i += 32) ei[i] = 0.0f;
  if (q == 0)
    for (int i = ln.l; i < E::F; i += 32) ej[i] = 0.0f;
  __syncthreads();
  if (ln.l < P) {
    const int d = ln.l * (LD + 1);
    ei[E::A + d] = 1.0f;
    ei[E::C + d] = 0.1f;
    ei[E::J + d] = 0.2f;
    if (q == 0) {
      ej[E::A + d] = 1.0f;
      ej[E::C + d] = 0.1f;
      ej[E::J + d] = 0.2f;
    }
    w[d] = 2.0f;
    for (int j = 0; j < P; ++j) ei[E::C + ln.l * LD + j] += 0.01f * j;
  }
  __syncthreads();
  grp::Tile<P> t;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (WHAT == kCombine) grp::combine<P>(ln, n, ei, ej, o, w);
    if (WHAT == kApply)
      grp::apply_value<P>(ln, n, ei, ej + E::ETA, ej + E::J, o + E::ETA,
                          o + E::J, w);
    if (WHAT == kTree) {
      grp::mm<P>(ln, ei + E::A, ej + E::A, t);
      grp::store<P>(ln, t, o + E::A);
      __syncthreads();
    }
    if (WHAT == kInv) grp::inv<P>(ln, n, w, o);
    if (WHAT == kMm || WHAT == kMtm || WHAT == kMmt) {
      grp::mm<P, WHAT == kMtm, WHAT == kMmt>(ln, ei + E::C, ej + E::J, t);
      grp::store<P>(ln, t, o);
      grp::sync();
    }
    if (WHAT == kSym) grp::sym<P>(ln, ei + E::C, o);
    if (WHAT == kShfl) {
      float x = o[ln.l];
      for (int i = 0; i < 100; ++i)
        x = __shfl_sync(grp::kWarp, x + 1.0f, (ln.l + 1) & 31);
      o[ln.l] = x;
    }
    if (WHAT == kRedux) {
      unsigned u = ln.l + it;
      for (int i = 0; i < 100; ++i) u = __reduce_max_sync(grp::kWarp, u + ln.l);
      o[ln.l] = u;
    }
    if (WHAT == kVote) {
      unsigned m = ln.l + it;
      for (int i = 0; i < 100; ++i)
        m = __ballot_sync(grp::kWarp, (m >> ln.l) & 1u) + 1u;
      o[ln.l] = m;
    }
    if (WHAT == kSmem) {
      float x = o[ln.l];
      for (int i = 0; i < 100; ++i) {
        w[ln.l] = x;
        __syncwarp();
        x = w[(ln.l + 1) & 31] + 1.0f;
        __syncwarp();
      }
      o[ln.l] = x;
    }
  }
  const long long t1 = clock64();
  if (ln.l == 0) out[q] = (t1 - t0) / iters;
}

template <int P, int WHAT>
void run(const char* name, int n, int warps) {
  using E = grp::Elem<P>;
  const int smem = 4 * (E::F + warps * (2 * E::F + E::WORK));
  cudaFuncSetAttribute(bench<P, WHAT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  long long* d;
  cudaMalloc(&d, 64 * sizeof(long long));
  bench<P, WHAT><<<1, 32 * warps, smem>>>(n, 4, d);     // warm-up
  bench<P, WHAT><<<1, 32 * warps, smem>>>(n, 50, d);
  long long h[64];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  const cudaError_t e = cudaGetLastError();
  long long slowest = 0;
  for (int i = 0; i < warps; ++i) slowest = h[i] > slowest ? h[i] : slowest;
  printf("%-14s P=%2d n=%2d warps=%2d: %6lld cycles a call (slowest warp)%s%s\n",
         name, P, n, warps, slowest, e ? ": " : "",
         e ? cudaGetErrorString(e) : "");
  cudaFree(d);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("%s, SM clock %d kHz\n", prop.name, khz);
  for (int warps : {1, 12, 16}) {
    run<16, kCombine>("combine", 12, warps);
    run<8, kCombine>("combine", 6, warps);
    run<16, kApply>("apply_value", 12, warps);
    run<8, kApply>("apply_value", 6, warps);
    run<16, kTree>("tree level", 12, warps);
    run<8, kTree>("tree level", 6, warps);
  }
  run<16, kInv>("inv", 12, 1);
  run<16, kInv>("inv", 4, 1);
  run<8, kInv>("inv", 6, 1);
  run<8, kInv>("inv", 2, 1);
  run<16, kMm>("mm", 16, 1);
  run<16, kMtm>("mtm", 16, 1);
  run<16, kMmt>("mmt", 16, 1);
  run<8, kMm>("mm", 8, 1);
  run<16, kSym>("sym", 16, 1);
  run<16, kMm>("mm", 16, 12);
  run<16, kShfl>("100 shfl", 0, 1);
  run<16, kRedux>("100 redux", 0, 1);
  run<16, kVote>("100 ballot", 0, 1);
  run<16, kSmem>("100 smem trip", 0, 1);
  return 0;
}
