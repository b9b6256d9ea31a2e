// Batched sequential Riccati backward pass: B instances, a lane group each.
//
// Replaces: ilqr_tpu/ops/pallas_batched.py::_batched_kernel (launcher
// _backward_batched_packed, entry backward_pass_batched), B4.
//
// Math: ilqr_tpu_torch/ops/riccati.py::backward_pass for every instance.
// With V = (V_x, V_xx) from the terminal expansion, t walks N-1 ... 0:
//   Q_x = l_x + f_x' V_x          Q_u = l_u + f_u' V_x
//   Q_xx = l_xx + (f_x' V_xx) f_x Q_ux = l_ux + (f_u' V_xx) f_x
//   Q_uu = l_uu + (f_u' V_xx) f_u
//   K = -(Q_uu + reg I)^-1 Q_ux,  u_ff = -(Q_uu + reg I)^-1 Q_u
// and the full symmetric value update through the stationarity residuals
// W = Q_uu K + Q_ux and w = Q_u + Q_uu u_ff (regularization enters the gain
// solve only):
//   V_x = Q_x + K' w + Q_ux' u_ff,  V_xx = sym(Q_xx + K' W + Q_ux' K)
//   dV += (u_ff' Q_u, 0.5 u_ff' (w - Q_u)),
// each sum in that order; ok = every gain finite.
//
// What bounds it on an H100: latency.  Each instance is a chain of N
// dependent steps of about 1-2 kflop on ~60 floats of state and inputs; the
// B instances are independent.  By bytes (the expansion read once, the
// gains written once) B = 1024, N = 128 needs ~11 us.
//
// Design:
// - A lane group per instance: NX lanes, lane r holding column r of V_xx
//   (its row, V_xx being symmetric) and V_x[r], so a warp runs 32 / NX
//   instances and B = 1024 spreads over 128 (n_x = 4) or 64 (n_x = 2)
//   warps, one block each, across the SMs.  Lane r forms column r of
//   f_x' V_xx and f_u' V_xx; the group exchanges them, V_x, and later the
//   columns of K, Q_ux and W with width-NX shuffles.  Every lane then forms
//   column r and row r of Q_xx + K' W + Q_ux' K, whose half-sum is column r
//   of the new V_xx: the two lanes that form an entry (i, r) and (r, i)
//   evaluate the same fmaf chains on the same values, so V_xx stays exactly
//   symmetric.  Q_u, Q_uu, its closed-form inverse (smallmat.cuh), u_ff, w
//   and dV are formed in every lane of the group.  This cuts the chain a
//   lane issues per step about NX-fold against one thread per instance.
// - No device-memory wait on the chain: the recursion runs from the end of
//   the horizon in chunks of kChunk steps (the ragged chunk at t = 0), and
//   each chunk of every field is one contiguous run per instance in the
//   (B, N, ...) layout of ops/linearize.py::linearize_trajectory_batched.
//   A producer warp beside the compute warp (the block's warp 1, on
//   another scheduler) keeps a ring of kStages chunk buffers full: its lane
//   g copies group g's runs by bulk copy (runs.cuh: at any 4-byte
//   alignment, since an instance's rows start b N F floats in), completing
//   on the stage's full barrier, and the compute warp releases a stage on
//   its empty barrier, as the chain kernels of chain_rollout.cu do.  Each
//   instance's runs start 4 banks after the previous instance's.  (A bulk
//   copy takes ~100 cycles to issue, one a lane, so the 7 x 32 / NX copies
//   of a chunk cost about half of the chunk's compute on the compute warp
//   itself; four-byte cp.async copies, one a lane per float, cost more
//   than the compute.)
// - u_ff and K go to device memory through shared memory: the compute warp
//   stages a chunk's gains in one of two output buffers, and producer lane
//   g drains group g's runs with bulk stores; dV and the finite flag ok
//   are formed in the compute warp.
// - Lanes of instances past B (the last block) run on instance B - 1's data
//   and store nothing: every lane takes part in every shuffle.
// That register form serves (n_x, n_u) = (2, 1), (4, 1) and (4, 2).
//
// The wide form (wide_riccati_kernel; B4w), every other n_x, n_u <= 16,
// as JAX's kernel takes them.  A step's operands no longer fit a lane
// group's registers ((16, 4): 676 floats of inputs a step), so an instance
// is a warp, its matrices zero-padded to P x P in shared memory (P = 8 when
// n_x, n_u <= 8, else 16; one instantiation per P), and a step is the
// register form's recursion in the entry-parallel math of
// group_linalg.cuh: T = f_x' V_xx and F = f_u' V_xx, Q_xx (kept in
// registers), Q_ux and Q_uu, the gain solve by Gauss-Jordan with the pivot
// from a warp reduction (a zero pivot gives non-finite gains, so ok = 0,
// as the plain version's solve flags it), W, w, V_x and V_xx = sym(Q_xx +
// K'W + Q_ux'K), each product unrolled to P.  Rows and sums that run over
// the controls stop at U = 8 when n_u <= 8 (one instantiation more at
// P = 16: (12, 4) forms 7 of its 9 products at half or a quarter of the
// work).  A block is one instance (so B = 64 fills 64 SMs): a compute warp
// and a producer warp whose lane 0 keeps the instance's ring of
// kWideStages chunks of kWideChunk steps full with the bulk copies of
// runs.cuh (any 4-byte alignment: an instance's rows start b N F floats
// in), released by the compute warp on the stage's empty barrier.  Gains
// go out by plain stores.
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "async_copy.cuh"
#include "group_linalg.cuh"
#include "runs.cuh"
#include "smallmat.cuh"

namespace {

using namespace ilqr;

constexpr int kChunk = 16;   // steps per shared-memory chunk
constexpr int kStages = 2;   // chunk buffers in the ring
constexpr unsigned kFull = 0xffffffffu;

struct BatchedExpansion {
  const float* f_x;   // (B, N, NX, NX)
  const float* f_u;   // (B, N, NX, NU)
  const float* l_x;   // (B, N, NX)
  const float* l_u;   // (B, N, NU)
  const float* l_xx;  // (B, N, NX, NX)
  const float* l_ux;  // (B, N, NU, NX)
  const float* l_uu;  // (B, N, NU, NU)
  const float* v_x;   // (B, NX)
  const float* v_xx;  // (B, NX, NX)
};

enum Field { kFx = 0, kFu, kLx, kLu, kLxx, kLux, kLuu, kFields };

__device__ __forceinline__ const float* field(const BatchedExpansion& ex,
                                              int f) {
  switch (f) {
    case kFx: return ex.f_x;
    case kFu: return ex.f_u;
    case kLx: return ex.l_x;
    case kLu: return ex.l_u;
    case kLxx: return ex.l_xx;
    case kLux: return ex.l_ux;
    default: return ex.l_uu;
  }
}

// Shared memory of one block: barriers, then, in floats, kStages chunk
// buffers, each field-major with one segment per instance, then two
// output buffers of a chunk's K and u_ff.  A segment holds a run of n
// floats at its phase (runs.cuh): n + 4 rounded up to 32 floats, plus 4,
// so that consecutive instances' segments start 4 banks apart.
template <int NX, int NU>
struct Smem {
  static constexpr int kGroups = 32 / NX;  // instances per warp
  __host__ __device__ static constexpr int width(int f) {
    return f == kFx || f == kLxx ? NX * NX
           : f == kFu || f == kLux ? NX * NU
           : f == kLx ? NX
           : f == kLu ? NU
           : NU * NU;
  }
  __host__ __device__ static constexpr int seg(int n) {
    return (n + 4 + 31) / 32 * 32 + 4;
  }
  __host__ __device__ static constexpr int off(int f) {
    int o = 0;
    for (int g = 0; g < f; ++g) o += kGroups * seg(kChunk * width(g));
    return o;
  }
  static constexpr int kBuf = off(kFields);
  static constexpr int kSegK = seg(kChunk * NU * NX);
  static constexpr int kSegU = seg(kChunk * NU);
  static constexpr int kSegOut = kSegK + kSegU;  // K run, then u_ff run
  static constexpr int kOut = kStages * kBuf;    // the output buffers
  static constexpr int kOutBuf = kGroups * kSegOut;
  static constexpr int kBarBytes = 8 * (2 * kStages + 4);
  static constexpr int kBytes = kBarBytes + 4 * (kOut + 2 * kOutBuf);
};

struct Barriers {
  uint64_t* full;    // chunk buffer loaded (kGroups arrivals + bytes)
  uint64_t* empty;   // chunk buffer read by the compute warp (32)
  uint64_t* ofull;   // output buffer written by the compute warp (32)
  uint64_t* oempty;  // output buffer drained by the producer (kGroups)
};

// Lane g < kGroups: copy group g's runs of steps [t_lo, t_lo + T) of every
// field (instance b0 + g, or B - 1 past B) into buf; they complete on bar.
template <int NX, int NU>
__device__ __forceinline__ void load_chunk(const BatchedExpansion& ex,
                                           float* buf, uint64_t* bar, int b0,
                                           int B, int N, int t_lo, int T,
                                           int lane) {
  using S = Smem<NX, NU>;
  if (lane >= S::kGroups) return;
  const size_t s0 = (size_t)min(b0 + lane, B - 1) * N + t_lo;
  uint32_t bytes = 0;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int w = S::width(f);
    bytes += load_ends(buf + S::off(f) + lane * S::seg(kChunk * w),
                       field(ex, f) + s0 * w, T * w);
  }
  // The plain loads come before the arrival that releases them.
  mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int w = S::width(f);
    load_mid(buf + S::off(f) + lane * S::seg(kChunk * w),
             field(ex, f) + s0 * w, T * w, bar);
  }
}

// Producer lane g < kGroups: fill group g's segments of the ring ahead of
// the compute warp (chunk c in stage c % kStages, round c / kStages) and
// drain group g's outputs of each chunk (output buffer c % 2).
template <int NX, int NU>
__device__ void produce(const BatchedExpansion& ex, float* smem, Barriers bar,
                        int b0, int B, int N, float* u_ff_out, float* K_out,
                        int lane) {
  using S = Smem<NX, NU>;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  auto chunk_lo = [&](int c) { return max(0, N - (c + 1) * kChunk); };
  int loaded = 0;
  for (int c = 0; c < n_chunks; ++c) {
    for (; loaded < n_chunks && loaded < c + kStages; ++loaded) {
      const int s = loaded % kStages;
      // Round r reuses the stage after the compute warp released r - 1.
      mbar_wait(&bar.empty[s], ((loaded / kStages) & 1) ^ 1);
      const int t_lo = chunk_lo(loaded);
      load_chunk<NX, NU>(ex, smem + s * S::kBuf, &bar.full[s], b0, B, N,
                         t_lo, N - loaded * kChunk - t_lo, lane);
    }
    const int o = c & 1;
    const int t_lo = chunk_lo(c), T = N - c * kChunk - t_lo;
    mbar_wait(&bar.ofull[o], (c >> 1) & 1);
    if (b0 + lane < B) {
      const size_t o0 = (size_t)(b0 + lane) * N + t_lo;
      const float* src = smem + S::kOut + o * S::kOutBuf + lane * S::kSegOut;
      store_rows(K_out + o0 * NU * NX, src, T * NU * NX);
      store_rows(u_ff_out + o0 * NU, src + S::kSegK, T * NU);
    }
    bulk_commit();
    bulk_wait_read();
    mbar_arrive(&bar.oempty[o]);
  }
  bulk_wait_all();
}

// Element m of every lane of this lane's group.
__device__ __forceinline__ float from(float v, int m, int width) {
  return __shfl_sync(kFull, v, m, width);
}

// sum_m a[m] b[m * stride], as one fmaf chain in m order.
template <int M>
__device__ __forceinline__ float dot(const float* a, const float* b,
                                     int stride) {
  float s = 0.0f;
#pragma unroll
  for (int m = 0; m < M; ++m) s = fmaf(a[m], b[m * stride], s);
  return s;
}

template <int NX, int NU>
__global__ void __launch_bounds__(64)
batched_riccati_kernel(BatchedExpansion ex, int B, int N, float reg,
                       const float* __restrict__ reg_b,
                       float* __restrict__ u_ff_out, float* __restrict__ K_out,
                       float* __restrict__ dV_out,
                       unsigned char* __restrict__ ok_out) {
  using S = Smem<NX, NU>;
  constexpr int NN = NX * NX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const Barriers bar{bars, bars + kStages, bars + 2 * kStages,
                     bars + 2 * kStages + 2};
  float* smem = reinterpret_cast<float*>(smem_raw + S::kBarBytes);
  const int b0 = blockIdx.x * S::kGroups;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.full[s], S::kGroups);
      mbar_init(&bar.empty[s], 32);
    }
    for (int o = 0; o < 2; ++o) {
      mbar_init(&bar.ofull[o], 32);
      mbar_init(&bar.oempty[o], S::kGroups);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the block's only barrier: the mbarriers are ready
  if (threadIdx.x >= 32) {
    const int lane = threadIdx.x - 32;
    if (lane < S::kGroups)
      produce<NX, NU>(ex, smem, bar, b0, B, N, u_ff_out, K_out, lane);
    return;
  }

  // The compute warp.
  const int lane = threadIdx.x, g = lane / NX, r = lane % NX;
  const int b = b0 + g;
  const int bl = min(b, B - 1);
  // Column r of V_xx (the terminal's, read as a column so that an input
  // that is not exactly symmetric enters as the one-thread recursion reads
  // it) and V_x[r].
  float Vc[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) Vc[i] = ex.v_xx[(size_t)bl * NN + i * NX + r];
  float vx = ex.v_x[(size_t)bl * NX + r];
  const float rg = reg_b != nullptr ? reg_b[bl] : reg;
  float dv1 = 0.0f, dv2 = 0.0f;
  bool bad = false;

  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t_lo = max(0, N - (c + 1) * kChunk);
    const int T = N - c * kChunk - t_lo;
    const int s = c % kStages, o = c & 1;
    const float* buf = smem + s * S::kBuf;
    const size_t s0 = (size_t)bl * N + t_lo;
    // Where group g's runs of this chunk sit in their segments.
    int sh[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      sh[f] = phase(field(ex, f) + s0 * S::width(f));
    const float* fx0 = buf + S::off(kFx) + g * S::seg(kChunk * NN) + sh[kFx];
    const float* fu0 =
        buf + S::off(kFu) + g * S::seg(kChunk * NX * NU) + sh[kFu];
    const float* lx0 = buf + S::off(kLx) + g * S::seg(kChunk * NX) + sh[kLx];
    const float* lu0 = buf + S::off(kLu) + g * S::seg(kChunk * NU) + sh[kLu];
    const float* lxx0 =
        buf + S::off(kLxx) + g * S::seg(kChunk * NN) + sh[kLxx];
    const float* lux0 =
        buf + S::off(kLux) + g * S::seg(kChunk * NU * NX) + sh[kLux];
    const float* luu0 =
        buf + S::off(kLuu) + g * S::seg(kChunk * NU * NU) + sh[kLuu];
    float* out = smem + S::kOut + o * S::kOutBuf + g * S::kSegOut;
    float* oK = out + phase(K_out + s0 * NU * NX);
    float* oU = out + S::kSegK + phase(u_ff_out + s0 * NU);
    mbar_wait(&bar.full[s], (c / kStages) & 1);
    // Output buffer o is free once the producer drained chunk c - 2.
    mbar_wait(&bar.oempty[o], ((c >> 1) & 1) ^ 1);
#pragma unroll 1
    for (int k = T - 1; k >= 0; --k) {
      const float* fx = fx0 + k * NN;
      const float* fu = fu0 + k * NX * NU;
      const float* lx = lx0 + k * NX;
      const float* lu = lu0 + k * NU;
      const float* lxx = lxx0 + k * NN;
      const float* lux = lux0 + k * NU * NX;
      const float* luu = luu0 + k * NU * NU;

      // Column r of f_x' V_xx and of f_u' V_xx, then all of both and V_x
      // in every lane of the group.
      float Tc[NX], Fc[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) Tc[i] = dot<NX>(Vc, fx + i, NX);
#pragma unroll
      for (int a = 0; a < NU; ++a) Fc[a] = dot<NX>(Vc, fu + a, NU);
      float Tf[NN], Ff[NU * NX], vxf[NX];
#pragma unroll
      for (int m = 0; m < NX; ++m) {
#pragma unroll
        for (int i = 0; i < NX; ++i) Tf[i * NX + m] = from(Tc[i], m, NX);
#pragma unroll
        for (int a = 0; a < NU; ++a) Ff[a * NX + m] = from(Fc[a], m, NX);
        vxf[m] = from(vx, m, NX);
      }
      // Row r of f_x' V_xx, by selects (a register array takes no lane
      // index).
      float Tr[NX];
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        Tr[m] = Tf[m];
#pragma unroll
        for (int i = 1; i < NX; ++i)
          if (r == i) Tr[m] = Tf[i * NX + m];
      }

      // The Q-expansion: Q_x[r], Q_u, column and row r of Q_xx, column r
      // of Q_ux, Q_uu.
      const float qx = dot<NX>(vxf, fx + r, NX) + lx[r];
      float Qu[NU], Uc[NU], Quu[NU * NU], Qc[NX], Qr[NX];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Qu[a] = dot<NX>(vxf, fu + a, NU) + lu[a];
        Uc[a] = dot<NX>(Ff + a * NX, fx + r, NX) + lux[a * NX + r];
#pragma unroll
        for (int d = 0; d < NU; ++d)
          Quu[a * NU + d] = dot<NX>(Ff + a * NX, fu + d, NU) + luu[a * NU + d];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        Qc[i] = dot<NX>(Tf + i * NX, fx + r, NX) + lxx[i * NX + r];
        Qr[i] = dot<NX>(Tr, fx + i, NX) + lxx[r * NX + i];
      }

      // Gains from Q_uu + reg I: column r of K, and u_ff.
      float R[NU * NU], Ri[NU * NU], Kc[NU], u[NU];
#pragma unroll
      for (int i = 0; i < NU * NU; ++i) R[i] = Quu[i];
#pragma unroll
      for (int d = 0; d < NU; ++d) R[d * NU + d] += rg;
      inv<NU>(R, Ri);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Kc[a] = -dot<NU>(Ri + a * NU, Uc, 1);
        u[a] = -dot<NU>(Ri + a * NU, Qu, 1);
        bad |= !isfinite(Kc[a]) || !isfinite(u[a]);
        oK[k * NU * NX + a * NX + r] = Kc[a];
      }
      if (r == 0) {
#pragma unroll
        for (int a = 0; a < NU; ++a) oU[k * NU + a] = u[a];
      }

      // The value update through the stationarity residuals.
      float Wc[NU], w[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        Wc[a] = dot<NU>(Quu + a * NU, Kc, 1) + Uc[a];
        w[a] = dot<NU>(Quu + a * NU, u, 1) + Qu[a];
      }
      vx = qx + dot<NU>(Kc, w, 1) + dot<NU>(Uc, u, 1);
      float Kf[NU * NX], Uf[NU * NX], Wf[NU * NX];
#pragma unroll
      for (int m = 0; m < NX; ++m)
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          Kf[a * NX + m] = from(Kc[a], m, NX);
          Uf[a * NX + m] = from(Uc[a], m, NX);
          Wf[a * NX + m] = from(Wc[a], m, NX);
        }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        // (i, r) and (r, i) of Q_xx + K' W + Q_ux' K.
        const float col =
            Qc[i] + dot<NU>(Wc, Kf + i, NX) + dot<NU>(Kc, Uf + i, NX);
        const float row =
            Qr[i] + dot<NU>(Kc, Wf + i, NX) + dot<NU>(Uc, Kf + i, NX);
        Vc[i] = 0.5f * (col + row);
      }

      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        s1 = fmaf(u[a], Qu[a], s1);
        s2 = fmaf(u[a], w[a] - Qu[a], s2);
      }
      dv1 += s1;
      dv2 += 0.5f * s2;
    }
    fence_async_smem();  // the staged gains are read next by bulk stores
    mbar_arrive(&bar.ofull[o]);
    mbar_arrive(&bar.empty[s]);
  }

  bool any_bad = false;
#pragma unroll
  for (int m = 0; m < NX; ++m) any_bad |= from(bad ? 1.0f : 0.0f, m, NX) != 0.0f;
  if (r == 0 && b < B) {
    dV_out[(size_t)b * 2] = dv1;
    dV_out[(size_t)b * 2 + 1] = dv2;
    ok_out[b] = any_bad ? 0 : 1;
  }
}

template <int NX, int NU>
int run(int B, int N, float reg, const float* reg_b,
        const BatchedExpansion& ex, float* u_ff, float* K, float* dV,
        unsigned char* ok, cudaStream_t stream) {
  using S = Smem<NX, NU>;
  cudaError_t err = cudaFuncSetAttribute(
      batched_riccati_kernel<NX, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + S::kGroups - 1) / S::kGroups;
  batched_riccati_kernel<NX, NU><<<blocks, 64, S::kBytes, stream>>>(
      ex, B, N, reg, reg_b, u_ff, K, dV, ok);
  return static_cast<int>(cudaGetLastError());
}

// ---- The wide form (B4w) ------------------------------------------------

constexpr int kWideChunk = 8;      // steps a stage of the ring
constexpr int kWideStages = 2;     // stages of the ring

// Floats of a run of n floats placed at its phase, 16-byte multiples.
__host__ __device__ __forceinline__ int wide_seg(int n) {
  return (n + 7) / 4 * 4;
}

__host__ __device__ __forceinline__ int wide_width(int f, int nx, int nu) {
  return f == kFx || f == kLxx ? nx * nx
         : f == kFu ? nx * nu
         : f == kLux ? nu * nx
         : f == kLx ? nx
         : f == kLu ? nu
         : nu * nu;
}

// A block's shared memory: the ring's barrier words, then in floats
// kWideStages stages of the ring (each field's run of a chunk, field after
// field, at run-time sizes), then the step's matrices (zero-padded P x P)
// and vectors.
template <int P>
struct WideSmem {
  static constexpr int S = grp::Mat<P>::SIZE;
  enum { kVxx, kFX, kFU, kT, kF, kQux, kQuu, kR, kRi, kK, kW, kX, kMats };
  enum { kVx, kQx, kQu, kU, kWv, kVecs };
  static constexpr int kWork = kMats * S + 8 * P;
  int off[kFields];   // each field's run in a stage
  int stage;          // floats of a stage
  __host__ __device__ WideSmem(int nx, int nu) {
    int o = 0;
    for (int f = 0; f < kFields; ++f) {
      off[f] = o;
      o += wide_seg(kWideChunk * wide_width(f, nx, nu));
    }
    stage = o;
  }
  static constexpr int kBarBytes = 16 * kWideStages;
  __host__ __device__ int bytes() const {
    return kBarBytes + 4 * (kWideStages * stage + kWork);
  }
};

// Producer lane: fill instance b's ring ahead of its compute warp, chunk c
// in stage c % kWideStages, from the end of the horizon.
template <int P>
__device__ void produce_wide(const BatchedExpansion& ex,
                             const WideSmem<P>& S, float* ring,
                             uint64_t* full, uint64_t* empty, int nx, int nu,
                             int b, int N) {
  const int n_chunks = (N + kWideChunk - 1) / kWideChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kWideStages;
    mbar_wait(&empty[s], ((c / kWideStages) & 1) ^ 1);
    const int t_lo = max(0, N - (c + 1) * kWideChunk);
    const int T = N - c * kWideChunk - t_lo;
    const size_t s0 = (size_t)b * N + t_lo;
    float* buf = ring + s * S.stage;
    uint32_t bytes = 0;
    for (int f = 0; f < kFields; ++f) {
      const int w = wide_width(f, nx, nu);
      bytes += load_ends(buf + S.off[f], field(ex, f) + s0 * w, T * w);
    }
    // The plain loads come before the arrival that releases them.
    mbar_arrive_expect_tx(&full[s], bytes);
    for (int f = 0; f < kFields; ++f) {
      const int w = wide_width(f, nx, nu);
      load_mid(buf + S.off[f], field(ex, f) + s0 * w, T * w, &full[s]);
    }
  }
}

template <int P, int U>
__global__ void __launch_bounds__(64)
wide_riccati_kernel(BatchedExpansion ex, int nx, int nu, int N,
                    float reg, const float* __restrict__ reg_b,
                    float* __restrict__ u_ff_out, float* __restrict__ K_out,
                    float* __restrict__ dV_out,
                    unsigned char* __restrict__ ok_out) {
  using M = grp::Mat<P>;
  using W = WideSmem<P>;
  constexpr int LD = M::LD, SZ = M::SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const W S(nx, nu);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + W::kBarBytes);
  const int b = blockIdx.x;
  // kWideStages full barriers (the producer lane's arrival and bytes),
  // then kWideStages empty ones (the compute warp's).
  uint64_t* full = bars;
  uint64_t* empty = bars + kWideStages;
  float* ring = smem;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 32);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the block's only barrier: the mbarriers are ready
  if (threadIdx.x >= 32) {
    if (threadIdx.x == 32)
      produce_wide<P>(ex, S, ring, full, empty, nx, nu, b, N);
    return;
  }

  // The compute warp.
  const grp::Lane ln;
  const int l = ln.l;
  float* wk = ring + kWideStages * S.stage;
  float* Vxx = wk + W::kVxx * SZ;
  float* FX = wk + W::kFX * SZ;
  float* FU = wk + W::kFU * SZ;
  float* Tm = wk + W::kT * SZ;
  float* Fm = wk + W::kF * SZ;
  float* Qux = wk + W::kQux * SZ;
  float* Quu = wk + W::kQuu * SZ;
  float* Rm = wk + W::kR * SZ;
  float* Ri = wk + W::kRi * SZ;
  float* Km = wk + W::kK * SZ;
  float* Wm = wk + W::kW * SZ;
  float* Xm = wk + W::kX * SZ;
  float* vec = wk + W::kMats * SZ;
  float* Vx = vec + W::kVx * P;
  float* Qx = vec + W::kQx * P;
  float* Qu = vec + W::kQu * P;
  float* u = vec + W::kU * P;
  float* w = vec + W::kWv * P;

  // Padding stays zero: clear the work space once, then write real
  // entries only.
  for (int i = l; i < W::kWork; i += 32) wk[i] = 0.0f;
  grp::sync();
  for (int i = l; i < nx * nx; i += 32)
    Vxx[i / nx * LD + i % nx] = ex.v_xx[(size_t)b * nx * nx + i];
  if (l < nx) Vx[l] = ex.v_x[(size_t)b * nx + l];
  const float rg = reg_b != nullptr ? reg_b[b] : reg;
  float dv1 = 0.0f, dv2 = 0.0f;
  bool bad = false;
  grp::sync();

  const int n_chunks = (N + kWideChunk - 1) / kWideChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t_lo = max(0, N - (c + 1) * kWideChunk);
    const int T = N - c * kWideChunk - t_lo;
    const int s = c % kWideStages;
    const float* buf = ring + s * S.stage;
    const size_t s0 = (size_t)b * N + t_lo;
    // Where this chunk's runs sit in their regions (load_ends' phase), in
    // floats from buf.
    int run[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      run[f] = S.off[f] + phase(field(ex, f) + s0 * wide_width(f, nx, nu));
    mbar_wait(&full[s], (c / kWideStages) & 1);
#pragma unroll 1
    for (int k = T - 1; k >= 0; --k) {
      const float* fx = buf + run[kFx] + k * nx * nx;
      const float* fu = buf + run[kFu] + k * nx * nu;
      const float* lx = buf + run[kLx] + k * nx;
      const float* lu = buf + run[kLu] + k * nu;
      const float* lxx = buf + run[kLxx] + k * nx * nx;
      const float* lux = buf + run[kLux] + k * nu * nx;
      const float* luu = buf + run[kLuu] + k * nu * nu;
      const size_t st = s0 + k;
      grp::Tile<P> a, d, q;

      // f_x and f_u into their padded matrices.
      grp::load_raw<P>(ln, fx, nx, nx, a);
      grp::store<P>(ln, a, FX);
      grp::load_raw<P>(ln, fu, nx, nu, a);
      grp::store<P>(ln, a, FU);
      grp::sync();
      // T = f_x' V_xx, F = f_u' V_xx; Q_x = l_x + f_x' V_x (lanes 0..P-1),
      // Q_u = l_u + f_u' V_x (lanes P..2P-1).
      grp::mm<P, true>(ln, FX, Vxx, a);
      grp::store<P>(ln, a, Tm);
      grp::mm<P, true, false, U>(ln, FU, Vxx, a);
      grp::store<P, U>(ln, a, Fm);
      if (l < P) Qx[l] = (l < nx ? lx[l] : 0.0f) + grp::dot_col<P>(FX, l, Vx);
      if (l >= P && l < 2 * P)
        Qu[l - P] = (l - P < nu ? lu[l - P] : 0.0f) +
                    grp::dot_col<P>(FU, l - P, Vx);
      grp::sync();
      // Q_xx = l_xx + T f_x (kept in q), Q_ux = l_ux + F f_x,
      // Q_uu = l_uu + F f_u, R = Q_uu + reg I.
      grp::mm<P>(ln, Tm, FX, q);
      grp::load_raw<P>(ln, lxx, nx, nx, d);
      grp::add<P>(q, d);
      grp::mm<P, false, false, U>(ln, Fm, FX, a);
      grp::load_raw<P>(ln, lux, nu, nx, d);
      grp::add<P>(a, d);
      grp::store<P, U>(ln, a, Qux);
      grp::mm<P, false, false, U>(ln, Fm, FU, a);
      grp::load_raw<P>(ln, luu, nu, nu, d);
      grp::add<P>(a, d);
      grp::store<P, U>(ln, a, Quu);
      grp::add_diag<P>(ln, nu, rg, a);
      grp::store<P, U>(ln, a, Rm);
      grp::sync();
      grp::inv<P>(ln, nu, Rm, Ri);
      // K = -(Q_uu + reg I)^-1 Q_ux, u_ff = -(Q_uu + reg I)^-1 Q_u.
      grp::mm<P, false, false, U, U>(ln, Ri, Qux, a);
#pragma unroll
      for (int t = 0; t < M::R; ++t)
#pragma unroll
        for (int j = 0; j < M::CC; ++j) {
          const int i = ln.rg + 8 * t, jj = M::CC * ln.cg + j;
          a.v[t][j] = -a.v[t][j];
          if (i < nu && jj < nx) {
            K_out[(st * nu + i) * nx + jj] = a.v[t][j];
            bad |= !isfinite(a.v[t][j]);
          }
        }
      grp::store<P, U>(ln, a, Km);
      if (l < P) {
        const float v = -grp::dot_row<P>(Ri, l, Qu);
        u[l] = v;
        if (l < nu) {
          u_ff_out[st * nu + l] = v;
          bad |= !isfinite(v);
        }
      }
      grp::sync();
      // W = Q_uu K + Q_ux, w = Q_u + Q_uu u_ff.
      grp::mm<P, false, false, U, U>(ln, Quu, Km, a);
      grp::load<P>(ln, Qux, d);
      grp::add<P>(a, d);
      grp::store<P, U>(ln, a, Wm);
      if (l < P) w[l] = Qu[l] + grp::dot_row<P>(Quu, l, u);
      grp::sync();
      // V_xx = sym(Q_xx + K' W + Q_ux' K), V_x = Q_x + K' w + Q_ux' u_ff,
      // dV += (u_ff' Q_u, 0.5 u_ff' (w - Q_u)).
      grp::mm<P, true, false, P, U>(ln, Km, Wm, a);
      grp::add<P>(q, a);
      grp::mm<P, true, false, P, U>(ln, Qux, Km, a);
      grp::add<P>(q, a);
      grp::store<P>(ln, q, Xm);
      if (l < P) {
        const float s1 = grp::dot_col<P>(Km, l, w);
        const float s2 = grp::dot_col<P>(Qux, l, u);
        Vx[l] = Qx[l] + s1 + s2;
      }
      if (l == 0) {
        float s1 = 0.0f, s2 = 0.0f;
        for (int i = 0; i < nu; ++i) {
          s1 = fmaf(u[i], Qu[i], s1);
          s2 = fmaf(u[i], w[i] - Qu[i], s2);
        }
        dv1 += s1;
        dv2 += 0.5f * s2;
      }
      grp::sync();
      grp::sym<P>(ln, Xm, Vxx);
    }
    mbar_arrive(&empty[s]);
  }

  const bool any_bad = __ballot_sync(grp::kWarp, bad) != 0u;
  if (l == 0) {
    dV_out[(size_t)b * 2] = dv1;
    dV_out[(size_t)b * 2 + 1] = dv2;
    ok_out[b] = any_bad ? 0 : 1;
  }
}

template <int P, int U>
int run_wide(int nx, int nu, int B, int N, float reg, const float* reg_b,
             const BatchedExpansion& ex, float* u_ff, float* K, float* dV,
             unsigned char* ok, cudaStream_t stream) {
  const int bytes = WideSmem<P>(nx, nu).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wide_riccati_kernel<P, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_riccati_kernel<P, U><<<B, 64, bytes, stream>>>(
      ex, nx, nu, N, reg, reg_b, u_ff, K, dV, ok);
  return static_cast<int>(cudaGetLastError());
}

bool register_shape(int n_x, int n_u) {
  return (n_x == 2 && n_u == 1) || (n_x == 4 && (n_u == 1 || n_u == 2));
}
int wide_pad(int n_x, int n_u) { return n_x <= 8 && n_u <= 8 ? 8 : 16; }

}  // namespace

// Steps per chunk of the register form (for tests that cross the chunk
// edges).
extern "C" int ilqr_batched_riccati_chunk_steps() { return kChunk; }

// Lanes the wide form gives an instance at (n_x, n_u): a warp (0: the
// register form's shapes, whose groups are n_x lanes).
extern "C" int ilqr_batched_riccati_wide_lanes(int n_x, int n_u) {
  return register_shape(n_x, n_u) ? 0 : 32;
}

// The wide form's padded size P at (n_x, n_u) (0: the register form's
// shapes) and the steps of a ring stage (for tests that cross its chunk
// edges).
extern "C" int ilqr_batched_riccati_wide_pad(int n_x, int n_u) {
  return register_shape(n_x, n_u) ? 0 : wide_pad(n_x, n_u);
}
extern "C" int ilqr_batched_riccati_wide_chunk_steps() { return kWideChunk; }

// reg_b (B,), or null for reg shared by every instance; expansion fields
// (B, N, ...) and terminal (B, ...), contiguous; outputs u_ff (B, N, n_u),
// K (B, N, n_u, n_x), dV (B, 2) and ok (B,) bytes (1: every gain of the
// instance finite).  The register form at (2, 1), (4, 1), (4, 2), the wide
// form at every other 1 <= n_x, n_u <= 16.
extern "C" int ilqr_batched_riccati(
    int n_x, int n_u, int B, int N, float reg, const float* reg_b,
    const float* f_x, const float* f_u, const float* l_x, const float* l_u,
    const float* l_xx, const float* l_ux, const float* l_uu, const float* v_x,
    const float* v_xx, float* u_ff, float* K, float* dV, unsigned char* ok,
    void* stream) {
  const BatchedExpansion ex{f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_x == 2 && n_u == 1)
    return run<2, 1>(B, N, reg, reg_b, ex, u_ff, K, dV, ok, s);
  if (n_x == 4 && n_u == 1)
    return run<4, 1>(B, N, reg, reg_b, ex, u_ff, K, dV, ok, s);
  if (n_x == 4 && n_u == 2)
    return run<4, 2>(B, N, reg, reg_b, ex, u_ff, K, dV, ok, s);
  if (n_x < 1 || n_u < 1 || n_x > 16 || n_u > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide_pad(n_x, n_u) == 8)
    return run_wide<8, 8>(n_x, n_u, B, N, reg, reg_b, ex, u_ff, K, dV, ok, s);
  if (n_u <= 8)
    return run_wide<16, 8>(n_x, n_u, B, N, reg, reg_b, ex, u_ff, K, dV, ok,
                           s);
  return run_wide<16, 16>(n_x, n_u, B, N, reg, reg_b, ex, u_ff, K, dV, ok, s);
}
