// Batched sequential Riccati backward pass: B instances, one thread each.
//
// Replaces: ilqr_tpu/ops/pallas_batched.py::_batched_kernel (launcher
// _backward_batched_packed, entry backward_pass_batched).
//
// Math: ilqr_tpu_torch/ops/riccati.py::backward_pass for every instance.
// With V = (V_x, V_xx) from the terminal expansion, t walks N-1 ... 0:
//   Q_x = l_x + f_x' V_x          Q_u = l_u + f_u' V_x
//   Q_xx = l_xx + f_x' V_xx f_x   Q_ux = l_ux + f_u' V_xx f_x
//   Q_uu = l_uu + f_u' V_xx f_u
//   K = -(Q_uu + reg I)^-1 Q_ux,  u_ff = -(Q_uu + reg I)^-1 Q_u
// and the full symmetric value update through the stationarity residuals
// W = Q_uu K + Q_ux and w = Q_u + Q_uu u_ff (regularization enters the gain
// solve only):
//   V_x = Q_x + K' w + Q_ux' u_ff,  V_xx = sym(Q_xx + K' W + Q_ux' K)
//   dV += (u_ff' Q_u, 0.5 u_ff' (w - Q_u)).
//
// What bounds it on an H100: latency.  Each instance is a chain of N
// dependent steps of about 1-2 kflop on ~60 floats of state and inputs; the
// B instances are independent.
//
// Design: one thread per instance holds V_x and V_xx in registers and walks
// its horizon backward; blocks of 32 threads, so B = 1024 instances spread
// over 32 SMs rather than 8.  The TPU kernel put the instances on the
// (8, 128) vector tiles and time on its sequential grid, with the value in
// VMEM scratch; here a loop inside the thread is the sequential axis.  The
// expansion is read in the (B, N, ...) layout that
// ops/linearize.py::linearize_trajectory_batched gives, so neighbouring
// threads read addresses N * F floats apart (uncoalesced); a batch-minor
// layout is later work.  The Q_uu + reg I inverse is the closed form of
// smallmat.cuh.  No padding: threads past B return.
#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace {

using namespace ilqr;

constexpr int kThreads = 32;  // instances per block

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

template <int NX, int NU>
__global__ void __launch_bounds__(kThreads)
batched_riccati_kernel(BatchedExpansion ex, int B, int N,
                       const float* __restrict__ reg,
                       float* __restrict__ u_ff_out, float* __restrict__ K_out,
                       float* __restrict__ dV_out) {
  constexpr int NN = NX * NX;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float V_x[NX], V_xx[NN];
  load<NX>(ex.v_x + (size_t)b * NX, V_x);
  load<NN>(ex.v_xx + (size_t)b * NN, V_xx);
  const float r = reg[b];
  float dv1 = 0.0f, dv2 = 0.0f;
  for (int t = N - 1; t >= 0; --t) {
    const size_t s = (size_t)b * N + t;
    float f_x[NN], f_u[NX * NU];
    load<NN>(ex.f_x + s * NN, f_x);
    load<NX * NU>(ex.f_u + s * NX * NU, f_u);

    // Q-expansion.
    float Q_x[NX], Q_u[NU], fuT_Vxx[NU * NX], T[NN], Q_xx[NN],
        Q_ux[NU * NX], Q_uu[NU * NU];
    mtv<NX, NX>(f_x, V_x, Q_x);
    mtv<NU, NX>(f_u, V_x, Q_u);
    mtm<NU, NX, NX>(f_u, V_xx, fuT_Vxx);
    mtm<NX, NX, NX>(f_x, V_xx, T);
    mm<NX, NX, NX>(T, f_x, Q_xx);
    mm<NU, NX, NX>(fuT_Vxx, f_x, Q_ux);
    mm<NU, NX, NU>(fuT_Vxx, f_u, Q_uu);
#pragma unroll
    for (int i = 0; i < NX; ++i) Q_x[i] += ex.l_x[s * NX + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) Q_u[i] += ex.l_u[s * NU + i];
#pragma unroll
    for (int i = 0; i < NN; ++i) Q_xx[i] += ex.l_xx[s * NN + i];
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) Q_ux[i] += ex.l_ux[s * NU * NX + i];
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) Q_uu[i] += ex.l_uu[s * NU * NU + i];

    // Gains from Q_uu + reg I.
    float R[NU * NU], Ri[NU * NU], K[NU * NX], u[NU];
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) R[i] = Q_uu[i];
#pragma unroll
    for (int d = 0; d < NU; ++d) R[d * NU + d] += r;
    inv<NU>(R, Ri);
    mm<NU, NU, NX>(Ri, Q_ux, K);
    mv<NU, NU>(Ri, Q_u, u);
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) {
      K[i] = -K[i];
      K_out[s * NU * NX + i] = K[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      u[i] = -u[i];
      u_ff_out[s * NU + i] = u[i];
    }

    // Value update through the stationarity residuals.
    float W[NU * NX], w[NU], a1[NX], a2[NX], KtW[NN], QtK[NN];
    mm<NU, NU, NX>(Q_uu, K, W);
    mv<NU, NU>(Q_uu, u, w);
#pragma unroll
    for (int i = 0; i < NU * NX; ++i) W[i] += Q_ux[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) w[i] += Q_u[i];
    mtv<NX, NU>(K, w, a1);
    mtv<NX, NU>(Q_ux, u, a2);
#pragma unroll
    for (int i = 0; i < NX; ++i) V_x[i] = Q_x[i] + a1[i] + a2[i];
    mtm<NX, NU, NX>(K, W, KtW);
    mtm<NX, NU, NX>(Q_ux, K, QtK);
#pragma unroll
    for (int i = 0; i < NN; ++i) T[i] = Q_xx[i] + KtW[i] + QtK[i];
    sym<NX>(T, V_xx);

    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      s1 += u[i] * Q_u[i];
      s2 += u[i] * (w[i] - Q_u[i]);
    }
    dv1 += s1;
    dv2 += 0.5f * s2;
  }
  dV_out[(size_t)b * 2] = dv1;
  dV_out[(size_t)b * 2 + 1] = dv2;
}

template <int NX, int NU>
int run(int B, int N, const float* reg, const BatchedExpansion& ex,
        float* u_ff, float* K, float* dV, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  batched_riccati_kernel<NX, NU><<<blocks, kThreads, 0, stream>>>(
      ex, B, N, reg, u_ff, K, dV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// reg (B,); expansion fields (B, N, ...) and terminal (B, ...), contiguous;
// outputs u_ff (B, N, n_u), K (B, N, n_u, n_x), dV (B, 2).
extern "C" int ilqr_batched_riccati(
    int n_x, int n_u, int B, int N, const float* reg, const float* f_x,
    const float* f_u, const float* l_x, const float* l_u, const float* l_xx,
    const float* l_ux, const float* l_uu, const float* v_x, const float* v_xx,
    float* u_ff, float* K, float* dV, void* stream) {
  const BatchedExpansion ex{f_x, f_u, l_x, l_u, l_xx, l_ux, l_uu, v_x, v_xx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_x == 2 && n_u == 1) return run<2, 1>(B, N, reg, ex, u_ff, K, dV, s);
  if (n_x == 4 && n_u == 1) return run<4, 1>(B, N, reg, ex, u_ff, K, dV, s);
  if (n_x == 4 && n_u == 2) return run<4, 2>(B, N, reg, ex, u_ff, K, dV, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
