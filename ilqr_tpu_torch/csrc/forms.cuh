// The systems the rollout kernels (chain_kernel.cuh; B2, B5) run, as
// "forms": a step, a stage cost and a terminal cost over one state in
// registers, with the parameters each keeps in the block's shared memory.
//
//   QuadraticForm<Model, NX, NU, INTEG>  a register model of models.cuh
//       under integrate<NX, INTEG> and the quadratic costs
//       (models/base.py::quadratic_*_cost);
//   TrackingForm<Base, NXB, NU, INTEG>   <-> models/tracking.py: the state
//       [x; k], the clock k advanced by the integrator on dk/dt = 1/dt (set
//       to k + 1 under 'discrete'), the quadratic cost about the reference
//       row at round(k);
//   RateForm<Base, NXB, NU, INTEG>       <-> models/rate.py: the state
//       [x; u_prev] under the discrete map [step(base, x, u); u], the base's
//       costs plus 0.5 (u - u_prev)' S (u - u_prev) dt;
//   ChainForm<M, NU, INTEG>              <-> models/chain.py: M masses,
//       their diagonal costs;
//   NeuralForm<Base, NX, NU, INTEG>      <-> models/neural.py: a register
//       model plus an MLP residual with tanh hidden layers, under the
//       explicit rules ('discrete' too over LTI), the base's quadratic
//       costs.
//
// A form provides
//   kForm = true; kSmem: floats it keeps in shared memory; kWork: floats of
//   shared memory for each lane (integrate_work); params_ok(n): whether a
//   buffer of n floats has its layout (host); fill(params, sm): the
//   block's copy into sm, by all threads before the block's barrier;
//   load(params, sm); step(x, u, xn, newton_iters, work); stage(x, u);
//   terminal(x).
// Parameter buffers are written by ilqr_tpu_torch/ops/fused_rollout.py::
// params_buffer; change both sides together.
#pragma once

#include <type_traits>

#include "models.cuh"

namespace ilqr {

// Floats of shared memory a register model keeps (LtiRegs above n_x = 4),
// 0 for the models that keep none.  A model that declares kSmem loads
// from (its block, its shared copy), the rest from their block.
template <class M, class = void>
struct ModelSmem {
  static constexpr bool kDeclared = false;
  static constexpr int value = 0;
};
template <class M>
struct ModelSmem<M, std::void_t<decltype(M::kSmem)>> {
  static constexpr bool kDeclared = true;
  static constexpr int value = M::kSmem;
};

template <class M>
__device__ __forceinline__ void load_model(M& m, const float* p,
                                           const float* sm) {
  if constexpr (ModelSmem<M>::kDeclared) {
    m.load(p, sm);
  } else {
    m.load(p);
  }
}

// v' M v with M read volatile from shared memory (a copy that every lane
// reads at one address; hoisted out of the time loop it would spill).
template <int N>
__device__ __forceinline__ float quad_form_shared(const float* v,
                                                  const float* M) {
  const volatile float* c = M;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s += v[i] * c[i * N + j] * v[j];
  return s;
}

// A register model under integrate<NX, INTEG> and the quadratic costs.
// Shared memory: the stage cost's x_target, Q, R where kCostShared, then
// the model's own (LtiRegs).
template <class Model, int NX, int NU, int INTEG>
struct QuadraticForm {
  using L = ParamLayout<NX, NU>;
  static constexpr bool kForm = true;
  static constexpr int kCostSmem = kCostShared<NX> ? cost_floats<NX, NU>()
                                                   : 0;
  static constexpr int kSmem = kCostSmem + ModelSmem<Model>::value;
  static constexpr int kWork = integrate_work<NX, INTEG>();
  static bool params_ok(int n) { return n == L::kModel + Model::kParams; }

  Model model;
  std::conditional_t<kCostShared<NX>, StageCostShared<NX, NU>,
                     StageCostRegs<NX, NU>>
      cost;
  const float* p;

  static __device__ __forceinline__ void fill(const float* params,
                                              float* sm) {
    if constexpr (kCostShared<NX>) StageCostShared<NX, NU>::fill(params, sm);
    if constexpr (ModelSmem<Model>::value > 0)
      Model::fill(params + L::kModel, sm + kCostSmem);
  }
  __device__ __forceinline__ void load(const float* params, const float* sm) {
    load_model(model, params + L::kModel, sm + kCostSmem);
    if constexpr (kCostShared<NX>) {
      cost.load(params, sm);
    } else {
      cost.load(params);
    }
    p = params;
  }
  __device__ __forceinline__ void step(const float* x, const float* u,
                                       float* xn, int newton_iters,
                                       float* work) const {
    integrate<NX, INTEG>(
        [&](const auto* xs, auto* xdot) { model.f(xs, u, xdot); }, cost.dt,
        x, xn, newton_iters, work);
  }
  __device__ __forceinline__ float stage(const float* x,
                                         const float* u) const {
    return cost(x, u);
  }
  __device__ __forceinline__ float terminal(const float* x) const {
    return terminal_cost<NX, NU>(p, x);
  }
};

// The tracking wrapper over a register model Base (NXB states) under
// INTEG (explicit or 'discrete').  Buffer: [dt, n_xref, n_uref, Q (NXB^2),
// R (NU^2), Q_f (NXB^2), the base's model block, X_ref (n_xref x NXB),
// U_ref (n_uref x NU)]; the row counts as floats (exact below 2^24).  The
// reference rows stay in device memory: the stage cost reads the row at
// the state's clock, i = clip(round(k), 0, n_xref - 1) (round half to
// even, as torch.round) and i_u = min(i, n_uref - 1), as
// models/tracking.py::stage_cost gathers them.  Q and R are registers up to
// NXB = 4, else a shared copy.
template <class Base, int NXB, int NU, int INTEG>
struct TrackingForm {
  static constexpr bool kForm = true;
  static constexpr int NX = NXB + 1;
  static constexpr int kQ = 3;
  static constexpr int kR = kQ + NXB * NXB;
  static constexpr int kQf = kR + NU * NU;
  static constexpr int kBase = kQf + NXB * NXB;
  static constexpr int kRef = kBase + Base::kParams;
  static constexpr bool kShared = NXB > 4;
  static constexpr int kCostSmem = kShared ? NXB * NXB + NU * NU : 0;
  static constexpr int kSmem = kCostSmem + ModelSmem<Base>::value;
  static constexpr int kWork = 0;
  static_assert(INTEG != kBackwardEuler && INTEG != kTrapezoidal,
                "the tracking form runs the explicit rules and 'discrete'");
  static bool params_ok(int n) { return n >= kRef + NXB + NU; }

  Base base;
  float dt, inv_dt;
  int n_xref, n_uref;
  const float* x_ref;
  const float* u_ref;
  const float* Q_f;
  float QR[kShared ? 1 : NXB * NXB + NU * NU];
  const float* qr_sm;

  static __device__ __forceinline__ void fill(const float* p, float* sm) {
    for (int i = threadIdx.x; i < kCostSmem; i += blockDim.x)
      sm[i] = p[kQ + i];
    if constexpr (ModelSmem<Base>::value > 0)
      Base::fill(p + kBase, sm + kCostSmem);
  }
  __device__ __forceinline__ void load(const float* p, const float* sm) {
    load_model(base, p + kBase, sm + kCostSmem);
    dt = p[0];
    inv_dt = 1.0f / dt;   // torch.ones_like(k) / dt: an IEEE quotient
    n_xref = static_cast<int>(p[1]);
    n_uref = static_cast<int>(p[2]);
    x_ref = p + kRef;
    u_ref = x_ref + n_xref * NXB;
    Q_f = p + kQf;
    if constexpr (kShared) {
      qr_sm = sm;
    } else {
#pragma unroll
      for (int i = 0; i < NXB * NXB + NU * NU; ++i) QR[i] = p[kQ + i];
    }
  }
  __device__ __forceinline__ void step(const float* x, const float* u,
                                       float* xn, int newton_iters,
                                       float* work) const {
    integrate<NX, INTEG>(
        [&](const auto* xs, auto* xdot) {
          base.f(xs, u, xdot);
          if constexpr (INTEG == kDiscrete) {
            xdot[NXB] = xs[NXB] + 1.0f;
          } else {
            xdot[NXB] = inv_dt;
          }
        },
        dt, x, xn, newton_iters, work);
  }
  __device__ __forceinline__ float stage(const float* x,
                                         const float* u) const {
    const float k = fminf(fmaxf(rintf(x[NXB]), 0.0f),
                          static_cast<float>(n_xref - 1));
    const int i = static_cast<int>(k);
    const int iu = min(i, n_uref - 1);
    float dx[NXB], du[NU];
#pragma unroll
    for (int j = 0; j < NXB; ++j) dx[j] = x[j] - x_ref[i * NXB + j];
#pragma unroll
    for (int j = 0; j < NU; ++j) du[j] = u[j] - u_ref[iu * NU + j];
    float q, r;
    if constexpr (kShared) {
      q = quad_form_shared<NXB>(dx, qr_sm);
      r = quad_form_shared<NU>(du, qr_sm + NXB * NXB);
    } else {
      q = quad_form<NXB>(dx, QR);
      r = quad_form<NU>(du, QR + NXB * NXB);
    }
    return 0.5f * (q + r) * dt;
  }
  __device__ __forceinline__ float terminal(const float* x) const {
    float dx[NXB];
#pragma unroll
    for (int j = 0; j < NXB; ++j)
      dx[j] = x[j] - x_ref[(n_xref - 1) * NXB + j];
    return 0.5f * quad_form<NXB>(dx, Q_f);
  }
};

// The rate wrapper over a register model Base (NXB states) whose own
// integrator is INTEG (explicit or 'discrete'); the wrapper's map is the
// 'discrete' one.  Buffer: the base's [dt, x_target, Q, R, Q_f, model
// block], then S (NU x NU).
template <class Base, int NXB, int NU, int INTEG>
struct RateForm {
  using B = QuadraticForm<Base, NXB, NU, INTEG>;
  static constexpr bool kForm = true;
  static constexpr int NX = NXB + NU;
  static constexpr int kS = B::L::kModel + Base::kParams;
  static constexpr int kSmem = B::kSmem;
  static constexpr int kWork = B::kWork;
  static bool params_ok(int n) { return B::params_ok(n - NU * NU); }

  B base;
  float S[NU * NU];

  static __device__ __forceinline__ void fill(const float* p, float* sm) {
    B::fill(p, sm);
  }
  __device__ __forceinline__ void load(const float* p, const float* sm) {
    base.load(p, sm);
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) S[i] = p[kS + i];
  }
  __device__ __forceinline__ void step(const float* x, const float* u,
                                       float* xn, int newton_iters,
                                       float* work) const {
    base.step(x, u, xn, newton_iters, work);
#pragma unroll
    for (int j = 0; j < NU; ++j) xn[NXB + j] = u[j];
  }
  __device__ __forceinline__ float stage(const float* x,
                                         const float* u) const {
    float du[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) du[j] = u[j] - x[NXB + j];
    return base.stage(x, u) + 0.5f * quad_form<NU>(du, S) * base.cost.dt;
  }
  __device__ __forceinline__ float terminal(const float* x) const {
    return base.terminal(x);
  }
};

// The spring chain of M masses, x = (q, qdot):
//   qdd_i = -k (2 q_i - q_{i-1} - q_{i+1}) - c qd_i - s sin(q_i) + (S u)_i
// with walls at both ends.  Buffer: [dt, k, c, s, wq, wv, wu, wqf, wvf,
// q_target (M), S (M x NU)].  S sits in shared memory and S u is formed
// once a step (the control is held over the step's evaluations).  Its own
// diagonal costs:
//   l = 0.5 dt (wq |q - q_target|^2 + wv |qd|^2 + wu |u|^2),
//   l_f = 0.5 (wqf |q - q_target|^2 + wvf |qd|^2).
template <int M, int NU, int INTEG>
struct ChainForm {
  static constexpr bool kForm = true;
  static constexpr int NX = 2 * M;
  static constexpr int kTarget = 9;
  static constexpr int kS = kTarget + M;
  static constexpr int kSmem = M * NU;
  static constexpr int kWork = 0;
  static_assert(INTEG == kEuler || INTEG == kMidpoint || INTEG == kRk4,
                "the chain runs the explicit rules");
  static bool params_ok(int n) { return n == kS + M * NU; }

  float dt, k, c, s, wq, wv, wu, wqf, wvf, q_target[M];
  const float* S;

  static __device__ __forceinline__ void fill(const float* p, float* sm) {
    for (int i = threadIdx.x; i < kSmem; i += blockDim.x) sm[i] = p[kS + i];
  }
  __device__ __forceinline__ void load(const float* p, const float* sm) {
    dt = p[0];
    k = p[1];
    c = p[2];
    s = p[3];
    wq = p[4];
    wv = p[5];
    wu = p[6];
    wqf = p[7];
    wvf = p[8];
#pragma unroll
    for (int i = 0; i < M; ++i) q_target[i] = p[kTarget + i];
    S = sm;
  }
  __device__ __forceinline__ void step(const float* x, const float* u,
                                       float* xn, int newton_iters,
                                       float* work) const {
    const volatile float* Sv = S;
    float su[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float a = 0.0f;
#pragma unroll
      for (int j = 0; j < NU; ++j) a += Sv[i * NU + j] * u[j];
      su[i] = a;
    }
    const float nk = -k;
    integrate<NX, INTEG>(
        [&](const float* xs, float* xdot) {
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const float left = i > 0 ? xs[i - 1] : 0.0f;
            const float right = i + 1 < M ? xs[i + 1] : 0.0f;
            const float q = xs[i], qd = xs[M + i];
            xdot[i] = qd;
            xdot[M + i] = nk * ((q + q) - left - right) - c * qd -
                          s * sinf(q) + su[i];
          }
        },
        dt, x, xn, newton_iters, work);
  }
  __device__ __forceinline__ float stage(const float* x,
                                         const float* u) const {
    float dq = 0.0f, v = 0.0f, uu = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float d = x[i] - q_target[i];
      dq += d * d;
      v += x[M + i] * x[M + i];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) uu += u[j] * u[j];
    return 0.5f * dt * (wq * dq + wv * v + wu * uu);
  }
  __device__ __forceinline__ float terminal(const float* x) const {
    float dq = 0.0f, v = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float d = x[i] - q_target[i];
      dq += d * d;
      v += x[M + i] * x[M + i];
    }
    return 0.5f * (wqf * dq + wvf * v);
  }
};

// The caps of NeuralForm's MLP (ops/fused_rollout.py, NEURAL_MAX_HIDDEN
// and NEURAL_MAX_WIDTH; the inputs are n_x + n_u <= 20 by the register
// models).
constexpr int kNeuralMaxHidden = 4;
constexpr int kNeuralMaxWidth = 64;

// A register model Base plus an MLP residual on its continuous dynamics,
//   xdot = f_base(x, u) + W_L' tanh(... tanh(W_0' [x; u] + b_0) ...) + b_L,
// under INTEG (explicit, or 'discrete' where the map is f itself), the
// base's quadratic costs.  Buffer: the base's [dt, x_target, Q, R, Q_f,
// model block], then [L (layers, the output's included), widths w_0 =
// NX + NU, w_1 ... w_L = NX, then W_l (w_l x w_{l+1}, row-major) and b_l
// (w_{l+1}) of each layer], the counts as floats.  The header and the
// weights sit in the block's shared memory (kSmem covers the caps: at most
// kNeuralMaxHidden hidden layers of at most kNeuralMaxWidth units), read by
// every lane at one address; a lane keeps the hidden activations in its
// shared work, two buffers of kNeuralMaxWidth entries kWorkStride apart
// (at width 64 they would spill from registers).  Each neuron sums its
// inputs in order, then adds its bias; tanhf is the accurate one.
template <class Base, int NX, int NU, int INTEG>
struct NeuralForm {
  using B = QuadraticForm<Base, NX, NU, INTEG>;
  static constexpr bool kForm = true;
  static constexpr int NI = NX + NU;
  static constexpr int H = kNeuralMaxHidden;
  static constexpr int W = kNeuralMaxWidth;
  static constexpr int kMlp = B::L::kModel + Base::kParams;
  static constexpr int kHdr = H + 3;  // L, w_0 ... w_{H+1}
  static constexpr int kWeights =
      (NI + 1) * W + (H - 1) * (W + 1) * W + (W + 1) * NX;
  static constexpr int kSmem = B::kSmem + kHdr + kWeights;
  static constexpr int kWork = 2 * W;
  static_assert(INTEG != kBackwardEuler && INTEG != kTrapezoidal,
                "the neural form runs the explicit rules and 'discrete'");
  static_assert(NI <= 20, "the inputs of the neural form's MLP");
  static bool params_ok(int n) {
    return n >= kMlp + 3 + (NI + 1) * NX && n <= kMlp + kHdr + kWeights;
  }

  B base;
  int n_layers;
  const float* hdr;  // the shared copy of the header, then the weights

  // The header's layer count and hidden widths, clamped to the caps (the
  // host refuses larger MLPs; a clamped read stays inside kSmem).
  static __device__ __forceinline__ int layers_of(float l) {
    return min(max(static_cast<int>(l), 1), H + 1);
  }
  static __device__ __forceinline__ int width_of(float w) {
    return min(max(static_cast<int>(w), 1), W);
  }
  static __device__ __forceinline__ void fill(const float* p, float* sm) {
    B::fill(p, sm);
    const float* m = p + kMlp;
    const int L = layers_of(m[0]);
    int n = 0, fi = NI;  // the weights' floats
    for (int l = 0; l < L; ++l) {
      const int fo = l == L - 1 ? NX : width_of(m[2 + l]);
      n += (fi + 1) * fo;
      fi = fo;
    }
    float* s = sm + B::kSmem;
    for (int i = threadIdx.x; i < L + 2; i += blockDim.x) s[i] = m[i];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s[kHdr + i] = m[L + 2 + i];
  }
  __device__ __forceinline__ void load(const float* p, const float* sm) {
    base.load(p, sm);
    hdr = sm + B::kSmem;
    n_layers = layers_of(hdr[0]);
  }
  __device__ __forceinline__ int width(int l) const {
    return l == 0 ? NI : l == n_layers ? NX : width_of(hdr[1 + l]);
  }
  // out = MLP([x; u]); work: the lane's two activation buffers.
  __device__ __forceinline__ void mlp(const float* x, const float* u,
                                      float* out, float* work) const {
    const float* w = hdr + kHdr;
    float z[NI];
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) z[NX + i] = u[i];
    const int L = n_layers;
    int off = 0;
#pragma unroll 1
    for (int l = 0; l < L - 1; ++l) {
      const int fi = width(l), fo = width(l + 1);
      const float* src = work + ((l + 1) & 1) * W * kWorkStride;
      float* dst = work + (l & 1) * W * kWorkStride;
#pragma unroll 1
      for (int j = 0; j < fo; ++j) {
        float a = 0.0f;
        if (l == 0) {
#pragma unroll
          for (int i = 0; i < NI; ++i) a += z[i] * w[off + i * fo + j];
        } else {
#pragma unroll 4
          for (int i = 0; i < fi; ++i)
            a += src[i * kWorkStride] * w[off + i * fo + j];
        }
        dst[j * kWorkStride] = tanhf(a + w[off + fi * fo + j]);
      }
      off += (fi + 1) * fo;
    }
    float o[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) o[k] = 0.0f;
    const int fi = width(L - 1);
    if (L == 1) {
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int k = 0; k < NX; ++k) o[k] += z[i] * w[i * NX + k];
    } else {
      const float* src = work + (L & 1) * W * kWorkStride;
#pragma unroll 1
      for (int i = 0; i < fi; ++i) {
        const float a = src[i * kWorkStride];
#pragma unroll
        for (int k = 0; k < NX; ++k) o[k] += a * w[off + i * NX + k];
      }
    }
#pragma unroll
    for (int k = 0; k < NX; ++k) out[k] = o[k] + w[off + fi * NX + k];
  }
  __device__ __forceinline__ void step(const float* x, const float* u,
                                       float* xn, int newton_iters,
                                       float* work) const {
    integrate<NX, INTEG>(
        [&](const float* xs, float* xdot) {
          float r[NX];
          base.model.f(xs, u, xdot);
          mlp(xs, u, r, work);
#pragma unroll
          for (int i = 0; i < NX; ++i) xdot[i] = xdot[i] + r[i];
        },
        base.cost.dt, x, xn, newton_iters, nullptr);
  }
  __device__ __forceinline__ float stage(const float* x,
                                         const float* u) const {
    return base.stage(x, u);
  }
  __device__ __forceinline__ float terminal(const float* x) const {
    return base.terminal(x);
  }
};

}  // namespace ilqr
