// Shared ham_soft physics of the CUDA kernels, as __device__ functions.
//
// The port of _build_physics of nbodysimproject_tpu/ops/pallas_hamsoft.py
// (:44-489): pair distances, the 8 clipped SPH iterations with the softmin
// eps* and the hand-written reverse sweep for its exact gradient, the
// soft-wall force, the reflection fold, the spring half-flow S(h/2), the
// gravity half-kick V(h/2) and the Strang trip, one thread per system.
// Included by hamsoft_multistep.cu (its one-thread layout, N = 3) and
// eps_grad.cu, and through hamsoft_physics_warp.cuh by hamsoft.cu and
// hamsoft_multistep.cu's warp layout (N = 4 and 8), so the kernels share
// one copy of the physics and each kernel family still builds in its own
// nvcc process.
//
// Built without --use_fast_math: the softmin's expf/logf and the small-
// theta series need IEEE float32.  maxf/minf below propagate NaN like
// jnp.maximum/jnp.minimum (fmaxf would drop it).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {


constexpr float kInvPi = 0.31830987f;  // float32(1 / pi)
constexpr int kIters = 8;               // SPH iterations, no convergence freeze

__device__ __forceinline__ float maxf(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float minf(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return minf(maxf(x, lo), hi);
}
__device__ __forceinline__ bool finitef(float x) { return isfinite(x); }

template <int N>
__host__ __device__ constexpr int pidx(int i, int j) {  // i < j
  return i * (2 * N - i - 1) / 2 + (j - i - 1);
}

// Per-system constants of the physics (the Pallas kernel's closure).
template <int N>
struct Sys {
  float mass[N], mval[N], inv_m[N];
  bool valid[N];
  float k_s, mu, alpha, flo, cap, eps_seed;
  float G, k_wall, eta, jcap;
  int bexp;
  bool barrier_on;
};

template <int N, int D>
__device__ __forceinline__ void pair_r2(const float* pos, float* r2) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float dx = pos[i * D + a] - pos[j * D + a];
        acc = acc + dx * dx;
      }
      r2[pidx<N>(i, j)] = acc;
    }
}

// eps* and its exact gradient: the 8 clipped SPH iterations from the
// kernel-entry eps (_solve_iterates), the softmin (eps_star_of) and the
// hand-written reverse sweep through the truncated map (_exact_grad).
// The forward pass keeps, from each iterate k and body i, the kernel
// terms W_ij, dS_i/dh, -G_raw / (2 S_i) (where the clip gate is open),
// the clip gate and -2 / h^2: the reverse sweep then runs no expf, no
// square root and no division, and since each kept term is the
// expression a recomputing sweep would evaluate on the same operands,
// the gradient has the same bits.
template <int N, int D>
__device__ __forceinline__ void eps_star_and_grad(const Sys<N>& s,
                                                  const float* pos,
                                                  float& es, float* g) {
  constexpr int NP = N * (N - 1) / 2;
  constexpr int NJ = N > 1 ? N - 1 : 1;  // slot of j != i: j - (j > i)
  float r2[NP > 0 ? NP : 1];
  pair_r2<N, D>(pos, r2);

  float W[kIters][N][NJ];
  float Sd[kIters][N], X[kIters][N], M2[kIters][N];
  unsigned gate[(kIters * N + 31) / 32];  // bit k N + i: flo < G_raw < cap
#pragma unroll
  for (int w = 0; w < (kIters * N + 31) / 32; ++w) gate[w] = 0u;
  float h[N];
  const float h0 = clipf(s.eps_seed, s.flo, s.cap);
#pragma unroll
  for (int i = 0; i < N; ++i) h[i] = h0;
#pragma unroll
  for (int k = 0; k < kIters; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float ih2 = 1.f / maxf(h[i] * h[i], 1e-24f);
      const float inv_hs = 1.f / maxf(h[i], 1e-12f);
      float S = 0.f, sd = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        float r = r2[i < j ? pidx<N>(i, j) : pidx<N>(j, i)];
        float w = kInvPi * ih2 * expf(-r * ih2);
        W[k][i][j - (j > i)] = w;
        S = S + s.mval[j] * w;
        sd = sd + s.mval[j] * w * (-2.f + 2.f * r * ih2) * inv_hs;
      }
      const float Ssafe = maxf(S, 1e-30f);
      const float G_raw = s.eta * sqrtf(s.mval[i] / Ssafe);
      const int bit = k * N + i;
      const bool open = (G_raw > s.flo) && (G_raw < s.cap);
      gate[bit / 32] |= open ? (1u << (bit % 32)) : 0u;
      // X feeds only c = u X where the clip gate is open; where it is
      // shut c is 0 (the recomputing sweep's 0 X is a zero of either
      // sign, or a NaN its finite guard zeroes, and a zero term changes
      // no bit of g), so the division is skipped there: on a saturated
      // system (S ~ 0) it overflows into IEEE division's slow path
      if (open)
        X[k][i] = -G_raw / (2.f * Ssafe);
      else
        X[k][i] = 0.f;
      Sd[k][i] = sd;
      M2[k][i] = -2.f * ih2;
      h[i] = clipf(G_raw, s.flo, s.cap);
    }

  // softmin over the valid bodies, with its weights d es / d h_i
  float t[N], u[N];
  float tmax = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = s.valid[i] ? -h[i] / s.alpha : -1e30f;
    tmax = (i == 0) ? t[0] : maxf(tmax, t[i]);
  }
  float ssum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) ssum = ssum + expf(t[i] - tmax);
  es = -s.alpha * (tmax + logf(ssum));
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = expf(t[i] - tmax) / ssum;

  // reverse sweep: h_k = clip(G_i(h_{k-1})) has a diagonal Jacobian, so
  // the cotangent on h stays per body
#pragma unroll
  for (int a = 0; a < N * D; ++a) g[a] = 0.f;
#pragma unroll
  for (int k = kIters - 1; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int bit = k * N + i;
      float c = ((gate[bit / 32] >> (bit % 32)) & 1u) ? u[i] * X[k][i] : 0.f;
      // the float32 backward overflows on saturated lanes, where the
      // true gradient is exactly zero
      c = finitef(c) ? c : 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        float coeff = c * s.mval[j] * W[k][i][j - (j > i)] * M2[k][i];
#pragma unroll
        for (int a = 0; a < D; ++a) {
          float d = pos[i * D + a] - pos[j * D + a];
          g[i * D + a] = g[i * D + a] + coeff * d;
          g[j * D + a] = g[j * D + a] - coeff * d;
        }
      }
      u[i] = c * Sd[k][i];
    }
  }
#pragma unroll
  for (int a = 0; a < N * D; ++a)
    g[a] = (s.valid[a / D] && finitef(g[a])) ? g[a] : 0.f;
}

// soft-wall force on eps (ops/barrier.py)
template <int N>
__device__ __forceinline__ float bar_force(const Sys<N>& s, float e) {
  float left = maxf(0.f, s.flo - e);
  float right = maxf(0.f, e - s.cap);
  float le = 1.f, re = 1.f;
  for (int k = 0; k < s.bexp - 2; ++k) {
    le = le * left;
    re = re * right;
  }
  return s.k_wall * (le - re);
}

// Closed-form reflection fold of (eps, pi) into [flo, cap]: the
// period-2(cap - flo) triangle map, pi flipped on odd reflections
// (ops/reflection.py:19-35, the Pallas kernel's fold).  (eps, pi) are
// per system, so the lane-split physics folds them as they are.
__device__ __forceinline__ void fold_eps(float flo, float cap, float& e,
                                         float& p) {
  float R = cap - flo;
  float Pw = 2.f * R;
  float Psafe = Pw > 0.f ? Pw : 1.f;
  float x = e - flo;
  float y = x - Psafe * floorf(x / Psafe);
  y = Pw > 0.f ? y : 0.f;
  bool on_up = y <= R;
  float e_out = on_up ? flo + y : cap - (y - R);
  float p_out = on_up ? p : -p;
  bool ok = finitef(R) && R > 0.f;
  e = ok ? e_out : flo;
  p = ok ? p_out : -p;
}

// S(h/2): exact spring rotation of (eps - eps*, pi) with the J-capped
// momentum impulse (hamsoft.spring_half_cached); REFL folds (eps, pi)
// before and after it (the reflection policy).
template <int N, int D, bool REFL = false>
__device__ __forceinline__ void s_half(const Sys<N>& s, float* vel, float& eps,
                                       float& pi, float es, const float* grad,
                                       float hh) {
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
  float dt_f = 0.5f * hh;
  float omega = sqrtf(s.k_s / s.mu);
  float theta = omega * dt_f;
  float th2 = theta * theta;
  float s_ser = theta * (1.f - th2 / 6.f * (1.f - th2 / 20.f));
  float c_ser = 1.f - th2 / 2.f * (1.f - th2 / 12.f);
  bool small = fabsf(theta) < 1e-8f;
  float sin_t = small ? s_ser : sinf(theta);
  float cos_t = small ? c_ser : cosf(theta);

  float pi_in = s.barrier_on ? pi + 0.5f * dt_f * bar_force<N>(s, eps) : pi;
  float Delta0 = eps - es;
  float mu_om = sqrtf(s.mu * s.k_s);
  float delta_t = Delta0 * cos_t + (pi_in / (s.mu * omega)) * sin_t;
  float eta_t = pi_in * cos_t - mu_om * Delta0 * sin_t;
  float I_tau = (Delta0 / omega) * sin_t +
                (pi_in / (s.mu * omega * omega)) * (1.f - cos_t);
  float eps_new = es + delta_t;
  float pi_new =
      s.barrier_on ? eta_t + 0.5f * dt_f * bar_force<N>(s, eps_new) : eta_t;

  // J-cap (hamsoft_flows.py:692-738)
  float J = s.k_s * I_tau;
  float absJ = fabsf(J);
  float p_scale = 0.f, dp_inf = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p2 = 0.f, g2 = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float pv = s.mass[i] * vel[i * D + a];
      p2 = p2 + pv * pv;
      float gg = grad[i * D + a];
      g2 = g2 + gg * gg;
    }
    p_scale = maxf(p_scale, s.valid[i] ? sqrtf(p2) : 0.f);
    dp_inf = maxf(dp_inf, s.valid[i] ? absJ * sqrtf(g2) : 0.f);
  }
  p_scale = maxf(p_scale, 1e-12f);
  float thr = s.jcap * p_scale;
  float scale = (dp_inf > thr) ? thr / maxf(dp_inf, 1e-30f) : 1.f;
  float Ja = J * scale;
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + Ja * grad[k] * s.inv_m[k / D];
  if (REFL) fold_eps(s.flo, s.cap, eps_new, pi_new);
  eps = eps_new;
  pi = pi_new;
}

// V(h/2): softened gravity kick on p and the dV/deps kick on pi
template <int N, int D>
__device__ __forceinline__ void v_half_kick(const Sys<N>& s, const float* pos,
                                            float* vel, float eps, float& pi,
                                            float hh) {
  float h2 = 0.5f * hh;
  float eps2 = eps * eps;
  float acc[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) acc[k] = 0.f;
  float ddU = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float r2 = eps2;
      float dx[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        dx[a] = pos[i * D + a] - pos[j * D + a];
        r2 = r2 + dx[a] * dx[a];
      }
      float inv_r = rsqrtf(r2);
      float w = inv_r * inv_r * inv_r;
      float pairm = (s.valid[i] && s.valid[j]) ? s.mass[i] * s.mass[j] : 0.f;
      ddU = ddU + pairm * w;
      float wi = (s.valid[j] ? s.mass[j] : 0.f) * w;
      float wj = (s.valid[i] ? s.mass[i] : 0.f) * w;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        acc[i * D + a] = acc[i * D + a] - wi * dx[a];
        acc[j * D + a] = acc[j * D + a] + wj * dx[a];
      }
    }
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + h2 * s.G * acc[k];
  float dU = s.G * eps * ddU;
  pi = s.barrier_on ? pi - h2 * (dU - bar_force<N>(s, eps)) : pi - h2 * dU;
}

// One Strang substep S V T V S; the (eps*, grad) cache carries across the
// trailing-S/leading-S boundary (identical q).  REFL (the reflection
// policy) folds (eps, pi) around the substep as well as around each S.
template <int N, int D, bool REFL = false>
__device__ __forceinline__ void strang_trip(const Sys<N>& s, float* pos,
                                            float* vel, float& eps, float& pi,
                                            float& es, float* grad, float h) {
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
  s_half<N, D, REFL>(s, vel, eps, pi, es, grad, h);
  v_half_kick<N, D>(s, pos, vel, eps, pi, h);
#pragma unroll
  for (int k = 0; k < N * D; ++k) pos[k] = pos[k] + h * vel[k];
  v_half_kick<N, D>(s, pos, vel, eps, pi, h);
  eps_star_and_grad<N, D>(s, pos, es, grad);
  s_half<N, D, REFL>(s, vel, eps, pi, es, grad, h);
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
}

template <int N, int D>
__device__ __forceinline__ void load_system(
    int b, int B, const float* pos, const float* vel, const float* mass,
    const float* k_s, const float* mu, const float* alpha, const float* flo,
    const float* cap, const float* eps, float G, float k_wall, float eta,
    float jcap, int bexp, int barrier_on, Sys<N>& s, float* q, float* v) {
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    q[k] = pos[k * B + b];
    v[k] = vel[k * B + b];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float m = mass[i * B + b];
    s.mass[i] = m;
    s.valid[i] = m > 0.f;
    s.mval[i] = s.valid[i] ? m : 0.f;
    s.inv_m[i] = s.valid[i] ? 1.f / maxf(m, 1e-30f) : 0.f;
  }
  s.k_s = k_s[b];
  s.mu = mu[b];
  s.alpha = alpha[b];
  s.flo = flo[b];
  s.cap = cap[b];
  s.eps_seed = eps[b];
  s.G = G;
  s.k_wall = k_wall;
  s.eta = eta;
  s.jcap = jcap;
  s.bexp = bexp;
  s.barrier_on = barrier_on != 0;
}

}  // namespace
