// Shared ham_soft physics of the CUDA kernels, as __device__ functions.
//
// The port of _build_physics of nbodysimproject_tpu/ops/pallas_hamsoft.py
// (:44-489): pair distances, the 8 clipped SPH iterations with the softmin
// eps* and the hand-written reverse sweep for its exact gradient, the
// soft-wall force, the reflection fold, the spring half-flow S(h/2), the
// gravity half-kick V(h/2) and the Strang trip, one thread per system;
// and the "reference" gradient's degeneracy fallback (reference_switch,
// compiled only where a kernel's REF template argument asks for it).
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
  float lam;  // the legacy gradient's strength (the "reference" fallback)
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
// the gradient has the same bits.  REF also hands out the final iterate
// h_i and the softmin's weights d es / d h_i, which the "reference"
// fallback (reference_switch) reads.
template <int N, int D, bool REF = false>
__device__ __forceinline__ void eps_star_and_grad(const Sys<N>& s,
                                                  const float* pos,
                                                  float& es, float* g,
                                                  float* h_fin = nullptr,
                                                  float* w_fin = nullptr) {
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
  if constexpr (REF) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      h_fin[i] = h[i];
      w_fin[i] = u[i];
    }
  }

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

// ---- the "reference" gradient's fallback (_build_physics :179-307) ----
//
// Where the exact gradient degenerates (its largest valid row norm
// <= 1e-12, or <= 1e-9 times the median pair distance), the Omega-
// corrected SPH gradient on the final iterate takes its place, its sign
// aligned against the legacy harmonic-mean gradient's.  Every sum is
// taken in the order of the TPU kernel's loops, which the lane layouts
// (hamsoft_physics_warp.cuh, eps_grad.cu) follow bit for bit.

// rmax: the largest valid pair distance, a bound on the median that
// decides most systems without it (the median lies between the smallest
// and the largest distance, and 1e-9 x rounds monotonically)
template <int N>
__device__ __forceinline__ float pair_r_max(const Sys<N>& s,
                                            const float* r2) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j)
      m = (s.valid[i] && s.valid[j]) ? maxf(m, r2[pidx<N>(i, j)]) : m;
  return sqrtf(m);
}

// The masked median of the pair distances by rank selection, ties broken
// by pair index (numpy's nanmedian: the mean of the two middle order
// statistics), 0 without a valid pair (_pair_r_median).  rv: each pair's
// distance, 3e38 where a member is masked; cnt: the valid pairs.
template <int NP>
__device__ __forceinline__ float rank_median(const float (&rv)[NP],
                                             float cnt) {
  const float lo = floorf(maxf(cnt - 1.f, 0.f) * 0.5f);
  float hi = floorf(cnt * 0.5f);
  hi = cnt > 0.f ? minf(hi, cnt - 1.f) : 0.f;
  float med_lo = 0.f, med_hi = 0.f;
  // unrolled up to N = 8 (28 pairs); above, NP^2 unrolled compares would
  // swamp the build of a branch that runs only on degenerate systems
#pragma unroll(NP <= 28 ? NP : 1)
  for (int k = 0; k < NP; ++k) {
    float rank = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < NP; ++k2) {
      const bool lt = (rv[k2] < rv[k]) || ((rv[k2] == rv[k]) && (k2 < k));
      rank = rank + (lt ? 1.f : 0.f);
    }
    med_lo = med_lo + (rank == lo ? rv[k] : 0.f);
    med_hi = med_hi + (rank == hi ? rv[k] : 0.f);
  }
  float med = 0.5f * (med_lo + med_hi);
  med = cnt > 0.f ? med : 0.f;
  return finitef(med) ? med : 0.f;
}

// the degeneracy test: gmax <= 1e-12, or gmax <= 1e-9 r_median, the
// median taken only where the bound rmax cannot decide
template <typename Median>
__device__ __forceinline__ bool degenerate_grad(float gmax, float rmax,
                                                Median median) {
  if (gmax <= 1e-12f) return true;
  if (gmax > 1e-9f * rmax) return false;
  return gmax <= 1e-9f * median();
}

template <int N, int D>
__device__ __forceinline__ void reference_switch(const Sys<N>& s,
                                                 const float* pos,
                                                 const float* h,
                                                 const float* w,
                                                 float* g) {
  constexpr int NP = N * (N - 1) / 2 > 0 ? N * (N - 1) / 2 : 1;
  float r2[NP];
  pair_r2<N, D>(pos, r2);
  float gmax = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float g2 = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) g2 = g2 + g[i * D + a] * g[i * D + a];
    gmax = maxf(gmax, s.valid[i] ? sqrtf(g2) : 0.f);
  }
  const bool degenerate =
      degenerate_grad(gmax, pair_r_max<N>(s, r2), [&]() {
        float rv[NP], cnt = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = i + 1; j < N; ++j) {
            const bool vp = s.valid[i] && s.valid[j];
            rv[pidx<N>(i, j)] = vp ? sqrtf(r2[pidx<N>(i, j)]) : 3e38f;
            cnt = cnt + (vp ? 1.f : 0.f);
          }
        return rank_median<NP>(rv, cnt);
      });
  if (!degenerate) return;

  // the Omega gradient on the final iterate (_omega_grad)
  float fb[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) fb[k] = 0.f;
  const float h_floor = maxf(1e-12f, 0.1f * maxf(s.flo, 1e-12f));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float hj = maxf(h[i], h_floor);
    const float ih2 = 1.f / maxf(hj * hj, 1e-24f);
    const float hs = maxf(hj, 1e-12f);
    float W[N > 1 ? N - 1 : 1];
    float S = 0.f, Sd = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j == i) continue;
      const float r = r2[i < j ? pidx<N>(i, j) : pidx<N>(j, i)];
      const float wj = kInvPi * ih2 * expf(-r * ih2);
      W[j - (j > i)] = wj;
      S = S + s.mval[j] * wj;
      Sd = Sd + s.mval[j] * wj * (-2.f + 2.f * r * ih2) / hs;
    }
    const float Ssafe = maxf(S, 1e-30f);
    float Om = 1.f + hj * Sd / (2.f * Ssafe);
    Om = (finitef(Om) && Om != 0.f) ? Om : 1.f;
    const float P = -hj / (2.f * Ssafe * Om);
    const float si = -w[i] * P;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j == i) continue;
      const float coeff = si * s.mval[j] * W[j - (j > i)] * (-2.f * ih2);
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const float d = pos[i * D + a] - pos[j * D + a];
        fb[i * D + a] = fb[i * D + a] + coeff * d;
        fb[j * D + a] = fb[j * D + a] - coeff * d;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N * D; ++k)
    fb[k] = (s.valid[k / D] && finitef(fb[k])) ? fb[k] : 0.f;

  // the legacy gradient (_legacy_grad), for the sign alignment
  float Dsum = 0.f, M = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const bool vp = s.valid[i] && s.valid[j];
      Dsum = Dsum + (vp ? 1.f / (sqrtf(r2[pidx<N>(i, j)]) + 1e-12f) : 0.f);
    }
#pragma unroll
  for (int i = 0; i < N; ++i) M = M + (s.valid[i] ? 1.f : 0.f);
  const float Dsafe = maxf(Dsum, 1e-30f);
  const float c_pref = s.lam * M / (Dsafe * Dsafe);
  const bool good = finitef(Dsum) && Dsum > 0.f;
  float gl[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) gl[k] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const bool vp = s.valid[i] && s.valid[j];
      const float r_safe = maxf(sqrtf(r2[pidx<N>(i, j)]), 1e-15f);
      const float den = r_safe + 1e-12f;
      const float A = vp ? 1.f / (r_safe * den * den) : 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const float d = pos[i * D + a] - pos[j * D + a];
        gl[i * D + a] = gl[i * D + a] - c_pref * A * d;
        gl[j * D + a] = gl[j * D + a] + c_pref * A * d;
      }
    }
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    const float gk = (good && finitef(gl[k])) ? gl[k] : 0.f;
    dot = dot + fb[k] * gk;
  }
  const bool flip = finitef(dot) && dot < 0.f;
#pragma unroll
  for (int k = 0; k < N * D; ++k) g[k] = flip ? -fb[k] : fb[k];
}

// (eps*, grad) in the kernel's gradient mode: REF runs the fallback
// after the exact gradient (the analysis, MEGNO and multi-step kernels
// clamp nothing in between)
template <int N, int D, bool REF>
__device__ __forceinline__ void eps_star_and_grad_mode(const Sys<N>& s,
                                                       const float* pos,
                                                       float& es, float* g) {
  if constexpr (REF) {
    float h[N], w[N];
    eps_star_and_grad<N, D, true>(s, pos, es, g, h, w);
    reference_switch<N, D>(s, pos, h, w, g);
  } else {
    eps_star_and_grad<N, D>(s, pos, es, g);
  }
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
// policy) folds (eps, pi) around the substep as well as around each S;
// REF takes the "reference" gradient.
template <int N, int D, bool REFL = false, bool REF = false>
__device__ __forceinline__ void strang_trip(const Sys<N>& s, float* pos,
                                            float* vel, float& eps, float& pi,
                                            float& es, float* grad, float h) {
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
  s_half<N, D, REFL>(s, vel, eps, pi, es, grad, h);
  v_half_kick<N, D>(s, pos, vel, eps, pi, h);
#pragma unroll
  for (int k = 0; k < N * D; ++k) pos[k] = pos[k] + h * vel[k];
  v_half_kick<N, D>(s, pos, vel, eps, pi, h);
  eps_star_and_grad_mode<N, D, REF>(s, pos, es, grad);
  s_half<N, D, REFL>(s, vel, eps, pi, es, grad, h);
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
}

template <int N, int D>
__device__ __forceinline__ void load_system(
    int b, int B, const float* pos, const float* vel, const float* mass,
    const float* k_s, const float* mu, const float* alpha, const float* flo,
    const float* cap, const float* eps, float G, float k_wall, float eta,
    float jcap, float lam, int bexp, int barrier_on, Sys<N>& s, float* q,
    float* v) {
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
  s.lam = lam;
  s.bexp = bexp;
  s.barrier_on = barrier_on != 0;
}

}  // namespace
