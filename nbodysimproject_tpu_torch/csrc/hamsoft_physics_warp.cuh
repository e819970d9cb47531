// Cooperative ham_soft physics: several lanes of a warp per system.
//
// The same physics as hamsoft_physics.cuh (the port of _build_physics of
// nbodysimproject_tpu/ops/pallas_hamsoft.py:44-489), laid out across the
// lanes of one system instead of one thread, and bit for bit the same:
// every sum that enters the trajectory is taken in the one-thread
// physics' order, so a trip here moves (pos, vel, eps, pi) exactly as
// the one-thread trip does.  Included by hamsoft.cu (the analysis and
// MEGNO kernels) and by hamsoft_multistep.cu (its warp layout, N = 4 to
// 16); the multi-step kernel's one-thread layout (N = 2 and 3) and
// eps_grad.cu (one thread at N <= 3, one lane per body above) do not.
//
// Layout (Lay<N>): a system owns SYS = NP * LPB consecutive lanes of a
// warp, NP the power of two >= N and LPB = min(4, 32 / NP) the lanes
// per body: four up to N = 8 (measured against one lane per body,
// PERF.md), two from N = 9 to 16, so that every system keeps to one warp
// and every sum to its shuffles.  Lane l of a system works for body
// i = l / LPB and holds SPL = ceil(N / LPB) of its neighbour slots,
// j = (l % LPB) * SPL + s.  A slot is "real" when j < N and j != i; a
// lane whose body is >= N (padding) has none.  Each lane keeps its own
// body's q_i, v_i and eps* gradient (the same in every lane of the
// body's group) and the positions of its slots' neighbours, fetched by
// shuffle after every drift.  Per-system scalars (eps, pi, eps*) are
// replicated in every lane.  Where a body's group has fewer lanes than
// there are dimensions (LPB = 2, d = 3) or quotients to split, a lane
// takes ceil(count / LPB) of them, in rounds.
//
// Ordered sums: a lane computes the terms of its own slots (W_ij, the
// pair forces, the pair potentials); every lane that needs the sum then
// reads all N terms by shuffle and adds them in ascending j (slot_sum,
// body_val, pair_sum), as the one-thread loops do.  Every lane of a
// system ends with the same bits, so every branch on a summed value (the
// SPH clip gate, the J-cap switch) is taken by all of them together.
// (Exchanging the terms through shared memory instead was slower.)
// Maxima need no order (xmax): max is exact.
//
// The SPH solve keeps, from each forward iterate k, the kernel terms
// W_ij of the lane's slots, dS_i/dh, -G_raw / (2 S_i), the clip gate and
// -2 / h^2; the reverse sweep then runs no expf and no sum over slots.
// The one-thread sweep scatters coeff_ijk (q_i - q_j) into g_i and out
// of g_j; here the lane of (i, j) writes that product into body i's and
// body j's rows of a shared-memory table, at the place the one-thread
// loop would add it, and one lane per body and dimension adds its row in
// that order.
//
// IEEE division and square root are the dearest steps of a trip (their
// slow-path branches also cut the instruction stream into short blocks).
// Where every lane of a body's group would compute the same independent
// quotients or roots, each lane computes one and shuffles it to the
// others (group_div): the same operations on the same operands.
//
// The "reference" gradient's fallback (reference_switch_w, compiled where
// the REF template argument asks for it) follows the one-thread
// reference_switch bit for bit the same way: its per-body terms are the
// lane's, its pair terms go through the reverse sweep's table, and its
// sums and its median read every term by shuffle in the one-thread order.

#pragma once

#include "hamsoft_physics.cuh"

namespace {

__host__ __device__ constexpr int next_pow2(int n) {
  return n <= 1 ? 1 : 2 * next_pow2((n + 1) / 2);
}

// lanes per body: four (measured against one lane per body, PERF.md)
// while a system of them fits in a warp, two from N = 9 to 16
__host__ __device__ constexpr int lanes_per_body(int n) {
  return 32 / next_pow2(n) < 4 ? 32 / next_pow2(n) : 4;
}

template <int N>
struct Lay {
  static constexpr int NP = next_pow2(N);             // body groups
  static constexpr int LPB = lanes_per_body(N);       // lanes per body
  static constexpr int SPL = (N + LPB - 1) / LPB;     // slots per lane
  static constexpr int SYS = NP * LPB;                // lanes per system
  static_assert(N >= 2 && N <= 16 && SYS <= 32,
                "a system of 2 to 16 bodies in one warp");
};

// Sum over the lanes l ^ o, o = LO, 2 LO, ... < HI (LO = 1, HI = LPB:
// the body's group; LO = LPB, HI = SYS: one value per body; LO = 1,
// HI = SYS: the whole system): for the metrics and the tangent map,
// which do not feed the trajectory.
template <int LO, int HI>
__device__ __forceinline__ float xsum(float v, unsigned mask) {
#pragma unroll
  for (int o = LO; o < HI; o <<= 1) v = v + __shfl_xor_sync(mask, v, o);
  return v;
}

template <int LO, int HI>
__device__ __forceinline__ float xmax(float v, unsigned mask) {
#pragma unroll
  for (int o = LO; o < HI; o <<= 1) v = maxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

// K independent divisions a_r / b_r of a body's group, lane c of the
// group dividing a_r / b_r for r = c, c + LPB, ... (one round per LPB
// quotients) and every lane reading all results: ceil(K / LPB) IEEE
// divisions per lane instead of K.  The quotients are bit for bit those
// of a / b in every lane.
template <int LPB, int K>
__device__ __forceinline__ void group_div(const float (&a)[K],
                                          const float (&b)[K], float (&q)[K],
                                          int sub, int group, unsigned mask) {
  constexpr int R = (K + LPB - 1) / LPB;  // rounds
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float num = a[r * LPB], den = b[r * LPB];
#pragma unroll
    for (int c = 1; c < LPB; ++c) {
      const int k = r * LPB + c;
      if (k < K) {
        num = (sub == c) ? a[k] : num;
        den = (sub == c) ? b[k] : den;
      }
    }
    x[r] = num / den;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    q[k] = __shfl_sync(mask, x[k / LPB], group + k % LPB);
}

// Body b's gradient entries g[0..D-1] from the reverse sweep's table:
// lane c of b's group adds the rows of dimensions a = c, c + LPB, ...
// (each in the table's order), and every lane of the group reads all D
// sums.  ``row_sum(a)``: the sum of the lane's body's row(s) of
// dimension a, as the one-thread loop adds it to g_b[a].
template <int N, int D, typename RowSum>
__device__ __forceinline__ void group_rows(bool body, int sub, int group,
                                           unsigned mask, RowSum row_sum,
                                           float* g) {
  constexpr int LPB = Lay<N>::LPB;
  constexpr int R = (D + LPB - 1) / LPB;  // rows per lane
  float ga[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int a = sub + r * LPB;
    ga[r] = (body && a < D) ? row_sum(a) : 0.f;
  }
  __syncwarp(mask);
#pragma unroll
  for (int a = 0; a < D; ++a)
    g[a] = __shfl_sync(mask, ga[a / LPB], group + a % LPB);
}

// What one lane knows of its system.
template <int N, int D>
struct Lane {
  using L = Lay<N>;
  unsigned mask;  // the system's lanes in the warp
  int base;       // the system's first lane in the warp
  int i;          // this lane's body
  int sub;        // this lane's place in the body's group
  int group;      // the body's group's first lane in the warp
  bool body;      // i < N (else a padding lane)
  int j[L::SPL];
  bool real[L::SPL];
  float mval_j[L::SPL];
  float mass_i, mval_i, inv_m_i;
  bool valid_i;
  float k_s, mu, alpha, flo, cap, eps_seed, G, k_wall, eta, jcap;
  float lam;  // the legacy gradient's strength (the "reference" fallback)
  int bexp;
  bool barrier_on;
  // the spring half-flow's constants (the h of the system is fixed)
  float dt_f, omega, sin_t, cos_t, mu_om, mu_w, mu_w2;
};

template <int N, int D>
__device__ __forceinline__ float bar_force_w(const Lane<N, D>& s,
                                             float e) {
  float left = maxf(0.f, s.flo - e);
  float right = maxf(0.f, e - s.cap);
  float le = 1.f, re = 1.f;
  for (int k = 0; k < s.bexp - 2; ++k) {
    le = le * left;
    re = re * right;
  }
  return s.k_wall * (le - re);
}

// Neighbour coordinates of the lane's slots, from the first lane of
// each neighbour's group.
template <int N, int D>
__device__ __forceinline__ void gather_slots(const Lane<N, D>& s,
                                             const float* own, float* nb) {
#pragma unroll
  for (int t = 0; t < Lay<N>::SPL; ++t) {
    const int src = s.base + min(s.j[t], N - 1) * Lay<N>::LPB;
#pragma unroll
    for (int a = 0; a < D; ++a)
      nb[t * D + a] = __shfl_sync(s.mask, own[a], src);
  }
}

// Sum over body i's neighbours j = 0..N-1, j != i, of the term v[t] of
// slot j, in ascending j from 0 (the one-thread loops' order): every
// lane reads each slot's term from the lane of i's group that holds it.
template <int N, int D>
__device__ __forceinline__ float slot_sum(const Lane<N, D>& s,
                                          const float (&v)[Lay<N>::SPL]) {
  constexpr int SPL = Lay<N>::SPL;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float x = __shfl_sync(s.mask, v[j % SPL], s.group + j / SPL);
    acc = (j == s.i) ? acc : acc + x;
  }
  return acc;
}

// Body i's value x, from the first lane of its group, for i = 0..N-1.
template <int N, int D>
__device__ __forceinline__ float body_val(const Lane<N, D>& s, float x,
                                          int i) {
  return __shfl_sync(s.mask, x, s.base + i * Lay<N>::LPB);
}

// Sum over the pairs i < j, in the one-thread loops' order (i, then j),
// of the term v[t] that the lane of body i holding slot j computed.
template <int N, int D>
__device__ __forceinline__ float pair_sum(const Lane<N, D>& s,
                                          const float (&v)[Lay<N>::SPL]) {
  constexpr int SPL = Lay<N>::SPL;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j)
      acc = acc + __shfl_sync(s.mask, v[j % SPL],
                              s.base + i * Lay<N>::LPB + j / SPL);
  return acc;
}

// The reverse sweep's table: for each iterate k, body b and dimension a
// one row of GROW terms coeff (q_i - q_j), in the order in which the
// one-thread sweep adds them to g_b: -term(i, b) for i < b, +term(b, j)
// for j != b ascending, -term(i, b) for i > b.
template <int N, int D>
struct GradRows {
  static constexpr int LEN = 2 * (N - 1);
  static constexpr int GROW = (LEN + 3) / 4 * 4;  // float4 rows
  static constexpr int SIZE = kIters * N * D * GROW;
};

// The lane's part of the SPH solve, kept from the forward pass.
template <int N>
struct SphStore {
  float W[kIters][Lay<N>::SPL];
  float X[kIters];   // -G_raw / (2 Ssafe)
  float Sd[kIters];  // dS_i / dh
  float M2[kIters];  // -2 / h^2
  unsigned gate;     // bit k: flo < G_raw < cap at iterate k
};

// Body b's gradient row from per-slot coefficients c_t: the one-thread
// loops add c_ij (q_i - q_j) to g_i and subtract it from g_j for every
// ordered pair; the lane of (i, j) writes both into the reverse sweep's
// table (its iterate-0 rows), and lane a of body b's group adds b's row
// in the one-thread order.  A slot whose term the one-thread loop does not
// add writes a zero, which changes no bit of the sum.
template <int N, int D>
__device__ __forceinline__ void pair_rows_w(const Lane<N, D>& s,
                                            const float* qi, const float* qj,
                                            const float (&c)[Lay<N>::SPL],
                                            float* rows, float* g) {
  using GR = GradRows<N, D>;
  __syncwarp(s.mask);  // the table's last readers are done
#pragma unroll
  for (int t = 0; t < Lay<N>::SPL; ++t) {
    if (!s.real[t]) continue;
    const int j = s.j[t];
    const int out = s.i + (j < s.i ? j : j - 1);
    const int in = s.i < j ? s.i : s.i + N - 2;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float term = c[t] * (qi[a] - qj[t * D + a]);
      rows[(s.i * D + a) * GR::GROW + out] = term;
      rows[(j * D + a) * GR::GROW + in] = -term;
    }
  }
  __syncwarp(s.mask);
  group_rows<N, D>(s.body, s.sub, s.group, s.mask, [&](int a) {
    const float* row = rows + (s.i * D + a) * GR::GROW;
    float ga = 0.f;
#pragma unroll
    for (int p = 0; p < GR::LEN; ++p) ga = ga + row[p];
    return ga;
  }, g);
}

// The "reference" fallback (hamsoft_physics.cuh's reference_switch) on
// the lane's body: r2 the lane's slots' squared distances, h and w its
// body's final iterate and softmin weight; g its exact gradient, replaced
// by the sign-aligned Omega gradient where the system's gradient
// degenerates (the same in every lane of the system).
template <int N, int D>
__device__ __forceinline__ void reference_switch_w(
    const Lane<N, D>& s, const float* qi, const float* qj,
    const float (&r2)[Lay<N>::SPL], float h, float w, float* g,
    float* rows) {
  constexpr int SPL = Lay<N>::SPL;
  constexpr int SYS = Lay<N>::SYS;
  constexpr int NP = N * (N - 1) / 2;
  float g2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) g2 = g2 + g[a] * g[a];
  const float gmax =
      xmax<Lay<N>::LPB, SYS>((s.body && s.valid_i) ? sqrtf(g2) : 0.f, s.mask);
  bool vp[SPL];  // the slot's pair is valid
  float rm = 0.f;
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    vp[t] = s.real[t] && s.valid_i && s.mval_j[t] > 0.f;
    rm = vp[t] ? maxf(rm, r2[t]) : rm;
  }
  const float rmax = sqrtf(xmax<1, SYS>(rm, s.mask));
  float vb[N];  // each body's validity, from its group
#pragma unroll
  for (int b = 0; b < N; ++b)
    vb[b] = body_val(s, s.valid_i ? 1.f : 0.f, b);
  const bool degenerate = degenerate_grad(gmax, rmax, [&]() {
    float rv[NP], cnt = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        const float r2p = __shfl_sync(s.mask, r2[j % SPL],
                                      s.base + i * Lay<N>::LPB + j / SPL);
        const bool v = vb[i] > 0.f && vb[j] > 0.f;
        rv[pidx<N>(i, j)] = v ? sqrtf(r2p) : 3e38f;
        cnt = cnt + (v ? 1.f : 0.f);
      }
    return rank_median<NP>(rv, cnt);
  });
  if (!degenerate) return;

  // the Omega gradient on the final iterate
  const float h_floor = maxf(1e-12f, 0.1f * maxf(s.flo, 1e-12f));
  const float hj = maxf(h, h_floor);
  const float ih2 = 1.f / maxf(hj * hj, 1e-24f);
  const float hs = maxf(hj, 1e-12f);
  float W[SPL], tS[SPL], tSd[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    float wt = kInvPi * ih2 * expf(-r2[t] * ih2);
    wt = s.real[t] ? wt : 0.f;
    W[t] = wt;
    tS[t] = s.mval_j[t] * wt;
    tSd[t] = s.mval_j[t] * wt * (-2.f + 2.f * r2[t] * ih2) / hs;
  }
  const float S = slot_sum(s, tS);
  const float Sd = slot_sum(s, tSd);
  const float Ssafe = maxf(S, 1e-30f);
  float Om = 1.f + hj * Sd / (2.f * Ssafe);
  Om = (finitef(Om) && Om != 0.f) ? Om : 1.f;
  const float P = -hj / (2.f * Ssafe * Om);
  const float si = -w * P;
  float c[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t) c[t] = si * s.mval_j[t] * W[t] * (-2.f * ih2);
  float fb[D];
  pair_rows_w(s, qi, qj, c, rows, fb);
#pragma unroll
  for (int a = 0; a < D; ++a) fb[a] = (s.valid_i && finitef(fb[a])) ? fb[a] : 0.f;

  // the legacy gradient, for the sign alignment: its pair loop runs over
  // i < j only, so the slots of j < i add zero terms
  float inv[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t)
    inv[t] = vp[t] ? 1.f / (sqrtf(r2[t]) + 1e-12f) : 0.f;
  const float Dsum = pair_sum(s, inv);
  float M = 0.f;
#pragma unroll
  for (int b = 0; b < N; ++b) M = M + vb[b];
  const float Dsafe = maxf(Dsum, 1e-30f);
  const float c_pref = s.lam * M / (Dsafe * Dsafe);
  const bool good = finitef(Dsum) && Dsum > 0.f;
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    const float r_safe = maxf(sqrtf(r2[t]), 1e-15f);
    const float den = r_safe + 1e-12f;
    const float A = vp[t] ? 1.f / (r_safe * den * den) : 0.f;
    c[t] = s.i < s.j[t] ? -(c_pref * A) : 0.f;
  }
  float gl[D];
  pair_rows_w(s, qi, qj, c, rows, gl);
  float prod[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
    prod[a] = fb[a] * ((good && finitef(gl[a])) ? gl[a] : 0.f);
  float dot = 0.f;
#pragma unroll
  for (int b = 0; b < N; ++b)
#pragma unroll
    for (int a = 0; a < D; ++a) dot = dot + body_val(s, prod[a], b);
  const bool flip = finitef(dot) && dot < 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) g[a] = flip ? -fb[a] : fb[a];
}

// eps* and its exact gradient for body i (the lane's g, d = D): the 8
// clipped SPH iterations from the kernel-entry eps, the softmin, and the
// reverse sweep on the stored terms.  rows: the system's GradRows table
// in shared memory.  REF then runs the "reference" fallback.
template <int N, int D, bool REF = false>
__device__ __forceinline__ void eps_star_and_grad_w(
    const Lane<N, D>& s, const float* qi, const float* qj, float& es,
    float* g, float* rows) {
  using L = Lay<N>;
  using GR = GradRows<N, D>;
  constexpr int SPL = L::SPL;
  float r2[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float dx = qi[a] - qj[t * D + a];
      acc = acc + dx * dx;
    }
    r2[t] = acc;
  }

  SphStore<N> st;
  st.gate = 0u;
  // 1 / max(h^2, 1e-24), 1 / max(h, 1e-12) and, from iterate k, the
  // reverse sweep's -G_raw / (2 Ssafe): one division across the group's
  // lanes
  float h = clipf(s.eps_seed, s.flo, s.cap);
  float ih2, inv_hs;
  {
    float q[2];
    group_div<L::LPB, 2>({1.f, 1.f},
                         {maxf(h * h, 1e-24f), maxf(h, 1e-12f)}, q, s.sub,
                         s.group, s.mask);
    ih2 = q[0];
    inv_hs = q[1];
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    float tS[SPL], tSd[SPL];
#pragma unroll
    for (int t = 0; t < SPL; ++t) {
      float w = kInvPi * ih2 * expf(-r2[t] * ih2);
      w = s.real[t] ? w : 0.f;
      st.W[k][t] = w;
      tS[t] = s.mval_j[t] * w;
      tSd[t] = s.mval_j[t] * w * (-2.f + 2.f * r2[t] * ih2) * inv_hs;
    }
    const float S = slot_sum(s, tS);
    const float Sd = slot_sum(s, tSd);
    float Ssafe = maxf(S, 1e-30f);
    float G_raw = s.eta * sqrtf(s.mval_i / Ssafe);
    st.gate |= ((G_raw > s.flo) && (G_raw < s.cap)) ? (1u << k) : 0u;
    st.Sd[k] = Sd;
    st.M2[k] = -2.f * ih2;
    h = clipf(G_raw, s.flo, s.cap);
    float q[3];
    group_div<L::LPB, 3>({1.f, 1.f, -G_raw},
                         {maxf(h * h, 1e-24f), maxf(h, 1e-12f), 2.f * Ssafe},
                         q, s.sub, s.group, s.mask);
    ih2 = q[0];
    inv_hs = q[1];
    st.X[k] = q[2];
  }

  // softmin over the valid bodies, with its weights d es / d h_i
  const float t = s.valid_i ? -h / s.alpha : -1e30f;
  float tmax = body_val(s, t, 0);
#pragma unroll
  for (int b = 1; b < N; ++b) tmax = maxf(tmax, body_val(s, t, b));
  const float e = expf(t - tmax);
  float ssum = 0.f;
#pragma unroll
  for (int b = 0; b < N; ++b) ssum = ssum + body_val(s, e, b);
  es = -s.alpha * (tmax + logf(ssum));
  float u = e / ssum;
  const float w_fin = u;

  // reverse sweep: the cotangent on h stays per body (diagonal
  // Jacobian); each pair term goes into the rows of both of its bodies
#pragma unroll
  for (int k = kIters - 1; k >= 0; --k) {
    float ui = ((st.gate >> k) & 1u) ? u : 0.f;
    float c = ui * st.X[k];
    // the float32 backward overflows on saturated lanes, where the true
    // gradient is exactly zero
    c = finitef(c) ? c : 0.f;
#pragma unroll
    for (int t2 = 0; t2 < SPL; ++t2) {
      if (!s.real[t2]) continue;
      const int j = s.j[t2];
      const float coeff = c * s.mval_j[t2] * st.W[k][t2] * st.M2[k];
      const int out = s.i + (j < s.i ? j : j - 1);
      const int in = s.i < j ? s.i : s.i + N - 2;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const float term = coeff * (qi[a] - qj[t2 * D + a]);
        rows[((k * N + s.i) * D + a) * GR::GROW + out] = term;
        rows[((k * N + j) * D + a) * GR::GROW + in] = -term;
      }
    }
    u = c * st.Sd[k];
  }
  __syncwarp(s.mask);
  // g_b[a], its rows added up by the lanes of body b's group (lane c:
  // the dimensions a = c, c + LPB, ...), k = 8, ..., 1
  float gb[D];
  group_rows<N, D>(s.body, s.sub, s.group, s.mask, [&](int a) {
    float ga = 0.f;
#pragma unroll
    for (int k = kIters - 1; k >= 0; --k) {
      const float4* row = reinterpret_cast<const float4*>(
          rows + ((k * N + s.i) * D + a) * GR::GROW);
#pragma unroll
      for (int p4 = 0; p4 < GR::GROW / 4; ++p4) {
        const float4 x = row[p4];
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (4 * p4 + r < GR::LEN) ga = ga + xs[r];
      }
    }
    return ga;
  }, gb);
#pragma unroll
  for (int a = 0; a < D; ++a)
    g[a] = (s.valid_i && finitef(gb[a])) ? gb[a] : 0.f;
  if constexpr (REF) reference_switch_w(s, qi, qj, r2, h, w_fin, g, rows);
}

// S(h/2): exact spring rotation of (eps - eps*, pi) with the J-capped
// momentum impulse; vi/gi are the lane's body's velocity and gradient.
// REFL folds (eps, pi) before and after it (the reflection policy), as
// the one-thread s_half does.
template <int N, int D, bool REFL = false>
__device__ __forceinline__ void s_half_w(const Lane<N, D>& s, float* vi,
                                         float& eps, float& pi, float es,
                                         const float* gi) {
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
  float pi_in =
      s.barrier_on ? pi + 0.5f * s.dt_f * bar_force_w(s, eps) : pi;
  float Delta0 = eps - es;
  // pi_in / (mu omega), Delta0 / omega, pi_in / (mu omega^2)
  float qd[3];
  group_div<Lay<N>::LPB, 3>({pi_in, Delta0, pi_in},
                            {s.mu_w, s.omega, s.mu_w2}, qd, s.sub, s.group,
                            s.mask);
  float delta_t = Delta0 * s.cos_t + qd[0] * s.sin_t;
  float eta_t = pi_in * s.cos_t - s.mu_om * Delta0 * s.sin_t;
  float I_tau = qd[1] * s.sin_t + qd[2] * (1.f - s.cos_t);
  float eps_new = es + delta_t;
  float pi_new = s.barrier_on
                     ? eta_t + 0.5f * s.dt_f * bar_force_w(s, eps_new)
                     : eta_t;

  // J-cap (hamsoft_flows.py:692-738): maxima over the valid bodies
  float J = s.k_s * I_tau;
  float absJ = fabsf(J);
  float p2 = 0.f, g2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float pv = s.mass_i * vi[a];
    p2 = p2 + pv * pv;
    g2 = g2 + gi[a] * gi[a];
  }
  // sqrt(p2), sqrt(g2): one root across the group's lanes
  const float y = sqrtf(s.sub == 1 ? g2 : p2);
  const float pn = __shfl_sync(s.mask, y, s.group);
  const float gn = __shfl_sync(s.mask, y, s.group + 1);
  const bool take = s.body && s.valid_i;
  float p_scale = xmax<Lay<N>::LPB, Lay<N>::SYS>(take ? pn : 0.f, s.mask);
  float dp_inf = xmax<Lay<N>::LPB, Lay<N>::SYS>(take ? absJ * gn : 0.f, s.mask);
  p_scale = maxf(p_scale, 1e-12f);
  float thr = s.jcap * p_scale;
  float scale = (dp_inf > thr) ? thr / maxf(dp_inf, 1e-30f) : 1.f;
  float Ja = J * scale;
#pragma unroll
  for (int a = 0; a < D; ++a) vi[a] = vi[a] + Ja * gi[a] * s.inv_m_i;
  if (REFL) fold_eps(s.flo, s.cap, eps_new, pi_new);
  eps = eps_new;
  pi = pi_new;
}

// V(h/2): softened gravity kick on the lane's body, dV/deps kick on pi.
template <int N, int D>
__device__ __forceinline__ void v_half_kick_w(const Lane<N, D>& s,
                                              const float* qi,
                                              const float* qj, float* vi,
                                              float eps, float& pi,
                                              float hh) {
  constexpr int SPL = Lay<N>::SPL;
  float h2 = 0.5f * hh;
  float eps2 = eps * eps;
  // per slot: -m_j w (q_i - q_j), and m_i m_j w for i < j
  float f[D][SPL], pw[SPL];
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    float r2 = eps2;
    float dx[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      dx[a] = qi[a] - qj[t * D + a];
      r2 = r2 + dx[a] * dx[a];
    }
    float inv_r = rsqrtf(r2);
    float w = inv_r * inv_r * inv_r;
    float pairm =
        (s.valid_i && s.mval_j[t] > 0.f) ? s.mass_i * s.mval_j[t] : 0.f;
    pw[t] = pairm * w;
    float wi = s.mval_j[t] * w;
#pragma unroll
    for (int a = 0; a < D; ++a) f[a][t] = -(wi * dx[a]);
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float ga = slot_sum(s, f[a]);
    vi[a] = vi[a] + h2 * s.G * ga;
  }
  const float ddU = pair_sum(s, pw);
  float dU = s.G * eps * ddU;
  pi = s.barrier_on ? pi - h2 * (dU - bar_force_w(s, eps)) : pi - h2 * dU;
}

// One Strang substep S V T V S of the lane's body; qj are refreshed
// after the drift.  The (eps*, grad) cache carries across trips.  REFL
// (the reflection policy) folds (eps, pi) around the substep as well as
// around each S; REF takes the "reference" gradient.
template <int N, int D, bool REFL = false, bool REF = false>
__device__ __forceinline__ void strang_trip_w(const Lane<N, D>& s,
                                              float* qi, float* qj,
                                              float* vi, float& eps,
                                              float& pi, float& es,
                                              float* gi, float h,
                                              float* rows) {
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
  s_half_w<N, D, REFL>(s, vi, eps, pi, es, gi);
  v_half_kick_w(s, qi, qj, vi, eps, pi, h);
#pragma unroll
  for (int a = 0; a < D; ++a) qi[a] = qi[a] + h * vi[a];
  gather_slots(s, qi, qj);
  v_half_kick_w(s, qi, qj, vi, eps, pi, h);
  eps_star_and_grad_w<N, D, REF>(s, qi, qj, es, gi, rows);
  s_half_w<N, D, REFL>(s, vi, eps, pi, es, gi);
  if (REFL) fold_eps(s.flo, s.cap, eps, pi);
}

// The lane's view of system b: its body's mass and state, its slots'
// masses, the system scalars and the spring constants of step h.
template <int N, int D>
__device__ __forceinline__ void load_lane(
    int b, int B, int lane_in_warp, const float* pos, const float* vel,
    const float* mass, const float* k_s, const float* mu,
    const float* alpha, const float* flo, const float* cap,
    const float* eps, float h, float G, float k_wall, float eta, float jcap,
    float lam, int bexp, int barrier_on, Lane<N, D>& s, float* qi,
    float* vi) {
  using L = Lay<N>;
  const int l = lane_in_warp % L::SYS;
  s.base = lane_in_warp - l;
  s.mask = (L::SYS == 32) ? 0xffffffffu
                          : (((1u << (L::SYS % 32)) - 1u) << s.base);
  s.i = l / L::LPB;
  s.sub = l % L::LPB;
  s.group = s.base + s.i * L::LPB;
  s.body = s.i < N;
  const int ib = s.body ? s.i : 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    qi[a] = s.body ? pos[(ib * D + a) * B + b] : 0.f;
    vi[a] = s.body ? vel[(ib * D + a) * B + b] : 0.f;
  }
  float m = s.body ? mass[ib * B + b] : 0.f;
  s.mass_i = m;
  s.valid_i = m > 0.f;
  s.mval_i = s.valid_i ? m : 0.f;
  s.inv_m_i = s.valid_i ? 1.f / maxf(m, 1e-30f) : 0.f;
#pragma unroll
  for (int t = 0; t < L::SPL; ++t) {
    const int j = (l % L::LPB) * L::SPL + t;
    s.j[t] = j;
    s.real[t] = s.body && j < N && j != s.i;
    float mj = j < N ? mass[j * B + b] : 0.f;
    s.mval_j[t] = mj > 0.f ? mj : 0.f;
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

  s.dt_f = 0.5f * h;
  s.omega = sqrtf(s.k_s / s.mu);
  float theta = s.omega * s.dt_f;
  float th2 = theta * theta;
  float s_ser = theta * (1.f - th2 / 6.f * (1.f - th2 / 20.f));
  float c_ser = 1.f - th2 / 2.f * (1.f - th2 / 12.f);
  bool small = fabsf(theta) < 1e-8f;
  s.sin_t = small ? s_ser : sinf(theta);
  s.cos_t = small ? c_ser : cosf(theta);
  s.mu_om = sqrtf(s.mu * s.k_s);
  s.mu_w = s.mu * s.omega;
  s.mu_w2 = s.mu * s.omega * s.omega;
}

}  // namespace
