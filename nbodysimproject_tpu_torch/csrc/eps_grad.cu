// Fused (eps*, d eps*/dq) kernel for the ham_soft scan path on Hopper
// (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_eps.py:
//   eps_star_and_grad_fused (_eps_grad_kernel, :50) -> hs_eps_grad
// at d = 2 and 3 (HS_D): the 8 clipped SPH iterations seeded from h0, the
// softmin eps* and the hand-written reverse sweep for its exact gradient,
// then (clamp) the soft policy's value clamp to
// [min(eps_min, eps_max), max(eps_min, eps_max)] with the gradient zeroed
// where the clamp saturates, and then, in the build variant HS_REF
// (use_fallback, the "reference" gradient mode), the degeneracy fallback:
// where the gradient's largest row norm is <= 1e-12 or <= 1e-9 times the
// median pair distance, the Omega gradient on the final iterate, its sign
// aligned against the legacy gradient's (hamsoft_physics.cuh's
// reference_switch; in the lane layout below, the same terms and sums).
// A slot whose mask is off takes mass 0 and drops out of every sum and of
// the softmin; its gradient is 0.
//
// What bounds it: operations.  Per system it reads N (D + 1) + 4 floats
// and N mask bytes and writes N D + 1 floats, while the forward solve and
// the reverse sweep spend about 9 N (N - 1) expf and ~10^3 (N = 3) to
// ~10^4 (N = 8) FP32 operations.  The scan path calls it on every substep
// at widths of 10^4 to 10^6 systems.  The layout is fixed per body-slot
// count N, from measurement (PERF.md section 6, row 4):
//   * N <= 3 (the bench's 3-body systems): one thread per system on the
//     one-thread physics of hamsoft_physics.cuh, the kept SPH terms in
//     registers (~156 of them, three blocks of 128 an SM).  Bench.py's
//     systems saturate the clip gate at every iterate (S ~ 0), where
//     -G_raw / (2 S) overflows into IEEE division's slow path; the
//     physics skips that division where the gate is shut, where its value
//     is never used.  One lane per body, as below, was no faster here:
//     its shuffles and selects cost what its occupancy gains;
//   * N >= 4 (the dataset's 8-slot systems): one lane per body,
//     floor(32 / N) systems a warp.  One thread per system held the kept
//     terms of all N bodies (640 floats at N = 8, 2,632 bytes spilled).
//     Body i's 8-iterate SPH chain needs only h_i and the pair distances,
//     so each lane runs its own body's chain and keeps only its terms.
//     The softmin reads the other bodies' values by shuffle; in the
//     reverse sweep each lane publishes its coeff_ijk by shuffle (one
//     rotation per neighbour), and every lane adds the terms of its own
//     body's gradient.  A warp per system, four lanes per body, on the
//     analysis kernels' lane-split physics was slower at N = 8.
// Every kept term is the expression the one-thread loops evaluate on the
// same operands, and every sum is added in their order (for g_i: k
// descending, then the one-thread loop's i ascending, j ascending), so
// both layouts give the parent one-thread kernel's bits (built with
// -fmad=false: nothing is contracted).  The wrapper hands the per-system
// rows h0, alpha, eps_min and eps_max as a pointer and an element stride
// (0 for a broadcast row) or as a scalar, and the mask as bytes: the
// kernel forms m_eff itself, so a call launches this kernel and nothing
// else.

#include "hamsoft_physics.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif
#ifndef HS_REF
#define HS_REF 0
#endif

namespace {

// the per-system rows h0, alpha, eps_min, eps_max: row r of system b is
// p[r][b * stride[r]], or value[r] where p[r] is null
struct Rows {
  const float* p[4];
  long long stride[4];
  float value[4];
};

__device__ __forceinline__ float row_at(const Rows& r, int k, int b) {
  return r.p[k] ? r.p[k][(long long)b * r.stride[k]] : r.value[k];
}

// the layout of each N: one lane per body from N = 4 up
constexpr bool kLaneLayout = HS_N >= 4;
constexpr int kBlock = 128;

// the clamp of the soft policy on (es, g), and eps*'s bounds
struct Bounds {
  float lo, hi;
};

__device__ __forceinline__ Bounds bounds_of(const Rows& rows, int b) {
  const float emin = row_at(rows, 2, b), emax = row_at(rows, 3, b);
  return {minf(emin, emax), maxf(emin, emax)};
}

// The "reference" fallback in the lane layout: lane i of a system holds
// body i's (final iterate h, softmin weight w, exact gradient g) and every
// body's positions (qa) and validity; the terms are the one-thread
// reference_switch's, and every sum is taken in its order (the Omega
// gradient's pair terms published by rotation, as in the reverse sweep;
// the legacy gradient's, whose pair loop runs over i < j only, formed
// by each lane for its own body; the median's distances and the other
// sums read by shuffle).
template <int N, int D>
__device__ __forceinline__ void reference_switch_lane(
    int i, int base, const bool (&valid)[N], bool valid_i, float mval_i,
    const float (&ms)[N - 1], const float (&qa)[N * D], const float (&qi)[D],
    const float (&qs)[N - 1][D], const float (&r2)[N - 1], float h, float w,
    float flo, float lam, float* g) {
  constexpr int NS = N - 1;
  constexpr int NP = N * (N - 1) / 2;
  constexpr unsigned kAll = 0xffffffffu;
  float g2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) g2 = g2 + g[a] * g[a];
  const float gn = valid_i ? sqrtf(g2) : 0.f;
  float gmax = 0.f;
#pragma unroll
  for (int b = 0; b < N; ++b) gmax = maxf(gmax, __shfl_sync(kAll, gn, base + b));
  // slot t holds pair (i, t + (t >= i)); its distance is the one-thread
  // pair's (dx^2 is even in dx)
  float rm = 0.f;
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    const int j = t + (t >= i);
    rm = (valid_i && valid[j]) ? maxf(rm, r2[t]) : rm;
  }
  float rmax = rm;
#pragma unroll
  for (int b = 0; b < N; ++b) rmax = maxf(rmax, __shfl_sync(kAll, rm, base + b));
  rmax = sqrtf(rmax);
  // degenerate_grad's test, with the median taken by every lane of the
  // warp where any system needs it: the warp's systems share its shuffles
  const bool need = !(gmax <= 1e-12f) && !(gmax > 1e-9f * rmax);
  float med = 0.f;
  if (__any_sync(kAll, need)) {
    float rv[NP], cnt = 0.f;
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int b = a + 1; b < N; ++b) {
        // pair (a, b) is slot b - 1 of lane a
        const float r2p = __shfl_sync(kAll, r2[b - 1], base + a);
        const bool v = valid[a] && valid[b];
        rv[pidx<N>(a, b)] = v ? sqrtf(r2p) : 3e38f;
        cnt = cnt + (v ? 1.f : 0.f);
      }
    med = rank_median<NP>(rv, cnt);
  }
  const bool degenerate = gmax <= 1e-12f || (need && gmax <= 1e-9f * med);
  // every lane of a warp runs the shuffles below; a system that does not
  // degenerate keeps its gradient
  if (!__any_sync(kAll, degenerate)) return;

  // the Omega gradient on the final iterate
  const float h_floor = maxf(1e-12f, 0.1f * maxf(flo, 1e-12f));
  const float hj = maxf(h, h_floor);
  const float ih2 = 1.f / maxf(hj * hj, 1e-24f);
  const float hs = maxf(hj, 1e-12f);
  float W[NS];
  float S = 0.f, Sd = 0.f;
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    const float wt = kInvPi * ih2 * expf(-r2[t] * ih2);
    W[t] = wt;
    S = S + ms[t] * wt;
    Sd = Sd + ms[t] * wt * (-2.f + 2.f * r2[t] * ih2) / hs;
  }
  const float Ssafe = maxf(S, 1e-30f);
  float Om = 1.f + hj * Sd / (2.f * Ssafe);
  Om = (finitef(Om) && Om != 0.f) ? Om : 1.f;
  const float P = -hj / (2.f * Ssafe * Om);
  const float si = -w * P;
  float coeff[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) coeff[t] = si * ms[t] * W[t] * (-2.f * ih2);
  float recv[NS];
#pragma unroll
  for (int r = 1; r < N; ++r) {
    const int slot = (i + r < N) ? i + r - 1 : i + r - N;
    float send = coeff[0];
#pragma unroll
    for (int t = 1; t < NS; ++t) send = (t == slot) ? coeff[t] : send;
    recv[r - 1] = __shfl_sync(kAll, send, base + (i - r + N) % N);
  }
  float fb[D];
#pragma unroll
  for (int a = 0; a < D; ++a) fb[a] = 0.f;
#pragma unroll
  for (int src = 0; src < N; ++src) {
    if (src == i) {
#pragma unroll
      for (int t = 0; t < NS; ++t)
#pragma unroll
        for (int a = 0; a < D; ++a)
          fb[a] = fb[a] + coeff[t] * (qi[a] - qs[t][a]);
    } else {
      const int r = (i - src + N) % N;
      float cf = recv[0];
#pragma unroll
      for (int q = 2; q < N; ++q) cf = (q == r) ? recv[q - 1] : cf;
#pragma unroll
      for (int a = 0; a < D; ++a) fb[a] = fb[a] - cf * (qa[src * D + a] - qi[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) fb[a] = (valid_i && finitef(fb[a])) ? fb[a] : 0.f;

  // the legacy gradient: D over the pairs i < j in order, from the lane
  // of each pair's first body
  float inv[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    const int j = t + (t >= i);
    inv[t] = (valid_i && valid[j]) ? 1.f / (sqrtf(r2[t]) + 1e-12f) : 0.f;
  }
  float Dsum = 0.f, M = 0.f;
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = a + 1; b < N; ++b)
      Dsum = Dsum + __shfl_sync(kAll, inv[b - 1], base + a);
#pragma unroll
  for (int b = 0; b < N; ++b) M = M + (valid[b] ? 1.f : 0.f);
  const float Dsafe = maxf(Dsum, 1e-30f);
  const float c_pref = lam * M / (Dsafe * Dsafe);
  const bool good = finitef(Dsum) && Dsum > 0.f;
  // body i's terms in the pair loop's order: +c A (q_j - q_i) from the
  // pairs (j, i), j < i, then -c A (q_i - q_j) from the pairs (i, j)
  float gl[D];
#pragma unroll
  for (int a = 0; a < D; ++a) gl[a] = 0.f;
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    const int j = t + (t >= i);
    const float r_safe = maxf(sqrtf(r2[t]), 1e-15f);
    const float den = r_safe + 1e-12f;
    const float A = (valid_i && valid[j]) ? 1.f / (r_safe * den * den) : 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if (j < i)
        gl[a] = gl[a] + c_pref * A * (qs[t][a] - qi[a]);
      else
        gl[a] = gl[a] - c_pref * A * (qi[a] - qs[t][a]);
    }
  }
  float prod[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
    prod[a] = fb[a] * ((good && finitef(gl[a])) ? gl[a] : 0.f);
  float dot = 0.f;
#pragma unroll
  for (int b = 0; b < N; ++b)
#pragma unroll
    for (int a = 0; a < D; ++a) dot = dot + __shfl_sync(kAll, prod[a], base + b);
  const bool flip = finitef(dot) && dot < 0.f;
  if (!degenerate) return;
#pragma unroll
  for (int a = 0; a < D; ++a) g[a] = flip ? -fb[a] : fb[a];
}

// One lane per body: lane l of a warp works for body i = l % N of system
// warp * SPW + l / N; the last 32 - SPW N lanes idle (they run along, so
// every shuffle has all 32 lanes, and store nothing).
template <int N, int D, bool REF>
__global__ void __launch_bounds__(kBlock) eps_grad_lane(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const unsigned char* __restrict__ mask, Rows rows,
    float* __restrict__ out_es, float* __restrict__ out_grad, int B,
    float eta, float lam, int clamp) {
  static_assert(N >= 2 && N <= 32, "a system's lanes fit in one warp");
  constexpr int SPW = 32 / N;  // systems per warp
  constexpr int NS = N - 1;    // neighbour slots
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int sw = lane / N;  // system within the warp (SPW: an idle lane)
  const int i = lane - sw * N;
  const int base = sw * N;
  const int b_raw = warp * SPW + sw;
  const bool live = sw < SPW && b_raw < B;
  const int b = live ? b_raw : 0;

  // the system's positions, each body's m_eff, and the slots j != i
  // (j ascending) of this lane's body
  float qa[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) qa[k] = pos[(size_t)b * (N * D) + k];
  float mv[N];
  bool valid[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float m = mask[(size_t)b * N + j] ? mass[(size_t)b * N + j] : 0.f;
    valid[j] = m > 0.f;
    mv[j] = valid[j] ? m : 0.f;
  }
  float qi[D], qs[NS][D], ms[NS];
  bool valid_i = valid[0];
  float mval_i = mv[0];
#pragma unroll
  for (int a = 0; a < D; ++a) qi[a] = qa[a];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    valid_i = (i == j) ? valid[j] : valid_i;
    mval_i = (i == j) ? mv[j] : mval_i;
#pragma unroll
    for (int a = 0; a < D; ++a) qi[a] = (i == j) ? qa[j * D + a] : qi[a];
  }
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    // slot t is body t (t < i) or t + 1 (t >= i)
    const bool up = t >= i;
    ms[t] = up ? mv[t + 1] : mv[t];
#pragma unroll
    for (int a = 0; a < D; ++a)
      qs[t][a] = up ? qa[(t + 1) * D + a] : qa[t * D + a];
  }

  const Bounds bd = bounds_of(rows, b);
  const float flo = maxf(bd.lo, 1e-12f);
  const float cap = maxf(flo, bd.hi);
  const float alpha = row_at(rows, 1, b);

  // pair distances of the lane's slots, as pair_r2 (dx^2 is even in dx)
  float r2[NS];
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const float dx = qi[a] - qs[t][a];
      acc = acc + dx * dx;
    }
    r2[t] = acc;
  }

  // body i's 8 SPH iterates, keeping the kernel terms
  float W[kIters][NS], Sd[kIters], X[kIters], M2[kIters];
  unsigned gate = 0u;
  float h = clipf(row_at(rows, 0, b), flo, cap);
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const float ih2 = 1.f / maxf(h * h, 1e-24f);
    const float inv_hs = 1.f / maxf(h, 1e-12f);
    float S = 0.f, sd = 0.f;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const float r = r2[t];
      const float w = kInvPi * ih2 * expf(-r * ih2);
      W[k][t] = w;
      S = S + ms[t] * w;
      sd = sd + ms[t] * w * (-2.f + 2.f * r * ih2) * inv_hs;
    }
    const float Ssafe = maxf(S, 1e-30f);
    const float G_raw = eta * sqrtf(mval_i / Ssafe);
    const bool open = (G_raw > flo) && (G_raw < cap);
    gate |= open ? (1u << k) : 0u;
    // X feeds only c = u X where the gate is open: where it is shut the
    // one-thread sweep's c is 0 X, a zero or (X infinite) a NaN that the
    // finite guard zeroes, and a zero of either sign adds nothing to g.
    // So the division is skipped there: on saturated systems (S ~ 0) it
    // overflows into IEEE division's slow path.
    if (open)
      X[k] = -G_raw / (2.f * Ssafe);
    else
      X[k] = 0.f;
    Sd[k] = sd;
    M2[k] = -2.f * ih2;
    h = clipf(G_raw, flo, cap);
  }

  // softmin over the valid bodies, the one-thread order
  const float ti = valid_i ? -h / alpha : -1e30f;
  float tmax = __shfl_sync(kAll, ti, base);
#pragma unroll
  for (int j = 1; j < N; ++j) tmax = maxf(tmax, __shfl_sync(kAll, ti, base + j));
  const float e = expf(ti - tmax);
  float ssum = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) ssum = ssum + __shfl_sync(kAll, e, base + j);
  float es = -alpha * (tmax + logf(ssum));
  float u = e / ssum;
  const float w_fin = u;

  // reverse sweep: the cotangent on h stays per body
  float g[D];
#pragma unroll
  for (int a = 0; a < D; ++a) g[a] = 0.f;
#pragma unroll
  for (int k = kIters - 1; k >= 0; --k) {
    float c = ((gate >> k) & 1u) ? u * X[k] : 0.f;
    // the float32 backward overflows on saturated lanes, where the true
    // gradient is exactly zero
    c = finitef(c) ? c : 0.f;
    float coeff[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) coeff[t] = c * ms[t] * W[k][t] * M2[k];
    u = c * Sd[k];
    // rotation r: every lane sends its coeff for body (i + r) % N and
    // receives coeff_{src, i} from src = (i - r) % N
    float recv[NS];
#pragma unroll
    for (int r = 1; r < N; ++r) {
      const int slot = (i + r < N) ? i + r - 1 : i + r - N;
      float send = coeff[0];
#pragma unroll
      for (int t = 1; t < NS; ++t) send = (t == slot) ? coeff[t] : send;
      const int src = (i - r + N) % N;
      recv[r - 1] = __shfl_sync(kAll, send, base + src);
    }
    // g_i's terms of iterate k in the one-thread order: -term(src, i) for
    // src < i, +term(i, j) for j ascending, -term(src, i) for src > i
#pragma unroll
    for (int src = 0; src < N; ++src) {
      if (src == i) {
#pragma unroll
        for (int t = 0; t < NS; ++t)
#pragma unroll
          for (int a = 0; a < D; ++a)
            g[a] = g[a] + coeff[t] * (qi[a] - qs[t][a]);
      } else {
        const int r = (i - src + N) % N;
        float cf = recv[0];
#pragma unroll
        for (int q = 2; q < N; ++q) cf = (q == r) ? recv[q - 1] : cf;
#pragma unroll
        for (int a = 0; a < D; ++a)
          g[a] = g[a] - cf * (qa[src * D + a] - qi[a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) g[a] = (valid_i && finitef(g[a])) ? g[a] : 0.f;
  if (clamp) {
    const bool open = (es >= bd.lo) && (es <= bd.hi);
#pragma unroll
    for (int a = 0; a < D; ++a) g[a] = open ? g[a] : 0.f;
    es = clipf(es, bd.lo, bd.hi);
  }
  if constexpr (REF)
    reference_switch_lane<N, D>(i, base, valid, valid_i, mval_i, ms, qa, qi,
                                qs, r2, h, w_fin, flo, lam, g);
  if (!live) return;
  if (i == 0) out_es[b] = es;
#pragma unroll
  for (int a = 0; a < D; ++a) out_grad[((size_t)b * N + i) * D + a] = g[a];
}

// One thread per system (hamsoft_physics.cuh's eps_star_and_grad).
template <int N, int D, bool REF>
__global__ void __launch_bounds__(kBlock) eps_grad_thread(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const unsigned char* __restrict__ mask, Rows rows,
    float* __restrict__ out_es, float* __restrict__ out_grad, int B,
    float eta, float lam, int clamp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sys<N> s;
  float q[N * D], g[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) q[k] = pos[(size_t)b * (N * D) + k];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float m = mask[(size_t)b * N + i] ? mass[(size_t)b * N + i] : 0.f;
    s.valid[i] = m > 0.f;
    s.mval[i] = s.valid[i] ? m : 0.f;
  }
  const Bounds bd = bounds_of(rows, b);
  s.flo = maxf(bd.lo, 1e-12f);
  s.cap = maxf(s.flo, bd.hi);
  s.alpha = row_at(rows, 1, b);
  s.eps_seed = row_at(rows, 0, b);
  s.eta = eta;
  s.lam = lam;

  float es, h[N], w[N];
  eps_star_and_grad<N, D, REF>(s, q, es, g, h, w);
  if (clamp) {
    const bool open = (es >= bd.lo) && (es <= bd.hi);
#pragma unroll
    for (int k = 0; k < N * D; ++k) g[k] = open ? g[k] : 0.f;
    es = clipf(es, bd.lo, bd.hi);
  }
  if constexpr (REF) reference_switch<N, D>(s, q, h, w, g);
  out_es[b] = es;
#pragma unroll
  for (int k = 0; k < N * D; ++k) out_grad[(size_t)b * (N * D) + k] = g[k];
}

template <int N, int D, bool REF>
int launch(const float* pos, const float* mass, const unsigned char* mask,
           const Rows& rows, float* out_es, float* out_grad, int B, float eta,
           float lam, int clamp, cudaStream_t st) {
  if constexpr (kLaneLayout) {
    constexpr int per = (kBlock / 32) * (32 / N);  // systems per block
    eps_grad_lane<N, D, REF><<<(B + per - 1) / per, kBlock, 0, st>>>(
        pos, mass, mask, rows, out_es, out_grad, B, eta, lam, clamp);
  } else {
    eps_grad_thread<N, D, REF><<<(B + kBlock - 1) / kBlock, kBlock, 0, st>>>(
        pos, mass, mask, rows, out_es, out_grad, B, eta, lam, clamp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hs_eps_grad(const float* pos, const float* mass,
                const unsigned char* mask, const void* const* row_ptr,
                const long long* row_stride, const float* row_value,
                float* out_es, float* out_grad, int B, float eta, float lam,
                int clamp, void* stream) {
  if (B <= 0) return 0;
  Rows rows;
  for (int k = 0; k < 4; ++k) {
    rows.p[k] = static_cast<const float*>(row_ptr[k]);
    rows.stride[k] = row_stride[k];
    rows.value[k] = row_value[k];
  }
  return launch<HS_N, HS_D, HS_REF != 0>(pos, mass, mask, rows, out_es,
                                         out_grad, B, eta, lam, clamp,
                                         (cudaStream_t)stream);
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
