// Fused multi-step ham_soft analysis and MEGNO kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of nbodysimproject_tpu/ops/pallas_hamsoft.py:
//   hamsoft_analysis_multistep (_hamsoft_analysis_kernel, :565) -> hs_analysis
//   hamsoft_megno_multistep    (_hamsoft_megno_kernel,    :770) -> hs_megno
// on the shared physics of hamsoft_physics.cuh.  Covered configuration:
// the soft barrier policy and the exact eps* gradient (the dataset
// pipeline's); the wrappers in ops/hamsoft_kernels.py refuse the others.
//
// What bounds it: operations, not bytes.  A system brings in about a
// hundred floats and writes a few hundred, while every Strang trip spends
// about 10^3 expf (8 SPH iterations forward plus the recomputing reverse
// sweep, N (N-1) kernel terms each) and about 10^4 FP32 operations at
// N = 8.  The design follows from that:
//   * one thread owns one system for the whole horizon; its bodies, the
//     (eps*, grad) cache and the metric accumulators live in registers
//     (spilling to L1-cached local memory where 255 registers do not
//     hold the 9 stored SPH iterates), so device memory is touched only
//     at entry, at each metric sample and MEGNO row, and at exit;
//   * inputs are coordinate-major ((N*D, B) and (B,) rows): neighbouring
//     threads read neighbouring addresses;
//   * each thread loops over its own n_sub inside a macro step instead of
//     masking up to n_sub_max (masked trips are exact identities);
//   * blocks are one warp, so a small dispatch spreads over many SMs and
//     each warp has a scheduler to itself: the run is latency-bound on
//     one thread's trip chain.

#include "hamsoft_physics.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif

namespace {

constexpr int kAccMetrics = 4;          // com_drift, cos_theta, var_L, tr_hessian
constexpr int kAccRows = 1 + 4 * kAccMetrics;

// variational (tangent-map) acceleration
template <int N, int D>
__device__ __forceinline__ void tangent_accel(const Sys<N>& s, const float* pos,
                                              const float* dr, float eps,
                                              float* acc) {
  float eps2 = eps * eps;
#pragma unroll
  for (int k = 0; k < N * D; ++k) acc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      bool pairv = s.valid[i] && s.valid[j];
      float r2 = eps2;
      float dx[D], ddx[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        dx[a] = pos[j * D + a] - pos[i * D + a];
        ddx[a] = dr[j * D + a] - dr[i * D + a];
        r2 = r2 + dx[a] * dx[a];
      }
      float inv_r2 = 1.f / r2;
      float inv_r3 = inv_r2 * rsqrtf(r2);
      float dot = dx[0] * ddx[0];
#pragma unroll
      for (int a = 1; a < D; ++a) dot = dot + dx[a] * ddx[a];
      float coeff = 3.f * dot * inv_r2 * inv_r3;
      float mj = pairv ? s.mval[j] : 0.f;
      float mi = pairv ? s.mval[i] : 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float term = ddx[a] * inv_r3 - coeff * dx[a];
        acc[i * D + a] = acc[i * D + a] + s.G * mj * term;
        acc[j * D + a] = acc[j * D + a] - s.G * mi * term;
      }
    }
}

// The four in-register step metrics (diagnostics/metrics.py:56-123), d = 2.
template <int N, int D>
__device__ __forceinline__ void metrics_of(const Sys<N>& s, const float* pos,
                                           const float* vel, float eps,
                                           float L0, float nb, float* out) {
  static_assert(D == 2, "the analysis metrics are ported for d = 2");
  float com2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float sm = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) sm = sm + s.mval[i] * pos[i * D + a];
    com2 = com2 + sm * sm;
  }
  out[0] = sqrtf(com2);

  float L_i[N];
  float L_tot = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    L_i[i] = s.mval[i] * (pos[i * D] * vel[i * D + 1] - pos[i * D + 1] * vel[i * D]);
    L_tot = (i == 0) ? L_i[0] : L_tot + L_i[i];
  }
  float L_mean = L_tot / nb;
  float var_L = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float d0 = L_i[i] - L_mean;
    var_L = var_L + (s.valid[i] ? d0 * d0 : 0.f);
  }
  var_L = var_L / nb;
  bool cos_ok = (L0 != 0.f) && (L_tot != 0.f);
  out[1] = cos_ok ? (L_tot * L0) / (fabsf(L_tot) * fabsf(L0)) : nanf("");
  out[2] = var_L;

  float eps2 = eps * eps;
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float r2 = 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        float dx = pos[i * D + a] - pos[j * D + a];
        r2 = r2 + dx * dx;
      }
      float sq = r2 + eps2;
      float num = float(D) * sq - 3.f * r2;
      float ssafe = maxf(sq, 0.f);
      float den = ssafe * ssafe * sqrtf(ssafe);
      float pairm = (s.valid[i] && s.valid[j]) ? s.mass[i] * s.mass[j] : 0.f;
      tr = tr + pairm * num / den;
    }
  out[3] = s.G * 2.f * tr;  // i != j double-counts the i < j sum
}

template <int N, int D>
__global__ void __launch_bounds__(32, 1) analysis_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const float* __restrict__ L0_in, float* __restrict__ out_pos,
    float* __restrict__ out_vel, float* __restrict__ out_eps,
    float* __restrict__ out_pi, float* __restrict__ out_acc,
    float* __restrict__ out_es, float* __restrict__ out_ps, int B,
    int n_steps, int n_sub_max, int interval, float G, float k_wall,
    float eta, float jcap, int bexp, int barrier_on) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sys<N> s;
  float q[N * D], v[N * D], grad[N * D];
  load_system<N, D>(b, B, pos, vel, mass, k_s, mu, alpha, flo, cap, eps_in, G,
                    k_wall, eta, jcap, bexp, barrier_on, s, q, v);
  float eps = eps_in[b], pi = pi_in[b];
  const float h = h_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);
  const float L0 = L0_in[b];
  float nb = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) nb = nb + (s.valid[i] ? 1.f : 0.f);
  nb = maxf(nb, 1.f);

  float es;
  eps_star_and_grad<N, D>(s, q, es, grad);

  // count, then (sum, sumsq, max, min) per metric
  float acc[kAccRows];
  acc[0] = 0.f;
#pragma unroll
  for (int m = 0; m < kAccMetrics; ++m) {
    acc[1 + 4 * m] = 0.f;
    acc[2 + 4 * m] = 0.f;
    acc[3 + 4 * m] = -INFINITY;
    acc[4 + 4 * m] = INFINITY;
  }

  for (int step = 0; step < n_steps; ++step) {
    for (int sub = 0; sub < ns; ++sub)
      strang_trip<N, D>(s, q, v, eps, pi, es, grad, h);
    if (step % interval == 0) {  // the scan path's sampling predicate
      float met[kAccMetrics];
      metrics_of<N, D>(s, q, v, eps, L0, nb, met);
      acc[0] = acc[0] + 1.f;
#pragma unroll
      for (int m = 0; m < kAccMetrics; ++m) {
        float x = met[m];
        acc[1 + 4 * m] = acc[1 + 4 * m] + x;
        acc[2 + 4 * m] = acc[2 + 4 * m] + x * x;
        acc[3 + 4 * m] = maxf(acc[3 + 4 * m], x);
        acc[4 + 4 * m] = minf(acc[4 + 4 * m], x);
      }
      const int row = step / interval;
      out_es[row * B + b] = eps;
      out_ps[row * B + b] = pi;
    }
  }

#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[k * B + b] = q[k];
    out_vel[k * B + b] = v[k];
  }
  out_eps[b] = eps;
  out_pi[b] = pi;
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) out_acc[r * B + b] = acc[r];
}

template <int N, int D>
__global__ void __launch_bounds__(32, 1) megno_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const float* __restrict__ dt_in, const float* __restrict__ dr_in,
    const float* __restrict__ dv_in, float* __restrict__ out_pos,
    float* __restrict__ out_vel, float* __restrict__ out_eps,
    float* __restrict__ out_pi, float* __restrict__ out_accum,
    float* __restrict__ out_t, float* __restrict__ out_ys, int B, int n_steps,
    int n_sub_max, float G, float k_wall, float eta, float jcap, int bexp,
    int barrier_on) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sys<N> s;
  float q[N * D], v[N * D], grad[N * D], dr[N * D], dv[N * D];
  load_system<N, D>(b, B, pos, vel, mass, k_s, mu, alpha, flo, cap, eps_in, G,
                    k_wall, eta, jcap, bexp, barrier_on, s, q, v);
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    dr[k] = dr_in[k * B + b];
    dv[k] = dv_in[k * B + b];
  }
  float eps = eps_in[b], pi = pi_in[b];
  const float h = h_in[b];
  const float dt = dt_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);

  float es;
  eps_star_and_grad<N, D>(s, q, es, grad);
  float accum = 0.f, tt = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    for (int sub = 0; sub < ns; ++sub)
      strang_trip<N, D>(s, q, v, eps, pi, es, grad, h);
    // MEGNO update on the macro-step boundary (diagnostics/megno.py:73-87)
#pragma unroll
    for (int k = 0; k < N * D; ++k) dr[k] = dr[k] + dv[k] * dt;
    float da[N * D];
    tangent_accel<N, D>(s, q, dr, eps, da);
#pragma unroll
    for (int k = 0; k < N * D; ++k) dv[k] = dv[k] + da[k] * dt;
    tt = tt + dt;
    float nr2 = dr[0] * dr[0];
#pragma unroll
    for (int k = 1; k < N * D; ++k) nr2 = nr2 + dr[k] * dr[k];
    float norm_r = sqrtf(nr2);
    // reference quirk: divides by the tiny norm, then treats it as 1
    bool tiny = norm_r < 1e-12f;
    float scale = tiny ? norm_r : 1.f;
#pragma unroll
    for (int k = 0; k < N * D; ++k) {
      dr[k] = dr[k] / scale;
      dv[k] = dv[k] / scale;
    }
    norm_r = tiny ? 1.f : norm_r;
    float nv2 = dv[0] * dv[0];
#pragma unroll
    for (int k = 1; k < N * D; ++k) nv2 = nv2 + dv[k] * dv[k];
    float norm_v = sqrtf(nv2);
    accum = accum + (norm_v / norm_r) * tt * dt;
    out_ys[step * B + b] = 2.f * accum / tt;
  }

#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[k * B + b] = q[k];
    out_vel[k * B + b] = v[k];
  }
  out_eps[b] = eps;
  out_pi[b] = pi;
  out_accum[b] = accum;
  out_t[b] = tt;
}

constexpr int kBlock = 32;

}  // namespace

extern "C" {

int hs_analysis(const float* pos, const float* vel, const float* mass,
                const float* eps, const float* pi, const float* k_s,
                const float* mu, const float* alpha, const float* flo,
                const float* cap, const float* h, const int* nsub,
                const float* L0, float* out_pos, float* out_vel,
                float* out_eps, float* out_pi, float* out_acc, float* out_es,
                float* out_ps, int B, int n_steps, int n_sub_max, int interval,
                float G, float k_wall, float eta, float jcap, int bexp,
                int barrier_on, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + kBlock - 1) / kBlock);
  analysis_kernel<HS_N, HS_D><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, L0, out_pos,
      out_vel, out_eps, out_pi, out_acc, out_es, out_ps, B, n_steps, n_sub_max,
      interval, G, k_wall, eta, jcap, bexp, barrier_on);
  return (int)cudaGetLastError();
}

int hs_megno(const float* pos, const float* vel, const float* mass,
             const float* eps, const float* pi, const float* k_s,
             const float* mu, const float* alpha, const float* flo,
             const float* cap, const float* h, const int* nsub,
             const float* dt, const float* dr, const float* dv,
             float* out_pos, float* out_vel, float* out_eps, float* out_pi,
             float* out_accum, float* out_t, float* out_ys, int B,
             int n_steps, int n_sub_max, float G, float k_wall, float eta,
             float jcap, int bexp, int barrier_on, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + kBlock - 1) / kBlock);
  megno_kernel<HS_N, HS_D><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, dt, dr, dv,
      out_pos, out_vel, out_eps, out_pi, out_accum, out_t, out_ys, B, n_steps,
      n_sub_max, G, k_wall, eta, jcap, bexp, barrier_on);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
