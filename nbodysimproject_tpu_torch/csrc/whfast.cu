// Fused multi-step batched WHFast (Wisdom–Holman) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_whfast.py:
//   whfast_multistep (:331; body _whfast_multistep_kernel :162, helpers
//   _kepler_lc_blocks :81 and _stumpff23 :47) -> hs_whfast
// Each system advances n_steps Wisdom–Holman steps D(h/2) K(h) D(h/2) with
// the interior half-drifts merged, D(h/2) [K(h) D(h)]^{n-1} K(h) D(h/2)
// (n_steps + 1 Kepler solves):
//   * Jacobi transforms as prefix sums over the bodies, with the reciprocal
//     interior masses of the Pallas kernel (multiplications, not divisions);
//   * the drift: the centre of mass linearly, each body i >= 1 on a Kepler
//     orbit of mu_i = G cum_i in Jacobi coordinates, solved by fixed-depth
//     Laguerre–Conway (n = 5, `iters` updates, Vallado's logarithmic seed on
//     hyperbolic orbits), the closed-form Stumpff c2/c3 with the series
//     window |z| <= 0.3 and cosh/sinh through expf with the argument clamped
//     at 88; slot 0 anchored at the centre of mass;
//   * the kick: the softened direct acceleration (rsqrtf of r^2 + eps2
//     floored at 1e-30) plus the Jacobi back-reaction suffix sum, zero on
//     zero-mass (padded) slots.
// Bodies are ordered with the dominant mass first (the Jacobi convention).
//
// What bounds it: operations.  A system reads and writes 4 N D + N + 1
// floats once and does, per step, N - 1 Kepler solves of about
// 60 + 49 iters + 40 operations plus a Stumpff evaluation (one of expf,
// or cosf and sinf, and two divisions: 20 operations) per update and one
// at the end, and an interaction kick of about 12 operations per pair and
// 12 per body (chip_smoke.py::whfast_ops counts them off these loops, each
// add, multiply, divide, sqrtf, rsqrtf, expf, logf, cosf or sinf as one
// operation, compares and selects as none).  Design: one thread per system
// for the whole horizon, bodies in registers, the (B, N, D) tensors read at
// entry and written at exit only, 256-thread blocks.  Built with
// -fmad=false, so it rounds as its plain PyTorch version does.
//
// NaN handling follows the Pallas kernel's jnp.minimum / jnp.maximum, which
// propagate NaN: the clamps are written as selects, not fminf / fmaxf.

#include <cuda_runtime.h>
#include <math.h>

#ifndef HS_N
#define HS_N 3
#endif
#ifndef HS_D
#define HS_D 2
#endif

namespace {

struct Stumpff {
  float c2, c3;
};

__device__ __forceinline__ Stumpff stumpff23(float z) {
  const bool small = fabsf(z) <= 0.3f;
  const float zs = small ? z : 0.f;
  const float z2 = zs * zs;
  const float z3 = z2 * zs;
  const float z4 = z2 * z2;
  const float z5 = z4 * zs;
  const float c2_s = 0.5f - zs / 24.0f + z2 / 720.0f - z3 / 40320.0f +
                     z4 / 3628800.0f - z5 / 479001600.0f;
  const float c3_s = (1.0f / 6.0f) - zs / 120.0f + z2 / 5040.0f -
                     z3 / 362880.0f + z4 / 39916800.0f - z5 / 6227020800.0f;
  const bool pos = z > 0.f;
  float c0, c1;
  if (pos) {
    const float s_e = sqrtf(z);
    c0 = cosf(s_e);
    c1 = sinf(s_e) / s_e;
  } else {
    float s_h = sqrtf(-z);
    s_h = s_h > 88.0f ? 88.0f : s_h;
    const float e_h = expf(s_h);
    const float inv_e = 1.0f / e_h;
    c0 = 0.5f * (e_h + inv_e);
    c1 = 0.5f * (e_h - inv_e) / s_h;
  }
  const float z_safe = small ? 1.0f : z;
  Stumpff s;
  s.c2 = small ? c2_s : (1.0f - c0) / z_safe;
  s.c3 = small ? c3_s : (1.0f - c1) / z_safe;
  return s;
}

// Laguerre–Conway propagation of one Jacobi pair (r, v) under mu for dt
// (pallas_whfast.py:81-159), in place.
template <int D>
__device__ __forceinline__ void kepler_lc(float* r, float* v, float mu,
                                          float dt, float sgn_dt,
                                          int iters) {
  float r0sq = r[0] * r[0];
  float rv = r[0] * v[0];
  float v2 = v[0] * v[0];
#pragma unroll
  for (int a = 1; a < D; ++a) {
    r0sq = r0sq + r[a] * r[a];
    rv = rv + r[a] * v[a];
    v2 = v2 + v[a] * v[a];
  }
  const float r0 = sqrtf(r0sq);
  const bool degenerate = r0 < 1e-14f;
  const float r0s = degenerate ? 1.0f : r0;
  const float vr0 = rv / r0s;
  const float alpha = 2.0f / r0s - v2 / mu;
  const float sqrt_mu = sqrtf(mu);
  const float chi0 = fabsf(alpha) > 1e-12f ? sqrt_mu * fabsf(alpha) * dt
                                           : sqrt_mu * dt / r0s;
  // Vallado's logarithmic hyperbolic seed
  const bool hyp = alpha < -1e-12f;
  const float alpha_h = hyp ? alpha : -1.0f;
  const float log_num = -2.0f * mu * alpha_h * dt;
  const float log_den =
      r0s * vr0 + sgn_dt * sqrtf(-mu / alpha_h) * (1.0f - r0s * alpha_h);
  const float log_arg = log_num / (log_den == 0.f ? 1.0f : log_den);
  const bool hyp_ok = hyp && (log_den != 0.f) && (log_arg > 0.f);
  const float chi0_hyp =
      sgn_dt * sqrtf(-1.0f / alpha_h) * logf(hyp_ok ? log_arg : 1.0f);
  float chi = hyp_ok ? chi0_hyp : chi0;

  const float a1 = r0s * vr0 / sqrt_mu;
  const float a2 = 1.0f - alpha * r0s;
  const float ln = 5.0f;
  const float smudt = sqrt_mu * dt;
  for (int it = 0; it < iters; ++it) {
    const float z = alpha * chi * chi;
    const Stumpff s = stumpff23(z);
    const float chi2 = chi * chi;
    const float f = a1 * chi2 * s.c2 + a2 * chi2 * chi * s.c3 + r0s * chi -
                    smudt;
    const float fp = a1 * chi * (1.0f - z * s.c3) + a2 * chi2 * s.c2 + r0s;
    const float fpp = a1 * (1.0f - z * s.c2) + a2 * chi * (1.0f - z * s.c3);
    const float disc =
        sqrtf(fabsf(16.0f * fp * fp - 20.0f * f * fpp));
    const float den = fp + (fp >= 0.f ? disc : -disc);
    const bool den_bad = den == 0.f;
    const float step = ln * f / (den_bad ? 1.0f : den);
    chi = chi - (den_bad ? 0.f : step);
  }

  // f/g epilogue
  const float z = alpha * chi * chi;
  const Stumpff s = stumpff23(z);
  const float chi2 = chi * chi;
  const float ff = 1.0f - chi2 * s.c2 / r0s;
  const float gg = dt - chi2 * chi * s.c3 / sqrt_mu;
  float r_new[D];
#pragma unroll
  for (int a = 0; a < D; ++a) r_new[a] = ff * r[a] + gg * v[a];
  float rn2 = r_new[0] * r_new[0];
#pragma unroll
  for (int a = 1; a < D; ++a) rn2 = rn2 + r_new[a] * r_new[a];
  const float rn = sqrtf(rn2);
  const bool rn_zero = rn == 0.f;
  const float rns = rn_zero ? 1.0f : rn;
  const float fdot = sqrt_mu / (rns * r0s) * (alpha * chi2 * chi * s.c3 - chi);
  const float gdot = 1.0f - chi2 * s.c2 / rns;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const float v_new = rn_zero ? v[a] : fdot * r[a] + gdot * v[a];
    const float r_out = degenerate ? r[a] + v[a] * dt : r_new[a];
    v[a] = degenerate ? v[a] : v_new;
    r[a] = r_out;
  }
}

template <int N, int D>
struct System {
  float mass[N], cm[N], inv_cm[N], mu[N], msafe[N];
  bool live[N];
  float eps2, G;

  __device__ __forceinline__ void to_jacobi(const float* x, float* jx) const {
    float Rs[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      jx[a] = x[a];
      Rs[a] = mass[0] * x[a];
    }
#pragma unroll
    for (int i = 1; i < N; ++i) {
#pragma unroll
      for (int a = 0; a < D; ++a)
        jx[i * D + a] = x[i * D + a] - Rs[a] * inv_cm[i - 1];
      if (i < N - 1) {
#pragma unroll
        for (int a = 0; a < D; ++a)
          Rs[a] = Rs[a] + mass[i] * x[i * D + a];
      }
    }
  }

  __device__ __forceinline__ void from_jacobi(const float* jx,
                                              float* x) const {
    float s[D];
#pragma unroll
    for (int a = 0; a < D; ++a) s[a] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int a = 0; a < D; ++a) x[i * D + a] = jx[i * D + a] + s[a];
      if (i < N - 1) {
        const float w = mass[i] * inv_cm[i];
#pragma unroll
        for (int a = 0; a < D; ++a) s[a] = s[a] + w * jx[i * D + a];
      }
    }
  }

  // D(dt): centre of mass linearly, bodies i >= 1 on Kepler orbits in
  // Jacobi coordinates, reconstructed with slot 0 zeroed and translated so
  // the centre of mass lands on its free drift
  __device__ __forceinline__ void drift(float* pos, float* vel, float dt,
                                        float sgn_dt, int iters) const {
    float jp[N * D], jv[N * D];
    to_jacobi(pos, jp);
    to_jacobi(vel, jv);
    const float invM = inv_cm[N - 1];
    float comq[D], comv[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float sq = mass[0] * pos[a];
      float sv = mass[0] * vel[a];
#pragma unroll
      for (int i = 1; i < N; ++i) {
        sq = sq + mass[i] * pos[i * D + a];
        sv = sv + mass[i] * vel[i * D + a];
      }
      comq[a] = sq * invM;
      comv[a] = sv * invM;
      jp[a] = 0.f;
      jv[a] = 0.f;
    }
#pragma unroll
    for (int i = 1; i < N; ++i)
      kepler_lc<D>(jp + i * D, jv + i * D, mu[i], dt, sgn_dt, iters);
    from_jacobi(jp, pos);
    from_jacobi(jv, vel);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float sq = mass[0] * pos[a];
      float sv = mass[0] * vel[a];
#pragma unroll
      for (int i = 1; i < N; ++i) {
        sq = sq + mass[i] * pos[i * D + a];
        sv = sv + mass[i] * vel[i * D + a];
      }
      const float dq = comq[a] + comv[a] * dt - sq * invM;
      const float dv = comv[a] - sv * invM;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        pos[i * D + a] = pos[i * D + a] + dq;
        vel[i * D + a] = vel[i * D + a] + dv;
      }
    }
  }

  // a_int = -grad V_int / m: softened direct acceleration plus the Jacobi
  // back-reaction suffix sum
  __device__ __forceinline__ void accel(const float* pos, float* acc) const {
#pragma unroll
    for (int k = 0; k < N * D; ++k) acc[k] = 0.f;
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
        const float inv_r = rsqrtf(r2 < 1e-30f ? 1e-30f : r2);
        const float w = inv_r * inv_r * inv_r;
        const float wi = (G * mass[j]) * w;
        const float wj = (G * mass[i]) * w;
#pragma unroll
        for (int a = 0; a < D; ++a) {
          acc[i * D + a] = acc[i * D + a] - wi * dx[a];
          acc[j * D + a] = acc[j * D + a] + wj * dx[a];
        }
      }
    float jp[N * D], wvec[N * D];
    to_jacobi(pos, jp);
#pragma unroll
    for (int a = 0; a < D; ++a) wvec[a] = 0.f;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      float jr2 = eps2;
#pragma unroll
      for (int a = 0; a < D; ++a) jr2 = jr2 + jp[i * D + a] * jp[i * D + a];
      const float inv_jr = rsqrtf(jr2 < 1e-30f ? 1e-30f : jr2);
      const float wfac =
          live[i] ? G * mass[i] * inv_jr * inv_jr * inv_jr : 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) wvec[i * D + a] = wfac * jp[i * D + a];
    }
    float S[D];
#pragma unroll
    for (int a = 0; a < D; ++a) S[a] = 0.f;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const float mprev_over_m =
          live[i] ? (i >= 1 ? cm[i - 1] : 1.0f) / msafe[i] : 0.f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        acc[i * D + a] =
            live[i] ? acc[i * D + a] + mprev_over_m * wvec[i * D + a] - S[a]
                    : 0.f;
        S[a] = S[a] + wvec[i * D + a];
      }
    }
  }
};

template <int N, int D>
__global__ void __launch_bounds__(256) whfast_kernel(
    const float* __restrict__ pos_in, const float* __restrict__ vel_in,
    const float* __restrict__ mass_in, const float* __restrict__ eps2_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel, int B,
    int n_steps, float h, float half_h, float G, int iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  System<N, D> sys;
  float pos[N * D], vel[N * D], acc[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    pos[k] = pos_in[(size_t)b * (N * D) + k];
    vel[k] = vel_in[(size_t)b * (N * D) + k];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sys.mass[i] = mass_in[(size_t)b * N + i];
  sys.eps2 = eps2_in[b];
  sys.G = G;
  sys.cm[0] = sys.mass[0];
#pragma unroll
  for (int i = 1; i < N; ++i) sys.cm[i] = sys.cm[i - 1] + sys.mass[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sys.inv_cm[i] = 1.0f / sys.cm[i];
    sys.mu[i] = G * sys.cm[i];
    sys.live[i] = sys.mass[i] > 0.f;
    sys.msafe[i] = sys.live[i] ? sys.mass[i] : 1.0f;
  }
  const float sgn = h >= 0.f ? 1.0f : -1.0f;

  sys.drift(pos, vel, half_h, sgn, iters);
  for (int step = 0; step < n_steps - 1; ++step) {
    sys.accel(pos, acc);
#pragma unroll
    for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + h * acc[k];
    sys.drift(pos, vel, h, sgn, iters);
  }
  sys.accel(pos, acc);
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + h * acc[k];
  sys.drift(pos, vel, half_h, sgn, iters);
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[(size_t)b * (N * D) + k] = pos[k];
    out_vel[(size_t)b * (N * D) + k] = vel[k];
  }
}

constexpr int kBlock = 256;

}  // namespace

extern "C" {

int hs_whfast(const float* pos, const float* vel, const float* mass,
              const float* eps2, float* out_pos, float* out_vel, int B,
              int n_steps, float h, float half_h, float G, int iters,
              void* stream) {
  if (B <= 0) return 0;
  if (n_steps < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((B + kBlock - 1) / kBlock);
  whfast_kernel<HS_N, HS_D><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      pos, vel, mass, eps2, out_pos, out_vel, B, n_steps, h, half_h, G,
      iters);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
