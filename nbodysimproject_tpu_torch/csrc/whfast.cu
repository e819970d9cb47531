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
//     hyperbolic orbits), the Stumpff c2/c3 as a series for |z| <= 0.3 and
//     in closed form outside it, cosh/sinh through expf with the argument
//     clamped at 88; slot 0 anchored at the centre of mass;
//   * the kick: the softened direct acceleration (rsqrtf of r^2 + eps2
//     floored at 1e-30) plus the Jacobi back-reaction suffix sum, zero on
//     zero-mass (padded) slots.
// Bodies are ordered with the dominant mass first (the Jacobi convention).
//
// What bounds it: operations.  A system reads and writes 4 N D + N + 1
// floats once and does, per step, N - 1 Kepler solves of about
// 25 + 35 iters + 32 operations plus a Stumpff evaluation per update and
// one at the end, and an interaction kick of about 12 operations per pair
// and 12 per body (chip_smoke.py::whfast_ops counts them off these loops,
// each add, multiply, divide, fabsf, sqrtf, rsqrtf, expf, logf, cos or sin
// as one operation and an FMA as two, compares and selects as none).  The
// Pallas kernel evaluates both Stumpff forms and selects, since a TPU lane
// cannot branch; here a thread branches, so the series (10 FMAs in Horner
// form on float32 reciprocal factorials, no division) runs inside the
// window and the closed form (a square root, sincosf or expf, three
// divisions) only outside it; so does the hyperbolic seed.  Bench.py's
// orbits keep nearly every z inside the window.  One thread per system
// for the whole horizon, bodies in registers, the (B, N, D) tensors read
// at entry and written at exit only, 256-thread blocks.  The build has
// -fmad=false, so the multiply-adds written here as __fmaf_rn (the
// Laguerre–Conway update, the f/g epilogue, the Jacobi and centre-of-mass
// sums, the pair kick) are the only contracted ones; the kernel is
// therefore not bitwise its plain PyTorch version, which keeps the JAX
// source's expressions (PERF.md section 6, row 6, states the difference).
//
// NaN handling follows the Pallas kernel's jnp.minimum / jnp.maximum, which
// propagate NaN: the clamps are written as selects, not fminf / fmaxf, and
// a NaN z takes the closed form, as the Pallas kernel's select does.

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

// the series' coefficients 1 / k!, rounded to float32 once
constexpr float kInv24 = 1.0f / 24.0f, kInv720 = 1.0f / 720.0f,
                kInv40320 = 1.0f / 40320.0f,
                kInv3628800 = 1.0f / 3628800.0f,
                kInv479001600 = 1.0f / 479001600.0f;
constexpr float kInv6 = 1.0f / 6.0f, kInv120 = 1.0f / 120.0f,
                kInv5040 = 1.0f / 5040.0f, kInv362880 = 1.0f / 362880.0f,
                kInv39916800 = 1.0f / 39916800.0f,
                kInv6227020800 = 1.0f / 6227020800.0f;

// c2(z), c3(z) in closed form: cos and sin of sqrt(z) for z > 0, cosh
// and sinh through expf of sqrt(-z) clamped at 88 otherwise
__device__ __forceinline__ Stumpff stumpff_closed(float z) {
  float c0, c1;
  if (z > 0.f) {
    const float s_e = sqrtf(z);
    float sn;
    sincosf(s_e, &sn, &c0);
    c1 = sn / s_e;
  } else {
    float s_h = sqrtf(-z);
    s_h = s_h > 88.0f ? 88.0f : s_h;
    const float e_h = expf(s_h);
    const float inv_e = 1.0f / e_h;
    c0 = 0.5f * (e_h + inv_e);
    c1 = 0.5f * (e_h - inv_e) / s_h;
  }
  return {(1.0f - c0) / z, (1.0f - c1) / z};
}

// c2(z), c3(z) as their series to z^5, in Horner form
__device__ __forceinline__ Stumpff stumpff_series(float z) {
  Stumpff s;
  float p = __fmaf_rn(z, -kInv479001600, kInv3628800);
  p = __fmaf_rn(z, p, -kInv40320);
  p = __fmaf_rn(z, p, kInv720);
  p = __fmaf_rn(z, p, -kInv24);
  s.c2 = __fmaf_rn(z, p, 0.5f);
  p = __fmaf_rn(z, -kInv6227020800, kInv39916800);
  p = __fmaf_rn(z, p, -kInv362880);
  p = __fmaf_rn(z, p, kInv5040);
  p = __fmaf_rn(z, p, -kInv120);
  s.c3 = __fmaf_rn(z, p, kInv6);
  return s;
}

// the series for |z| <= 0.3, else the closed form, which is evaluated
// only where it is taken (a NaN z takes it, as the Pallas kernel's
// select does)
__device__ __forceinline__ Stumpff stumpff23(float z) {
  if (!(fabsf(z) <= 0.3f)) return stumpff_closed(z);
  return stumpff_series(z);
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
    r0sq = __fmaf_rn(r[a], r[a], r0sq);
    rv = __fmaf_rn(r[a], v[a], rv);
    v2 = __fmaf_rn(v[a], v[a], v2);
  }
  const float r0 = sqrtf(r0sq);
  const bool degenerate = r0 < 1e-14f;
  const float r0s = degenerate ? 1.0f : r0;
  const float vr0 = rv / r0s;
  const float alpha = 2.0f / r0s - v2 / mu;
  const float sqrt_mu = sqrtf(mu);
  float chi = fabsf(alpha) > 1e-12f ? sqrt_mu * fabsf(alpha) * dt
                                    : sqrt_mu * dt / r0s;
  // Vallado's logarithmic hyperbolic seed, only on hyperbolic orbits
  if (alpha < -1e-12f) {
    const float log_num = -2.0f * mu * alpha * dt;
    const float log_den =
        __fmaf_rn(sgn_dt * sqrtf(-mu / alpha), __fmaf_rn(-r0s, alpha, 1.0f),
                  r0s * vr0);
    const float log_arg = log_num / (log_den == 0.f ? 1.0f : log_den);
    if (log_den != 0.f && log_arg > 0.f)
      chi = sgn_dt * sqrtf(-1.0f / alpha) * logf(log_arg);
  }

  const float a1 = r0s * vr0 / sqrt_mu;
  const float a2 = __fmaf_rn(-alpha, r0s, 1.0f);
  const float ln = 5.0f;
  const float smudt = sqrt_mu * dt;
  for (int it = 0; it < iters; ++it) {
    const float chi2 = chi * chi;
    const float z = alpha * chi2;
    const Stumpff s = stumpff23(z);
    const float omz3 = __fmaf_rn(-z, s.c3, 1.0f);  // 1 - z c3
    const float a2chi2 = a2 * chi2;
    const float f = __fmaf_rn(
        a1 * chi2, s.c2,
        __fmaf_rn(a2chi2 * chi, s.c3, __fmaf_rn(r0s, chi, -smudt)));
    const float fp =
        __fmaf_rn(a1 * chi, omz3, __fmaf_rn(a2chi2, s.c2, r0s));
    const float fpp =
        __fmaf_rn(a1, __fmaf_rn(-z, s.c2, 1.0f), a2 * chi * omz3);
    const float disc =
        sqrtf(fabsf(__fmaf_rn(16.0f * fp, fp, -20.0f * f * fpp)));
    const float den = fp + (fp >= 0.f ? disc : -disc);
    const bool den_bad = den == 0.f;
    const float step = ln * f / (den_bad ? 1.0f : den);
    chi = chi - (den_bad ? 0.f : step);
  }

  // f/g epilogue
  const float chi2 = chi * chi;
  const float z = alpha * chi2;
  const Stumpff s = stumpff23(z);
  const float chi2c2 = chi2 * s.c2;
  const float chi3c3 = chi2 * chi * s.c3;
  const float ff = 1.0f - chi2c2 / r0s;
  const float gg = dt - chi3c3 / sqrt_mu;
  float r_new[D];
#pragma unroll
  for (int a = 0; a < D; ++a) r_new[a] = __fmaf_rn(ff, r[a], gg * v[a]);
  float rn2 = r_new[0] * r_new[0];
#pragma unroll
  for (int a = 1; a < D; ++a) rn2 = __fmaf_rn(r_new[a], r_new[a], rn2);
  const float rn = sqrtf(rn2);
  const bool rn_zero = rn == 0.f;
  const float rns = rn_zero ? 1.0f : rn;
  const float fdot =
      sqrt_mu / (rns * r0s) * __fmaf_rn(alpha, chi3c3, -chi);
  const float gdot = 1.0f - chi2c2 / rns;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const float v_new =
        rn_zero ? v[a] : __fmaf_rn(fdot, r[a], gdot * v[a]);
    const float r_out = degenerate ? __fmaf_rn(v[a], dt, r[a]) : r_new[a];
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
        jx[i * D + a] = __fmaf_rn(-Rs[a], inv_cm[i - 1], x[i * D + a]);
      if (i < N - 1) {
#pragma unroll
        for (int a = 0; a < D; ++a)
          Rs[a] = __fmaf_rn(mass[i], x[i * D + a], Rs[a]);
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
        for (int a = 0; a < D; ++a) s[a] = __fmaf_rn(w, jx[i * D + a], s[a]);
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
        sq = __fmaf_rn(mass[i], pos[i * D + a], sq);
        sv = __fmaf_rn(mass[i], vel[i * D + a], sv);
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
        sq = __fmaf_rn(mass[i], pos[i * D + a], sq);
        sv = __fmaf_rn(mass[i], vel[i * D + a], sv);
      }
      const float dq = __fmaf_rn(-sq, invM, __fmaf_rn(comv[a], dt, comq[a]));
      const float dv = __fmaf_rn(-sv, invM, comv[a]);
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
          r2 = __fmaf_rn(dx[a], dx[a], r2);
        }
        const float inv_r = rsqrtf(r2 < 1e-30f ? 1e-30f : r2);
        const float w = inv_r * inv_r * inv_r;
        const float wi = (G * mass[j]) * w;
        const float wj = (G * mass[i]) * w;
#pragma unroll
        for (int a = 0; a < D; ++a) {
          acc[i * D + a] = __fmaf_rn(-wi, dx[a], acc[i * D + a]);
          acc[j * D + a] = __fmaf_rn(wj, dx[a], acc[j * D + a]);
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
      for (int a = 0; a < D; ++a)
        jr2 = __fmaf_rn(jp[i * D + a], jp[i * D + a], jr2);
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
            live[i]
                ? __fmaf_rn(mprev_over_m, wvec[i * D + a], acc[i * D + a]) -
                      S[a]
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
    for (int k = 0; k < N * D; ++k) vel[k] = __fmaf_rn(h, acc[k], vel[k]);
    sys.drift(pos, vel, h, sgn, iters);
  }
  sys.accel(pos, acc);
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = __fmaf_rn(h, acc[k], vel[k]);
  sys.drift(pos, vel, half_h, sgn, iters);
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[(size_t)b * (N * D) + k] = pos[k];
    out_vel[(size_t)b * (N * D) + k] = vel[k];
  }
}

constexpr int kBlock = 256;

// the Stumpff functions alone, for the tests: per z, the branch
// stumpff23 takes and both of its forms, as (c2, c3) pairs in out
// (B, 3, 2)
__global__ void stumpff_probe(const float* __restrict__ z,
                              float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Stumpff s[3] = {stumpff23(z[b]), stumpff_series(z[b]),
                        stumpff_closed(z[b])};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[(size_t)b * 6 + 2 * k] = s[k].c2;
    out[(size_t)b * 6 + 2 * k + 1] = s[k].c3;
  }
}

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

int hs_whfast_stumpff(const float* z, float* out, int B, void* stream) {
  if (B <= 0) return 0;
  stumpff_probe<<<(B + kBlock - 1) / kBlock, kBlock, 0,
                  (cudaStream_t)stream>>>(z, out, B);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
