// Fused (eps*, d eps*/dq) kernel for the ham_soft scan path on Hopper
// (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_eps.py:
//   eps_star_and_grad_fused (_eps_grad_kernel, :50) -> hs_eps_grad
// on the shared physics of hamsoft_physics.cuh: the 8 clipped SPH
// iterations seeded from h0, the softmin eps* and the hand-written
// reverse sweep for its exact gradient, then (clamp) the soft policy's
// value clamp to [min(eps_min, eps_max), max(eps_min, eps_max)] with the
// gradient zeroed where the clamp saturates.  The "reference" gradient
// fallback is not ported; the wrapper refuses it.  Masked slots arrive
// with mass 0 and drop out of every sum and of the softmin.
//
// What bounds it: operations.  Per system it reads N (D + 1) + 4 floats
// and writes N D + 1, while the forward solve and the reverse sweep spend
// about 9 N (N - 1) expf and ~10^3 (N = 3) to ~10^4 (N = 8) FP32
// operations.  Design: one thread per system with its bodies, the 9
// stored iterates and the gradient in registers; the row-major (B, N, D)
// tensors of the scan path are read and written in place (a warp's loads
// cover whole cache lines), so the wrapper needs no transposes; 128-thread
// blocks, since the scan path calls it on every substep at widths of
// 10^4 to 10^6 systems.

#include "hamsoft_physics.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif

namespace {

template <int N, int D>
__global__ void __launch_bounds__(128) eps_grad_kernel(
    const float* __restrict__ pos, const float* __restrict__ mass,
    const float* __restrict__ h0, const float* __restrict__ alpha,
    const float* __restrict__ emin, const float* __restrict__ emax,
    float* __restrict__ out_es, float* __restrict__ out_grad, int B,
    float eta, int clamp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sys<N> s;
  float q[N * D], g[N * D];
#pragma unroll
  for (int k = 0; k < N * D; ++k) q[k] = pos[(size_t)b * (N * D) + k];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float m = mass[(size_t)b * N + i];
    s.mass[i] = m;
    s.valid[i] = m > 0.f;
    s.mval[i] = s.valid[i] ? m : 0.f;
    s.inv_m[i] = s.valid[i] ? 1.f / maxf(m, 1e-30f) : 0.f;
  }
  // bound resolution exactly as eps_target_production
  const float lo = minf(emin[b], emax[b]);
  const float hi = maxf(emin[b], emax[b]);
  s.flo = maxf(lo, 1e-12f);
  s.cap = maxf(s.flo, hi);
  s.alpha = alpha[b];
  s.eps_seed = h0[b];
  s.eta = eta;
  s.k_s = 1.f;
  s.mu = 1.f;
  s.G = 1.f;
  s.k_wall = 0.f;
  s.jcap = 0.02f;
  s.bexp = 5;
  s.barrier_on = false;

  float es;
  eps_star_and_grad<N, D>(s, q, es, g);
  if (clamp) {
    const bool gate = (es >= lo) && (es <= hi);
#pragma unroll
    for (int k = 0; k < N * D; ++k) g[k] = gate ? g[k] : 0.f;
    es = clipf(es, lo, hi);
  }
  out_es[b] = es;
#pragma unroll
  for (int k = 0; k < N * D; ++k) out_grad[(size_t)b * (N * D) + k] = g[k];
}

constexpr int kBlock = 128;

}  // namespace

extern "C" {

int hs_eps_grad(const float* pos, const float* mass, const float* h0,
                const float* alpha, const float* emin, const float* emax,
                float* out_es, float* out_grad, int B, float eta, int clamp,
                void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + kBlock - 1) / kBlock);
  eps_grad_kernel<HS_N, HS_D><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      pos, mass, h0, alpha, emin, emax, out_es, out_grad, B, eta, clamp);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
