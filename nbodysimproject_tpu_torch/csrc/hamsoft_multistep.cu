// Fused multi-step ham_soft integration kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_hamsoft.py:
//   hamsoft_multistep (_hamsoft_multistep_kernel, :508) -> hs_multistep
// on the shared physics of hamsoft_physics.cuh: n_steps macro steps, each
// system running its own n_sub Strang trips of size h, no sampling.  Both
// barrier policies: "soft" (wall kicks on pi) and "reflection" (closed-form
// folds of (eps, pi) around each flow); the exact eps* gradient.
//
// What bounds it: operations, as for the analysis kernel.  A trip spends
// about 10^3 FP32 operations at N = 3 and 10^4 at N = 8 (the 8 SPH
// iterations and the recomputing reverse sweep), against a few dozen
// floats in and out per system for the whole horizon.  Design:
//   * one thread owns one system for the whole call: bodies, (eps*, grad)
//     cache and scalars in registers; device memory is touched at entry
//     and exit only;
//   * inputs are coordinate-major ((N*D, B) and (B,) rows), so
//     neighbouring threads read neighbouring addresses;
//   * each thread runs its own n_sub trips per macro step (the Pallas
//     kernel masks up to n_sub_max; a masked trip is an exact identity);
//   * the SPH solve is seeded from the kernel-entry eps, as in the Pallas
//     kernel, so a horizon cut into several calls seeds each call anew;
//   * one-warp blocks with the analysis kernel's launch bounds (up to 255
//     registers a thread: the N = 8 trip spills even so); at the bench
//     widths (2^20 systems) the grid fills every SM many times over.

#include "hamsoft_physics.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif

namespace {

template <int N, int D, bool REFL>
__global__ void __launch_bounds__(32, 1) multistep_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel,
    float* __restrict__ out_eps, float* __restrict__ out_pi, int B,
    int n_steps, int n_sub_max, float G, float k_wall, float eta, float jcap,
    int bexp, int barrier_on) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Sys<N> s;
  float q[N * D], v[N * D], grad[N * D];
  load_system<N, D>(b, B, pos, vel, mass, k_s, mu, alpha, flo, cap, eps_in, G,
                    k_wall, eta, jcap, bexp, barrier_on, s, q, v);
  float eps = eps_in[b], pi = pi_in[b];
  const float h = h_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);

  float es;
  eps_star_and_grad<N, D>(s, q, es, grad);
  for (int step = 0; step < n_steps; ++step)
    for (int sub = 0; sub < ns; ++sub)
      strang_trip<N, D, REFL>(s, q, v, eps, pi, es, grad, h);

#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[k * B + b] = q[k];
    out_vel[k * B + b] = v[k];
  }
  out_eps[b] = eps;
  out_pi[b] = pi;
}

constexpr int kBlock = 32;

}  // namespace

extern "C" {

int hs_multistep(const float* pos, const float* vel, const float* mass,
                 const float* eps, const float* pi, const float* k_s,
                 const float* mu, const float* alpha, const float* flo,
                 const float* cap, const float* h, const int* nsub,
                 float* out_pos, float* out_vel, float* out_eps,
                 float* out_pi, int B, int n_steps, int n_sub_max, float G,
                 float k_wall, float eta, float jcap, int bexp, int barrier_on,
                 int reflection, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + kBlock - 1) / kBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (reflection)
    multistep_kernel<HS_N, HS_D, true><<<grid, kBlock, 0, st>>>(
        pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, out_pos,
        out_vel, out_eps, out_pi, B, n_steps, n_sub_max, G, k_wall, eta, jcap,
        bexp, barrier_on);
  else
    multistep_kernel<HS_N, HS_D, false><<<grid, kBlock, 0, st>>>(
        pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, out_pos,
        out_vel, out_eps, out_pi, B, n_steps, n_sub_max, G, k_wall, eta, jcap,
        bexp, barrier_on);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
