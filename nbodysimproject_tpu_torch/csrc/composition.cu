// Fused multi-step kick-drift composition kernel (velocity Verlet and the
// Yoshida4 triple jump) for Hopper (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_batch.py:
//   composition_multistep (_composition_multistep_kernel, :49) -> hs_composition
// (verlet_multistep :175 and yoshida4_multistep :182 are its two schemes).
// Each step runs the stage table (drift d_s h, then a full kick k_s h with
// the softened direct acceleration); the velocity lives at the first
// stage's half-step inside the loop, so adjacent half-kicks of
// consecutive stages and steps are fused into one kick, and half-kicks of
// d_0 h / 2 open and close the horizon.  G is folded into the masses and
// the pair term uses rsqrt, as in the Pallas kernel.  No mask: every slot
// is a body (the wrapper refuses a mask).
//
// What bounds it: operations.  Per system it reads and writes 4 N D + N + 1
// floats once, while each step costs about 20 FP32 operations per pair and
// stage (3 pairs at N = 3: ~80 per Verlet step).  Design: one thread per
// system for the whole horizon with positions, half-step velocities and
// accelerations in registers (~40 live floats at N = 3, so occupancy is
// high); the row-major (B, N, D) tensors are read at entry and written at
// exit only; 256-thread blocks.

#include <cuda_runtime.h>
#include <math.h>

#ifndef HS_N
#define HS_N 3
#endif
#ifndef HS_D
#define HS_D 2
#endif

namespace {

constexpr int kMaxStages = 3;

// drift and kick coefficients of each stage, already multiplied by h and
// rounded to float32 on the host, and the opening/closing half-kick
struct Stages {
  float dh[kMaxStages];
  float kh[kMaxStages];
  float k_half;
  int n;
};

template <int N, int D>
__device__ __forceinline__ void accel(const float* pos, const float* gmass,
                                      float eps2, float* acc) {
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
      float inv_r = rsqrtf(r2);
      float w = inv_r * inv_r * inv_r;
      float wi = gmass[j] * w;
      float wj = gmass[i] * w;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        acc[i * D + a] = acc[i * D + a] - wi * dx[a];
        acc[j * D + a] = acc[j * D + a] + wj * dx[a];
      }
    }
}

template <int N, int D>
__global__ void __launch_bounds__(256) composition_kernel(
    const float* __restrict__ pos_in, const float* __restrict__ vel_in,
    const float* __restrict__ mass, const float* __restrict__ eps2_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel, int B,
    int n_steps, float G, Stages st) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float pos[N * D], vel[N * D], acc[N * D], gmass[N];
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    pos[k] = pos_in[(size_t)b * (N * D) + k];
    vel[k] = vel_in[(size_t)b * (N * D) + k];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) gmass[i] = G * mass[(size_t)b * N + i];
  const float eps2 = eps2_in[b];

  accel<N, D>(pos, gmass, eps2, acc);
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + st.k_half * acc[k];
  for (int step = 0; step < n_steps; ++step) {
    for (int s = 0; s < st.n; ++s) {
#pragma unroll
      for (int k = 0; k < N * D; ++k) pos[k] = pos[k] + st.dh[s] * vel[k];
      accel<N, D>(pos, gmass, eps2, acc);
#pragma unroll
      for (int k = 0; k < N * D; ++k) vel[k] = vel[k] + st.kh[s] * acc[k];
    }
  }
  // close the trailing half-step: v_T = v_{T+1/2} - (d_0 h / 2) a_T
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[(size_t)b * (N * D) + k] = pos[k];
    out_vel[(size_t)b * (N * D) + k] = vel[k] - st.k_half * acc[k];
  }
}

constexpr int kBlock = 256;

}  // namespace

extern "C" {

int hs_composition(const float* pos, const float* vel, const float* mass,
                   const float* eps2, float* out_pos, float* out_vel, int B,
                   int n_steps, float G, const float* dh, const float* kh,
                   int n_stages, float k_half, void* stream) {
  if (B <= 0) return 0;
  if (n_stages < 1 || n_stages > kMaxStages) return (int)cudaErrorInvalidValue;
  Stages st;
  for (int s = 0; s < kMaxStages; ++s) {
    st.dh[s] = s < n_stages ? dh[s] : 0.f;
    st.kh[s] = s < n_stages ? kh[s] : 0.f;
  }
  st.k_half = k_half;
  st.n = n_stages;
  dim3 grid((B + kBlock - 1) / kBlock);
  composition_kernel<HS_N, HS_D><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      pos, vel, mass, eps2, out_pos, out_vel, B, n_steps, G, st);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
