// Fused multi-step kick-drift composition kernel (velocity Verlet and the
// Yoshida4 triple jump) for Hopper (sm_90a), 2 <= N <= 16 bodies, d = 2
// or 3.
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
// floats once, while a stage costs a drift and a kick (N D FMAs each) and,
// per pair, D subtractions, D FMAs for r^2, an rsqrt, four multiplies and
// 2 D FMAs into the accelerations.  At N = 3, d = 2 that is 51 FP32 and
// MUFU instructions a Verlet step, and the H100 issues one warp
// instruction a clock on each SM sub-partition, so the issue rate, not the
// FP32 operation count, is the floor (chip_smoke.py prints both; PERF.md
// section 6, row 5).  Design:
//   * one thread per system for the whole horizon, positions, half-step
//     velocities and accelerations in registers; the row-major (B, N, D)
//     tensors are read at entry and written at exit only; 256-thread
//     blocks (128 and 512 were no faster);
//   * the scheme is a template argument: the stage loop is unrolled and
//     its coefficients are held in registers before the step loop, so
//     nothing is indexed at run time (0 bytes of stack frame);
//   * explicit FMAs (__fmaf_rn; the build has -fmad=false) in the drift,
//     the kick, r^2 and the accumulation, which starts from each body's
//     first pair term instead of from zeros.  So the kernel is not bitwise
//     its plain PyTorch version, which keeps the JAX source's separately
//     rounded products (PERF.md section 6 states the difference);
//   * the pair term takes rsqrt.approx.ftz, not rsqrtf, whose guard for a
//     subnormal argument costs a compare and two predicated multiplies a
//     pair.  Both are the same MUFU.RSQ for a normal argument, and a
//     subnormal r^2 (only possible where eps2 is 0 or subnormal) changes
//     no bit either: rsqrtf returns more than 2^63 there and the flushed
//     argument +inf, so w = inv_r^3 is +inf on both, as it is for r^2 = 0;
//     a NaN stays NaN.  Only a negative eps2, which no squared softening
//     is, tells the two apart.

#include <cuda_runtime.h>

#ifndef HS_N
#define HS_N 3
#endif
#ifndef HS_D
#define HS_D 2
#endif

static_assert(HS_N >= 2 && HS_N <= 16, "composition kernel: 2 <= N <= 16");
static_assert(HS_D == 2 || HS_D == 3, "composition kernel: d = 2 or 3");

namespace {

constexpr int kMaxStages = 3;
constexpr int kBlock = 256;

// drift and kick coefficients of each stage, already multiplied by h and
// rounded to float32 on the host, and the opening/closing half-kick; read
// only at compile-time indices
struct Coef {
  float dh[kMaxStages];
  float kh[kMaxStages];
  float k_half;
};

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the softened acceleration, pair by pair in the Pallas kernel's order;
// each body's sum starts from its first pair term: body 0 at pair (0, 1),
// body j at pair (0, j)
template <int N, int D>
__device__ __forceinline__ void accel(const float (&pos)[N * D],
                                      const float (&gm)[N], float eps2,
                                      float (&acc)[N * D]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float dx[D];
      float r2 = eps2;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        dx[a] = pos[i * D + a] - pos[j * D + a];
        r2 = __fmaf_rn(dx[a], dx[a], r2);
      }
      const float inv_r = rsqrt_ftz(r2);
      const float w = inv_r * inv_r * inv_r;
      const float wi = gm[j] * w;
      const float wj = gm[i] * w;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        acc[i * D + a] = (i == 0 && j == 1)
                             ? -wi * dx[a]
                             : __fmaf_rn(-wi, dx[a], acc[i * D + a]);
        acc[j * D + a] =
            i == 0 ? wj * dx[a] : __fmaf_rn(wj, dx[a], acc[j * D + a]);
      }
    }
}

template <int N, int D, int S>
__device__ __forceinline__ void run(float (&pos)[N * D], float (&vel)[N * D],
                                    const float (&gm)[N], float eps2,
                                    const float (&dh)[S], const float (&kh)[S],
                                    float k_half, int n_steps) {
  float acc[N * D];
  accel<N, D>(pos, gm, eps2, acc);
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = __fmaf_rn(k_half, acc[k], vel[k]);
  // one step per trip (chip_smoke.py counts the trip's SASS instructions)
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < N * D; ++k)
        pos[k] = __fmaf_rn(dh[s], vel[k], pos[k]);
      accel<N, D>(pos, gm, eps2, acc);
#pragma unroll
      for (int k = 0; k < N * D; ++k)
        vel[k] = __fmaf_rn(kh[s], acc[k], vel[k]);
    }
  }
  // close the trailing half-step: v_T = v_{T+1/2} - (d_0 h / 2) a_T
#pragma unroll
  for (int k = 0; k < N * D; ++k) vel[k] = __fmaf_rn(-k_half, acc[k], vel[k]);
}

template <int N, int D, int S>
__global__ void __launch_bounds__(kBlock) composition_kernel(
    const float* __restrict__ pos_in, const float* __restrict__ vel_in,
    const float* __restrict__ mass, const float* __restrict__ eps2_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel, int B,
    int n_steps, float G, Coef c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float pos[N * D], vel[N * D], gm[N], dh[S], kh[S];
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    pos[k] = pos_in[(size_t)b * (N * D) + k];
    vel[k] = vel_in[(size_t)b * (N * D) + k];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) gm[i] = G * mass[(size_t)b * N + i];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dh[s] = c.dh[s];
    kh[s] = c.kh[s];
  }
  const float eps2 = eps2_in[b];
  run<N, D, S>(pos, vel, gm, eps2, dh, kh, c.k_half, n_steps);
#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[(size_t)b * (N * D) + k] = pos[k];
    out_vel[(size_t)b * (N * D) + k] = vel[k];
  }
}

}  // namespace

extern "C" {

// n_stages 1 runs the Verlet instance, 3 the Yoshida4 one
int hs_composition(const float* pos, const float* vel, const float* mass,
                   const float* eps2, float* out_pos, float* out_vel, int B,
                   int n_steps, float G, const float* dh, const float* kh,
                   int n_stages, float k_half, void* stream) {
  if (B <= 0) return 0;
  if (n_stages != 1 && n_stages != 3) return (int)cudaErrorInvalidValue;
  Coef c = {};
  for (int s = 0; s < n_stages; ++s) {
    c.dh[s] = dh[s];
    c.kh[s] = kh[s];
  }
  c.k_half = k_half;
  dim3 grid((B + kBlock - 1) / kBlock);
  auto st = (cudaStream_t)stream;
  if (n_stages == 1)
    composition_kernel<HS_N, HS_D, 1><<<grid, kBlock, 0, st>>>(
        pos, vel, mass, eps2, out_pos, out_vel, B, n_steps, G, c);
  else
    composition_kernel<HS_N, HS_D, 3><<<grid, kBlock, 0, st>>>(
        pos, vel, mass, eps2, out_pos, out_vel, B, n_steps, G, c);
  return (int)cudaGetLastError();
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
