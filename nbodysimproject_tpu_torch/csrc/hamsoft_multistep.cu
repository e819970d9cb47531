// Fused multi-step ham_soft integration kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_hamsoft.py:
//   hamsoft_multistep (_hamsoft_multistep_kernel, :508) -> hs_multistep
// n_steps macro steps, each system running its own n_sub Strang trips of
// size h, no sampling, at d = 2 and 3 (HS_D).  All three barrier
// policies: "soft" (wall kicks on pi), "reflection" (closed-form folds of
// (eps, pi) around each flow) and "none", each build holding both folds;
// the eps* gradient mode is a template argument (REF), instantiated by
// the build variant HS_REF ("reference": the degeneracy fallback), so
// the default build holds only the exact gradient.
//
// What bounds it: operations.  A trip spends about 10^3 FP32 operations
// at N = 3 and 10^4 at N = 8 (the 8 SPH iterations and the reverse
// sweep), against a few dozen floats in and out per system for the whole
// horizon.  Its two paths want different layouts, so the layout is fixed
// per body-slot count N, from measurement (PERF.md section 6, row 3):
//   * N = 8 (the use_fused_metrics=False analysis: 16384 systems, n_sub
//     up to 256, chunks of at most 10 steps) is set by the serial chain
//     of the deepest systems.  It runs the analysis kernel's lane-split
//     physics (hamsoft_physics_warp.cuh): a warp per system, four lanes
//     per body, the SPH kernel terms kept from the forward pass,
//     independent divisions split across a body's lanes.  One thread per
//     system took about 9x as long there;
//   * N = 3 (the bench's 2^20 three-body systems) is throughput bound on
//     instructions, where the warp's 16 lanes a system, repeating its
//     scalar work, took about 5x as long.  One thread owns one system
//     (hamsoft_physics.cuh); its forward SPH pass keeps the kernel terms
//     in registers for the reverse sweep (no expf, square root or
//     division there), in blocks of kThreadBlock threads;
//   * N = 4 runs the warp layout: one thread per system was faster there
//     but spills at every launch bound (192 kept terms).  So do N = 5-16
//     (two lanes a body from N = 9, a warp per system); N = 2 runs one
//     thread per system, as N = 3 does.
// The warp layout's reverse-sweep tables live in dynamic shared memory
// (96 KiB a block at N = 16, d = 3).
// Both layouts add every sum in the one-thread order, so a trip moves
// (pos, vel, eps, pi) bit for bit the same in either, and as the analysis
// and MEGNO kernels do.  The wrapper hands in the systems deepest first
// (order[w] is the system of slot w), so the deepest start in the first
// wave and a warp of one-thread systems runs systems of equal depth;
// every output is written at the system's own index.  Inputs are
// coordinate-major ((N*D, B) and (B,) rows), read at entry and written at
// exit only.  The SPH solve is seeded from the kernel-entry eps, as in
// the Pallas kernel, so a horizon cut into several calls seeds each call
// anew.

#include "hamsoft_physics_warp.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif
#ifndef HS_REF
#define HS_REF 0
#endif
// the build variant "thread": one thread per system at every N, the
// order both layouts keep (a witness of the warp layout's sums; it
// spills from N = 4)
#ifndef HS_THREAD
#define HS_THREAD 0
#endif

namespace {

// the layout of each N: one thread per system at N = 2 and 3, the
// lane-split physics from N = 4 up
constexpr bool kWarpLayout = HS_N >= 4 && !HS_THREAD;
constexpr int kThreadBlock = 128;
constexpr int kWarpBlock = 64;

// ptxas keeps the N = 3 trip, kept terms included, in ~220 registers
// without spilling (two blocks an SM)
template <int N, int D, bool REFL, bool REF>
__global__ void __launch_bounds__(kThreadBlock, 2) multistep_thread(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const int* __restrict__ order, float* __restrict__ out_pos,
    float* __restrict__ out_vel, float* __restrict__ out_eps,
    float* __restrict__ out_pi, int B, int n_steps, int n_sub_max, float G,
    float k_wall, float eta, float jcap, float lam, int bexp,
    int barrier_on) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const int b = order[w];
  Sys<N> s;
  float q[N * D], v[N * D], grad[N * D];
  load_system<N, D>(b, B, pos, vel, mass, k_s, mu, alpha, flo, cap, eps_in, G,
                    k_wall, eta, jcap, lam, bexp, barrier_on, s, q, v);
  float eps = eps_in[b], pi = pi_in[b];
  const float h = h_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);

  float es;
  eps_star_and_grad_mode<N, D, REF>(s, q, es, grad);
  for (int step = 0; step < n_steps; ++step)
    for (int sub = 0; sub < ns; ++sub)
      strang_trip<N, D, REFL, REF>(s, q, v, eps, pi, es, grad, h);

#pragma unroll
  for (int k = 0; k < N * D; ++k) {
    out_pos[k * B + b] = q[k];
    out_vel[k * B + b] = v[k];
  }
  out_eps[b] = eps;
  out_pi[b] = pi;
}

template <int N, int D, bool REFL, bool REF>
__global__ void __launch_bounds__(kWarpBlock) multistep_warp(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const int* __restrict__ order, float* __restrict__ out_pos,
    float* __restrict__ out_vel, float* __restrict__ out_eps,
    float* __restrict__ out_pi, int B, int n_steps, int n_sub_max, float G,
    float k_wall, float eta, float jcap, float lam, int bexp,
    int barrier_on) {
  constexpr int SYS = Lay<N>::SYS;
  // the block's reverse-sweep tables (warp_smem bytes)
  extern __shared__ __align__(16) float rows[];
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / SYS;
  if (w >= B) return;
  const int b = order[w];
  const int lane = threadIdx.x & 31;
  float* rw = rows + (threadIdx.x / SYS) * GradRows<N, D>::SIZE;

  Lane<N, D> s;
  float qi[D], vi[D], gi[D], qj[Lay<N>::SPL * D];
  const float h = h_in[b];
  load_lane<N, D>(b, B, lane, pos, vel, mass, k_s, mu, alpha, flo, cap,
                  eps_in, h, G, k_wall, eta, jcap, lam, bexp, barrier_on, s,
                  qi, vi);
  gather_slots(s, qi, qj);
  float eps = eps_in[b], pi = pi_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);

  float es;
  eps_star_and_grad_w<N, D, REF>(s, qi, qj, es, gi, rw);
  for (int step = 0; step < n_steps; ++step)
    for (int sub = 0; sub < ns; ++sub)
      strang_trip_w<N, D, REFL, REF>(s, qi, qj, vi, eps, pi, es, gi, h, rw);

  if (s.body && s.sub == 0) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      out_pos[(s.i * D + a) * B + b] = qi[a];
      out_vel[(s.i * D + a) * B + b] = vi[a];
    }
  }
  if (lane % SYS == 0) {
    out_eps[b] = eps;
    out_pi[b] = pi;
  }
}

// The warp layout's dynamic shared memory: one reverse-sweep table a
// system (96 KiB a block at N = 16, d = 3, past the 48 KiB static limit)
template <int N, int D>
constexpr size_t warp_smem() {
  return sizeof(float) * (kWarpBlock / Lay<N>::SYS) * GradRows<N, D>::SIZE;
}

// The kernel a build launches for (REFL, REF), its block and its shared
// bytes; the attribute that lets it take them is set before each launch
template <bool REFL>
struct Layout {
  static constexpr bool REF = HS_REF != 0;
  static constexpr int block = kWarpLayout ? kWarpBlock : kThreadBlock;
  static constexpr size_t smem = kWarpLayout ? warp_smem<HS_N, HS_D>() : 0;
  static auto kernel() {
    if constexpr (kWarpLayout)
      return &multistep_warp<HS_N, HS_D, REFL, REF>;
    else
      return &multistep_thread<HS_N, HS_D, REFL, REF>;
  }
};

template <bool REFL>
int launch(const float* pos, const float* vel, const float* mass,
           const float* eps, const float* pi, const float* k_s,
           const float* mu, const float* alpha, const float* flo,
           const float* cap, const float* h, const int* nsub,
           const int* order, float* out_pos, float* out_vel, float* out_eps,
           float* out_pi, int B, int n_steps, int n_sub_max, float G,
           float k_wall, float eta, float jcap, float lam, int bexp,
           int barrier_on, cudaStream_t st) {
  using LY = Layout<REFL>;
  auto* const kernel = LY::kernel();
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LY::smem);
  if (set != cudaSuccess) return (int)set;
  constexpr int per = kWarpLayout ? kWarpBlock / Lay<HS_N>::SYS
                                  : kThreadBlock;  // systems per block
  kernel<<<(B + per - 1) / per, LY::block, LY::smem, st>>>(
      pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, order,
      out_pos, out_vel, out_eps, out_pi, B, n_steps, n_sub_max, G, k_wall,
      eta, jcap, lam, bexp, barrier_on);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hs_multistep(const float* pos, const float* vel, const float* mass,
                 const float* eps, const float* pi, const float* k_s,
                 const float* mu, const float* alpha, const float* flo,
                 const float* cap, const float* h, const int* nsub,
                 const int* order, float* out_pos, float* out_vel,
                 float* out_eps, float* out_pi, int B, int n_steps,
                 int n_sub_max, float G, float k_wall, float eta, float jcap,
                 float lam, int bexp, int barrier_on, int reflection,
                 void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return reflection
             ? launch<true>(pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap,
                            h, nsub, order, out_pos, out_vel, out_eps,
                            out_pi, B, n_steps, n_sub_max, G, k_wall, eta,
                            jcap, lam, bexp, barrier_on, st)
             : launch<false>(pos, vel, mass, eps, pi, k_s, mu, alpha, flo,
                             cap, h, nsub, order, out_pos, out_vel, out_eps,
                             out_pi, B, n_steps, n_sub_max, G, k_wall, eta,
                             jcap, lam, bexp, barrier_on, st);
}

// shared bytes per block (out[0]) and resident warps per multiprocessor
// (out[1]) of the soft / no-barrier instance, out[2..3] of the
// reflection one
int hs_occupancy(int* out) {
  cudaError_t e = cudaSuccess;
  int k = 0;
  for (bool refl : {false, true}) {
    auto* const kernel =
        refl ? Layout<true>::kernel() : Layout<false>::kernel();
    constexpr size_t smem = Layout<false>::smem;
    constexpr int block = Layout<false>::block;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        block, smem);
    out[k++] = (int)smem;
    out[k++] = blocks * block / 32;
  }
  return (int)e;
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
