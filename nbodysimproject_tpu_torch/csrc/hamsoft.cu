// Fused multi-step ham_soft analysis and MEGNO kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of nbodysimproject_tpu/ops/pallas_hamsoft.py:
//   hamsoft_analysis_multistep (_hamsoft_analysis_kernel, :565) -> hs_analysis
//   hamsoft_megno_multistep    (_hamsoft_megno_kernel,    :770) -> hs_megno
// on the cooperative physics of hamsoft_physics_warp.cuh, at d = 2 and 3
// (HS_D).  All three barrier policies and both eps* gradient modes: the
// policy and the mode are template arguments (REFL, REF), and each build
// variant instantiates one pair of them (HS_REFL, HS_REF: the reflection
// fold, the "reference" gradient's fallback), so the default build, the
// soft and no-barrier policies with the exact gradient (the dataset
// pipeline's), holds neither branch.  The soft policy's wall kicks are a
// runtime flag (barrier_on), off for "none".
//
// What bounds it: operations, not bytes, and on the main path the serial
// chain of the deepest systems (n_sub 256 over 1000 steps: 256,000
// Strang trips one after another, each about 10^4 FP32 operations and
// 10^3 expf at N = 8).  One thread per system cannot get that chain
// below about 2 s even at one operation a cycle, so the design splits
// each trip across lanes:
//   * several lanes of a warp per body, each holding a share of the
//     body's neighbour slots (hamsoft_physics_warp.cuh): four at
//     N <= 8 (a warp per system at N = 5-8, two systems a warp at
//     N = 3 and 4, four at N = 2), two at N = 9-16 (a warp per
//     system); the terms of a sum over slots, bodies or pairs are
//     exchanged by warp shuffle and added in the one-thread physics'
//     order, so the trajectory is bit for bit that of
//     hamsoft_multistep.cu, and no sum leaves its warp;
//   * the SPH kernel terms of every forward iterate stay in registers,
//     so the reverse sweep runs no expf; its pair terms go through a
//     table in dynamic shared memory, one row per iterate, body and
//     dimension (8 N d rows of 2 (N - 1) terms a system: 96 KiB a block
//     at N = 16, d = 3, which bounds the warps resident on an SM);
//   * what is left is a chain of IEEE divisions, square roots and expf
//     (8 SPH iterations), so independent quotients and roots that every
//     lane of a body would repeat are split across its lanes;
//   * the 17 analysis accumulators are spread over the system's lanes,
//     one or a few per lane;
//   * the wrapper hands in the systems in descending n_sub order
//     (order[w] is the system of warp slot w), so the deepest systems
//     start in the first wave; every output is written at the system's
//     own index, so a result does not depend on where the system lies in
//     the batch;
//   * inputs stay coordinate-major ((N*D, B), (B,) rows and L0 as 1 or 3
//     rows of B), read once at entry; device memory is touched again only
//     at each metric sample, each MEGNO row, and at exit.

#include "hamsoft_physics_warp.cuh"

#ifndef HS_N
#define HS_N 8
#endif
#ifndef HS_D
#define HS_D 2
#endif
#ifndef HS_REFL
#define HS_REFL 0
#endif
#ifndef HS_REF
#define HS_REF 0
#endif

namespace {

constexpr int kAccMetrics = 4;          // com_drift, cos_theta, var_L, tr_hessian
constexpr int kAccRows = 1 + 4 * kAccMetrics;
constexpr int kBlock = 64;

template <int N, int D>
struct Geo {
  static constexpr int SYS = Lay<N>::SYS;
  static constexpr int PER_BLOCK = kBlock / SYS;  // systems per block
  static constexpr int ACC_PER_LANE = (kAccRows + SYS - 1) / SYS;
  // the reverse sweep's tables of a block, in dynamic shared memory (64
  // and 96 KiB at N = 16, d = 2 and 3: past the 48 KiB static limit)
  static constexpr size_t SMEM =
      sizeof(float) * PER_BLOCK * GradRows<N, D>::SIZE;
};

// the thread's system's table in the block's dynamic shared memory
template <int N, int D>
__device__ __forceinline__ float* system_rows() {
  extern __shared__ __align__(16) float hs_rows[];
  return hs_rows + (threadIdx.x / Geo<N, D>::SYS) * GradRows<N, D>::SIZE;
}

// The warp slot of this thread's system, or -1 past the batch.
template <int N, int D>
__device__ __forceinline__ int system_slot(int B) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / Geo<N, D>::SYS;
  return w < B ? w : -1;
}

// variational (tangent-map) acceleration of the lane's body
template <int N, int D>
__device__ __forceinline__ void tangent_accel_w(const Lane<N, D>& s,
                                                const float* qi,
                                                const float* qj,
                                                const float* dri,
                                                const float* drj, float eps,
                                                float* acc) {
  constexpr int SPL = Lay<N>::SPL;
  float eps2 = eps * eps;
  float part[D];
#pragma unroll
  for (int a = 0; a < D; ++a) part[a] = 0.f;
#pragma unroll
  for (int t = 0; t < SPL; ++t) {
    float r2 = eps2;
    float dx[D], ddx[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      dx[a] = qj[t * D + a] - qi[a];
      ddx[a] = drj[t * D + a] - dri[a];
      r2 = r2 + dx[a] * dx[a];
    }
    float inv_r2 = 1.f / r2;
    float inv_r3 = inv_r2 * rsqrtf(r2);
    float dot = dx[0] * ddx[0];
#pragma unroll
    for (int a = 1; a < D; ++a) dot = dot + dx[a] * ddx[a];
    float coeff = 3.f * dot * inv_r2 * inv_r3;
    float mj = (s.valid_i && s.mval_j[t] > 0.f) ? s.mval_j[t] : 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float term = ddx[a] * inv_r3 - coeff * dx[a];
      part[a] = part[a] + (s.real[t] ? s.G * mj * term : 0.f);
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = xsum<1, Lay<N>::LPB>(part[a], s.mask);
}

// L0 of the tilt: L_z (d = 2) or the L vector (d = 3)
template <int D>
struct Lrows {
  static constexpr int R = D == 2 ? 1 : 3;
};

// The four in-register step metrics (diagnostics/metrics.py:56-123), on
// every lane of the system.  d = 2: the reference's scalar L_z
// statistics; d = 3: the vector branch of the TPU kernel
// (_hamsoft_analysis_kernel :656-686): L_tot = |sum_i m_i q_i x v_i|,
// var_L the variance of the per-body |L_i|, cos_theta the tilt of L
// against L0.
template <int N, int D>
__device__ __forceinline__ void metrics_w(const Lane<N, D>& s,
                                          const float* qi, const float* qj,
                                          const float* vi, float eps,
                                          const float* L0, float nb,
                                          float* out) {
  static_assert(D == 2 || D == 3, "the analysis metrics take d = 2 or 3");
  constexpr int SYS = Lay<N>::SYS;
  float com2 = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float sm = xsum<Lay<N>::LPB, SYS>(s.mval_i * qi[a], s.mask);
    com2 = com2 + sm * sm;
  }
  out[0] = sqrtf(com2);

  if constexpr (D == 2) {
    float L_i = s.mval_i * (qi[0] * vi[1] - qi[1] * vi[0]);
    float L_tot = xsum<Lay<N>::LPB, SYS>(L_i, s.mask);
    float L_mean = L_tot / nb;
    float d0 = L_i - L_mean;
    float var_L =
        xsum<Lay<N>::LPB, SYS>(s.valid_i ? d0 * d0 : 0.f, s.mask) / nb;
    bool cos_ok = (L0[0] != 0.f) && (L_tot != 0.f);
    out[1] = cos_ok ? (L_tot * L0[0]) / (fabsf(L_tot) * fabsf(L0[0]))
                    : nanf("");
    out[2] = var_L;
  } else {
    const float c[3] = {s.mval_i * (qi[1] * vi[2] - qi[2] * vi[1]),
                        s.mval_i * (qi[2] * vi[0] - qi[0] * vi[2]),
                        s.mval_i * (qi[0] * vi[1] - qi[1] * vi[0])};
    float Lv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) Lv[a] = xsum<Lay<N>::LPB, SYS>(c[a], s.mask);
    float L_tot = sqrtf(Lv[0] * Lv[0] + Lv[1] * Lv[1] + Lv[2] * Lv[2]);
    float l_i = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]);
    float l_mean = xsum<Lay<N>::LPB, SYS>(s.valid_i ? l_i : 0.f, s.mask) / nb;
    float d0 = l_i - l_mean;
    float var_L =
        xsum<Lay<N>::LPB, SYS>(s.valid_i ? d0 * d0 : 0.f, s.mask) / nb;
    float L0n = sqrtf(L0[0] * L0[0] + L0[1] * L0[1] + L0[2] * L0[2]);
    float dot = Lv[0] * L0[0] + Lv[1] * L0[1] + Lv[2] * L0[2];
    bool cos_ok = (L0n != 0.f) && (L_tot != 0.f);
    // the TPU kernel floors the denominator at 1e-300, which is 0 in
    // float32: the floor is max(x, 0), NaN kept
    out[1] = cos_ok ? dot / maxf(L_tot * L0n, 0.f) : nanf("");
    out[2] = var_L;
  }

  float eps2 = eps * eps;
  float tr = 0.f;
#pragma unroll
  for (int t = 0; t < Lay<N>::SPL; ++t) {
    float r2 = 0.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float dx = qi[a] - qj[t * D + a];
      r2 = r2 + dx * dx;
    }
    float sq = r2 + eps2;
    float num = float(D) * sq - 3.f * r2;
    float ssafe = maxf(sq, 0.f);
    float den = ssafe * ssafe * sqrtf(ssafe);
    float pairm =
        (s.valid_i && s.mval_j[t] > 0.f) ? s.mass_i * s.mval_j[t] : 0.f;
    bool upper = s.real[t] && s.i < s.j[t];
    tr = tr + (upper ? pairm * num / den : 0.f);
  }
  tr = xsum<1, SYS>(tr, s.mask);
  out[3] = s.G * 2.f * tr;  // i != j double-counts the i < j sum
}

// One resident block a multiprocessor is all the bound asks, as for the
// MEGNO kernel: ptxas' own register choice spilled 8 bytes at N = 5,
// d = 3.  At N = 3, 4 and 8 it keeps the kernel unspilled either way and
// the main path's fused call takes the same time (PERF.md section 6).
template <int N, int D, bool REFL, bool REF>
__global__ void __launch_bounds__(kBlock, 1) analysis_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const int* __restrict__ order, const float* __restrict__ L0_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel,
    float* __restrict__ out_eps, float* __restrict__ out_pi,
    float* __restrict__ out_acc, float* __restrict__ out_es,
    float* __restrict__ out_ps, int B, int n_steps, int n_sub_max,
    int interval, float G, float k_wall, float eta, float jcap, float lam,
    int bexp, int barrier_on) {
  using GE = Geo<N, D>;
  const int w = system_slot<N, D>(B);
  if (w < 0) return;
  const int b = order[w];
  const int lane = threadIdx.x & 31;
  const int l = lane % GE::SYS;
  float* rw = system_rows<N, D>();

  Lane<N, D> s;
  float qi[D], vi[D], gi[D], qj[Lay<N>::SPL * D];
  const float h = h_in[b];
  load_lane<N, D>(b, B, lane, pos, vel, mass, k_s, mu, alpha, flo, cap,
                       eps_in, h, G, k_wall, eta, jcap, lam, bexp, barrier_on,
                       s, qi, vi);
  gather_slots(s, qi, qj);
  float eps = eps_in[b], pi = pi_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);
  float L0[Lrows<D>::R];
#pragma unroll
  for (int a = 0; a < Lrows<D>::R; ++a) L0[a] = L0_in[a * B + b];
  float nb = xsum<Lay<N>::LPB, GE::SYS>(s.valid_i ? 1.f : 0.f, s.mask);
  nb = maxf(nb, 1.f);

  float es;
  eps_star_and_grad_w<N, D, REF>(s, qi, qj, es, gi, rw);

  // row r = l + a * SYS of the accumulators: 0 the count, then
  // (sum, sumsq, max, min) per metric
  float acc[GE::ACC_PER_LANE];
#pragma unroll
  for (int a = 0; a < GE::ACC_PER_LANE; ++a) {
    const int r = l + a * GE::SYS;
    const int stat = (r - 1) & 3;
    acc[a] = (r == 0 || stat < 2) ? 0.f : (stat == 2 ? -INFINITY : INFINITY);
  }

  for (int step = 0; step < n_steps; ++step) {
    for (int sub = 0; sub < ns; ++sub)
      strang_trip_w<N, D, REFL, REF>(s, qi, qj, vi, eps, pi, es, gi, h, rw);
    if (step % interval == 0) {  // the scan path's sampling predicate
      float met[kAccMetrics];
      metrics_w(s, qi, qj, vi, eps, L0, nb, met);
#pragma unroll
      for (int a = 0; a < GE::ACC_PER_LANE; ++a) {
        const int r = l + a * GE::SYS;
        if (r >= kAccRows) continue;
        if (r == 0) {
          acc[a] = acc[a] + 1.f;
          continue;
        }
        const int m = (r - 1) >> 2, stat = (r - 1) & 3;
        float x = met[0];
#pragma unroll
        for (int k = 1; k < kAccMetrics; ++k) x = (m == k) ? met[k] : x;
        if (stat == 0) acc[a] = acc[a] + x;
        else if (stat == 1) acc[a] = acc[a] + x * x;
        else if (stat == 2) acc[a] = maxf(acc[a], x);
        else acc[a] = minf(acc[a], x);
      }
      if (l == 0) {
        const int row = step / interval;
        out_es[row * B + b] = eps;
        out_ps[row * B + b] = pi;
      }
    }
  }

  if (s.body && s.sub == 0) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      out_pos[(s.i * D + a) * B + b] = qi[a];
      out_vel[(s.i * D + a) * B + b] = vi[a];
    }
  }
  if (l == 0) {
    out_eps[b] = eps;
    out_pi[b] = pi;
  }
#pragma unroll
  for (int a = 0; a < GE::ACC_PER_LANE; ++a) {
    const int r = l + a * GE::SYS;
    if (r < kAccRows) out_acc[r * B + b] = acc[a];
  }
}

// One resident block a multiprocessor is all the bound asks: without it
// ptxas holds the kernel to 128 registers (eight blocks) and spills at
// N = 8.
template <int N, int D, bool REFL, bool REF>
__global__ void __launch_bounds__(kBlock, 1) megno_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ mass, const float* __restrict__ eps_in,
    const float* __restrict__ pi_in, const float* __restrict__ k_s,
    const float* __restrict__ mu, const float* __restrict__ alpha,
    const float* __restrict__ flo, const float* __restrict__ cap,
    const float* __restrict__ h_in, const int* __restrict__ nsub_in,
    const int* __restrict__ order, const float* __restrict__ dt_in,
    const float* __restrict__ dr_in, const float* __restrict__ dv_in,
    float* __restrict__ out_pos, float* __restrict__ out_vel,
    float* __restrict__ out_eps, float* __restrict__ out_pi,
    float* __restrict__ out_accum, float* __restrict__ out_t,
    float* __restrict__ out_ys, int B, int n_steps, int n_sub_max, float G,
    float k_wall, float eta, float jcap, float lam, int bexp,
    int barrier_on) {
  using GE = Geo<N, D>;
  constexpr int SPL = Lay<N>::SPL;
  const int w = system_slot<N, D>(B);
  if (w < 0) return;
  const int b = order[w];
  const int lane = threadIdx.x & 31;
  const int l = lane % GE::SYS;
  float* rw = system_rows<N, D>();

  Lane<N, D> s;
  float qi[D], vi[D], gi[D], qj[SPL * D], dri[D], dvi[D], drj[SPL * D];
  const float h = h_in[b];
  load_lane<N, D>(b, B, lane, pos, vel, mass, k_s, mu, alpha, flo, cap,
                       eps_in, h, G, k_wall, eta, jcap, lam, bexp, barrier_on,
                       s, qi, vi);
  gather_slots(s, qi, qj);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    dri[a] = s.body ? dr_in[(s.i * D + a) * B + b] : 0.f;
    dvi[a] = s.body ? dv_in[(s.i * D + a) * B + b] : 0.f;
  }
  float eps = eps_in[b], pi = pi_in[b];
  const float dt = dt_in[b];
  const int ns = min(max(nsub_in[b], 1), n_sub_max);

  float es;
  eps_star_and_grad_w<N, D, REF>(s, qi, qj, es, gi, rw);
  float accum = 0.f, tt = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    for (int sub = 0; sub < ns; ++sub)
      strang_trip_w<N, D, REFL, REF>(s, qi, qj, vi, eps, pi, es, gi, h, rw);
    // MEGNO update on the macro-step boundary (diagnostics/megno.py:73-87)
#pragma unroll
    for (int a = 0; a < D; ++a) dri[a] = dri[a] + dvi[a] * dt;
    gather_slots(s, dri, drj);
    float da[D];
    tangent_accel_w(s, qi, qj, dri, drj, eps, da);
#pragma unroll
    for (int a = 0; a < D; ++a) dvi[a] = dvi[a] + da[a] * dt;
    tt = tt + dt;
    float p2 = dri[0] * dri[0];
#pragma unroll
    for (int a = 1; a < D; ++a) p2 = p2 + dri[a] * dri[a];
    float nr2 = xsum<Lay<N>::LPB, GE::SYS>(s.body ? p2 : 0.f, s.mask);
    float norm_r = sqrtf(nr2);
    // reference quirk: divides by the tiny norm, then treats it as 1
    bool tiny = norm_r < 1e-12f;
    float scale = tiny ? norm_r : 1.f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      dri[a] = dri[a] / scale;
      dvi[a] = dvi[a] / scale;
    }
    norm_r = tiny ? 1.f : norm_r;
    float v2 = dvi[0] * dvi[0];
#pragma unroll
    for (int a = 1; a < D; ++a) v2 = v2 + dvi[a] * dvi[a];
    float nv2 = xsum<Lay<N>::LPB, GE::SYS>(s.body ? v2 : 0.f, s.mask);
    float norm_v = sqrtf(nv2);
    accum = accum + (norm_v / norm_r) * tt * dt;
    if (l == 0) out_ys[step * B + b] = 2.f * accum / tt;
  }

  if (s.body && s.sub == 0) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      out_pos[(s.i * D + a) * B + b] = qi[a];
      out_vel[(s.i * D + a) * B + b] = vi[a];
    }
  }
  if (l == 0) {
    out_eps[b] = eps;
    out_pi[b] = pi;
    out_accum[b] = accum;
    out_t[b] = tt;
  }
}

template <int N, int D>
dim3 grid_of(int B) {
  constexpr int per = Geo<N, D>::PER_BLOCK;
  return dim3((B + per - 1) / per);
}

// Lets ``kernel`` take the block's tables (past 48 KiB only after this);
// set on every launch, for whichever device is current.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// out[0]: the shared bytes of a block of ``kernel``; out[1]: its warps
// resident on one multiprocessor at that size
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t bytes, int* out) {
  cudaError_t e = allow_smem(kernel, bytes);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kBlock, bytes);
  out[0] = (int)bytes;
  out[1] = blocks * kBlock / 32;
  return e;
}

}  // namespace

extern "C" {

int hs_analysis(const float* pos, const float* vel, const float* mass,
                const float* eps, const float* pi, const float* k_s,
                const float* mu, const float* alpha, const float* flo,
                const float* cap, const float* h, const int* nsub,
                const int* order, const float* L0, float* out_pos,
                float* out_vel, float* out_eps, float* out_pi,
                float* out_acc, float* out_es, float* out_ps, int B,
                int n_steps, int n_sub_max, int interval, float G,
                float k_wall, float eta, float jcap, float lam, int bexp,
                int barrier_on, void* stream) {
  if (B <= 0) return 0;
  auto* const kernel =
      &analysis_kernel<HS_N, HS_D, HS_REFL != 0, HS_REF != 0>;
  constexpr size_t smem = Geo<HS_N, HS_D>::SMEM;
  const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  kernel<<<grid_of<HS_N, HS_D>(B), kBlock, smem,
           (cudaStream_t)stream>>>(
          pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, order,
          L0, out_pos, out_vel, out_eps, out_pi, out_acc, out_es, out_ps, B,
          n_steps, n_sub_max, interval, G, k_wall, eta, jcap, lam, bexp,
          barrier_on);
  return (int)cudaGetLastError();
}

int hs_megno(const float* pos, const float* vel, const float* mass,
             const float* eps, const float* pi, const float* k_s,
             const float* mu, const float* alpha, const float* flo,
             const float* cap, const float* h, const int* nsub,
             const int* order, const float* dt, const float* dr,
             const float* dv, float* out_pos, float* out_vel,
             float* out_eps, float* out_pi, float* out_accum, float* out_t,
             float* out_ys, int B, int n_steps, int n_sub_max, float G,
             float k_wall, float eta, float jcap, float lam, int bexp,
             int barrier_on, void* stream) {
  if (B <= 0) return 0;
  auto* const kernel =
      &megno_kernel<HS_N, HS_D, HS_REFL != 0, HS_REF != 0>;
  constexpr size_t smem = Geo<HS_N, HS_D>::SMEM;
  const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  kernel<<<grid_of<HS_N, HS_D>(B), kBlock, smem,
           (cudaStream_t)stream>>>(
          pos, vel, mass, eps, pi, k_s, mu, alpha, flo, cap, h, nsub, order,
          dt, dr, dv, out_pos, out_vel, out_eps, out_pi, out_accum, out_t,
          out_ys, B, n_steps, n_sub_max, G, k_wall, eta, jcap, lam, bexp,
          barrier_on);
  return (int)cudaGetLastError();
}

// the analysis kernel's (out[0..1]) and the MEGNO kernel's (out[2..3])
// shared bytes per block and resident warps per multiprocessor
int hs_occupancy(int* out) {
  constexpr size_t smem = Geo<HS_N, HS_D>::SMEM;
  cudaError_t e = occupancy(
      &analysis_kernel<HS_N, HS_D, HS_REFL != 0, HS_REF != 0>, smem, out);
  if (e == cudaSuccess)
    e = occupancy(&megno_kernel<HS_N, HS_D, HS_REFL != 0, HS_REF != 0>,
                  smem, out + 2);
  return (int)e;
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
