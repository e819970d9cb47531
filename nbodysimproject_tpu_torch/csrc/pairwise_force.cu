// Tiled exact O(N^2) Plummer-softened force of large-N systems, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of nbodysimproject_tpu/ops/pallas_kernels.py:
//   pairwise_force_pallas (:81; body _force_kernel :28) -> hs_pairwise_force
// For each system b and body i < n:
//   F_i = m_i * (G * acc_i),  acc_i = - sum over j tiles of
//         sum_{j in tile} w_ij (q_i - q_j),
//   w_ij = m_j / (r_ij^2 + eps^2)^{3/2}  (rsqrtf, cubed by two multiplies),
// a pair counting only where i != j, j < n and r_ij^2 + eps^2 > 0 (the
// r2 > 0 guard is a select before rsqrtf: the unsoftened WHFast kick runs
// with eps = 0).  As in the Pallas body, each thread sums one j tile into a
// partial sum and subtracts that from its running accumulator, then
// multiplies by G and by m_i.  Zero-mass (padded) slots add nothing to the
// other bodies' forces and receive F = 0.  eps and G are per system.
//
// Layout: one thread per target body i; a block owns kTI consecutive i of
// one system; the grid is (ceil(n / kTI), B).  Each j tile of kTJ sources
// is staged through shared memory by the whole block, one float4 per
// source (its coordinates, then its mass), and every thread of the block
// reads the same source at the same time (one 16-byte broadcast load per
// pair, no bank conflicts).
//
// What bounds it: operations.  A valid pair costs 5 D + 4 operations
// (D subtractions and multiplies, D - 1 adds for r^2, the eps^2 add, one
// rsqrtf, three multiplies for m_j / r^3, D multiplies and D adds into the
// partial sums); the bytes are (B, N, D) positions and (B, N) masses read
// once and (B, N, D) forces written once.  chip_smoke.py::pairwise_ops
// counts the operations off this loop.  Design for the bound: the inner
// loop reads only shared memory and registers; the validity test (an
// integer and a float compare and two selects) runs only on the one tile
// that holds the block's own targets, or on every tile when eps = 0 (under
// eps > 0, r^2 >= eps^2 > 0 elsewhere); a tile's sum runs in kU
// interleaved accumulators, so kU pairs are in flight per thread.
// Built with -fmad=false (the build's flag), so each pair rounds as the
// plain PyTorch version's does; the sums run in another order than there.

#include <cuda_runtime.h>
#include <math.h>

#ifndef HS_D
#define HS_D 2
#endif

namespace {

constexpr int kTI = 256;  // target bodies per block, one per thread
constexpr int kTJ = 512;  // source bodies per shared-memory tile
constexpr int kU = 8;     // interleaved accumulators of a tile's sum
static_assert(kTJ % kTI == 0, "a block's targets lie in one source tile");

// One staged source: its coordinates and, after them, its mass.
template <int D>
__device__ __forceinline__ float src_mass(const float4& s) {
  return D == 2 ? s.z : s.w;
}

// One source ``s`` (tile index k) into the accumulator ``part``.  The
// checked form applies the validity test, i != j and r^2 > 0, with a
// select before rsqrtf; the unchecked form is for tiles that hold no
// target of the block under eps > 0, where r^2 >= eps^2 > 0 and j != i
// hold for every pair, so both forms give the same bits there.
template <int D, bool kChecked>
__device__ __forceinline__ void add_pair(float (&part)[D],
                                         const float (&xi)[D],
                                         const float4& s, int k, int k_self,
                                         float eps2) {
  const float sq[3] = {s.x, s.y, s.z};
  float dx[D];
#pragma unroll
  for (int a = 0; a < D; ++a) dx[a] = xi[a] - sq[a];
  float d2 = dx[0] * dx[0];
#pragma unroll
  for (int a = 1; a < D; ++a) d2 = d2 + dx[a] * dx[a];
  const float r2 = d2 + eps2;
  float w;
  if (kChecked) {
    const bool valid = (k != k_self) && (r2 > 0.f);
    const float inv_r = rsqrtf(valid ? r2 : 1.f);
    w = valid ? src_mass<D>(s) * inv_r * inv_r * inv_r : 0.f;
  } else {
    const float inv_r = rsqrtf(r2);
    w = src_mass<D>(s) * inv_r * inv_r * inv_r;
  }
#pragma unroll
  for (int a = 0; a < D; ++a) part[a] = part[a] + w * dx[a];
}

// The partial sum of sources [0, k_end) of the staged tile, in kU
// interleaved accumulators (source k into accumulator k % kU: kU
// independent chains for the pipeline, and a shorter rounding chain
// than one running sum over kTJ terms), added pairwise at the end.
template <int D, bool kChecked>
__device__ __forceinline__ void tile_sum(float (&out)[D],
                                         const float (&xi)[D],
                                         const float4* s_src, int k_end,
                                         int k_self, float eps2) {
  float part[kU][D];
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int a = 0; a < D; ++a) part[u][a] = 0.f;
  int k = 0;
  for (; k + kU <= k_end; k += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      add_pair<D, kChecked>(part[u], xi, s_src[k + u], k + u, k_self, eps2);
  }
  for (; k < k_end; ++k)
    add_pair<D, kChecked>(part[0], xi, s_src[k], k, k_self, eps2);
#pragma unroll
  for (int w = kU / 2; w > 0; w /= 2)
#pragma unroll
    for (int u = 0; u < w; ++u)
#pragma unroll
      for (int a = 0; a < D; ++a) part[u][a] = part[u][a] + part[u + w][a];
#pragma unroll
  for (int a = 0; a < D; ++a) out[a] = part[0][a];
}

template <int D>
__global__ void __launch_bounds__(kTI)
    pairwise_force_kernel(const float* __restrict__ pos,
                          const float* __restrict__ mass,
                          const float* __restrict__ eps,
                          const float* __restrict__ G,
                          float* __restrict__ out, int n) {
  static_assert(D == 2 || D == 3, "a staged source is one float4");
  __shared__ float4 s_src[kTJ];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTI;
  const int i = i0 + threadIdx.x;
  const bool live = i < n;
  const float* p = pos + (size_t)b * n * D;
  const float* m = mass + (size_t)b * n;
  const float e = eps[b];
  const float eps2 = e * e;

  float xi[D];
  float acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    xi[a] = live ? p[(size_t)i * D + a] : 0.f;
    acc[a] = 0.f;
  }

  for (int j0 = 0; j0 < n; j0 += kTJ) {
    __syncthreads();
    for (int k = threadIdx.x; k < kTJ; k += kTI) {
      const int j = j0 + k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n) {
#pragma unroll
        for (int a = 0; a < D; ++a) v[a] = p[(size_t)j * D + a];
        v[D] = m[j];
      }
      s_src[k] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    const int k_end = min(kTJ, n - j0);  // j < n
    const int k_self = i - j0;           // i != j
    // the block's targets lie in this tile, or eps = 0: the checked form
    const bool checked = (i0 >= j0 && i0 < j0 + kTJ) || !(eps2 > 0.f);
    float part[D];
    if (checked)
      tile_sum<D, true>(part, xi, s_src, k_end, k_self, eps2);
    else
      tile_sum<D, false>(part, xi, s_src, k_end, k_self, eps2);
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] = acc[a] - part[a];
  }

  if (live) {
    const float g = G[b];
    const float mi = m[i];
    float* o = out + ((size_t)b * n + i) * D;
#pragma unroll
    for (int a = 0; a < D; ++a) o[a] = (g * acc[a]) * mi;
  }
}

}  // namespace

extern "C" {

// pos (B, n, HS_D), mass (B, n), eps (B,), G (B,), out (B, n, HS_D): float32,
// contiguous, on the device of ``stream``.
int hs_pairwise_force(const float* pos, const float* mass, const float* eps,
                      const float* G, float* out, int B, int n,
                      void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kTI - 1) / kTI, B);
  pairwise_force_kernel<HS_D><<<grid, kTI, 0, (cudaStream_t)stream>>>(
      pos, mass, eps, G, out, n);
  return (int)cudaGetLastError();
}

int hs_pairwise_tile_j(void) { return kTJ; }

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
