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
// one system and one slice of the sources; the grid is
// (ceil(n / kTI), B, slices).  Each j tile of kTJ sources is staged
// through shared memory by the whole block, one float4 per source (its
// coordinates, then its mass), and every thread of the block reads the
// same source at the same time (one 16-byte broadcast load per pair, no
// bank conflicts).
//
// What bounds it: operations.  A valid pair costs 5 D + 4 operations
// counted as the bound counts them (an FMA as two); the bytes are
// (B, N, D) positions and (B, N) masses read once and (B, N, D) forces
// written once.  chip_smoke.py::pairwise_ops counts the operations off
// this loop.  Design for the bound:
//   * the pair is written with explicit FMAs (r^2 and the accumulation),
//     so it issues D subtractions, 2 D FMAs and three multiplies on the
//     FP32 pipe beside one rsqrtf (the build's -fmad=false, which the
//     other kernels' bitwise gates rely on, contracts nothing by itself);
//     each pair therefore rounds apart from the plain version's, within
//     the tolerance chip_smoke.py holds it to;
//   * the inner loop reads only shared memory and registers; the
//     validity test (an integer and a float compare and two selects) runs
//     only on the one tile that holds the block's own targets, or on
//     every tile when eps = 0 (under eps > 0, r^2 >= eps^2 > 0 elsewhere);
//     a tile's sum runs in kU interleaved accumulators, so kU pairs are in
//     flight per thread;
//   * where ceil(n / kTI) B blocks would leave SMs idle (N = 4096 and
//     B = 1: 16 blocks on 132 SMs), the wrapper splits the sources into
//     slices of whole kSG granules (ops/force_kernels.py::source_slices,
//     from n, B, the SM count and the blocks an SM holds: as many as one
//     wave of blocks holds); each slice writes its running accumulator
//     to scratch and a second pass adds the slices in slice order, then
//     applies G and m_i.  No atomics: a run is deterministic.

#include <cuda_runtime.h>
#include <math.h>

#ifndef HS_D
#define HS_D 2
#endif

namespace {

constexpr int kTI = 256;  // target bodies per block, one per thread
constexpr int kTJ = 512;  // source bodies per shared-memory tile
constexpr int kU = 8;     // interleaved accumulators of a tile's sum
constexpr int kSG = 64;   // source slices start on multiples of kSG

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
  float r2 = __fmaf_rn(dx[0], dx[0], eps2);
#pragma unroll
  for (int a = 1; a < D; ++a) r2 = __fmaf_rn(dx[a], dx[a], r2);
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
  for (int a = 0; a < D; ++a) part[a] = __fmaf_rn(w, dx[a], part[a]);
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
                          float* __restrict__ out,
                          float* __restrict__ part_out, int n) {
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
  // this block's slice of the sources: [j_lo, j_hi), whole granules of
  // kSG, staged kTJ at a time from j_lo
  const int granules = (n + kSG - 1) / kSG;
  const int S = gridDim.z, sl = blockIdx.z;
  const int j_lo = (int)((long long)sl * granules / S) * kSG;
  const int j_hi = min(n, (int)((long long)(sl + 1) * granules / S) * kSG);

  float xi[D];
  float acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    xi[a] = live ? p[(size_t)i * D + a] : 0.f;
    acc[a] = 0.f;
  }

  for (int j0 = j_lo; j0 < j_hi; j0 += kTJ) {
    const int k_end = min(kTJ, j_hi - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < k_end; k += kTI) {
      const int j = j0 + k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < D; ++a) v[a] = p[(size_t)j * D + a];
      v[D] = m[j];
      s_src[k] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    const int k_self = i - j0;  // i != j
    // the block's targets overlap this tile, or eps = 0: the checked form
    const bool checked =
        (i0 < j0 + k_end && j0 < i0 + kTI) || !(eps2 > 0.f);
    float part[D];
    if (checked)
      tile_sum<D, true>(part, xi, s_src, k_end, k_self, eps2);
    else
      tile_sum<D, false>(part, xi, s_src, k_end, k_self, eps2);
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] = acc[a] - part[a];
  }

  if (!live) return;
  if (S == 1) {
    const float g = G[b];
    const float mi = m[i];
    float* o = out + ((size_t)b * n + i) * D;
#pragma unroll
    for (int a = 0; a < D; ++a) o[a] = (g * acc[a]) * mi;
  } else {
    float* o = part_out + (((size_t)sl * gridDim.y + b) * n + i) * D;
#pragma unroll
    for (int a = 0; a < D; ++a) o[a] = acc[a];
  }
}

// The second pass of a sliced launch: each (b, i) adds its S slice
// accumulators in slice order, then applies G and m_i.
template <int D>
__global__ void __launch_bounds__(kTI)
    combine_slices_kernel(const float* __restrict__ part,
                          const float* __restrict__ mass,
                          const float* __restrict__ G,
                          float* __restrict__ out, int B, int n, int S) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * n) return;
  const int b = (int)(t / n);
  float acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = 0.f;
  for (int sl = 0; sl < S; ++sl) {
    const float* p = part + ((size_t)sl * B * n + t) * D;
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] = acc[a] + p[a];
  }
  const float g = G[b];
  const float mi = mass[t];
#pragma unroll
  for (int a = 0; a < D; ++a) out[t * D + a] = (g * acc[a]) * mi;
}

}  // namespace

extern "C" {

// pos (B, n, HS_D), mass (B, n), eps (B,), G (B,), out (B, n, HS_D): float32,
// contiguous, on the device of ``stream``.  ``slices`` source slices (at
// most the number of kSG granules); above 1, ``part`` is
// (slices, B, n, HS_D) float32 scratch.
int hs_pairwise_force(const float* pos, const float* mass, const float* eps,
                      const float* G, float* out, float* part, int B, int n,
                      int slices, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const int granules = (n + kSG - 1) / kSG;
  if (B > 65535 || slices < 1 || slices > granules)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + kTI - 1) / kTI, B, slices);
  pairwise_force_kernel<HS_D><<<grid, kTI, 0, st>>>(pos, mass, eps, G, out,
                                                    part, n);
  if (slices > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const size_t rows = (size_t)B * n;
    combine_slices_kernel<HS_D><<<(unsigned)((rows + kTI - 1) / kTI), kTI,
                                  0, st>>>(part, mass, G, out, B, n, slices);
  }
  return (int)cudaGetLastError();
}

int hs_pairwise_tile_j(void) { return kTJ; }

int hs_pairwise_block_i(void) { return kTI; }

int hs_pairwise_slice_granule(void) { return kSG; }

// Blocks of the force kernel that one SM holds at once.
int hs_pairwise_blocks_per_sm(void) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pairwise_force_kernel<HS_D>, kTI, 0);
  return blocks;
}

const char* hs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
