// K1: NeRF inverse-CDF resampling, one warp per ray.
//
// Replaces the Pallas TPU kernel scnerf_tpu/kernels/pdf_pallas.py:
// sample_pdf_pallas_core (body _kernel). Per ray r, with B bins and S samples:
//   pdf = (w + 1e-5) / sum(w + 1e-5)                 (B-1 entries)
//   cdf = [0, cumsum(pdf)]                           (B entries)
//   inds = #{j : u >= cdf[j]}                        (searchsorted, right)
//   below = max(inds-1, 0), above = min(inds, B-1)
//   denom = cdf[above] - cdf[below], 1 where denom < 1e-5 (a guard, not a max)
//   out = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below])
//
// What bounds it: memory. Per ray it reads (2B - 1 + S) floats and writes S
// (about 0.75 KB in and 0.25 KB out at B = 63, S = 64), against ~B*S
// compares; an 8192-ray chunk moves about 8 MB, a few microseconds of HBM
// time, so at serving sizes launch latency and occupancy dominate.
//
// Design: a warp owns a ray. Lanes load the weight and bin rows coalesced,
// reduce the normaliser with shuffles, and build the CDF by a warp-shuffle
// inclusive scan in 32-wide pieces (a carried prefix joins the pieces) into
// the warp's slice of shared memory, next to a copy of the bin row. Each lane
// then takes samples s = lane, lane+32, ...: it counts the CDF entries <= u
// (the exact compare-and-count of the reference, broadcast reads from shared
// memory), clamps, gathers the bracketing CDF values and bins from shared
// memory, and interpolates. The lerp's multiply and add are kept apart
// (__fmul_rn/__fadd_rn) so they round as the plain version's separate ops do.
// None of the TPU workarounds survive: no triangular-matmul cumsum, no
// one-hot gathers, no VMEM row blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kEps = 1e-5f;

__global__ void sample_pdf_kernel(const float* __restrict__ bins,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ u,
                                  float* __restrict__ out,
                                  int n_rays, int n_bins, int n_samples) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // uniform across the warp; no block barrier below

  float* cdf = smem + warp * 2 * n_bins;
  float* edge = cdf + n_bins;
  const int n_w = n_bins - 1;
  const float* w_row = weights + static_cast<int64_t>(ray) * n_w;
  const float* b_row = bins + static_cast<int64_t>(ray) * n_bins;

  float part = 0.f;
  for (int j = lane; j < n_w; j += 32) part += w_row[j] + kEps;
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFullMask, part, off);
  const float total = part;

  for (int j = lane; j < n_bins; j += 32) edge[j] = b_row[j];
  if (lane == 0) cdf[0] = 0.f;
  float carry = 0.f;
  for (int base = 0; base < n_w; base += 32) {
    const int j = base + lane;
    float v = j < n_w ? (w_row[j] + kEps) / total : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v += o;
    }
    v += carry;
    if (j < n_w) cdf[j + 1] = v;
    carry = __shfl_sync(kFullMask, v, 31);
  }
  __syncwarp();

  const float* u_row = u + static_cast<int64_t>(ray) * n_samples;
  float* o_row = out + static_cast<int64_t>(ray) * n_samples;
  for (int s = lane; s < n_samples; s += 32) {
    const float us = u_row[s];
    int inds = 0;
    for (int j = 0; j < n_bins; ++j) inds += us >= cdf[j];
    const int below = max(inds - 1, 0);
    const int above = min(inds, n_bins - 1);
    const float cdf_b = cdf[below];
    float denom = cdf[above] - cdf_b;
    if (denom < kEps) denom = 1.f;
    const float t = (us - cdf_b) / denom;
    const float bin_b = edge[below];
    o_row[s] = __fadd_rn(bin_b, __fmul_rn(t, edge[above] - bin_b));
  }
}

}  // namespace

// bins (n_rays, n_bins), weights (n_rays, n_bins-1), u and out
// (n_rays, n_samples): float32, contiguous, on the current device.
// 2 <= n_bins <= 1024. Launches on `stream`; returns cudaGetLastError().
extern "C" int scnerf_sample_pdf(const float* bins, const float* weights,
                                 const float* u, float* out, int n_rays,
                                 int n_bins, int n_samples, cudaStream_t stream) {
  if (n_rays == 0 || n_samples == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(2) * n_bins * kWarpsPerBlock * sizeof(float);
  const int blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sample_pdf_kernel<<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      bins, weights, u, out, n_rays, n_bins, n_samples);
  return static_cast<int>(cudaGetLastError());
}
