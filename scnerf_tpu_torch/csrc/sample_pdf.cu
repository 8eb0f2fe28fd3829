// K1 and K2: inverse-CDF resampling, one warp per ray.
//
// K1 replaces the Pallas TPU kernel scnerf_tpu/kernels/pdf_pallas.py:
// sample_pdf_pallas_core (body _kernel), the NeRF variant. K2 replaces
// _pallas_fwd (body _kernel_fwd) under the custom VJP sample_pdf_pallas_diff,
// in both variants; it also writes the search counts and, when asked, the
// CDF, which the backward (plain PyTorch, kernels/pdf_cuda.py) reads.
// Per ray r, with B bins, S samples and the variant's eps (NeRF 1e-5,
// NeRF++ 1e-6):
//   pdf = (w + eps) / sum(w + eps)                   (B-1 entries)
//   cdf = [0, cumsum(pdf)]                           (B entries)
//   inds = #{j < M : u >= cdf[j]}    M = B (NeRF), B-1 (NeRF++)
//   NeRF:   below = max(inds-1, 0), above = min(inds, B-1)
//   NeRF++: above = max(inds, 1),   below = above - 1
//   denom = cdf[above] - cdf[below], 1 where denom < eps (a guard, not a max)
//   width = bins[above] - bins[below]   (+ eps for NeRF++)
//   out = bins[below] + (u - cdf[below]) / denom * width
//
// What bounds it: memory. Per ray it reads (2B - 1 + S) floats and writes S
// (K2 also S counts, and B CDF entries when asked): about 1 KB in and 1 KB
// out at B = 63, S = 128, against ~B*S compares; a 4096-ray call moves about
// 8 MB, a few microseconds of HBM time, so at serving sizes launch latency
// and the host's work around the launch dominate.
//
// Design: a warp owns a ray. Lanes load the weight and bin rows coalesced,
// reduce the normaliser with shuffles, and build the CDF by a warp-shuffle
// inclusive scan in 32-wide pieces (a carried prefix joins the pieces) into
// the warp's slice of shared memory, next to a copy of the bin row. Each lane
// then takes samples s = lane, lane+32, ...: it counts the CDF entries <= u
// (the exact compare-and-count of the reference, broadcast reads from shared
// memory), brackets, gathers the CDF values and bins from shared memory, and
// interpolates. The lerp's multiply and adds are kept apart
// (__fmul_rn/__fadd_rn) so they round as the plain version's separate ops do.
// The variant and the extra outputs are template parameters, so K1 (the
// NeRF instantiation without them) compiles to what it was before K2 joined
// it. None of the TPU workarounds survive: no triangular-matmul cumsum, no
// one-hot gathers, no VMEM row blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kNerfpp, bool kSaved>
__global__ void sample_pdf_kernel(const float* __restrict__ bins,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ u,
                                  float* __restrict__ out,
                                  int* __restrict__ inds_out,
                                  float* __restrict__ cdf_out,
                                  int n_rays, int n_bins, int n_samples) {
  constexpr float kEps = kNerfpp ? 1e-6f : 1e-5f;
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

  if (kSaved && cdf_out != nullptr) {
    float* c_row = cdf_out + static_cast<int64_t>(ray) * n_bins;
    for (int j = lane; j < n_bins; j += 32) c_row[j] = cdf[j];
  }

  const int n_search = kNerfpp ? n_bins - 1 : n_bins;
  const float* u_row = u + static_cast<int64_t>(ray) * n_samples;
  float* o_row = out + static_cast<int64_t>(ray) * n_samples;
  for (int s = lane; s < n_samples; s += 32) {
    const float us = u_row[s];
    int inds = 0;
    for (int j = 0; j < n_search; ++j) inds += us >= cdf[j];
    int below, above;
    if (kNerfpp) {
      above = max(inds, 1);
      below = above - 1;
    } else {
      below = max(inds - 1, 0);
      above = min(inds, n_bins - 1);
    }
    const float cdf_b = cdf[below];
    float denom = cdf[above] - cdf_b;
    if (denom < kEps) denom = 1.f;
    const float t = (us - cdf_b) / denom;
    const float bin_b = edge[below];
    float width = edge[above] - bin_b;
    if (kNerfpp) width = __fadd_rn(width, kEps);
    o_row[s] = __fadd_rn(bin_b, __fmul_rn(t, width));
    if (kSaved) inds_out[static_cast<int64_t>(ray) * n_samples + s] = inds;
  }
}

template <bool kNerfpp, bool kSaved>
int launch(const float* bins, const float* weights, const float* u, float* out,
           int* inds, float* cdf, int n_rays, int n_bins, int n_samples,
           cudaStream_t stream) {
  if (n_rays == 0 || (n_samples == 0 && cdf == nullptr)) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = static_cast<size_t>(2) * n_bins * kWarpsPerBlock * sizeof(float);
  const int blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sample_pdf_kernel<kNerfpp, kSaved><<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      bins, weights, u, out, inds, cdf, n_rays, n_bins, n_samples);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All entries: bins (n_rays, n_bins), weights (n_rays, n_bins-1), u and out
// (n_rays, n_samples): float32, contiguous, on the current device.
// 2 <= n_bins <= 1024. Launch on `stream`; return cudaGetLastError().

// K1, the NeRF variant without extra outputs.
extern "C" int scnerf_sample_pdf(const float* bins, const float* weights,
                                 const float* u, float* out, int n_rays,
                                 int n_bins, int n_samples, cudaStream_t stream) {
  return launch<false, false>(bins, weights, u, out, nullptr, nullptr, n_rays, n_bins,
                              n_samples, stream);
}

// K2, one entry per variant. inds (n_rays, n_samples) int32 receives the
// search counts; cdf (n_rays, n_bins) float32 receives the CDF, or is null.
extern "C" int scnerf_sample_pdf_fwd_nerfpp(const float* bins, const float* weights,
                                            const float* u, float* out, int* inds,
                                            float* cdf, int n_rays, int n_bins,
                                            int n_samples, cudaStream_t stream) {
  return launch<true, true>(bins, weights, u, out, inds, cdf, n_rays, n_bins, n_samples,
                            stream);
}

extern "C" int scnerf_sample_pdf_fwd_nerf(const float* bins, const float* weights,
                                          const float* u, float* out, int* inds,
                                          float* cdf, int n_rays, int n_bins,
                                          int n_samples, cudaStream_t stream) {
  return launch<false, true>(bins, weights, u, out, inds, cdf, n_rays, n_bins, n_samples,
                             stream);
}
