// K1 and K2: inverse-CDF resampling, a warp per ray or per two rays.
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
// Contract: weights >= 0 and finite, as compositing gives them.
// Built by kernels/_build.py into a library with a plain C interface (the
// extern "C" entries at the end); the CUDA implementations of the registered
// operators torch.ops.scnerf_tpu_torch.sample_pdf (K1) and sample_pdf_fwd
// (K2), defined in kernels/pdf_cuda.py, check the operands, allocate the
// outputs and call the entries through ctypes on the current stream.
//
// What bounds it: memory. Per ray it reads (2B - 1 + S) floats and writes S
// (K2 also S counts, and B CDF entries when asked): a call at the serving
// shapes (8192 rays, B = 63, S = 64; 4096, 63, 128) moves about 8 MB, some
// 2.5 us of HBM time. What a warp does with its row is a serial chain of
// latencies, so the design keeps that chain short and puts the loads in
// flight at once.
//
// Design: a warp owns a ray (or two, below). Each lane first issues every
// load it will need: its weights and bin edges (one register per 32-wide
// piece of the row) and its first samples of u. While they arrive, nothing
// waits on them but the normaliser, a shuffle reduction of the weights held
// in registers (each weight is read from device memory once). The CDF is
// built by a warp-shuffle inclusive scan in 32-wide pieces (a carried prefix
// joins the pieces) into the warp's slice of shared memory, next to the bin
// row. Each lane then takes its samples s = lane, lane+32, ... and finds the
// count by a binary search over the CDF (6 probes at B = 63, where the TPU's
// compare-and-count reads all M entries), the searches of a lane's samples
// interleaved so that their shared-memory reads overlap; it brackets,
// gathers the CDF values and bins from shared memory, and interpolates.
// The lerp's multiply and adds are kept apart (__fmul_rn/__fadd_rn) so they
// round as the plain version's separate ops do.
//
// The search: on a non-decreasing CDF the binary search's count equals the
// compare-and-count's exactly. The scan adds a piece's carry to every member
// (monotone) and each entry adds a term >= 0, but the shuffle scan sums each
// lane's prefix in another order, so two neighbours can come out inverted by
// an ulp where a term is below the rounding of the sum (zero weights beside
// large ones, mostly with NeRF++'s eps of 1e-6). For u inside such an
// ulp-wide inversion the search returns a count k with cdf[k-1] <= u <
// cdf[k], as compare-and-count does on sorted rows; elsewhere the two agree.
// The CDF itself, and so K2's saved CDF, is what the scan always gave.
// A ballot/popc count over a CDF held in registers was not built: the 32
// lanes hold 32 different samples, so each sample would take the whole warp
// for a shuffle, B/32 ballots and popcounts in turn, where the binary search
// takes log2(B) shared-memory probes on every lane at once.
//
// Layout: with S <= 64 on a short row (K1's serving shape) a warp takes two
// rays, each step of one (shuffle, probe, gather) beside the other's, so two
// chains of latencies overlap in half as many warps; any other shape takes a
// warp a ray. On the H100 this was faster at K1's shape than one ray a warp,
// and at both serving shapes than two warps a ray, each warp building the
// CDF and taking half the samples (PERF.md).
//
// What now bounds it: the chain per warp (the loads' latency, about 25
// dependent shuffles and a division per CDF entry, the probes, a division
// per sample) and the instructions the SM issues for it. No one stage holds
// the time: the scan, the divisions and the search each take a share, and
// the divisions stay to keep the values bit for bit. The CDF build weighs
// most where a ray has few samples (K1 builds twice as many CDFs as K2 for
// the same bytes, and takes longer). Not the bytes: a copy of the same bytes
// in one launch, back to back as the kernels are timed, takes under half of
// either kernel's time on the H100 (the profile script times it beside
// them; PERF.md). Holding K1 to one wave (32 registers a thread) spilled
// and was slower.
//
// The variant and the extra outputs are template parameters, so K1 is the
// NeRF instantiation without them; the row length (2 or 32 pieces), the
// samples a lane holds at once (2 or 4) and the rays a warp takes are chosen
// per launch. None of the TPU workarounds survive: no triangular-matmul
// cumsum, no one-hot gathers, no VMEM row blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// The samples s = first + 32 k (k < kU) of a row of u, 0 past its end.
template <int kU>
__device__ __forceinline__ void load_u(float (&us)[kU], const float* __restrict__ u_row,
                                       int first, int n_samples) {
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const int s = first + k * 32;
    us[k] = s < n_samples ? u_row[s] : 0.f;
  }
}

// kPieces: 32-wide pieces of the bin row a lane holds in registers (2 for
// B <= 64, 32 for B <= 1024). kU: samples of a ray a lane holds at once.
// kRays: rays a warp takes, their steps interleaved (each shuffle, search
// probe and gather of one ray beside the other's) so that two chains of
// latencies overlap.
template <bool kNerfpp, bool kSaved, int kPieces, int kU, int kRays>
__global__ void sample_pdf_kernel(const float* __restrict__ bins,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ u, float* __restrict__ out,
                                  int* __restrict__ inds_out, float* __restrict__ cdf_out,
                                  int n_rays, int n_bins, int n_samples) {
  constexpr float kEps = kNerfpp ? 1e-6f : 1e-5f;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int global_warp = blockIdx.x * (blockDim.x / 32) + warp;
  const int ray0 = global_warp * kRays;
  if (ray0 >= n_rays) return;  // uniform across the warp; no block barrier below
  const int n_w = n_bins - 1;

  // Every load first: nothing below waits on the bins or on u until the
  // CDF is built. A ray past the end (the last warp's second) loads zeros
  // and stores nothing.
  float w[kRays][kPieces];
  float e[kRays][kPieces];
  float us[kRays][kU];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int64_t ray = ray0 + r;
    const bool live = ray < n_rays;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int j = p * 32 + lane;
      w[r][p] = live && j < n_w ? weights[ray * n_w + j] : 0.f;
      e[r][p] = live && j < n_bins ? bins[ray * n_bins + j] : 0.f;
    }
    load_u(us[r], u + ray * n_samples, lane, live ? n_samples : 0);
  }

  float total[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      if (p * 32 + lane < n_w) sum += w[r][p] + kEps;
    }
    total[r] = sum;
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kRays; ++r) total[r] += __shfl_xor_sync(kFullMask, total[r], off);
  }

  float* cdf[kRays];
  float* c_row[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = ray0 + r;
    cdf[r] = smem + (warp * kRays + r) * 2 * n_bins;  // then the bin row
    c_row[r] = kSaved && cdf_out != nullptr && ray < n_rays
                   ? cdf_out + static_cast<int64_t>(ray) * n_bins : nullptr;
    if (lane == 0) {
      cdf[r][0] = 0.f;
      if (c_row[r] != nullptr) c_row[r][0] = 0.f;
    }
  }
  float carry[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) carry[r] = 0.f;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    if (p * 32 >= n_w) break;  // uniform
    const int j = p * 32 + lane;
    float v[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) v[r] = j < n_w ? (w[r][p] + kEps) / total[r] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const float o = __shfl_up_sync(kFullMask, v[r], off);
        if (lane >= off) v[r] += o;
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      v[r] += carry[r];
      if (j < n_w) {
        cdf[r][j + 1] = v[r];
        if (c_row[r] != nullptr) c_row[r][j + 1] = v[r];
      }
      carry[r] = __shfl_sync(kFullMask, v[r], 31);
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int j = p * 32 + lane;
      if (j < n_bins) cdf[r][n_bins + j] = e[r][p];
    }
  }
  __syncwarp();

  // The count #{j < n_search : u >= cdf[j]} by binary lifting: take each
  // power-of-two step whose last entry is still <= u. Every lane probes the
  // same number of times.
  const int n_search = kNerfpp ? n_bins - 1 : n_bins;
  const int top = 1 << (31 - __clz(n_search));
  for (int s0 = lane; s0 < n_samples; s0 += kU * 32) {
    if (s0 != lane) {
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const int64_t ray = ray0 + r;
        load_u(us[r], u + ray * n_samples, s0, ray < n_rays ? n_samples : 0);
      }
    }
    int pos[kRays][kU];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
#pragma unroll
      for (int k = 0; k < kU; ++k) pos[r][k] = 0;
    }
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
#pragma unroll
        for (int k = 0; k < kU; ++k) {
          const int probe = pos[r][k] + step;
          if (probe <= n_search && us[r][k] >= cdf[r][probe - 1]) pos[r][k] = probe;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int64_t ray = ray0 + r;
      if (ray >= n_rays) break;
      const float* c = cdf[r];
      const float* edge = c + n_bins;
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int s = s0 + k * 32;
        if (s >= n_samples) break;
        const int inds = pos[r][k];
        int below, above;
        if (kNerfpp) {
          above = max(inds, 1);
          below = above - 1;
        } else {
          below = max(inds - 1, 0);
          above = min(inds, n_bins - 1);
        }
        const float cdf_b = c[below];
        float denom = c[above] - cdf_b;
        if (denom < kEps) denom = 1.f;
        const float t = (us[r][k] - cdf_b) / denom;
        const float bin_b = edge[below];
        float width = edge[above] - bin_b;
        if (kNerfpp) width = __fadd_rn(width, kEps);
        out[ray * n_samples + s] = __fadd_rn(bin_b, __fmul_rn(t, width));
        if (kSaved) inds_out[ray * n_samples + s] = inds;
      }
    }
  }
}

template <bool kNerfpp, bool kSaved, int kPieces, int kU, int kRays>
void launch_kernel(int blocks, int warps, size_t smem, cudaStream_t stream, const float* bins,
                   const float* weights, const float* u, float* out, int* inds, float* cdf,
                   int n_rays, int n_bins, int n_samples) {
  sample_pdf_kernel<kNerfpp, kSaved, kPieces, kU, kRays>
      <<<blocks, 32 * warps, smem, stream>>>(bins, weights, u, out, inds, cdf, n_rays, n_bins,
                                             n_samples);
}

template <bool kNerfpp, bool kSaved>
int launch(const float* bins, const float* weights, const float* u, float* out,
           int* inds, float* cdf, int n_rays, int n_bins, int n_samples,
           cudaStream_t stream) {
  if (n_rays == 0 || (n_samples == 0 && cdf == nullptr)) {
    return static_cast<int>(cudaSuccess);
  }
  const bool short_row = n_bins <= 64;
  const int rays_per_warp = short_row && n_samples <= 64 ? 2 : 1;
  // Warps per block: as many as fit in the default shared memory.
  const size_t warp_smem = static_cast<size_t>(2) * n_bins * rays_per_warp * sizeof(float);
  int warps = kWarpsPerBlock;
  if (warps * warp_smem > kDefaultSmem) warps = static_cast<int>(kDefaultSmem / warp_smem);
  const int64_t total_warps = (static_cast<int64_t>(n_rays) + rays_per_warp - 1) / rays_per_warp;
  const int blocks = static_cast<int>((total_warps + warps - 1) / warps);
  const size_t smem = warps * warp_smem;
  const int per_lane = (n_samples + 31) / 32;
  const auto go = [&](auto kernel) {
    kernel(blocks, warps, smem, stream, bins, weights, u, out, inds, cdf, n_rays, n_bins,
           n_samples);
  };
  if (rays_per_warp == 2) {
    go(launch_kernel<kNerfpp, kSaved, 2, 2, 2>);
  } else if (short_row) {  // S > 64
    go(launch_kernel<kNerfpp, kSaved, 2, 4, 1>);
  } else if (per_lane <= 2) {
    go(launch_kernel<kNerfpp, kSaved, 32, 2, 1>);
  } else {
    go(launch_kernel<kNerfpp, kSaved, 32, 4, 1>);
  }
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
