// K4: row-wise sorted search, one warp per row.
//
// Replaces the Pallas TPU kernel scnerf_tpu/kernels/searchsorted_pallas.py:
// searchsorted_pallas (body _kernel). Per row r of a (B, N) sorted and of
// v (B, M):
//   left:  out[r, m] = #{i : a[r, i] <  v[r, m]}   (the TPU's sum(v > a))
//   right: out[r, m] = #{i : a[r, i] <= v[r, m]}   (the TPU's sum(v >= a))
// int32, in [0, N]: torch.searchsorted's indices on sorted, NaN-free rows.
//
// What bounds it: memory. Per row it reads N + M floats and writes M int32s;
// a call at the NeRF resampler's shape (8192 rows, N = 63, M = 64) moves
// 6.3 MB, about 1.9 us of HBM time, against 8192 * 64 * 6 compares. At such
// sizes the launch and the host's work around it take longer than the data.
//
// Design: a warp owns a row. Its lanes copy the row into the warp's slice of
// shared memory (coalesced), then each lane takes queries m = lane, lane+32,
// ... and binary-searches the shared row. A binary search rather than the
// TPU's compare-and-count: on a sorted row both give the same count exactly
// (the predicate a[i] < v, or a[i] <= v, holds on a prefix, ties included),
// but the search reads log2(N) entries where the count reads all N, and the
// wrapper admits rows up to what one block's shared memory holds (57,344
// floats). Lanes of a warp differ by at most one step, so the search hardly
// diverges. Up to 32 warps share a block while their rows fit (at the
// resamplers' shapes 1,024-thread blocks finish sooner than 256-thread ones);
// the TPU's row blocks in VMEM do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarpsPerBlock = 32;
constexpr size_t kMaxSmem = 232448;  // what one block may use on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;

template <bool kRight>
__global__ void searchsorted_kernel(const float* __restrict__ a,
                                    const float* __restrict__ v,
                                    int* __restrict__ out, int n_rows, int n_a,
                                    int n_v) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= n_rows) return;  // uniform across the warp; no block barrier below

  float* a_row = smem + static_cast<int64_t>(warp) * n_a;
  const float* a_src = a + static_cast<int64_t>(row) * n_a;
  for (int i = lane; i < n_a; i += 32) a_row[i] = a_src[i];
  __syncwarp();

  const float* v_row = v + static_cast<int64_t>(row) * n_v;
  int* o_row = out + static_cast<int64_t>(row) * n_v;
  for (int m = lane; m < n_v; m += 32) {
    const float x = v_row[m];
    int lo = 0;
    int len = n_a;
    while (len > 0) {
      const int half = len >> 1;
      const float y = a_row[lo + half];
      if (kRight ? (y <= x) : (y < x)) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    o_row[m] = lo;
  }
}

template <bool kRight>
int launch(const float* a, const float* v, int* out, int n_rows, int n_a, int n_v,
           cudaStream_t stream) {
  if (n_rows == 0 || n_v == 0) return static_cast<int>(cudaSuccess);
  const size_t row_bytes = static_cast<size_t>(n_a) * sizeof(float);
  int warps = kMaxWarpsPerBlock;
  if (row_bytes > 0) {
    const size_t fit = kMaxSmem / row_bytes;
    if (fit == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (fit < static_cast<size_t>(warps)) warps = static_cast<int>(fit);
  }
  const size_t smem = row_bytes * warps;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        searchsorted_kernel<kRight>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rows + warps - 1) / warps;
  searchsorted_kernel<kRight><<<blocks, 32 * warps, smem, stream>>>(a, v, out, n_rows,
                                                                    n_a, n_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (n_rows, n_a) sorted rows and v (n_rows, n_v): float32, contiguous, on the
// current device; out (n_rows, n_v) int32. n_a * 4 bytes <= 232,448. Launch
// on `stream`; return cudaGetLastError() (or the error that kept it from
// launching).
extern "C" int scnerf_searchsorted(const float* a, const float* v, int* out, int n_rows,
                                   int n_a, int n_v, int right, cudaStream_t stream) {
  return right ? launch<true>(a, v, out, n_rows, n_a, n_v, stream)
               : launch<false>(a, v, out, n_rows, n_a, n_v, stream);
}
