// K3: positional encoding and the whole NeRF MLP in one kernel, forward only.
//
// Replaces the Pallas TPU kernel scnerf_tpu/kernels/mlp_pallas.py:
// fused_query_field (body _kernel), for the configs it supports: depth 8,
// width 256, the skip after layer 4, viewdirs, float32. Per point, with
// pe = [x, sin(2^0 x), cos(2^0 x), ..., cos(2^(F-1) x)] (3 + 6F wide) and ve
// the same of the ray's view direction (3 + 6Fv wide):
//   h = relu(pe W0 + b0); h = relu(h Wl + bl), l = 1..4
//   h = [pe, h];          h = relu(h Wl + bl), l = 5..7
//   alpha = h Wa + ba     (from the trunk)
//   feat = h Wf + bf;     hv = relu([feat, ve] Wv + bv);  rgb = hv Wr + br
//   out = [rgb, alpha]    (N, S, 4)
//
// What bounds it: operations. A point costs 593,408 multiply-adds at
// multires 10/4 (the sum of the weights' sizes) and moves 40 bytes (pts,
// its share of viewdirs, out): 1.19 MFLOP per 40 B, far above the H100's 20
// FLOP/B of float32 without tensor cores. At the fine shape of the NeRF
// serving path (8192 rays x 128 samples) that is 1.245 TFLOP, 18.6 ms at the
// published 67 TFLOP/s, against 42 MB of traffic (12.5 us).
//
// Design (the simple one; tensor cores, a TMA weight ring and the like are
// later work): a block of 256 threads owns a tile of 64 points. The
// activations never leave shared memory: one buffer of rows x 64 points,
// row-major by feature (a row is 68 floats, padded so that the threads'
// float4 stores of their rows fall in different banks). The encoding goes
// into rows [0, P); every trunk layer writes its 256 outputs into rows
// [P, P + 256), so after layer 4 rows [0, P + 256) are [pe, h] and the skip
// concat costs nothing. The feature head writes rows [0, 256) and the view
// encoding goes into [256, 256 + V), so [feat, ve] is free too. Thread j
// computes output column j for all 64 points: 64 float32 accumulators in
// registers, one coalesced load of W[k, j] per k serving 64 FMAs, the 64
// inputs of row k read as 16 broadcast float4 loads. A layer writes over its
// own input: its outputs wait in registers until a barrier says every thread
// has read the input. One buffer (87 KB at 10/4) lets two blocks share an SM.
// The weights (2.37 MB) are read from global memory through L2, which holds
// them all; the TPU kernel keeps them resident in VMEM, but one 256 x 256
// float32 layer (256 KB) alone exceeds a block's 227 KB of shared memory.
// The views head (128 outputs) uses half the threads; alpha (1) and rgb (3)
// give a thread a (point, output) pair instead. Frequencies are the exact
// powers 2^i, as fields/encoding.py:freq_bands makes them for NeRFConfig, and
// sin/cos are the precise sinf/cosf: arguments reach 2^9 |x|, where the fast
// intrinsics are off by far more than the tolerance. Float32 FMA throughout,
// summing over k in order; no TF32, no bf16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // points per block
constexpr int kThreads = 256;      // = kWidth: one thread per output column
constexpr int kStride = kTile + 4; // floats per activation row
constexpr int kWidth = 256;
constexpr int kViewsWidth = 128;
constexpr int kDepth = 8;
constexpr int kSkip = 4;           // [pe, h] after this layer
constexpr int kLayers = kDepth + 4;  // trunk, feature, alpha, views, rgb
constexpr int kFeature = kDepth, kAlpha = kDepth + 1, kViews = kDepth + 2, kRgb = kDepth + 3;
constexpr int kMaxFreqs = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Params {
  const float* w[kLayers];  // (in, out), row-major
  const float* b[kLayers];  // (out,)
};

// Writes [x, sin(2^0 x), cos(2^0 x), ...] of coordinate d of point p into
// rows row0 + d, row0 + 3 + 6i + d (sin) and row0 + 6 + 6i + d (cos).
__device__ __forceinline__ void encode(float x, int d, int p, int n_freqs, int row0,
                                       float* act) {
  act[(row0 + d) * kStride + p] = x;
  for (int i = 0; i < n_freqs; ++i) {
    const float s = x * ldexpf(1.f, i);  // exact: a power of two
    act[(row0 + 3 + 6 * i + d) * kStride + p] = sinf(s);
    act[(row0 + 6 + 6 * i + d) * kStride + p] = cosf(s);
  }
}

// Rows [out_row, out_row + n_out) = act(rows [in_row, in_row + k_dim) W + b)
// for the tile's points; may overwrite its own input. Every thread of the
// block must call it (it holds two block barriers).
template <bool kRelu>
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const float* __restrict__ b, int k_dim,
                                      int n_out, float* act, int in_row, int out_row) {
  const int j = threadIdx.x;
  float acc[kTile];
#pragma unroll
  for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
  if (j < n_out) {
    const float* x = act + in_row * kStride;
    const float* wj = w + j;
#pragma unroll 4
    for (int k = 0; k < k_dim; ++k) {
      const float wk = __ldg(wj + static_cast<int64_t>(k) * n_out);
      const float4* xk = reinterpret_cast<const float4*>(x + k * kStride);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 xv = xk[q];
        acc[4 * q + 0] = fmaf(xv.x, wk, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv.y, wk, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv.z, wk, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv.w, wk, acc[4 * q + 3]);
      }
    }
  }
  __syncthreads();  // every thread has read the input rows
  if (j < n_out) {
    const float bj = __ldg(b + j);
    float4* y = reinterpret_cast<float4*>(act + (out_row + j) * kStride);
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      float4 o = make_float4(acc[4 * q] + bj, acc[4 * q + 1] + bj, acc[4 * q + 2] + bj,
                             acc[4 * q + 3] + bj);
      if (kRelu) {
        o.x = fmaxf(o.x, 0.f);
        o.y = fmaxf(o.y, 0.f);
        o.z = fmaxf(o.z, 0.f);
        o.w = fmaxf(o.w, 0.f);
      }
      y[q] = o;
    }
  }
  __syncthreads();  // the output rows are written
}

__global__ void __launch_bounds__(kThreads, 2)
fused_query_field_kernel(const float* __restrict__ pts, const float* __restrict__ viewdirs,
                         Params prm, float* __restrict__ out, int64_t n_points,
                         int n_samples, int n_freqs_pos, int n_freqs_view) {
  extern __shared__ __align__(16) float act[];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int pe_rows = 3 + 6 * n_freqs_pos;
  const int ve_rows = 3 + 6 * n_freqs_view;

  // pe into rows [0, pe_rows); the ragged tile's missing points read 0.
  for (int t = threadIdx.x; t < 3 * kTile; t += kThreads) {
    const int p = t / 3, d = t % 3;
    const int64_t point = tile0 + p;
    const float x = point < n_points ? pts[point * 3 + d] : 0.f;
    encode(x, d, p, n_freqs_pos, 0, act);
  }
  __syncthreads();

  // The trunk: layer 0 reads pe, layer kSkip + 1 reads [pe, h], the rest h.
  dense<true>(prm.w[0], prm.b[0], pe_rows, kWidth, act, 0, pe_rows);
  for (int l = 1; l < kDepth; ++l) {
    const bool skip_in = l == kSkip + 1;
    dense<true>(prm.w[l], prm.b[l], skip_in ? pe_rows + kWidth : kWidth, kWidth, act,
                skip_in ? 0 : pe_rows, pe_rows);
  }

  // alpha from the trunk, before the feature head writes over it.
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    const float* wa = prm.w[kAlpha];
    float a = 0.f;
    for (int k = 0; k < kWidth; ++k) a = fmaf(act[(pe_rows + k) * kStride + p], __ldg(wa + k), a);
    const int64_t point = tile0 + p;
    if (point < n_points) out[point * 4 + 3] = a + __ldg(prm.b[kAlpha]);
  }
  dense<false>(prm.w[kFeature], prm.b[kFeature], kWidth, kWidth, act, pe_rows, 0);

  // ve of each point's ray into rows [kWidth, kWidth + ve_rows).
  for (int t = threadIdx.x; t < 3 * kTile; t += kThreads) {
    const int p = t / 3, d = t % 3;
    const int64_t point = tile0 + p;
    const float x = point < n_points ? viewdirs[(point / n_samples) * 3 + d] : 0.f;
    encode(x, d, p, n_freqs_view, kWidth, act);
  }
  __syncthreads();

  dense<true>(prm.w[kViews], prm.b[kViews], kWidth + ve_rows, kViewsWidth, act, 0, 0);

  // rgb: thread t takes output t / kTile of point t % kTile.
  if (threadIdx.x < 3 * kTile) {
    const int p = threadIdx.x % kTile, c = threadIdx.x / kTile;
    const float* wr = prm.w[kRgb];
    float r = 0.f;
    for (int k = 0; k < kViewsWidth; ++k) r = fmaf(act[k * kStride + p], __ldg(wr + k * 3 + c), r);
    const int64_t point = tile0 + p;
    if (point < n_points) out[point * 4 + c] = r + __ldg(prm.b[kRgb] + c);
  }
}

}  // namespace

// pts (n_points, 3) with n_points = n_rays * n_samples, viewdirs (n_rays, 3)
// and out (n_points, 4): float32, contiguous, on the current device. params
// is a host array of 24 device pointers, each weight (in, out) and bias
// (out,) float32 contiguous: w0, b0, ..., w7, b7 of the trunk, then w, b of
// feature, alpha, views, rgb. 0 <= n_freqs_pos, n_freqs_view <= 16. Launch
// on `stream`; return cudaGetLastError() (or the error that kept it from
// launching).
extern "C" int scnerf_fused_query_field(const float* pts, const float* viewdirs,
                                        const float* const* params, float* out,
                                        long long n_points, int n_samples,
                                        int n_freqs_pos, int n_freqs_view,
                                        cudaStream_t stream) {
  if (n_points == 0) return static_cast<int>(cudaSuccess);
  if (n_freqs_pos < 0 || n_freqs_pos > kMaxFreqs || n_freqs_view < 0 ||
      n_freqs_view > kMaxFreqs || n_samples <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  for (int l = 0; l < kLayers; ++l) {
    prm.w[l] = params[2 * l];
    prm.b[l] = params[2 * l + 1];
  }
  const int pe_rows = 3 + 6 * n_freqs_pos;
  const int ve_rows = 3 + 6 * n_freqs_view;
  const int rows = kWidth + (pe_rows > ve_rows ? pe_rows : ve_rows);
  const size_t smem = static_cast<size_t>(rows) * kStride * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_query_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_points + kTile - 1) / kTile;
  fused_query_field_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      pts, viewdirs, prm, out, n_points, n_samples, n_freqs_pos, n_freqs_view);
  return static_cast<int>(cudaGetLastError());
}
