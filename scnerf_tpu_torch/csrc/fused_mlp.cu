// K3: positional encoding and the whole NeRF MLP in one kernel, forward only,
// its products on Hopper's tensor cores (wgmma) in 3xTF32.
//
// Replaces the Pallas TPU kernel scnerf_tpu/kernels/mlp_pallas.py:
// fused_query_field (body _kernel), for the configs it supports: depth 8,
// width 256, the skip after layer 4, viewdirs, float32. Points are D = 3 or
// 4 wide (NeRF's and NeRF++'s fg points; NeRF++'s inverted-sphere bg points
// (x/r, y/r, z/r, 1/r)), D a template parameter of the kernel. Per point,
// with pe = [x, sin(2^0 x), cos(2^0 x), ..., cos(2^(F-1) x)] (D + 2DF wide)
// and ve the same of the ray's view direction (3 + 6Fv wide):
//   h = relu(pe W0 + b0); h = relu(h Wl + bl), l = 1..4
//   h = [pe, h];          h = relu(h Wl + bl), l = 5..7
//   alpha = h Wa + ba     (from the trunk)
//   feat = h Wf + bf;     hv = relu([feat, ve] Wv + bv);  rgb = hv Wr + br
//   out = [rgb, alpha]    (N, S, 4)
// NeRF++'s MLPNet is this network under other names (base, sigma, remap,
// rgb0, rgb1); its caller applies abs to alpha and a sigmoid to rgb.
//
// What bounds it: operations. A point costs 593,408 multiply-adds at
// multires 10/4 and moves 40 bytes; at the fine shape of the NeRF serving
// path (8192 rays x 128 samples) that is 1.245 TFLOP against 42 MB. On the
// CUDA cores (67 TFLOP/s of float32) no kernel can take less than 18.6 ms.
// The tensor cores multiply TF32 at 495 TFLOP/s (dense), and 3xTF32 takes
// three passes: 7.54 ms.
//
// Why 3xTF32: the port holds K3 to float32 limits against its float32 twin
// (median |err| < 1e-5, max < 2e-4). One TF32 pass keeps 11 significant
// bits of each operand, about 5e-4 of relative error per product. Each
// operand x is split into big = tf32(x) and small = tf32(x - big) (rounded
// as cvt.rna.tf32.f32 does: to nearest, ties away from zero), and each
// product is small_a big_b + big_a small_b + big_a big_b, small products
// first. What is left out, small_a small_b and the rounding of the small
// halves, is about 2^-22 of each product: float32's own order of error.
// The tensor cores' float32 accumulation truncates: each product step loses
// up to an ulp of its accumulator, always toward zero, so a 256-wide layer
// summed in one accumulator drifts by up to some 1e-5 of its value, and the
// card tests' far-out points then miss the median limit. So the products of
// each K-slice go into a fresh accumulator, which is then added to the
// layer's float32 sums with rounding FADDs.
//
// Design:
// - A block owns a tile of 64 points: two consumer warpgroups (256 threads)
//   that compute, and one producer warpgroup that streams the weights. The
//   flush keeps a slice's products beside the float32 sums, so a consumer
//   thread holds two accumulator sets, and 128 points x 256 outputs would
//   need 256 registers a thread for them. Each tile streams the whole packed
//   weights (4.75 MB at 10/4) from L2. The activations never leave shared
//   memory: one buffer, feature-major (act[row][point]), rows of 72 floats.
//   72 = 8 mod 32 puts the 32 loads of an A fragment (4 rows x 8 points)
//   into 32 different banks.
// - Rows with K padded to a multiple of 32 by zero rows: pe in rows
//   [0, pe_pad) (63 -> 64 at 10/4), each trunk layer writes rows
//   [pe_pad, pe_pad + 256), so after layer 4 the rows are [pe, 0, h] and the
//   skip concat costs nothing (319 -> 320 wide; at D = 4, 84 -> 96 and
//   340 -> 352). The feature head writes rows [0, 256) and the view encoding
//   goes into [256, 256 + ve_pad) (283 -> 288 wide), so [feat, ve] is free
//   too. A layer writes over its own input: its outputs wait in the
//   accumulators until a barrier of the 256 consumer threads says every
//   consumer warp has read the input, and a second one publishes them.
// - The 8 trunk layers, feature (256 -> 256) and views (288 -> 128), 99.9%
//   of the multiply-adds, run on the tensor cores: wgmma.m64nNk8.tf32, A
//   (the activations, split in registers: cvt.rna, a subtraction, cvt.rna)
//   from registers, B (the weights, split by the wrapper) from shared
//   memory, K-major as TF32 requires. Each consumer warpgroup owns half the
//   outputs of a layer for all 64 points: 64 x 128 (64 float32 accumulators
//   a thread and 64 for a slice's products) or 64 x 64 for views. alpha
//   (256 -> 1) and rgb (128 -> 3) stay on the CUDA cores in float32 FMA,
//   four threads a point, each one of the four interleaved partial sums,
//   combined by shuffles in the order ((s0 + s1) + (s2 + s3)).
// - Weights: the wrapper (kernels/mlp_cuda.py:pack_weights) transposes each
//   tensor-core layer to K-major, pads K with the zero rows above, splits it
//   into TF32 big and small and lays out each k8 step of it as two tiles,
//   big then small, of wgmma's canonical K-major form without swizzle: core
//   matrices of 8 outputs x 4 K (16 bytes a row, 128 bytes each), the two of
//   a k8 step 128 bytes apart, the next 8 outputs 256 bytes on. All layers
//   make one contiguous stream, then the biases and the alpha and rgb
//   weights in float32. One 256 x 256 layer (512 KB split) is larger than a
//   block's 227 KB of shared memory, so the stream passes through a ring in
//   shared memory.
// - The ring: stages of 16 rows of the stream (32 KB of a 256-wide layer,
//   16 KB of views), as many as fit beside the activations, at most 4. The
//   producer warpgroup gives up its registers (setmaxnreg) and one of its
//   threads fills the stages in order with one cp.async.bulk (TMA) copy
//   each, across layer boundaries, as far ahead as the stages allow: it
//   waits on a stage's "empty" mbarrier, then arms its "full" mbarrier with
//   the copy's bytes (complete_tx). A consumer warpgroup waits on "full",
//   and each of its warps arrives on "empty" once its wgmma have read the
//   stage. No block-wide barrier runs inside a slice.
// - The flush slice: the products of 32 rows (two stages) go into one fresh
//   accumulator where four stages fit, else those of 16 rows (one stage of
//   three). The flush rows, the order of the products and of the FADDs make
//   the outputs; the schedule does not move them.
// - Ping-pong: the two consumer warpgroups take turns to issue a slice's
//   wgmma group, ordered by two named barriers (warpgroup w waits on its
//   own, issues, and arrives on the other's). Warpgroup 1 thus runs half a
//   slice behind warpgroup 0, and each one's wait and flush run while the
//   other's wgmma keep the tensor cores busy. A warpgroup splits the next
//   slice's A fragments while its own wgmma run (two fragment sets). Turns
//   restart at each layer, whose two consumer barriers bring both
//   warpgroups together.
// - What is left between the schedule and the 3xTF32 bound: shared memory
//   serves 128 bytes a clock, and a 32-row slice of a 256-wide layer moves
//   176 KB through it (96 KB of B reads: big, small, big a k8 step; 64 KB
//   of copies in; 16 KB of A loads) against 1,536 clocks of products, so
//   it is near its limit while the products run; each layer boundary (the
//   epilogue's bias, ReLU and 64 stores a thread, then the next layer's
//   first split) and the tile's encoding and rgb leave the tensor cores
//   idle.
// - Shared memory per block, and the four layouts: act (256 + max(pe_pad,
//   ve_pad)) x 72 x 4 B plus the ring. D = 3, 10/4: 92,160 + 4 stages
//   (131,072) = 223,232; D = 4, 10/4: 101,376 + 4 stages = 232,448 (a
//   block's limit); D = 3, 16/16: 110,592 + 3 stages (98,304) = 208,896;
//   D = 4, 16/16: 119,808 + 3 stages = 218,112. The ring's 2 x 4 mbarriers
//   (8 bytes each) lie in the padding columns [64, 72) of activation rows
//   0-3, which nothing else reads or writes. One block per SM. Registers:
//   the producer keeps 24 a thread and the consumers take 240: 64
//   accumulators, 64 for a slice's products, 8 for each k8 step's split A
//   fragment, twice (-Xptxas -v in build/kernels/fused_mlp.log: no
//   spills; it reports the 168 a thread has at launch).
// - Frequencies are the exact powers 2^i, as fields/encoding.py:freq_bands
//   makes them for NeRFConfig, and sin/cos are the precise sinf/cosf:
//   arguments reach 2^15 |x|, where the fast intrinsics are off by far more
//   than the tolerance. No fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // points per block: wgmma's M
constexpr int kConsumerThreads = 256;     // two warpgroups that compute
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kStride = kTile + 8;        // floats per activation row, 8 mod 32
constexpr int kWidth = 256;
constexpr int kViewsWidth = 128;
constexpr int kDepth = 8;
constexpr int kSkip = 4;                  // [pe, h] after this layer
constexpr int kMaxFreqs = 16;
constexpr int kAlignK = 32;               // K of every tensor-core layer pads to this
constexpr int kStageK = 16;               // rows of the stream a ring stage holds
constexpr int kStageFloats = kStageK * kWidth * 2;  // big and small: 32 KB
constexpr size_t kStageBytes = kStageFloats * sizeof(float);
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 232448;       // what one block may use on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;
// Named barriers (0 is __syncthreads'): consumer warpgroup w's turn to
// issue is kBarTurn + w; kBarConsumers joins the 256 consumer threads.
constexpr int kBarTurn = 1, kBarConsumers = 3;
// Float offsets of the biases after the tensor-core stream: trunk 8 x 256,
// feature 256, views 128, alpha 1, rgb 3; then alpha's weights (256) and
// rgb's (128 x 3).
constexpr int kBiasFeature = kDepth * kWidth, kBiasViews = kBiasFeature + kWidth,
              kBiasAlpha = kBiasViews + kViewsWidth, kBiasRgb = kBiasAlpha + 1,
              kBiasFloats = kBiasRgb + 3;

constexpr int pad_k(int x) { return (x + kAlignK - 1) / kAlignK * kAlignK; }

// Where things lie in the packed weights (mlp_cuda.py:pack_weights computes
// the same table).
struct Layout {
  int pe_rows, pe_pad, ve_rows, ve_pad;
  int wide_k;   // K of the trunk and feature layers together (N = 256)
  int views_k;  // K of the views layer (N = 128)
  int64_t bias;  // float offsets
  int64_t alpha_w;
  int64_t rgb_w;
};

Layout make_layout(int point_dim, int n_freqs_pos, int n_freqs_view) {
  Layout lay;
  lay.pe_rows = point_dim * (1 + 2 * n_freqs_pos);
  lay.ve_rows = 3 + 6 * n_freqs_view;
  lay.pe_pad = pad_k(lay.pe_rows);
  lay.ve_pad = pad_k(lay.ve_rows);
  // K of layer 0, 1-4, 5 ([pe, 0, h]), 6-7, feature; then views.
  lay.wide_k = lay.pe_pad + 4 * kWidth + (lay.pe_pad + kWidth) + 2 * kWidth + kWidth;
  lay.views_k = kWidth + lay.ve_pad;
  lay.bias = 2 * (static_cast<int64_t>(lay.wide_k) * kWidth +
                  static_cast<int64_t>(lay.views_k) * kViewsWidth);
  lay.alpha_w = lay.bias + kBiasFloats;
  lay.rgb_w = lay.alpha_w + kWidth;
  return lay;
}

size_t act_bytes(const Layout& lay) {
  const int rows = kWidth + (lay.pe_pad > lay.ve_pad ? lay.pe_pad : lay.ve_pad);
  return static_cast<size_t>(rows) * kStride * sizeof(float);
}

// The ring's stages: as many as fit beside the activations, at most 4 (3 or
// 4 for every frequency count the kernel takes).
int ring_stages(const Layout& lay) {
  const size_t fit = (kMaxSmem - act_bytes(lay)) / kStageBytes;
  return static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
}

size_t shared_bytes(const Layout& lay) { return act_bytes(lay) + ring_stages(lay) * kStageBytes; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32: to the nearest TF32 value, ties away from zero, as an
// fp32 bit pattern whose low 13 bits are 0.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// wgmma's shared-memory matrix descriptor for a K-major TF32 tile without
// swizzle: the start address, the two core matrices of a k8 step 128 bytes
// apart (leading byte offset), the next 8 rows 256 bytes on (stride byte
// offset), all in 16-byte units.
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint32_t addr = smem_addr(tile);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (+)= a b over one k8 step for the warpgroup's 64 points x 128 outputs: a
// in registers (the A fragment, TF32), b through its shared-memory
// descriptor (K-major TF32), d float32; scale_d = 0 writes d, 1 adds to it.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a b over one k8 step for the warpgroup's 64 points x 64 outputs: a
// in registers (the A fragment, TF32), b through its shared-memory
// descriptor (K-major TF32), d float32; scale_d = 0 writes d, 1 adds to it.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (kN == 128) {
    wgmma_n128(d, a, b, scale_d);
  } else {
    wgmma_n64(d, a, b, scale_d);
  }
}

// Keeps the compiler from reading d before the wgmma that write it are
// waited for.
template <int kRegs>
__device__ __forceinline__ void fence_regs(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The producer's arrival on a "full" barrier, which then also waits for
// `bytes` of copies to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` from global memory into shared memory at
// `dst`, completing on the barrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers of the 256 consumer threads.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

// The ring's barriers: stage s's "full" barrier in the padding of
// activation row s, its "empty" barrier 8 bytes on.
__device__ __forceinline__ uint32_t full_bar(const float* act, int s) {
  return smem_addr(act + s * kStride + kTile);
}
__device__ __forceinline__ uint32_t empty_bar(const float* act, int s) {
  return full_bar(act, s) + 8;
}

// A consumer's place in the ring: the stage it reads next and that stage's
// phase parity. Both consumer warpgroups read every stage.
template <int kStages>
struct Ring {
  const float* buf;
  const float* act;  // whose padding holds the barriers
  int stage;
  uint32_t phase;

  // Waits for the next stage's copy; returns the stage's index.
  __device__ __forceinline__ int wait() {
    const int s = stage;
    mbar_wait(full_bar(act, s), phase);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    return s;
  }
};

// The producer: fills the ring's stages in order with the stream's
// `wide_stages` stages of 256-wide layers, then its `views_stages` stages of
// views (half as many bytes), each stage once every consumer warp has
// released its previous contents.
template <int kStages>
__device__ __forceinline__ void produce(const float* w, float* buf, const float* act,
                                        int wide_stages, int views_stages) {
  const char* src = reinterpret_cast<const char*>(w);
  const uint32_t dst0 = smem_addr(buf);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < wide_stages + views_stages; ++i) {
    mbar_wait(empty_bar(act, stage), phase ^ 1);  // the first round passes
    const uint32_t bytes = i < wide_stages ? kStageBytes : kStageBytes / 2;
    const uint32_t full = full_bar(act, stage);
    mbar_expect_tx(full, bytes);
    bulk_copy(dst0 + stage * static_cast<uint32_t>(kStageBytes), src, bytes, full);
    src += bytes;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Writes [x, sin(2^0 x), cos(2^0 x), ...] of coordinate d of a kDim-wide
// point p into rows row0 + d, row0 + kDim + 2 kDim i + d (sin) and
// row0 + 2 kDim + 2 kDim i + d (cos).
template <int kDim>
__device__ __forceinline__ void encode(float x, int d, int p, int n_freqs, int row0,
                                       float* act) {
  act[(row0 + d) * kStride + p] = x;
  for (int i = 0; i < n_freqs; ++i) {
    const float s = x * ldexpf(1.f, i);  // exact: a power of two
    act[(row0 + kDim + 2 * kDim * i + d) * kStride + p] = sinf(s);
    act[(row0 + 2 * kDim + 2 * kDim * i + d) * kStride + p] = cosf(s);
  }
}

// The split A fragments of k8 steps [k0 / 8, k0 / 8 + kSteps) of the warp's
// 16 points p0..: step t's a0 (point g, k q), a1 (g + 8, q), a2 (g, q + 4),
// a3 (g + 8, q + 4), rows from `row`, each as TF32 big and small.
template <int kSteps>
__device__ __forceinline__ void split_a(const float* act, int row, int p0, int g, int q,
                                        uint32_t (&big)[kSteps][4],
                                        uint32_t (&small)[kSteps][4]) {
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const float* x = act + (row + 8 * t + q) * kStride + p0 + g;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = x[(r >> 1) * 4 * kStride + (r & 1) * 8];
      big[t][r] = to_tf32(v);
      small[t][r] = to_tf32(v - __uint_as_float(big[t][r]));
    }
  }
}

// Rows [out_row, out_row + 2 kN) = act(rows [in_row, in_row + k_dim) W + b)
// for the tile's points, W from the ring's next k_dim / kStageK stages; may
// overwrite its own input. Every consumer thread calls it; warpgroup w
// computes outputs [w kN, (w + 1) kN). On return the outputs are written
// and visible to every consumer thread.
template <int kN, bool kRelu, int kFlushK, int kStages>
__device__ __forceinline__ void tc_layer(Ring<kStages>& ring, float* act, int in_row, int k_dim,
                                         int out_row, const float* __restrict__ bias) {
  constexpr int kRegs = kN / 2;
  constexpr int kSteps = kFlushK / 8;          // k8 steps a flush slice
  constexpr int kStageSteps = kStageK / 8;     // k8 steps a stage
  constexpr int kSub = kFlushK / kStageK;      // stages a flush slice
  constexpr int kStepFloats = 8 * 2 * kN * 2;  // a k8 step's big and small tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;               // the consumer warpgroup
  const int g = lane >> 2, q = lane & 3;  // the fragments' row group and column
  const int p0 = 16 * (warp & 3);         // the warp's 16 points
  const int n0 = wg * kN;                 // the warpgroup's first output
  float acc[kRegs], part[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0.f;
  const int slices = k_dim / kFlushK;

  // One flush slice: its products from the fragments `a_*` while the next
  // slice's fragments are split into `next_*`, then the flush.
  auto slice = [&](int sl, uint32_t (&a_big)[kSteps][4], uint32_t (&a_small)[kSteps][4],
                   uint32_t (&next_big)[kSteps][4], uint32_t (&next_small)[kSteps][4]) {
    int stages[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) stages[j] = ring.wait();
    consumers_sync(kBarTurn + wg);  // this warpgroup's turn
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      // The warpgroup's outputs start n0 / 8 core-matrix pairs (64 floats
      // each) into the tile; the small tile follows the big one.
      const float* big = ring.buf + stages[t / kStageSteps] * kStageFloats +
                         (t % kStageSteps) * kStepFloats + n0 * 8;
      const uint64_t b_big = tile_desc(big), b_small = tile_desc(big + 2 * kN * 8);
      wgmma<kN>(part, a_small[t], b_big, t > 0);
      wgmma<kN>(part, a_big[t], b_small, 1);
      wgmma<kN>(part, a_big[t], b_big, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // The other warpgroup's turn (warpgroup 0's first turn of the next layer
    // is given at that layer's start).
    if (wg == 0 || sl + 1 < slices) consumers_arrive(kBarTurn + 1 - wg);
    if (sl + 1 < slices) {
      split_a(act, in_row + (sl + 1) * kFlushK, p0, g, q, next_big, next_small);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(part);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) mbar_arrive(empty_bar(act, stages[j]));
    }
#pragma unroll
    for (int i = 0; i < kRegs; ++i) acc[i] += part[i];
  };

  uint32_t a0_big[kSteps][4], a0_small[kSteps][4], a1_big[kSteps][4], a1_small[kSteps][4];
  split_a(act, in_row, p0, g, q, a0_big, a0_small);
  if (wg == 1) consumers_arrive(kBarTurn);  // warpgroup 0 issues first
  for (int sl = 0; sl < slices; sl += 2) {
    slice(sl, a0_big, a0_small, a1_big, a1_small);
    if (sl + 1 < slices) slice(sl + 1, a1_big, a1_small, a0_big, a0_small);
  }
  consumers_sync(kBarConsumers);  // every consumer warp has read the input rows

  // Register i holds point g + 8 ((i >> 1) & 1) of the warp's 16, output
  // n0 + 8 (i / 4) + 2q + (i & 1).
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    const int n = n0 + 8 * (i / 4) + 2 * q + (i & 1);
    float o = acc[i] + __ldg(bias + n);
    if (kRelu) o = fmaxf(o, 0.f);
    act[(out_row + n) * kStride + p0 + g + 8 * ((i >> 1) & 1)] = o;
  }
  consumers_sync(kBarConsumers);  // the outputs are written
}

template <int kDim, int kFlushK, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
fused_query_field_kernel(const float* __restrict__ pts, const float* __restrict__ viewdirs,
                         const float* __restrict__ w, Layout lay, float* __restrict__ out,
                         int64_t n_points, int n_samples, int n_freqs_pos, int n_freqs_view) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;
  const int rows = kWidth + (lay.pe_pad > lay.ve_pad ? lay.pe_pad : lay.ve_pad);
  float* buf = smem + rows * kStride;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(act, s), 1);
      mbar_init(empty_bar(act, s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised; the only block-wide barrier

  if (threadIdx.x >= kConsumerThreads) {
    // The producer warpgroup: one thread streams the weights.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerThreads) {
      produce<kStages>(w, buf, act, lay.wide_k / kStageK, lay.views_k / kStageK);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    Ring<kStages> ring{buf, act, 0, 0};
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const float* bias = w + lay.bias;

    // pe into rows [0, pe_rows), zero rows up to pe_pad; the ragged tile's
    // missing points read 0. The producer's first copies land meanwhile.
    for (int t = threadIdx.x; t < kDim * kTile; t += kConsumerThreads) {
      const int p = t / kDim, d = t % kDim;
      const int64_t point = tile0 + p;
      const float x = point < n_points ? pts[point * kDim + d] : 0.f;
      encode<kDim>(x, d, p, n_freqs_pos, 0, act);
    }
    for (int t = threadIdx.x; t < (lay.pe_pad - lay.pe_rows) * kTile; t += kConsumerThreads) {
      act[(lay.pe_rows + t / kTile) * kStride + t % kTile] = 0.f;
    }
    consumers_sync(kBarConsumers);  // pe is written

    // The trunk: layer 0 reads pe, layer kSkip + 1 reads [pe, 0, h], the rest h.
    tc_layer<kWidth / 2, true, kFlushK>(ring, act, 0, lay.pe_pad, lay.pe_pad, bias);
    for (int l = 1; l < kDepth; ++l) {
      const bool skip_in = l == kSkip + 1;
      tc_layer<kWidth / 2, true, kFlushK>(ring, act, skip_in ? 0 : lay.pe_pad,
                                          skip_in ? lay.pe_pad + kWidth : kWidth, lay.pe_pad,
                                          bias + l * kWidth);
    }

    // alpha from the trunk, before the feature head writes over it (its
    // first consumer barrier comes after these reads): thread t sums
    // products k = j, j + 4, ... (j = t % 4) of point t / 4.
    const int p = threadIdx.x >> 2, j = threadIdx.x & 3;
    const int64_t point = tile0 + p;
    {
      const float* h = act + (lay.pe_pad + j) * kStride + p;
      const float* wa = w + lay.alpha_w + j;
      float s = 0.f;
      for (int k = 0; k < kWidth; k += 4) s = fmaf(h[k * kStride], __ldg(wa + k), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // s0 + s1, s2 + s3
      s += __shfl_xor_sync(0xffffffffu, s, 2);  // (s0 + s1) + (s2 + s3)
      if (j == 0 && point < n_points) out[point * 4 + 3] = s + __ldg(bias + kBiasAlpha);
    }
    tc_layer<kWidth / 2, false, kFlushK>(ring, act, lay.pe_pad, kWidth, 0, bias + kBiasFeature);

    // ve of each point's ray into rows [kWidth, kWidth + ve_rows), zero rows
    // up to ve_pad: every consumer warp is past the feature layer's reads.
    for (int t = threadIdx.x; t < 3 * kTile; t += kConsumerThreads) {
      const int vp = t / 3, d = t % 3;
      const int64_t vpoint = tile0 + vp;
      const float x = vpoint < n_points ? viewdirs[(vpoint / n_samples) * 3 + d] : 0.f;
      encode<3>(x, d, vp, n_freqs_view, kWidth, act);
    }
    for (int t = threadIdx.x; t < (lay.ve_pad - lay.ve_rows) * kTile; t += kConsumerThreads) {
      act[(kWidth + lay.ve_rows + t / kTile) * kStride + t % kTile] = 0.f;
    }
    consumers_sync(kBarConsumers);  // ve is written

    tc_layer<kViewsWidth / 2, true, kFlushK>(ring, act, 0, lay.views_k, 0, bias + kBiasViews);

    // rgb: thread t sums products k = j, j + 4, ... (j = t % 4) of point
    // t / 4 for each of the three outputs.
    {
      const float* hv = act + j * kStride + p;
      const float* wr = w + lay.rgb_w + j * 3;  // (128, 3) row-major
      float s[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < kViewsWidth; k += 4) {
        const float x = hv[k * kStride];
#pragma unroll
        for (int c = 0; c < 3; ++c) s[c] = fmaf(x, __ldg(wr + k * 3 + c), s[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 2);
      }
      if (j == 0 && point < n_points) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[point * 4 + c] = s[c] + __ldg(bias + kBiasRgb + c);
      }
    }
  }
}

template <int kDim, int kFlushK, int kStages>
int launch(const float* pts, const float* viewdirs, const float* weights, float* out,
           long long n_points, int n_samples, int n_freqs_pos, int n_freqs_view,
           const Layout& lay, cudaStream_t stream) {
  const size_t smem = act_bytes(lay) + kStages * kStageBytes;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(fused_query_field_kernel<kDim, kFlushK, kStages>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_points + kTile - 1) / kTile;
  fused_query_field_kernel<kDim, kFlushK, kStages>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          pts, viewdirs, weights, lay, out, n_points, n_samples, n_freqs_pos, n_freqs_view);
  return static_cast<int>(cudaGetLastError());
}

// Four stages of 16 rows where they fit, flushed every 32 rows; else three,
// flushed every 16.
template <int kDim>
int launch_dim(const float* pts, const float* viewdirs, const float* weights, float* out,
               long long n_points, int n_samples, int n_freqs_pos, int n_freqs_view,
               cudaStream_t stream) {
  const Layout lay = make_layout(kDim, n_freqs_pos, n_freqs_view);
  if (ring_stages(lay) == 4) {
    return launch<kDim, 32, 4>(pts, viewdirs, weights, out, n_points, n_samples, n_freqs_pos,
                               n_freqs_view, lay, stream);
  }
  return launch<kDim, 16, 3>(pts, viewdirs, weights, out, n_points, n_samples, n_freqs_pos,
                             n_freqs_view, lay, stream);
}

}  // namespace

// The dynamic shared memory a block of the kernel takes at this point width
// and these frequency counts (bytes).
extern "C" long long scnerf_fused_query_field_smem(int point_dim, int n_freqs_pos,
                                                   int n_freqs_view) {
  return static_cast<long long>(shared_bytes(make_layout(point_dim, n_freqs_pos, n_freqs_view)));
}

// pts (n_points, point_dim) with n_points = n_rays * n_samples and point_dim
// 3 or 4, viewdirs (n_rays, 3) and out (n_points, 4): float32, contiguous, on
// the current device. weights is mlp_cuda.py:pack_weights's buffer for this
// point width and these frequency counts, 16-byte aligned. 0 <= n_freqs_pos,
// n_freqs_view <= 16. Launch on `stream`; return cudaGetLastError() (or the
// error that kept it from launching).
extern "C" int scnerf_fused_query_field(const float* pts, const float* viewdirs,
                                        const float* weights, float* out, long long n_points,
                                        int n_samples, int point_dim, int n_freqs_pos,
                                        int n_freqs_view, cudaStream_t stream) {
  if (n_points == 0) return static_cast<int>(cudaSuccess);
  if (n_freqs_pos < 0 || n_freqs_pos > kMaxFreqs || n_freqs_view < 0 ||
      n_freqs_view > kMaxFreqs || n_samples <= 0 || (point_dim != 3 && point_dim != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (point_dim == 3) {
    return launch_dim<3>(pts, viewdirs, weights, out, n_points, n_samples, n_freqs_pos,
                         n_freqs_view, stream);
  }
  return launch_dim<4>(pts, viewdirs, weights, out, n_points, n_samples, n_freqs_pos,
                       n_freqs_view, stream);
}
