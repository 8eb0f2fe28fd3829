// One float32 dense layer through cuBLASLt: out = x @ w + b, with ReLU when
// asked, the bias and the ReLU in the product's epilogue, and the output
// written at any leading dimension (a column block of a wider buffer).
//
// This is no kernel of the port: it is the matrix product that PyTorch's
// addmm runs (cuBLASLt's BIAS / RELU_BIAS epilogues), asked the way
// PyTorch's gemm_and_bias asks it, because PyTorch takes that route only
// for a contiguous output. The descriptors and the heuristic's algorithm
// are kept per shape, leading dimensions, epilogue and operand alignments,
// so that a call costs one attribute write and the matmul.
//
// Row-major x (m, k) at leading dimension ldx, w (k, n) contiguous, b (n),
// out (m, n) at leading dimension ldo are, in cuBLASLt's column-major
// terms, out^T (n x m) = w^T (n x k) . x^T (k x m) with the bias along the
// n rows: compute type CUBLAS_COMPUTE_32F (no TF32), scale type float32.
#include <cublasLt.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

struct Plan {
  long long m;
  int n, k, ldx, ldo, relu;
  unsigned align_w, align_x, align_o, align_b;
  size_t workspace;
  cublasLtMatmulDesc_t op;
  cublasLtMatrixLayout_t w_layout, x_layout, o_layout;
  cublasLtMatmulAlgo_t algo;
};

constexpr int kMaxPlans = 64;
cublasLtHandle_t handle = nullptr;
Plan plans[kMaxPlans];
int n_plans = 0;

// The largest power of two up to 256 that divides the address, as PyTorch
// computes an operand's alignment for the heuristic.
unsigned alignment(const void* p) {
  uintptr_t address = reinterpret_cast<uintptr_t>(p);
  unsigned a = 256;
  while (address % a) a /= 2;
  return a;
}

void destroy(Plan& p) {
  if (p.o_layout) cublasLtMatrixLayoutDestroy(p.o_layout);
  if (p.x_layout) cublasLtMatrixLayoutDestroy(p.x_layout);
  if (p.w_layout) cublasLtMatrixLayoutDestroy(p.w_layout);
  if (p.op) cublasLtMatmulDescDestroy(p.op);
}

int make_plan(Plan& p) {
  p.op = nullptr;
  p.w_layout = p.x_layout = p.o_layout = nullptr;
  cublasStatus_t s = cublasLtMatmulDescCreate(&p.op, CUBLAS_COMPUTE_32F, CUDA_R_32F);
  if (s != CUBLAS_STATUS_SUCCESS) return s;
  cublasOperation_t no = CUBLAS_OP_N;
  cublasLtEpilogue_t epilogue = p.relu ? CUBLASLT_EPILOGUE_RELU_BIAS : CUBLASLT_EPILOGUE_BIAS;
  if ((s = cublasLtMatmulDescSetAttribute(p.op, CUBLASLT_MATMUL_DESC_TRANSA, &no, sizeof(no))) ||
      (s = cublasLtMatmulDescSetAttribute(p.op, CUBLASLT_MATMUL_DESC_TRANSB, &no, sizeof(no))) ||
      (s = cublasLtMatmulDescSetAttribute(p.op, CUBLASLT_MATMUL_DESC_EPILOGUE, &epilogue,
                                          sizeof(epilogue))) ||
      (s = cublasLtMatrixLayoutCreate(&p.w_layout, CUDA_R_32F, p.n, p.k, p.n)) ||
      (s = cublasLtMatrixLayoutCreate(&p.x_layout, CUDA_R_32F, p.k, p.m, p.ldx)) ||
      (s = cublasLtMatrixLayoutCreate(&p.o_layout, CUDA_R_32F, p.n, p.m, p.ldo)))
    return s;
  cublasLtMatmulPreference_t pref;
  if ((s = cublasLtMatmulPreferenceCreate(&pref))) return s;
  const struct { cublasLtMatmulPreferenceAttributes_t attr; unsigned value; } aligns[] = {
      {CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_A_BYTES, p.align_w},
      {CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_B_BYTES, p.align_x},
      {CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_C_BYTES, p.align_o},
      {CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_D_BYTES, p.align_b},
  };
  s = cublasLtMatmulPreferenceSetAttribute(pref, CUBLASLT_MATMUL_PREF_MAX_WORKSPACE_BYTES,
                                           &p.workspace, sizeof(p.workspace));
  for (const auto& a : aligns) {
    if (s) break;
    uint32_t v = a.value;
    s = cublasLtMatmulPreferenceSetAttribute(pref, a.attr, &v, sizeof(v));
  }
  cublasLtMatmulHeuristicResult_t result = {};
  int found = 0;
  if (!s)
    s = cublasLtMatmulAlgoGetHeuristic(handle, p.op, p.w_layout, p.x_layout, p.o_layout,
                                       p.o_layout, pref, 1, &result, &found);
  cublasLtMatmulPreferenceDestroy(pref);
  if (s) return s;
  if (found == 0) return CUBLAS_STATUS_NOT_SUPPORTED;
  p.algo = result.algo;
  return CUBLAS_STATUS_SUCCESS;
}

}  // namespace

// Returns 0 or a cublasStatus_t. Not thread-safe: the caller holds the GIL.
extern "C" int scnerf_dense_lt(const float* x, int ldx, const float* w, const float* b,
                               float* out, int ldo, long long m, int n, int k, int relu,
                               void* workspace, size_t workspace_bytes, cudaStream_t stream) {
  if (handle == nullptr) {
    cublasStatus_t s = cublasLtCreate(&handle);
    if (s) return s;
  }
  Plan key = {};
  key.m = m; key.n = n; key.k = k; key.ldx = ldx; key.ldo = ldo; key.relu = relu != 0;
  key.align_w = alignment(w); key.align_x = alignment(x);
  key.align_o = alignment(out); key.align_b = alignment(b);
  key.workspace = workspace_bytes;
  Plan* plan = nullptr;
  for (int i = 0; i < n_plans && plan == nullptr; ++i) {
    const Plan& p = plans[i];
    if (p.m == key.m && p.n == key.n && p.k == key.k && p.ldx == key.ldx && p.ldo == key.ldo &&
        p.relu == key.relu && p.align_w == key.align_w && p.align_x == key.align_x &&
        p.align_o == key.align_o && p.align_b == key.align_b && p.workspace == key.workspace)
      plan = &plans[i];
  }
  bool kept = true;
  if (plan == nullptr) {
    int s = make_plan(key);
    if (s) {
      destroy(key);
      return s;
    }
    kept = n_plans < kMaxPlans;
    if (kept) {
      plans[n_plans] = key;
      plan = &plans[n_plans++];
    } else {
      plan = &key;
    }
  }
  const float one = 1.0f, zero = 0.0f;
  cublasStatus_t s = cublasLtMatmulDescSetAttribute(plan->op, CUBLASLT_MATMUL_DESC_BIAS_POINTER,
                                                    &b, sizeof(b));
  if (!s)
    s = cublasLtMatmul(handle, plan->op, &one, w, plan->w_layout, x, plan->x_layout, &zero, out,
                       plan->o_layout, out, plan->o_layout, &plan->algo, workspace,
                       workspace_bytes, stream);
  if (!kept) destroy(key);
  return s;
}
