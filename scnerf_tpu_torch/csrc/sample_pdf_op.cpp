// K1 and K2 (csrc/sample_pdf.cu) as registered PyTorch operators, so that a
// call from Python goes through the dispatcher to these functions with no
// Python work between the checks, the allocation and the launch:
//
//   torch.ops.scnerf_tpu_torch.sample_pdf(bins, weights, u) -> out
//   torch.ops.scnerf_tpu_torch.sample_pdf_fwd(bins, weights, u, variant,
//                                             with_cdf) -> (out, inds, cdf?)
//
// The schemas are defined in Python (kernels/pdf_cuda.py, with the fake
// implementations that torch.export traces), so this file registers only the
// CUDA implementations: a second TORCH_LIBRARY of the namespace would fail at
// load time. kernels/pdf_cuda.py sends CPU tensors to the plain twin before
// it reaches an operator. No derivative is
// registered: the wrappers refuse an input that requires grad under grad
// mode before they call an operator, and sample_pdf_diff (an autograd
// function around sample_pdf_fwd) is the differentiable route. The checks raise
// ValueError (TORCH_CHECK_VALUE) or TypeError (TORCH_CHECK_TYPE) with the
// messages the Python wrappers gave. Built with kernels/_build.py:build_ops
// and loaded with torch.ops.load_library.

#include <climits>
#include <optional>
#include <string>
#include <tuple>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

extern "C" {
int scnerf_sample_pdf(const float* bins, const float* weights, const float* u, float* out,
                      int n_rays, int n_bins, int n_samples, cudaStream_t stream);
int scnerf_sample_pdf_fwd_nerfpp(const float* bins, const float* weights, const float* u,
                                 float* out, int* inds, float* cdf, int n_rays, int n_bins,
                                 int n_samples, cudaStream_t stream);
int scnerf_sample_pdf_fwd_nerf(const float* bins, const float* weights, const float* u,
                               float* out, int* inds, float* cdf, int n_rays, int n_bins,
                               int n_samples, cudaStream_t stream);
}

namespace {

constexpr int64_t kMaxBins = 1024;

void check_inputs(const char* name, const at::Tensor& bins, const at::Tensor& weights,
                  const at::Tensor& u) {
  TORCH_CHECK_VALUE(bins.dim() == 2 && weights.dim() == 2 && u.dim() == 2,
                    "expected 2D bins, weights, u; got ", bins.sizes(), ", ", weights.sizes(),
                    ", ", u.sizes());
  const int64_t n = bins.size(0);
  const int64_t b = bins.size(1);
  TORCH_CHECK_VALUE(weights.size(0) == n && weights.size(1) == b - 1 && u.size(0) == n,
                    "shapes disagree: bins ", bins.sizes(), " needs weights (", n, ", ", b - 1,
                    ") and u (", n, ", S); got ", weights.sizes(), ", ", u.sizes());
  TORCH_CHECK_TYPE(bins.scalar_type() == at::kFloat, "bins must be float32, got ",
                   bins.scalar_type());
  TORCH_CHECK_TYPE(weights.scalar_type() == at::kFloat, "weights must be float32, got ",
                   weights.scalar_type());
  TORCH_CHECK_TYPE(u.scalar_type() == at::kFloat, "u must be float32, got ", u.scalar_type());
  TORCH_CHECK_VALUE(weights.device() == bins.device() && u.device() == bins.device(),
                    "bins, weights and u lie on different devices: ", bins.device(), ", ",
                    weights.device(), ", ", u.device());
  TORCH_CHECK_VALUE(bins.is_cuda(), name, " runs on cpu or cuda, not ", bins.device());
  TORCH_CHECK_VALUE(b >= 2 && b <= kMaxBins, "the kernel takes 2 <= B <= ", kMaxBins,
                    " bins, got ", b);
  TORCH_CHECK_VALUE(bins.is_contiguous(), "bins must be contiguous");
  TORCH_CHECK_VALUE(weights.is_contiguous(), "weights must be contiguous");
  TORCH_CHECK_VALUE(u.is_contiguous(), "u must be contiguous");
  TORCH_CHECK_VALUE(n <= INT_MAX / 2 && u.size(1) <= INT_MAX,
                    "the kernel takes fewer than 2^30 rays and 2^31 samples, got ", n, " and ",
                    u.size(1));
}

// The entries return cudaGetLastError() after their launch: the check of
// C10_CUDA_KERNEL_LAUNCH_CHECK, on the status the launch left.
void check_launch(int status) { C10_CUDA_CHECK(static_cast<cudaError_t>(status)); }

at::Tensor sample_pdf_cuda(const at::Tensor& bins, const at::Tensor& weights,
                           const at::Tensor& u) {
  check_inputs("sample_pdf_core", bins, weights, u);
  const c10::cuda::OptionalCUDAGuard guard(bins.device());
  at::Tensor out = at::empty(u.sizes(), u.options());
  check_launch(scnerf_sample_pdf(
      bins.data_ptr<float>(), weights.data_ptr<float>(), u.data_ptr<float>(),
      out.data_ptr<float>(), static_cast<int>(bins.size(0)), static_cast<int>(bins.size(1)),
      static_cast<int>(u.size(1)), c10::cuda::getCurrentCUDAStream(bins.get_device()).stream()));
  return out;
}

std::tuple<at::Tensor, at::Tensor, std::optional<at::Tensor>> sample_pdf_fwd_cuda(
    const at::Tensor& bins, const at::Tensor& weights, const at::Tensor& u,
    const std::string& variant, bool with_cdf) {
  const bool nerfpp = variant == "nerfpp";
  TORCH_CHECK_VALUE(nerfpp || variant == "nerf",
                    "variant must be one of ('nerf', 'nerfpp'), got '", variant, "'");
  check_inputs("sample_pdf_fwd", bins, weights, u);
  const c10::cuda::OptionalCUDAGuard guard(bins.device());
  at::Tensor out = at::empty(u.sizes(), u.options());
  at::Tensor inds = at::empty(u.sizes(), u.options().dtype(at::kInt));
  std::optional<at::Tensor> cdf;
  if (with_cdf) cdf = at::empty(bins.sizes(), bins.options());
  const auto entry = nerfpp ? scnerf_sample_pdf_fwd_nerfpp : scnerf_sample_pdf_fwd_nerf;
  check_launch(entry(bins.data_ptr<float>(), weights.data_ptr<float>(), u.data_ptr<float>(),
                     out.data_ptr<float>(), inds.data_ptr<int>(),
                     with_cdf ? cdf->data_ptr<float>() : nullptr,
                     static_cast<int>(bins.size(0)), static_cast<int>(bins.size(1)),
                     static_cast<int>(u.size(1)),
                     c10::cuda::getCurrentCUDAStream(bins.get_device()).stream()));
  return {out, inds, cdf};
}

}  // namespace

TORCH_LIBRARY_IMPL(scnerf_tpu_torch, CUDA, m) {
  m.impl("sample_pdf", &sample_pdf_cuda);
  m.impl("sample_pdf_fwd", &sample_pdf_fwd_cuda);
}
