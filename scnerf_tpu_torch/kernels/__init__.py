"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

Each source is built one way, by ``_build.build`` into a library with a plain
C interface, and launched one way, by ``_build.launch`` through ctypes.

| kernel | wrapper | source | host route | replaces |
| --- | --- | --- | --- | --- |
| K1 inverse-CDF | ``pdf_cuda.sample_pdf_core`` | ``csrc/sample_pdf.cu`` | registered operator ``torch.ops.scnerf_tpu_torch.sample_pdf`` (defined in ``pdf_cuda.py``), whose CUDA implementation launches through ctypes (``_build.launch``) | ``scnerf_tpu/kernels/pdf_pallas.py:sample_pdf_pallas_core`` |
| K2 inverse-CDF with counts | ``pdf_cuda.sample_pdf_fwd`` (under ``sample_pdf_diff``) | ``csrc/sample_pdf.cu`` | registered operator ``torch.ops.scnerf_tpu_torch.sample_pdf_fwd``, as K1's | ``scnerf_tpu/kernels/pdf_pallas.py:_pallas_fwd`` |
| K3 encoding + NeRF MLP | ``mlp_cuda.fused_query_field`` (the NeRF serve function's fine field) | ``csrc/fused_mlp.cu`` | registered operator ``torch.ops.scnerf_tpu_torch.fused_query_field`` (defined in ``mlp_cuda.py``), as K1's | ``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field`` |
| K4 row-wise searchsorted | ``searchsorted_cuda.searchsorted_cuda`` | ``csrc/searchsorted.cu`` | ctypes (``_build.launch``) from the wrapper | ``scnerf_tpu/kernels/searchsorted_pallas.py:searchsorted_pallas`` |

Beside them, and none of them: ``dense_lt.dense_into`` (``csrc/dense_lt.cu``,
registered operator ``torch.ops.scnerf_tpu_torch.dense_into`` over ctypes) is
a float32 dense layer through cuBLASLt, its bias and ReLU in the product's
epilogue, written into a column block of a wider buffer; the serve path's
early fields (``fields/nerf.py:query_field_fused``,
``fields/nerfpp.py:query_mlpnet_fused``) write their skip and view-branch
inputs with it.
"""
