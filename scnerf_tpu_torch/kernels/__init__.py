"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

| kernel | wrapper | source | replaces |
| --- | --- | --- | --- |
| K1 inverse-CDF | ``pdf_cuda.sample_pdf_core`` | ``csrc/sample_pdf.cu`` | ``scnerf_tpu/kernels/pdf_pallas.py:sample_pdf_pallas_core`` |
| K2 inverse-CDF with counts | ``pdf_cuda.sample_pdf_fwd`` (under ``sample_pdf_diff``) | ``csrc/sample_pdf.cu`` | ``scnerf_tpu/kernels/pdf_pallas.py:_pallas_fwd`` |
"""
