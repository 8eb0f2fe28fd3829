"""scnerf-tpu on PyTorch and CUDA: the NeRF and NeRF++ serving paths.

A port of ``scnerf_tpu`` (JAX) that runs on an NVIDIA Hopper card. Module
paths mirror the JAX package, so ``scnerf_tpu/render/renderer.py`` has its
counterpart in ``scnerf_tpu_torch/render/renderer.py``. Public functions keep
the JAX layouts (rays ``(N, 3)``, raw field output ``(N, S, 4)``, dense
weights ``w`` as ``(in, out)``) so both packages can be fed the same arrays.

The package imports ``torch`` and never ``jax`` or ``scnerf_tpu``. Kernels
written for the card live in ``kernels/`` with their sources in ``csrc/``;
each has a plain PyTorch twin that runs for tensors on the CPU.
"""
__version__ = "0.1.0"
