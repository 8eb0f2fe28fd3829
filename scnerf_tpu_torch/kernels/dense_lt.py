"""A float32 dense layer written into a column block of a wider buffer, its
bias and ReLU in the matrix product's epilogue.

:func:`dense_into` computes ``x @ w + b`` (then ReLU when asked) into
``out``, an ``(M, N)`` view whose rows may be longer than ``N`` (a column
block of the buffer that the next layer reads whole). PyTorch's ``addmm``
runs cuBLASLt's BIAS / RELU_BIAS epilogue only for a contiguous output;
into a strided one it fills the bias first and adds a separate ReLU. So on
the card this calls cuBLASLt itself (``csrc/dense_lt.cu``, a plain-C
library built and launched through ``_build``), asked as PyTorch asks it:
compute type float32 (no TF32), the heuristic's first algorithm for the
operands' shapes and alignments. It is a matrix product as ``torch.addmm``
is, none of the kernels K1-K4.

The launch is the registered operator
``torch.ops.scnerf_tpu_torch.dense_into``, which mutates ``out`` and returns
nothing, so that ``torch.export`` keeps it in a serving program. The
tensor's device decides the route: a CUDA tensor goes to the operator, a CPU
tensor to the plain twin, ``torch.addmm(..., out=out)`` and an in-place
ReLU (:func:`dense_into_plain`). Only
the serve path's inference twins of the fields call it
(``fields/nerf.py:query_field_fused``, ``fields/nerfpp.py:query_mlpnet_fused``);
it has no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.kernels import _build
from scnerf_tpu_torch.kernels.pdf_cuda import OPS_NAMESPACE

# The workspace a call offers cuBLASLt's heuristic, one buffer per card,
# allocated at the first call. At the serve path's shapes the heuristic
# picks PyTorch's kernel with 0, 1 or 32 MiB (no split over K).
WORKSPACE_BYTES = 32 * 1024 * 1024
_workspaces: dict[int, torch.Tensor] = {}

_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define("dense_into(Tensor x, Tensor w, Tensor b, Tensor(a!) out, bool relu) -> ()")


@torch.library.register_fake(f"{OPS_NAMESPACE}::dense_into", lib=_LIB)
def _dense_into_fake(x, w, b, out, relu):
    return None


def _check(x, w, b, out):
    m, k = x.shape
    if w.shape[0] != k or b.shape != (w.shape[1],) or out.shape != (m, w.shape[1]):
        raise ValueError(f"dense_into: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, out {tuple(out.shape)} do not fit")


def _dense_into_cuda(x, w, b, out, relu):
    """cuBLASLt on the current stream, not synchronised: float32 operands of
    one card, ``w`` and ``b`` contiguous, ``x`` and ``out`` with unit column
    stride and rows at least as long as their width."""
    _check(x, w, b, out)
    tensors = (x, w, b, out)
    if any(t.dtype is not torch.float32 for t in tensors):
        raise TypeError("dense_into takes float32 operands")
    if any(t.device != out.device for t in tensors):
        raise ValueError("dense_into's operands lie on different devices")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("dense_into needs a contiguous weight and bias")
    m, k = x.shape
    n = w.shape[1]
    for name, t, width in (("x", x, k), ("out", out, n)):
        if t.stride(1) != 1 or t.stride(0) < width:
            raise ValueError(f"dense_into: {name} needs unit column stride and rows of at "
                             f"least {width}, got strides {t.stride()}")
    if m == 0:
        return
    index = out.get_device()
    workspace = _workspaces.get(index)
    if workspace is None:
        workspace = _workspaces[index] = torch.empty(WORKSPACE_BYTES, dtype=torch.uint8,
                                                     device=out.device)
    err = _build.launch(_entry(), index, x.data_ptr(), x.stride(0), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), out.stride(0), m, n, k, int(relu),
                        workspace.data_ptr(), WORKSPACE_BYTES)
    if err != 0:
        raise RuntimeError(f"dense_into: cuBLASLt failed with status {err}")


_LIB.impl("dense_into", _dense_into_cuda, "CUDA")


@functools.cache
def _entry():
    """``scnerf_dense_lt(x, ldx, w, b, out, ldo, m, n, k, relu, workspace,
    workspace_bytes, stream)``."""
    fn = _build.load("dense_lt").scnerf_dense_lt
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dense_into_plain(params: dict, x: torch.Tensor, out: torch.Tensor,
                     relu: bool) -> torch.Tensor:
    """The plain twin of :func:`dense_into`: ``torch.addmm`` into ``out``,
    then an in-place ReLU."""
    _check(x, params["w"], params["b"], out)
    torch.addmm(params["b"], x, params["w"], out=out)
    return out.relu_() if relu else out


def dense_into(params: dict, x: torch.Tensor, out: torch.Tensor, relu: bool) -> torch.Tensor:
    """``out[:] = x @ w + b`` (then ReLU if ``relu``) for the dense layer
    ``params`` (``fields/mlp.py``), ``x (M, K)`` and ``out (M, N)`` views
    with unit column stride; returns ``out``. A CPU ``out`` takes
    :func:`dense_into_plain`, any other the operator."""
    if out.device.type == "cpu":
        return dense_into_plain(params, x, out, relu)
    torch.ops.scnerf_tpu_torch.dense_into(x, params["w"], params["b"], out, relu)
    return out
