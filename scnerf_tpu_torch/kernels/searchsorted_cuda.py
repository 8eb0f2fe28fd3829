"""K4: row-wise sorted search as a CUDA kernel.

:func:`searchsorted_cuda` replaces
``scnerf_tpu/kernels/searchsorted_pallas.py:searchsorted_pallas``: ``(B, N)``
sorted rows and ``(B, M)`` queries, the same ``B`` (no broadcast), give
``(B, M)`` int32 insertion indices, left (``#{a < v}``) or right
(``#{a <= v}``). Plain twin: ``sampling/searchsorted.py:searchsorted``
(``torch.searchsorted``).

The kernel is ``csrc/searchsorted.cu`` (one warp per row, the row in shared
memory, a binary search per query; its header says what bounds it). The
tensor's device decides the route: a CUDA tensor goes to the kernel or
raises, a CPU tensor takes the twin. Nothing calls it on a render path, as
nothing calls ``searchsorted_pallas`` in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.sampling.searchsorted import searchsorted

# The longest row one block's shared memory holds (224 KiB of floats).
MAX_ROW = 57344
SIDES = ("left", "right")

# Kernel launches in this process; the wrapper adds one per launch and
# nowhere else.
launches = 0


@functools.cache
def _entry():
    """``scnerf_searchsorted(a, v, out, n_rows, n_a, n_v, right, stream)``."""
    from scnerf_tpu_torch.kernels import _build

    fn = _build.load("searchsorted").scnerf_searchsorted
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, v: torch.Tensor, side: str) -> None:
    if side not in SIDES:
        raise ValueError(f"side must be one of {SIDES}, got {side!r}")
    if a.ndim != 2 or v.ndim != 2:
        raise ValueError(f"expected 2D a and v, got {tuple(a.shape)} and {tuple(v.shape)}")
    if a.shape[0] != v.shape[0]:
        raise ValueError(f"a and v need the same rows, got {a.shape[0]} and {v.shape[0]}")
    for name, x in (("a", a), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if a.device != v.device:
        raise ValueError(f"a and v lie on different devices: {a.device}, {v.device}")


def searchsorted_cuda(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """K4: row-wise ``searchsorted`` of ``v (B, M)`` in the sorted rows of
    ``a (B, N)`` -> ``(B, M)`` int32.

    On CUDA: launched on the current stream, not synchronised; both inputs
    contiguous, ``N <= MAX_ROW``. Rows must be sorted and free of NaN, as for
    the twin.
    """
    global launches
    _check(a, v, side)
    if a.device.type == "cpu":
        return searchsorted(a, v, side)
    if a.device.type != "cuda":
        raise ValueError(f"searchsorted_cuda runs on cpu or cuda, not {a.device}")
    if a.shape[1] > MAX_ROW:
        raise ValueError(f"the kernel takes rows of at most {MAX_ROW} floats, got {a.shape[1]}")
    for name, x in (("a", a), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(v.shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _entry()(a.data_ptr(), v.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
                       v.shape[1], int(side == "right"), stream)
    if err != 0:
        raise RuntimeError(f"searchsorted kernel launch failed: CUDA error {err}")
    launches += 1
    return out
