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
raises, a CPU tensor takes the twin. The wrapper's host work is kept to one
pass of checks, the output's allocation and the launch through
``_build.launch``: at the resamplers' shapes it takes longer than the
kernel. Nothing calls it on a render path, as nothing calls
``searchsorted_pallas`` in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.kernels import _build
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
    fn = _build.load("searchsorted").scnerf_searchsorted
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def searchsorted_cuda(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """K4: row-wise ``searchsorted`` of ``v (B, M)`` in the sorted rows of
    ``a (B, N)`` -> ``(B, M)`` int32.

    On CUDA: launched on the current stream, not synchronised; both inputs
    contiguous, ``N <= MAX_ROW``. Rows must be sorted and free of NaN, as for
    the twin. The checks are one pass over cheap attributes: at the
    resamplers' shapes the host's work per call is what a caller waits for.
    """
    global launches
    if side != "left" and side != "right":
        raise ValueError(f"side must be one of {SIDES}, got {side!r}")
    try:
        (n_rows, n_a), (v_rows, n_v) = a.shape, v.shape
    except ValueError:
        raise ValueError(
            f"expected 2D a and v, got {tuple(a.shape)} and {tuple(v.shape)}") from None
    if n_rows != v_rows:
        raise ValueError(f"a and v need the same rows, got {n_rows} and {v_rows}")
    if a.dtype is not torch.float32 or v.dtype is not torch.float32:
        name, x = ("a", a) if a.dtype is not torch.float32 else ("v", v)
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    index = a.get_device()  # -1 off the card
    if index != v.get_device() or (index < 0 and a.device != v.device):
        raise ValueError(f"a and v lie on different devices: {a.device}, {v.device}")
    if index < 0:
        if a.device.type == "cpu":
            return searchsorted(a, v, side)
        raise ValueError(f"searchsorted_cuda runs on cpu or cuda, not {a.device}")
    if n_a > MAX_ROW:
        raise ValueError(f"the kernel takes rows of at most {MAX_ROW} floats, got {n_a}")
    if not (a.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{'a' if not a.is_contiguous() else 'v'} must be contiguous")
    out = torch.empty_like(v, dtype=torch.int32)
    if n_rows == 0 or n_v == 0:
        return out
    err = _build.launch(_entry(), index, a.data_ptr(), v.data_ptr(), out.data_ptr(), n_rows, n_a,
                        n_v, side == "right")
    if err != 0:
        raise RuntimeError(f"searchsorted kernel launch failed: CUDA error {err}")
    launches += 1
    return out
