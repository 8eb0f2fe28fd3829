"""Build the CUDA kernels at first use and load them.

``csrc/<name>.cu`` is compiled by one ``nvcc`` command for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/kernels/`` at the repository root, named by a hash of the source and
the flags: a changed source builds anew, an unchanged one loads the library
already built. A missing ``nvcc`` or a failed build raises. The compiler's
report (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<name>.log``.

The library is loaded as ``ctypes.PyDLL`` (:func:`load`): its entries only
enqueue work and return, so they keep the GIL rather than release and take
it back around a call of a few microseconds. :func:`launch` is the one way
to call an entry on the current stream: K1, K2 and K3 call it from the CUDA
implementations of their registered operators (``pdf_cuda.py``,
``mlp_cuda.py``), K4 from its wrapper.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Libraries a source links besides the CUDA runtime.
LINK_FLAGS = {"dense_lt": ("-lcublasLt",)}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        candidate = Path(CUDA_HOME or "") / "bin" / "nvcc"
        if CUDA_HOME and candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def flags(name: str) -> tuple:
    """``nvcc``'s flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + LINK_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """The ctypes library of ``csrc/<name>.cu``."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.
    The compiler's report is kept as ``<name>.log``, the library is moved
    into place only when the build succeeds."""
    lib = library_path(name)
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(name: str) -> ctypes.PyDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per process."""
    return ctypes.PyDLL(str(build(name)))


# PyTorch's own accessors of the current device and of a device's current
# stream as a raw handle (absent from builds without CUDA, where nothing
# launches).
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(entry, device_index: int, *args) -> int:
    """``entry(*args, stream)``, ``stream`` the raw handle of card
    ``device_index``'s current stream, read without building a
    ``torch.cuda.Stream``; the card is made current for the call only when
    it is not already. Returns the entry's status (0 or a CUDA error)."""
    if device_index == _current_device():
        return entry(*args, _raw_stream(device_index))
    with torch.cuda.device(device_index):
        return entry(*args, _raw_stream(device_index))
