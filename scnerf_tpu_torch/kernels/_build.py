"""Build the CUDA kernels at first use and load them.

Two routes, both under ``build/kernels/`` at the repository root, each
library named by a hash of its sources and flags: a changed source builds
anew, an unchanged one loads the library already built. A missing ``nvcc``
or a failed build raises.

- ctypes (K3, K4): ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
  (``sm_90a``) into a shared library with a plain C interface, loaded as
  ``ctypes.PyDLL`` (:func:`load`): its entries only enqueue work and return,
  so they keep the GIL rather than release and take it back around a call of
  a few microseconds. :func:`launch` is the wrappers' one way to call an
  entry on the current stream.
- registered operators (K1, K2): ``csrc/<name>.cu`` and ``csrc/<name>_op.cpp``,
  which defines ``torch.ops.scnerf_tpu_torch.*`` against PyTorch's headers,
  are compiled by one ``nvcc`` command (the ``.cpp`` by the host compiler,
  with torch's C++ ABI flag) and linked against torch's libraries
  (:func:`ops_build_command`), then loaded with ``torch.ops.load_library``
  (:func:`load_ops`). The library's name also hashes ``torch.__version__``.

The compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside each library as ``<name>.log`` (``<name>_op.log``).
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
TORCH_LIBRARIES = ("-ltorch", "-ltorch_cpu", "-ltorch_cuda", "-lc10", "-lc10_cuda")


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


def library_path(name: str) -> Path:
    """The ctypes library of ``csrc/<name>.cu``."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(cmd: list[str], tmp: Path, lib: Path, what: str) -> Path:
    """Run the build command ``cmd`` that writes ``tmp``; keep its report as
    ``<what>.log``, move ``tmp`` to ``lib``, or raise."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{what}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {what}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    return _compile(cmd, tmp, lib, name)


@functools.cache
def load(name: str) -> ctypes.PyDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per process."""
    return ctypes.PyDLL(str(build(name)))


def _cxx11_abi() -> int:
    """The C++ ABI torch was built with; the operators' library must match."""
    return int(torch._C._GLIBCXX_USE_CXX11_ABI)


def ops_library_path(name: str) -> Path:
    """The operator library of ``csrc/<name>.cu`` and ``csrc/<name>_op.cpp``:
    named by both sources, the flags and the torch it is built against."""
    sources = [(CSRC_DIR / f"{name}{suffix}").read_bytes() for suffix in (".cu", "_op.cpp")]
    key = " ".join((*NVCC_FLAGS, *TORCH_LIBRARIES, f"abi={_cxx11_abi()}", torch.__version__))
    digest = hashlib.sha256(b"\0".join([*sources, key.encode()])).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_op_{digest}.so"


def ops_build_command(name: str, out: Path) -> list[str]:
    """One ``nvcc`` command that compiles ``csrc/<name>.cu`` for ``sm_90a``
    and ``csrc/<name>_op.cpp`` with the host compiler against torch's and
    CUDA's headers, and links both into ``out`` against torch's libraries
    (found again at load time by an rpath)."""
    from torch.utils import cpp_extension

    nvcc = find_nvcc()
    includes = [*cpp_extension.include_paths(), str(Path(nvcc).resolve().parents[1] / "include")]
    lib_dirs = cpp_extension.library_paths()
    return [nvcc, *NVCC_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={_cxx11_abi()}",
            *(f"-I{d}" for d in includes), "-o", str(out),
            str(CSRC_DIR / f"{name}.cu"), str(CSRC_DIR / f"{name}_op.cpp"),
            *(f"-L{d}" for d in lib_dirs),
            *(flag for d in lib_dirs for flag in ("-Xlinker", f"-rpath,{d}")), *TORCH_LIBRARIES]


def build_ops(name: str) -> Path:
    """Build the operator library of ``name`` unless it exists; return its path."""
    lib = ops_library_path(name)
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    return _compile(ops_build_command(name, tmp), tmp, lib, f"{name}_op")


@functools.cache
def load_ops(name: str) -> Path:
    """Build (if needed) and load the operator library of ``name`` into
    ``torch.ops``, once per process; return its path."""
    lib = build_ops(name)
    torch.ops.load_library(str(lib))
    return lib


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
