"""ctypes bindings for the native host library, built at first use with g++.

Port of ``scnerf_tpu/native/__init__.py`` with its own copy of the C++
source (``searchsorted.cpp``): a row-wise host searchsorted with the
torchsearchsorted broadcast rule, a seeded permutation, and row and pixel
gathers, for host-side data work. The library is built into
``build/native/`` at the repository root (never beside the source), named by
a hash of the source and the flags, as ``kernels/_build.py`` names the
kernels' libraries; an unchanged source loads the library already built.
Without ``g++`` (or when the build fails) every function falls back to numpy,
as the JAX package's does: the same results, but the permutation, which is
then numpy's for the seed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("searchsorted.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libscnerf_native_{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, lib)
    return True


@functools.cache
def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library once per process; None
    when it cannot be built or loaded."""
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.scnerf_searchsorted.argtypes = [f32p, i64, i64, f32p, i64, i64, i64p, ctypes.c_bool]
    lib.scnerf_permutation.argtypes = [i64, ctypes.c_uint64, i64p]
    lib.scnerf_gather_rows.argtypes = [f32p, i64, i64, i64p, i64, f32p]
    lib.scnerf_gather_pixels.argtypes = [f32p, i64, i64, i64, i64p, i64p, i64p, i64, f32p]
    return lib


def available() -> bool:
    return load() is not None


def searchsorted_host(a: np.ndarray, v: np.ndarray, side: str = "left") -> np.ndarray:
    """Row-wise host searchsorted, int64 ``(max(Ba, Bv), M)``; either input
    may have one row, broadcast over the other's."""
    a = np.ascontiguousarray(a, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    rows = max(a.shape[0], v.shape[0])
    lib = load()
    if lib is None:
        return np.stack([np.searchsorted(a[i % a.shape[0]], v[i % v.shape[0]], side=side)
                         for i in range(rows)])
    out = np.empty((rows, v.shape[1]), np.int64)
    lib.scnerf_searchsorted(a, a.shape[0], a.shape[1], v, v.shape[0], v.shape[1], out,
                            side == "left")
    return out


def permutation_host(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` from ``seed`` (Fisher-Yates on
    ``std::mt19937_64``)."""
    lib = load()
    if lib is None:
        return np.random.RandomState(seed % (2**32)).permutation(n)
    out = np.empty(n, np.int64)
    lib.scnerf_permutation(n, seed, out)
    return out


def gather_rows_host(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``data[idx]`` of a float32 matrix."""
    data = np.ascontiguousarray(data, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    lib = load()
    if lib is None:
        return data[idx]
    out = np.empty((idx.shape[0], data.shape[1]), np.float32)
    lib.scnerf_gather_rows(data, data.shape[0], data.shape[1], idx, idx.shape[0], out)
    return out


def gather_pixels_host(images: np.ndarray, img_idx, px, py) -> np.ndarray:
    """``images[img_idx, py, px]`` of float32 ``(n, H, W, C)`` images;
    ``img_idx`` broadcasts over the pixels."""
    images = np.ascontiguousarray(images, np.float32)
    img_idx = np.ascontiguousarray(np.broadcast_to(img_idx, np.shape(px)), np.int64)
    px = np.ascontiguousarray(px, np.int64)
    py = np.ascontiguousarray(py, np.int64)
    lib = load()
    if lib is None:
        return images[img_idx, py, px]
    _, H, W, C = images.shape
    out = np.empty((px.shape[0], C), np.float32)
    lib.scnerf_gather_pixels(images, H, W, C, img_idx, px, py, px.shape[0], out)
    return out
