"""Small imaging utilities shared by the driver and its tools.

Port of ``scnerf_tpu/core/imaging.py`` (``to8b``, ``colorize_depth`` with
matplotlib's "jet" map computed here, so no matplotlib is needed) plus a
PNG reader and writer on the standard library's ``zlib``, so that reading an
LLFF scene's ``images_N/`` and writing the driver's images need neither
``imageio`` nor PIL. They cover 8-bit gray, gray+alpha, RGB and RGBA,
non-interlaced, with all five row filters: what LLFF's downscaled PNGs and
the driver's own images use. Anything else raises and names ``imageio``;
:func:`imread` hands other files to ``imageio`` where it is installed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples only).
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


# matplotlib's "jet" (its segment data), so that the depth images need no
# matplotlib: (x, value) breakpoints per channel.
_JET = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)
_LUT_SIZE = 256


def _jet_lut() -> np.ndarray:
    """The ``(256, 3)`` lookup table matplotlib builds for "jet"."""
    xind = np.linspace(0, 1, _LUT_SIZE)
    lut = []
    for points in _JET:
        x, y = np.array(points).T
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        inner = distance * (y[ind] - y[ind - 1]) + y[ind - 1]
        lut.append(np.clip(np.concatenate([[y[0]], inner, [y[-1]]]), 0.0, 1.0))
    return np.stack(lut, -1)


def colorize_depth(depth: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Depth map -> RGB visualization (percentile-normalized like the
    reference's ``colorize``), float32 ``(..., 3)``: matplotlib's "jet" map
    (the JAX package's default, and the only one its callers use), computed
    here as matplotlib computes it."""
    d = np.asarray(depth, np.float64)
    valid = np.isfinite(d) if mask is None else (mask > 0.5) & np.isfinite(d)
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
        if hi - lo < 1e-10:
            hi = lo + 1e-10
        norm = np.clip((d - lo) / (hi - lo), 0, 1)
    else:
        norm = np.zeros_like(d)
    # matplotlib's lookup: index int(x * N), with x = 1 in the last entry;
    # NaN takes its "bad" colour, black.
    bad = np.isnan(norm)
    idx = np.minimum((np.where(bad, 0.0, norm) * _LUT_SIZE).astype(int), _LUT_SIZE - 1)
    rgb = np.where(bad[..., None], 0.0, _jet_lut()[idx])
    if mask is not None:
        rgb = np.where((mask > 0.5)[..., None], rgb, 1.0)
    return rgb.astype(np.float32)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 ``(H, W)``, ``(H, W, 1|2|3|4)`` image as an 8-bit PNG
    (filter 0 on every row)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype} (see to8b)")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"write_png: no PNG colour type for shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * channels)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a decompressed 8-bit image."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG (gray, gray+alpha, RGB or RGBA) as
    uint8 ``(H, W)`` for gray and ``(H, W, C)`` otherwise, as
    ``imageio.imread`` returns it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}; this "
            "reader takes 8-bit non-interlaced gray/RGB(A) PNGs; read others with imageio")
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * channels, channels)
    return img.reshape(h, w) if channels == 1 else img.reshape(h, w, channels)


def imread(path) -> np.ndarray:
    """An image file as uint8, as ``imageio.imread`` returns it: a PNG by
    :func:`read_png`, any other format by ``imageio`` (imported here), and
    without ``imageio`` an ``ImportError`` that names it."""
    if str(path).lower().endswith(".png"):
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs imageio, which is not installed; PNGs need nothing") from e
    return np.asarray(imageio.imread(path))
