"""K3: positional encoding and the NeRF MLP fused into one CUDA kernel.

:func:`fused_query_field` replaces
``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field``: points ``(N, S, 3)``
and view directions ``(N, 3)`` through the encodings and the whole MLP to
the raw ``(N, S, 4)`` ``[rgb, sigma]``, forward only, for the configs that
:func:`supports_config` accepts (depth 8, width 256, skip after layer 4,
viewdirs: the JAX kernel's set; the port computes in float32 only). Plain
twin: :func:`fused_query_field_plain`, which is ``fields/nerf.py:query_field``.

The kernel is ``csrc/fused_mlp.cu`` (a 64-point tile per block, activations
in shared memory, float32 FMA; its header says what bounds it). The tensor's
device decides the route: a CUDA tensor goes to the kernel or raises, a CPU
tensor takes the twin. A config the kernel does not compute raises on every
device. Like the JAX kernel, it is wired into no render or serve path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.fields.nerf import NeRFConfig, query_field

# The encodings' frequency counts the kernel's activation buffer holds.
MAX_FREQS = 16
HEADS = ("feature", "alpha", "views", "rgb")

# Kernel launches in this process; the wrapper adds one per launch and
# nowhere else.
launches = 0


@functools.cache
def _entry():
    """``scnerf_fused_query_field(pts, viewdirs, params[24], out, n_points,
    n_samples, n_freqs_pos, n_freqs_view, stream)``."""
    from scnerf_tpu_torch.kernels import _build

    fn = _build.load("fused_mlp").scnerf_fused_query_field
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def supports_config(cfg: NeRFConfig) -> bool:
    """The JAX kernel's configs: depth 8, width 256, skips (4,), viewdirs."""
    return cfg.depth == 8 and cfg.width == 256 and tuple(cfg.skips) == (4,) and cfg.use_viewdirs


def _layers(params: dict) -> list[dict]:
    return [*params["pts"], *(params[name] for name in HEADS)]


def _expected_shapes(cfg: NeRFConfig) -> list[tuple[int, int]]:
    """``(in, out)`` of each layer, in :func:`_layers`' order."""
    pe, ve, w = cfg.pos_encoding.out_dim, cfg.view_encoding.out_dim, cfg.width
    trunk = [(pe if i == 0 else w + pe if i - 1 in cfg.skips else w, w)
             for i in range(cfg.depth)]
    return trunk + [(w, w), (w, 1), (w + ve, w // 2), (w // 2, 3)]


def _check(params: dict, cfg: NeRFConfig, pts: torch.Tensor, viewdirs: torch.Tensor) -> None:
    if not supports_config(cfg):
        raise ValueError(
            "fused_query_field computes depth 8, width 256, skips (4,) with viewdirs; "
            f"got depth={cfg.depth}, width={cfg.width}, skips={tuple(cfg.skips)}, "
            f"use_viewdirs={cfg.use_viewdirs}")
    for name, f in (("multires", cfg.multires), ("multires_views", cfg.multires_views)):
        if not 0 <= f <= MAX_FREQS:
            raise ValueError(f"fused_query_field takes 0 <= {name} <= {MAX_FREQS}, got {f}")
    if pts.ndim != 3 or pts.shape[-1] != 3:
        raise ValueError(f"pts must be (N, S, 3), got {tuple(pts.shape)}")
    if viewdirs.shape != (pts.shape[0], 3):
        raise ValueError(f"viewdirs must be ({pts.shape[0]}, 3), got {tuple(viewdirs.shape)}")
    layers = _layers(params)
    for i, (layer, (k, n)) in enumerate(zip(layers, _expected_shapes(cfg))):
        if layer["w"].shape != (k, n) or layer["b"].shape != (n,):
            raise ValueError(f"layer {i}: expected w {(k, n)} and b {(n,)}, got "
                             f"{tuple(layer['w'].shape)} and {tuple(layer['b'].shape)}")
    tensors = [pts, viewdirs, *(x for layer in layers for x in (layer["w"], layer["b"]))]
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"fused_query_field takes float32 only, got {x.dtype}")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"points, view directions and weights lie on different devices: {devices}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise ValueError("fused_query_field is forward only; call it under torch.no_grad()")


def fused_query_field_plain(params: dict, cfg: NeRFConfig, pts: torch.Tensor,
                            viewdirs: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch twin, on any device: ``query_field``."""
    return query_field(params, cfg, pts, viewdirs)


def fused_query_field(params: dict, cfg: NeRFConfig, pts: torch.Tensor,
                      viewdirs: torch.Tensor) -> torch.Tensor:
    """K3: encode ``pts (N, S, 3)`` and ``viewdirs (N, 3)`` and run the MLP
    ``params`` (the JAX ``(in, out)`` layout) -> raw ``(N, S, 4)``.

    On CUDA: launched on the current stream, not synchronised; every tensor
    contiguous. The same values as the twin up to float32 summation order.
    """
    global launches
    _check(params, cfg, pts, viewdirs)
    if pts.device.type == "cpu":
        return fused_query_field_plain(params, cfg, pts, viewdirs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_query_field runs on cpu or cuda, not {pts.device}")
    weights = [x for layer in _layers(params) for x in (layer["w"], layer["b"])]
    for x in (pts, viewdirs, *weights):
        if not x.is_contiguous():
            raise ValueError("fused_query_field needs contiguous points, view directions and weights")
    n, s, _ = pts.shape
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if out.numel() == 0:
        return out
    pointers = (ctypes.c_void_p * len(weights))(*(x.data_ptr() for x in weights))
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = _entry()(pts.data_ptr(), viewdirs.data_ptr(), pointers, out.data_ptr(),
                       n * s, s, cfg.multires, cfg.multires_views, stream)
    if err != 0:
        raise RuntimeError(f"fused_query_field kernel launch failed: CUDA error {err}")
    launches += 1
    return out
