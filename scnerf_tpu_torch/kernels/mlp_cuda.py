"""K3: positional encoding and the NeRF MLP fused into one CUDA kernel.

:func:`fused_query_field` replaces
``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field``: points ``(N, S, 3)``
and view directions ``(N, 3)`` through the encodings and the whole MLP to
the raw ``(N, S, 4)`` ``[rgb, sigma]``, forward only, for the configs that
:func:`supports_config` accepts (depth 8, width 256, skip after layer 4,
viewdirs: the JAX kernel's set; the port computes at float32 accuracy only).
Plain twin: :func:`fused_query_field_plain`, which is
``fields/nerf.py:query_field``.

The kernel is ``csrc/fused_mlp.cu``: a 64-point tile per block of two
warpgroups, activations in shared memory, the trunk, feature and views
products on the tensor cores (``wgmma``) in 3xTF32 (its header says what
bounds it and why 3xTF32). On each call the wrapper packs the weights for
it (:func:`pack_weights`). The tensor's device decides the route: a CUDA
tensor goes to the kernel or raises, a CPU tensor takes the twin. A config
the kernel does not compute raises on every device. Like the JAX kernel, it
is wired into no render or serve path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from scnerf_tpu_torch.fields.nerf import NeRFConfig, query_field
from scnerf_tpu_torch.kernels import _build

# The encodings' frequency counts the kernel's activation buffer holds.
MAX_FREQS = 16
HEADS = ("feature", "alpha", "views", "rgb")
# The kernel's K-slices are 32 or 16 rows deep: every tensor-core layer's K
# is padded to a multiple of 32.
K_ALIGN = 32

# Kernel launches in this process; the wrapper adds one per launch and
# nowhere else.
launches = 0


@functools.cache
def _entry():
    """``scnerf_fused_query_field(pts, viewdirs, weights, out, n_points,
    n_samples, n_freqs_pos, n_freqs_view, stream)``."""
    fn = _build.load("fused_mlp").scnerf_fused_query_field
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_memory_bytes(cfg: NeRFConfig) -> int:
    """The dynamic shared memory a block of the kernel takes for ``cfg``'s
    frequency counts, as the kernel's library computes it (builds it)."""
    fn = _build.load("fused_mlp").scnerf_fused_query_field_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return fn(cfg.multires, cfg.multires_views)


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


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` -> ``(big, small)``, both TF32 values rounded as
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero, the low 13
    of the 23 mantissa bits cleared. ``big`` is ``x`` rounded, ``small`` is
    ``x - big`` (exact in float32) rounded, so ``big + small`` is ``x`` to
    within 2^-22 of ``|x|``. Adding half a TF32 ulp to the magnitude bits
    and clearing them rounds a sign-magnitude number so, subnormals
    included. Where ``x`` is inf or NaN, ``big`` is ``x`` and ``small`` 0."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    big = torch.where(finite, (bits + 0x1000) & -0x2000, bits).view(torch.float32)
    rest = torch.where(finite, x - big, 0.0).view(torch.int32)
    return big, ((rest + 0x1000) & -0x2000).view(torch.float32)


def _pad_k(n: int) -> int:
    return -(-n // K_ALIGN) * K_ALIGN


def _tiles(halves: torch.Tensor, n: int) -> torch.Tensor:
    """``(2, K, n)`` big and small halves of the ``(in, out)`` weights of
    layers with ``n`` outputs, K rows in the kernel's order -> the kernel's B
    tiles, flat: for each k8 step kb, the big tile then the small one, each
    ``W^T`` in ``wgmma``'s K-major form without swizzle, ``W[8kb + 4h + c,
    8j + r]`` at ``((2j + h) * 8 + r) * 4 + c`` (core matrices of 8 outputs
    x 4 K)."""
    k = halves.shape[1]
    # (s, kb, h, c, j, r) -> (kb, s, j, h, r, c)
    return halves.view(2, k // 8, 2, 4, n // 8, 8).permute(1, 0, 4, 2, 5, 3).reshape(-1)


def pack_weights(params: dict, cfg: NeRFConfig) -> tuple[torch.Tensor, dict]:
    """The kernel's one weight buffer, float32, on ``params``' device, and
    its offset table (floats; ``csrc/fused_mlp.cu:make_layout`` computes the
    same):

    - ``"layers"``: the tensor-core layers (trunk 0-7, feature, views), each
      ``W^T`` (K-major), K padded to a multiple of 32 by zero rows where the
      kernel's activation rows have them (after pe in layers 0 and 5, after
      ve in views), split by :func:`split_tf32` and laid out by
      :func:`_tiles`; one contiguous stream of k8 steps;
    - ``"bias"``: the biases of trunk 0-7, feature, views, alpha, rgb;
    - ``"alpha_w"`` (256) and ``"rgb_w"`` (128 x 3, row-major), float32.

    Plain PyTorch, on every call (no cache keyed on the tensors): one
    concatenation, the split, and one permuting copy for the trunk and
    feature layers (all 256 wide) and one for views.
    """
    pe, ve, width = cfg.pos_encoding.out_dim, cfg.view_encoding.out_dim, cfg.width
    pe_pad, ve_pad = _pad_k(pe), _pad_k(ve)
    trunk = params["pts"]
    zeros = trunk[0]["w"].new_zeros(max(pe_pad - pe, ve_pad - ve) * width)
    pad_pe, pad_ve = zeros[:(pe_pad - pe) * width], zeros[:(ve_pad - ve) * width // 2]
    rows, offsets, at = [], [], 0  # (in, out) weights, flat, K rows in the kernel's order
    for i, layer in enumerate([*trunk, params["feature"], params["views"]]):
        w = layer["w"]
        if i == 0:
            parts = [w.reshape(-1), pad_pe]
        elif i - 1 in cfg.skips:
            parts = [w[:pe].reshape(-1), pad_pe, w[pe:].reshape(-1)]
        elif i == len(trunk) + 1:
            parts = [w.reshape(-1), pad_ve]
        else:
            parts = [w.reshape(-1)]
        rows += parts
        offsets.append(at)
        at += 2 * sum(p.numel() for p in parts)
    big, small = split_tf32(torch.cat(rows))
    halves = torch.stack([big, small]).view(2, -1)
    n_wide = offsets[-1] // 2  # floats of the 256-wide layers, one half
    biases = [layer["b"] for layer in trunk] + [params[h]["b"] for h in ("feature", "views",
                                                                         "alpha", "rgb")]
    tail = torch.cat([*biases, params["alpha"]["w"].reshape(-1), params["rgb"]["w"].reshape(-1)])
    packed = torch.cat([_tiles(halves[:, :n_wide].view(2, -1, width), width),
                        _tiles(halves[:, n_wide:].view(2, -1, width // 2), width // 2), tail])
    n_bias = sum(b.numel() for b in biases)
    table = {"layers": offsets, "bias": at, "alpha_w": at + n_bias,
             "rgb_w": at + n_bias + width}
    return packed, table


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

    On CUDA: the weights packed by :func:`pack_weights`, the kernel launched
    on the current stream, not synchronised; every tensor contiguous. The
    twin's values at float32 accuracy (3xTF32 products, another summation
    order).
    """
    global launches
    _check(params, cfg, pts, viewdirs)
    if pts.device.type == "cpu":
        return fused_query_field_plain(params, cfg, pts, viewdirs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_query_field runs on cpu or cuda, not {pts.device}")
    for x in (pts, viewdirs, *(t for layer in _layers(params) for t in (layer["w"], layer["b"]))):
        if not x.is_contiguous():
            raise ValueError("fused_query_field needs contiguous points, view directions and weights")
    n, s, _ = pts.shape
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if out.numel() == 0:
        return out
    weights = pack_weights(params, cfg)[0]
    err = _build.launch(_entry(), pts.get_device(), pts.data_ptr(), viewdirs.data_ptr(),
                        weights.data_ptr(), out.data_ptr(), n * s, s, cfg.multires,
                        cfg.multires_views)
    if err != 0:
        raise RuntimeError(f"fused_query_field kernel launch failed: CUDA error {err}")
    launches += 1
    return out
