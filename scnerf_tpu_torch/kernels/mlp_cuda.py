"""K3: positional encoding and the NeRF MLP fused into one CUDA kernel.

:func:`fused_query_field` replaces
``scnerf_tpu/kernels/mlp_pallas.py:fused_query_field``: points ``(N, S, 3)``
or ``(N, S, 4)`` and view directions ``(N, 3)`` through the encodings and
the whole MLP to the raw ``(N, S, 4)`` ``[rgb, sigma]``, forward only, for
the configs that :func:`supports_config` accepts (depth 8, width 256, skip
after layer 4, viewdirs: the JAX kernel's set; the port computes at float32
accuracy only). Plain twin: :func:`fused_query_field_plain`, which is
``fields/nerf.py:query_field`` on 3-D points.

The MLP is NeRF's (``fields/nerf.py``) or a NeRF++ MLPNet
(``fields/nerfpp.py``), which is the same network under other leaf names
(:data:`MLPNET_NAMES`): its fg net takes 3-D points, its bg net the 4-D
inverted-sphere points. The kernel returns the MLPNet's raw heads too; its
caller applies ``abs`` to sigma and a sigmoid to rgb. The point width is a
template parameter of the kernel, read from ``pts.shape[-1]``.

The kernel is ``csrc/fused_mlp.cu``: a 64-point tile per block, activations
in shared memory, the trunk, feature and views products on the tensor cores
(``wgmma``) in 3xTF32 by two consumer warpgroups that take turns, the
weights streamed through a shared-memory ring by a producer warpgroup's
TMA bulk copies (its header says what bounds it, why 3xTF32 and how the
ring is paced). It reads the weights as one buffer that
:func:`pack_weights` lays out; a caller that serves one model many times
packs once (:class:`PackedWeights`) and passes the buffer as ``packed=``.
The launch is the registered operator
``torch.ops.scnerf_tpu_torch.fused_query_field``, defined here at import
with a fake (shape-only) implementation so that ``torch.export`` keeps it
in a program; its CUDA implementation launches the plain-C library on the
current stream through ctypes (``_build.launch``). The tensor's device
decides the route: a CUDA tensor goes to the kernel or raises, a CPU tensor
takes the twin. A config the kernel does not compute raises on every device.
``serve.py:nerf_field_query`` routes the NeRF serve function's fine field
through it where :func:`serves` holds, and ``serve.py:nerfpp_field_query``
the last cascade level's fg and bg MLPNets of the NeRF++ serve function.

The module imports none of the model code (``fields``), so that a loaded
serving artifact that calls the operator needs only torch and this file.
"""
from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from scnerf_tpu_torch.kernels import _build
from scnerf_tpu_torch.kernels.pdf_cuda import OPS_NAMESPACE

if TYPE_CHECKING:
    from scnerf_tpu_torch.fields.nerf import NeRFConfig

# The encodings' frequency counts the kernel's activation buffer holds.
MAX_FREQS = 16
# The point widths the kernel is built for: NeRF's and NeRF++'s fg points,
# NeRF++'s inverted-sphere bg points.
POINT_DIMS = (3, 4)
HEADS = ("feature", "alpha", "views", "rgb")
# A NeRF++ MLPNet's leaves under the NeRF MLP's names.
MLPNET_NAMES = {"pts": "base", "feature": "remap", "alpha": "sigma", "views": "rgb0",
                "rgb": "rgb1"}
# The kernel's K-slices are 32 or 16 rows deep: every tensor-core layer's K
# is padded to a multiple of 32.
K_ALIGN = 32
# The one MLP the kernel computes (:func:`supports_config`).
DEPTH, WIDTH, SKIPS = 8, 256, (4,)

# Kernel launches in this process; the operator's CUDA implementation adds
# one per launch and nowhere else, so launches inside a loaded serving
# artifact count too.
launches = 0

# The operator's schema, in the namespace whose "DEF" ``pdf_cuda.py`` holds
# (a second "DEF" of it would fail).
_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define("fused_query_field(Tensor pts, Tensor viewdirs, Tensor packed, int multires, "
            "int multires_views) -> Tensor")


@torch.library.register_fake(f"{OPS_NAMESPACE}::fused_query_field", lib=_LIB)
def _fused_query_field_fake(pts, viewdirs, packed, multires, multires_views):
    return pts.new_empty((pts.shape[0], pts.shape[1], 4), dtype=torch.float32)


def _fused_query_field_cuda(pts, viewdirs, packed, multires, multires_views):
    """The operator on the card: the kernel launched on the current stream,
    not synchronised, on contiguous float32 operands of one device, checked
    here (every route, a loaded artifact's included, passes through)."""
    global launches
    _check_operands(pts, viewdirs, multires, multires_views, packed)
    if not all(x.is_contiguous() for x in (pts, viewdirs, packed)):
        raise ValueError("fused_query_field needs contiguous points, view directions and weights")
    n, s, point_dim = pts.shape
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if out.numel() == 0:
        return out
    err = _build.launch(_entry(), pts.get_device(), pts.data_ptr(), viewdirs.data_ptr(),
                        packed.data_ptr(), out.data_ptr(), n * s, s, point_dim, multires,
                        multires_views)
    if err != 0:
        raise RuntimeError(f"fused_query_field kernel launch failed: CUDA error {err}")
    launches += 1
    return out


_LIB.impl("fused_query_field", _fused_query_field_cuda, "CUDA")


@functools.cache
def _entry():
    """``scnerf_fused_query_field(pts, viewdirs, weights, out, n_points,
    n_samples, point_dim, n_freqs_pos, n_freqs_view, stream)``."""
    fn = _build.load("fused_mlp").scnerf_fused_query_field
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_memory_bytes(cfg: NeRFConfig, point_dim: int = 3) -> int:
    """The dynamic shared memory a block of the kernel takes for points
    ``point_dim`` wide and ``cfg``'s frequency counts, as the kernel's
    library computes it (builds it)."""
    fn = _build.load("fused_mlp").scnerf_fused_query_field_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(point_dim, cfg.multires, cfg.multires_views)


def supports_config(cfg: NeRFConfig) -> bool:
    """The JAX kernel's configs: depth 8, width 256, skips (4,), viewdirs."""
    return (cfg.depth == DEPTH and cfg.width == WIDTH and tuple(cfg.skips) == SKIPS
            and cfg.use_viewdirs)


def serves(cfg: NeRFConfig, device: torch.device, dtype: torch.dtype) -> bool:
    """Whether K3 computes the field of ``cfg`` for weights of ``dtype`` on
    ``device``: a CUDA device, float32, a supported config and frequency
    counts the kernel holds."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and supports_config(cfg) and 0 <= cfg.multires <= MAX_FREQS
            and 0 <= cfg.multires_views <= MAX_FREQS)


def nerf_names(params: dict) -> dict:
    """An MLP's layers under the NeRF MLP's names: ``params`` itself, or a
    NeRF++ MLPNet's layers renamed by :data:`MLPNET_NAMES` (the same
    objects, nothing copied)."""
    if "base" not in params:
        return params
    return {ours: params[theirs] for ours, theirs in MLPNET_NAMES.items()}


def _layers(params: dict) -> list[dict]:
    params = nerf_names(params)
    return [*params["pts"], *(params[name] for name in HEADS)]


def _encoded(n_freqs: int, dim: int = 3) -> int:
    """An encoding's width: the raw ``dim`` coordinates and a sin and a cos
    of each per frequency (``fields/encoding.py``, ``include_input``)."""
    return dim * (1 + 2 * n_freqs)


def _expected_shapes(multires: int, multires_views: int,
                     point_dim: int = 3) -> list[tuple[int, int]]:
    """``(in, out)`` of each layer of the MLP the kernel computes for points
    ``point_dim`` wide, in :func:`_layers`' order."""
    pe, ve, w = _encoded(multires, point_dim), _encoded(multires_views), WIDTH
    trunk = [(pe if i == 0 else w + pe if i - 1 in SKIPS else w, w) for i in range(DEPTH)]
    return trunk + [(w, w), (w, 1), (w + ve, w // 2), (w // 2, 3)]


def layout(multires: int, multires_views: int, point_dim: int = 3) -> dict:
    """:func:`pack_weights`' buffer at these frequency counts and point
    width, in floats, as ``csrc/fused_mlp.cu:make_layout`` lays it out:
    ``"layers"``, the offset of each tensor-core layer (trunk 0-7, feature,
    views; big and small halves, K padded to :data:`K_ALIGN`), then
    ``"bias"``, ``"alpha_w"``, ``"rgb_w"`` and the buffer's ``"length"``."""
    pe, ve = _encoded(multires, point_dim), _encoded(multires_views)
    shapes = _expected_shapes(multires, multires_views, point_dim)
    offsets, at = [], 0
    for i, (k, n) in enumerate([*shapes[:DEPTH + 1], shapes[DEPTH + 2]]):
        pad = (_pad_k(ve) - ve if i == DEPTH + 1
               else _pad_k(pe) - pe if i == 0 or i - 1 in SKIPS else 0)
        offsets.append(at)
        at += 2 * (k + pad) * n
    (alpha_k, alpha_n), (rgb_k, rgb_n) = shapes[DEPTH + 1], shapes[DEPTH + 3]
    bias = at + sum(n for _, n in shapes)
    return {"layers": offsets, "bias": at, "alpha_w": bias, "rgb_w": bias + alpha_k * alpha_n,
            "length": bias + alpha_k * alpha_n + rgb_k * rgb_n}


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


def pack_weights(params: dict, cfg: NeRFConfig, point_dim: int = 3
                 ) -> tuple[torch.Tensor, dict]:
    """The kernel's one weight buffer for the MLP ``params`` (NeRF's, or a
    NeRF++ MLPNet's through :func:`nerf_names`) on points ``point_dim``
    wide, float32, on ``params``' device, and its offset table (floats;
    ``csrc/fused_mlp.cu:make_layout`` computes the same):

    - ``"layers"``: the tensor-core layers (trunk 0-7, feature, views), each
      ``W^T`` (K-major), K padded to a multiple of 32 by zero rows where the
      kernel's activation rows have them (after pe in layers 0 and 5, after
      ve in views), split by :func:`split_tf32` and laid out by
      :func:`_tiles`; one contiguous stream of k8 steps;
    - ``"bias"``: the biases of trunk 0-7, feature, views, alpha, rgb;
    - ``"alpha_w"`` (256) and ``"rgb_w"`` (128 x 3, row-major), float32;
    - ``"length"``, the buffer's (:func:`layout`).

    Plain PyTorch: one concatenation, the split, and one permuting copy for
    the trunk and feature layers (all 256 wide) and one for views. No cache
    here: :func:`fused_query_field` packs on each call that is not given
    ``packed=``, and :class:`PackedWeights` keeps a buffer across calls.
    """
    params = nerf_names(params)
    pe, ve, width = _encoded(cfg.multires, point_dim), cfg.view_encoding.out_dim, cfg.width
    pe_pad, ve_pad = _pad_k(pe), _pad_k(ve)
    table = layout(cfg.multires, cfg.multires_views, point_dim)
    trunk = params["pts"]
    zeros = trunk[0]["w"].new_zeros(max(pe_pad - pe, ve_pad - ve) * width)
    pad_pe, pad_ve = zeros[:(pe_pad - pe) * width], zeros[:(ve_pad - ve) * width // 2]
    rows = []  # (in, out) weights, flat, K rows in the kernel's order
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
    big, small = split_tf32(torch.cat(rows))
    halves = torch.stack([big, small]).view(2, -1)
    n_wide = table["layers"][-1] // 2  # floats of the 256-wide layers, one half
    biases = [layer["b"] for layer in trunk] + [params[h]["b"] for h in ("feature", "views",
                                                                         "alpha", "rgb")]
    tail = torch.cat([*biases, params["alpha"]["w"].reshape(-1), params["rgb"]["w"].reshape(-1)])
    packed = torch.cat([_tiles(halves[:, :n_wide].view(2, -1, width), width),
                        _tiles(halves[:, n_wide:].view(2, -1, width // 2), width // 2), tail])
    return packed, table


def _check_operands(pts: torch.Tensor, viewdirs: torch.Tensor, multires: int,
                    multires_views: int, weights: torch.Tensor | list[torch.Tensor]) -> None:
    """Raise on operands the kernel does not take: frequency counts past
    :data:`MAX_FREQS`, points not ``(N, S, 3)`` or ``(N, S, 4)``, view
    directions not ``(N, 3)``, a buffer ``weights`` not of :func:`layout`'s
    length for the points' width, or
    points, view directions and ``weights`` (the buffer, or a list of the
    unpacked leaves) not all float32 on one device."""
    for name, f in (("multires", multires), ("multires_views", multires_views)):
        if not 0 <= f <= MAX_FREQS:
            raise ValueError(f"fused_query_field takes 0 <= {name} <= {MAX_FREQS}, got {f}")
    if pts.ndim != 3 or pts.shape[-1] not in POINT_DIMS:
        raise ValueError(f"pts must be (N, S, 3) or (N, S, 4), got {tuple(pts.shape)}")
    if viewdirs.shape != (pts.shape[0], 3):
        raise ValueError(f"viewdirs must be ({pts.shape[0]}, 3), got {tuple(viewdirs.shape)}")
    if isinstance(weights, torch.Tensor):
        want = layout(multires, multires_views, pts.shape[-1])["length"]
        if weights.shape != (want,):
            raise ValueError(f"packed must be pack_weights' ({want},) buffer for multires "
                             f"{multires}, multires_views {multires_views} and points "
                             f"{pts.shape[-1]} wide, got {tuple(weights.shape)}")
        weights = [weights]
    tensors = [pts, viewdirs, *weights]
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"fused_query_field takes float32 only, got {x.dtype}")
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"points, view directions and weights lie on different devices: {devices}")


def fused_query_field_plain(params: dict, cfg: NeRFConfig, pts: torch.Tensor,
                            viewdirs: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch twin, on any device: ``query_field``'s operations
    on points of either width, the MLP under :func:`nerf_names`."""
    from scnerf_tpu_torch.fields.encoding import EncodingConfig, positional_encoding
    from scnerf_tpu_torch.fields.nerf import nerf_mlp_apply

    pts_enc = positional_encoding(pts, EncodingConfig(input_dim=pts.shape[-1],
                                                      n_freqs=cfg.multires))
    vd = viewdirs[..., None, :].expand(*pts.shape[:-1], viewdirs.shape[-1])
    return nerf_mlp_apply(nerf_names(params), cfg, pts_enc,
                          positional_encoding(vd, cfg.view_encoding))


def fused_query_field(params: dict | None, cfg: NeRFConfig, pts: torch.Tensor,
                      viewdirs: torch.Tensor, *, packed: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """K3: encode ``pts (N, S, 3)`` or ``(N, S, 4)`` and ``viewdirs (N, 3)``
    and run the MLP ``params`` (the JAX ``(in, out)`` layout; NeRF's, or a
    NeRF++ MLPNet's) -> raw ``(N, S, 4)``.

    On CUDA: ``torch.ops.scnerf_tpu_torch.fused_query_field`` on the
    weights packed by :func:`pack_weights`, launched on the current stream,
    not synchronised; every tensor contiguous (the operator checks its
    operands). The twin's values at float32
    accuracy (3xTF32 products, another summation order). ``packed``, where
    given, is that buffer, packed by the caller: the call then skips
    :func:`pack_weights` and checks the buffer's length for the points'
    width (its contents are the caller's); the CPU route still reads
    ``params``.
    """
    if not supports_config(cfg):
        raise ValueError(
            "fused_query_field computes depth 8, width 256, skips (4,) with viewdirs; "
            f"got depth={cfg.depth}, width={cfg.width}, skips={tuple(cfg.skips)}, "
            f"use_viewdirs={cfg.use_viewdirs}")
    point_dim = pts.shape[-1]
    if packed is None:
        layers = _layers(params)
        shapes = _expected_shapes(cfg.multires, cfg.multires_views, point_dim)
        for i, (layer, (k, n)) in enumerate(zip(layers, shapes)):
            if layer["w"].shape != (k, n) or layer["b"].shape != (n,):
                raise ValueError(f"layer {i}: expected w {(k, n)} and b {(n,)}, got "
                                 f"{tuple(layer['w'].shape)} and {tuple(layer['b'].shape)}")
        weights = [x for layer in layers for x in (layer["w"], layer["b"])]
    else:
        weights = [packed]
    if torch.is_grad_enabled() and any(x.requires_grad for x in (pts, viewdirs, *weights)):
        raise ValueError("fused_query_field is forward only; call it under torch.no_grad()")
    if pts.device.type == "cpu" or packed is None:
        # What does not reach the operator, which checks its own operands:
        # the CPU route's, and the leaves before they are packed.
        _check_operands(pts, viewdirs, cfg.multires, cfg.multires_views,
                        weights if packed is None else packed)
    if pts.device.type == "cpu":
        return fused_query_field_plain(params, cfg, pts, viewdirs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_query_field runs on cpu or cuda, not {pts.device}")
    if packed is None:
        if not all(x.is_contiguous() for x in weights):
            raise ValueError("fused_query_field needs contiguous points, view directions and "
                             "weights")
        packed = pack_weights(params, cfg, point_dim)[0]
    return torch.ops.scnerf_tpu_torch.fused_query_field(pts, viewdirs, packed, cfg.multires,
                                                         cfg.multires_views)


class PackedWeights:
    """:func:`pack_weights`' buffer of one MLP's ``params`` on points
    ``point_dim`` wide, kept across calls: :meth:`get` packs again only
    where a leaf has changed in place since the last pack (its ``_version``
    moved) or was replaced, so the buffer always holds the weights that
    ``params`` holds. On any device;
    packs without autograd. An inference tensor keeps no version, so a leaf
    made under ``inference_mode`` is packed on every call."""

    def __init__(self, params: dict, cfg: NeRFConfig, point_dim: int = 3):
        self.params, self.cfg, self.point_dim = params, cfg, point_dim
        self._leaves: list[torch.Tensor] = []
        self._versions: list[int | None] = []
        self._buffer: torch.Tensor | None = None

    def get(self) -> torch.Tensor:
        leaves = [x for layer in _layers(self.params) for x in (layer["w"], layer["b"])]
        versions = [None if x.is_inference() else x._version for x in leaves]
        if (self._buffer is None or None in versions or versions != self._versions
                or any(a is not b for a, b in zip(leaves, self._leaves))):
            with torch.no_grad():
                self._buffer = pack_weights(self.params, self.cfg, self.point_dim)[0]
            self._leaves, self._versions = leaves, versions
        return self._buffer
