"""The NeRF scene MLP (coarse/fine).

Port of ``scnerf_tpu/fields/nerf.py``: D layers of width W with ReLU, the
encoded position concatenated back in (input first) after each layer in
``skips``, and the viewdirs head (feature -> [feature, view-enc] -> W//2 ->
rgb; alpha from the trunk). The output is raw ``[rgb_logits(3), sigma(1)]``;
the compositor applies the activations.

The matmuls are ``torch.addmm`` in float32, as the JAX package leaves them to
XLA outside any kernel; autograd differentiates them for the train step.
JAX's sample-chunked, rematerialised ``query_field_chunked`` is a memory lever
with the same values; the port calls :func:`query_field` directly, serving
and training alike (a fern train step peaks at a few GiB on an 80 GB card).
:func:`query_field_fused` is its inference-only twin for the serve path,
with the same values and no activation or concatenation pass of its own.
"""
from __future__ import annotations

import dataclasses

import torch

from scnerf_tpu_torch.fields.encoding import (EncodingConfig, positional_encoding,
                                               positional_encoding_into)
from scnerf_tpu_torch.fields.mlp import dense, dense_relu, init_dense, relu_trunk_fused
from scnerf_tpu_torch.kernels.dense_lt import dense_into


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    depth: int = 8
    width: int = 256
    skips: tuple = (4,)
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    output_ch: int = 4  # only used when not use_viewdirs

    @property
    def pos_encoding(self) -> EncodingConfig:
        return EncodingConfig(input_dim=3, n_freqs=self.multires)

    @property
    def view_encoding(self) -> EncodingConfig:
        return EncodingConfig(input_dim=3, n_freqs=self.multires_views)


def init_nerf_mlp(cfg: NeRFConfig, *, generator: torch.Generator | None = None,
                  device: torch.device | str = "cuda") -> dict:
    """Parameter dict for one NeRF MLP, with the JAX package's structure:
    ``{"pts": [dense]*depth, "feature", "alpha", "views", "rgb"}`` (or
    ``"output"`` without viewdirs)."""
    def layer(i, o, act):
        return init_dense(i, o, act, generator=generator, device=device)

    input_ch = cfg.pos_encoding.out_dim
    input_ch_views = cfg.view_encoding.out_dim
    pts = []
    in_dim = input_ch
    for i in range(cfg.depth):
        pts.append(layer(in_dim, cfg.width, "relu"))
        # The skip concat after layer i widens the next layer.
        in_dim = cfg.width + input_ch if i in cfg.skips else cfg.width
    params = {"pts": pts}
    if cfg.use_viewdirs:
        params["feature"] = layer(cfg.width, cfg.width, "linear")
        params["alpha"] = layer(cfg.width, 1, "linear")
        params["views"] = layer(input_ch_views + cfg.width, cfg.width // 2, "relu")
        params["rgb"] = layer(cfg.width // 2, 3, "linear")
    else:
        params["output"] = layer(cfg.width, cfg.output_ch, "linear")
    return params


def nerf_mlp_apply(params: dict, cfg: NeRFConfig, pts_enc: torch.Tensor,
                   views_enc: torch.Tensor | None = None) -> torch.Tensor:
    """Raw field query on encoded inputs ``(..., pos_dim)`` [and
    ``(..., view_dim)``] -> ``(..., 4)``."""
    h = pts_enc
    for i, layer in enumerate(params["pts"]):
        h = torch.relu(dense(layer, h))
        if i in cfg.skips:
            h = torch.cat([pts_enc, h], dim=-1)
    if cfg.use_viewdirs:
        alpha = dense(params["alpha"], h)
        feature = dense(params["feature"], h)
        h = torch.relu(dense(params["views"], torch.cat([feature, views_enc], dim=-1)))
        return torch.cat([dense(params["rgb"], h), alpha], dim=-1)
    return dense(params["output"], h)


def query_field(params: dict, cfg: NeRFConfig, pts: torch.Tensor,
                viewdirs: torch.Tensor | None = None) -> torch.Tensor:
    """Encode ``pts (N, S, 3)`` and ``viewdirs (N, 3)`` (broadcast over
    samples) and query the MLP -> ``(N, S, 4)``."""
    pts_enc = positional_encoding(pts, cfg.pos_encoding)
    views_enc = None
    if cfg.use_viewdirs:
        vd = viewdirs[..., None, :].expand(pts.shape)
        views_enc = positional_encoding(vd, cfg.view_encoding)
    return nerf_mlp_apply(params, cfg, pts_enc, views_enc)


def query_field_fused(params: dict, cfg: NeRFConfig, pts: torch.Tensor,
                      viewdirs: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`query_field` for inference, bit for bit: ``pts (N, S, 3)`` and
    ``viewdirs (N, 3)`` -> raw ``(N, S, 4)``, with the same parameters and
    the same matrix products over the same columns in the same order.

    The trunk is ``mlp.relu_trunk_fused``: each ReLU layer's bias and ReLU
    in its product's epilogue, the encoding and the skip layer's output
    written into the skip input. The feature layer writes into the first
    columns of the view branch's input, and the view directions, encoded
    once per ray rather than once per sample, are copied into its last
    columns. What stays: the alpha and rgb heads (``dense``) and their
    ``(N, S, 4)`` concatenation, 16 bytes a point: alpha's product has one
    column, which cuBLAS computes as a matrix-vector product and no
    epilogue writes into a wider row. No autograd: the serve functions call it
    under ``inference_mode``; training and the eval renders keep
    :func:`query_field`.
    """
    lead = pts.shape[:-1]
    x = pts.reshape(-1, pts.shape[-1])
    h = relu_trunk_fused(params["pts"], cfg.skips, x, cfg.pos_encoding)
    if not cfg.use_viewdirs:
        return dense(params["output"], h).reshape(*lead, -1)
    alpha = dense(params["alpha"], h)
    width = params["feature"]["w"].shape[1]
    views_in = x.new_empty((x.shape[0], width + cfg.view_encoding.out_dim))
    dense_into(params["feature"], h, views_in[:, :width], relu=False)
    rays = viewdirs.reshape(-1, viewdirs.shape[-1])
    views_enc = positional_encoding_into(
        rays, cfg.view_encoding, rays.new_empty((rays.shape[0], cfg.view_encoding.out_dim)))
    views_in.view(*lead, -1)[..., width:].copy_(
        views_enc.reshape(*viewdirs.shape[:-1], 1, -1))
    h = dense_relu(params["views"], views_in)
    return torch.cat([dense(params["rgb"], h), alpha], dim=-1).reshape(*lead, 4)
