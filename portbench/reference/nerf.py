"""Frozen copy of ``scnerf_tpu_torch/fields/nerf.py`` (the benchmark's plain reference).

The NeRF scene MLP (coarse/fine).

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
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.reference.encoding import EncodingConfig, positional_encoding
from portbench.reference.mlp import dense, init_dense


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
