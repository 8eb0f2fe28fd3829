"""NeRF++ scene representation: foreground + inverted-sphere background.

Port of ``scnerf_tpu/fields/nerfpp.py``:

- the fg MLPNet takes 3D points inside the unit sphere, the bg MLPNet the 4D
  ``(x', y', z', 1/r)`` inverted-sphere points;
- sigma is ``abs`` of the sigma head, rgb a sigmoid;
- the fg transmittance left over, ``bg_lambda``, scales the bg render; bg
  samples are processed far to near;
- auto-exposure: a per-image ``(scale_raw, shift)`` row of an ``(N, 2)``
  array; the scale is ``|scale_raw| + 0.5``.
- viewdirs always feed the rgb head (the JAX config's ``use_viewdirs`` is
  read nowhere, so the port's config has no such field).

The matmuls are ``torch.addmm`` in float32, and autograd runs through
:func:`nerfpp_forward` for training. JAX's sample-chunked remat
(``query_mlpnet_chunked``) keeps the same values and only saves training
memory, which an 80 GB card does not need, so the port applies each net at
once; the fused fg+bg query (``fuse_fgbg``) is not ported. The
transmittances take ``cumprod_positive`` (every factor is ``1 - alpha +
1e-10 > 0``), whose backward does not read the device as ``torch.cumprod``'s
does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from scnerf_tpu_torch.fields.encoding import EncodingConfig, positional_encoding
from scnerf_tpu_torch.fields.mlp import dense, dense_relu, init_dense, relu_trunk_fused
from scnerf_tpu_torch.kernels.dense_lt import dense_into
from scnerf_tpu_torch.camera.model import take_rows
from scnerf_tpu_torch.geometry.sphere import HUGE_NUMBER, TINY_NUMBER, depth2pts_outside
from scnerf_tpu_torch.render.composite import cumprod_positive


@dataclasses.dataclass(frozen=True)
class NerfPPConfig:
    depth: int = 8
    width: int = 256
    skips: tuple = (4,)
    max_freq_log2: int = 10  # frequencies of the positions
    max_freq_log2_viewdirs: int = 4

    def pos_encoding(self, input_dim: int) -> EncodingConfig:
        return EncodingConfig(input_dim=input_dim, n_freqs=self.max_freq_log2)

    @property
    def view_encoding(self) -> EncodingConfig:
        return EncodingConfig(input_dim=3, n_freqs=self.max_freq_log2_viewdirs)


def init_mlpnet(cfg: NerfPPConfig, input_dim: int, *,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cuda") -> dict:
    """One MLPNet (fg or bg, by ``input_dim`` 3 or 4), with the JAX
    package's structure: ``{"base": [dense]*depth, "sigma", "remap",
    "rgb0", "rgb1"}``."""
    def layer(i, o, act):
        return init_dense(i, o, act, generator=generator, device=device)

    input_ch = cfg.pos_encoding(input_dim).out_dim
    view_ch = cfg.view_encoding.out_dim
    base = []
    dim = input_ch
    for i in range(cfg.depth):
        base.append(layer(dim, cfg.width, "relu"))
        dim = cfg.width
        if i in cfg.skips and i != cfg.depth - 1:
            dim += input_ch
    return {
        "base": base,
        "sigma": layer(dim, 1, "linear"),
        "remap": layer(dim, 256, "linear"),
        "rgb0": layer(256 + view_ch, cfg.width // 2, "relu"),
        "rgb1": layer(cfg.width // 2, 3, "linear"),
    }


def mlpnet_apply(params: dict, cfg: NerfPPConfig, pts_enc: torch.Tensor,
                 views_enc: torch.Tensor):
    """Encoded points ``(..., Cp)`` and viewdirs ``(..., Cv)`` -> (rgb in
    [0, 1] ``(..., 3)``, sigma >= 0 ``(...,)``)."""
    h = torch.relu(dense(params["base"][0], pts_enc))
    for i in range(cfg.depth - 1):
        if i in cfg.skips:
            h = torch.cat([pts_enc, h], dim=-1)
        h = torch.relu(dense(params["base"][i + 1], h))
    sigma = torch.abs(dense(params["sigma"], h))[..., 0]
    remap = dense(params["remap"], h)
    del h
    hv = torch.relu(dense(params["rgb0"], torch.cat([remap, views_enc], dim=-1)))
    rgb = torch.sigmoid(dense(params["rgb1"], hv))
    return rgb, sigma


def query_mlpnet(params: dict, cfg: NerfPPConfig, pts: torch.Tensor,
                 views_enc: torch.Tensor, input_dim: int):
    """Encode ``pts (N, S, input_dim)``, broadcast ``views_enc (N, Cv)``
    over the samples, and apply the net -> (rgb ``(N, S, 3)``, sigma
    ``(N, S)``)."""
    pts_enc = positional_encoding(pts, cfg.pos_encoding(input_dim))
    ve = views_enc[..., None, :].expand(*pts_enc.shape[:-1], views_enc.shape[-1])
    return mlpnet_apply(params, cfg, pts_enc, ve)


def query_mlpnet_fused(params: dict, cfg: NerfPPConfig, pts: torch.Tensor,
                       views_enc: torch.Tensor, input_dim: int):
    """:func:`query_mlpnet` for inference, bit for bit: ``pts (N, S,
    input_dim)`` and ``views_enc (N, Cv)`` -> (rgb ``(N, S, 3)``, sigma
    ``(N, S)``), with the same parameters and the same matrix products over
    the same columns in the same order.

    As ``nerf.query_field_fused``: the trunk is ``mlp.relu_trunk_fused``;
    the remap layer writes into the first columns of the rgb branch's
    input and ``views_enc`` is copied into its last columns, once per
    sample, with no concatenation; the sigma and rgb heads stay ``dense``.
    No autograd: the NeRF++ serve function calls it under
    ``inference_mode``; training and the eval renders keep
    :func:`query_mlpnet`.
    """
    lead = pts.shape[:-1]
    x = pts.reshape(-1, input_dim)
    skips = tuple(i for i in cfg.skips if i != cfg.depth - 1)
    h = relu_trunk_fused(params["base"], skips, x, cfg.pos_encoding(input_dim))
    sigma = torch.abs(dense(params["sigma"], h))[..., 0]
    width = params["remap"]["w"].shape[1]
    rgb_in = x.new_empty((x.shape[0], width + views_enc.shape[-1]))
    dense_into(params["remap"], h, rgb_in[:, :width], relu=False)
    del h
    rgb_in.view(*lead, -1)[..., width:].copy_(views_enc[..., None, :])
    hv = dense_relu(params["rgb0"], rgb_in)
    rgb = torch.sigmoid(dense(params["rgb1"], hv))
    return rgb.reshape(*lead, 3), sigma.reshape(lead)


def init_nerfpp_net(cfg: NerfPPConfig, n_images: int = 0, autoexpo: bool = False, *,
                    generator: torch.Generator | None = None,
                    device: torch.device | str = "cuda") -> dict:
    """``{"fg", "bg"}`` MLPNets (+ ``"autoexpo"`` ``(n_images, 2)`` rows of
    ``(0.5, 0)``)."""
    params = {
        "fg": init_mlpnet(cfg, 3, generator=generator, device=device),
        "bg": init_mlpnet(cfg, 4, generator=generator, device=device),
    }
    if autoexpo:
        params["autoexpo"] = torch.tensor([[0.5, 0.0]], device=device).repeat(n_images, 1)
    return params


def nerfpp_forward(
    params: dict,
    cfg: NerfPPConfig,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    fg_z_max: torch.Tensor,
    fg_z_vals: torch.Tensor,
    bg_z_vals: torch.Tensor,
    query: Callable | None = None,
) -> dict[str, torch.Tensor]:
    """Joint fg/bg render of one cascade level.

    Args:
      ray_o, ray_d: ``(N, 3)``.
      fg_z_max: ``(N,)`` depth of the unit-sphere exit point.
      fg_z_vals: ``(N, S_fg)`` fg sample depths.
      bg_z_vals: ``(N, S_bg)`` bg inverse depths in [0, 1].
      query: the fields, ``query(mlpnet_params, cfg, pts, views_enc,
        input_dim) -> (rgb, sigma)`` as :func:`query_mlpnet`, which it is
        where not given (the NeRF++ serve function passes its own,
        ``serve.py:nerfpp_field_query``).
    Returns:
      dict: rgb, fg_weights, bg_weights, fg_rgb, fg_depth, bg_rgb, bg_depth,
      bg_lambda.
    """
    query = query or query_mlpnet
    ray_d_norm = torch.linalg.vector_norm(ray_d, dim=-1, keepdim=True)
    viewdirs = ray_d / ray_d_norm
    views_enc = positional_encoding(viewdirs, cfg.view_encoding)

    # ---- foreground. Each net's activations are freed before the next
    # runs: only its (rgb, sigma) outlive the call.
    fg_pts = ray_o[..., None, :] + fg_z_vals[..., None] * ray_d[..., None, :]
    fg_rgb, fg_sigma = query(params["fg"], cfg, fg_pts, views_enc, 3)

    fg_dists = fg_z_vals[..., 1:] - fg_z_vals[..., :-1]
    fg_dists = ray_d_norm * torch.cat(
        [fg_dists, fg_z_max[..., None] - fg_z_vals[..., -1:]], dim=-1)
    fg_alpha = 1.0 - torch.exp(-fg_sigma * fg_dists)
    T = cumprod_positive(1.0 - fg_alpha + TINY_NUMBER)
    bg_lambda = T[..., -1]
    T = torch.cat([torch.ones_like(T[..., :1]), T[..., :-1]], dim=-1)
    fg_weights = fg_alpha * T
    fg_rgb_map = torch.sum(fg_weights[..., None] * fg_rgb, dim=-2)
    fg_depth_map = torch.sum(fg_weights * fg_z_vals, dim=-1)

    # ---- background: inverted-sphere points, flipped far -> near before
    # the query; the z-vals are flipped to match for the compositing.
    shape = (*bg_z_vals.shape, 3)
    bg_pts, _ = depth2pts_outside(ray_o[..., None, :].expand(shape),
                                  ray_d[..., None, :].expand(shape), bg_z_vals)
    bg_pts = torch.flip(bg_pts, dims=[-2])
    bg_z_flip = torch.flip(bg_z_vals, dims=[-1])  # 1 -> 0
    bg_dists = bg_z_flip[..., :-1] - bg_z_flip[..., 1:]
    bg_dists = torch.cat([bg_dists, torch.full_like(bg_dists[..., :1], HUGE_NUMBER)], dim=-1)
    bg_rgb, bg_sigma = query(params["bg"], cfg, bg_pts, views_enc, 4)
    bg_alpha = 1.0 - torch.exp(-bg_sigma * bg_dists)
    T = cumprod_positive(1.0 - bg_alpha + TINY_NUMBER)[..., :-1]
    T = torch.cat([torch.ones_like(T[..., :1]), T], dim=-1)
    bg_weights = bg_alpha * T
    bg_rgb_map = torch.sum(bg_weights[..., None] * bg_rgb, dim=-2)
    bg_depth_map = torch.sum(bg_weights * bg_z_flip, dim=-1)

    bg_rgb_map = bg_lambda[..., None] * bg_rgb_map
    bg_depth_map = bg_lambda * bg_depth_map
    return {
        "rgb": fg_rgb_map + bg_rgb_map,
        "fg_weights": fg_weights,
        "bg_weights": bg_weights,
        "fg_rgb": fg_rgb_map,
        "fg_depth": fg_depth_map,
        "bg_rgb": bg_rgb_map,
        "bg_depth": bg_depth_map,
        "bg_lambda": bg_lambda,
    }


def autoexpo_params(params: dict, img_idx):
    """Effective (scale, shift) of image(s) ``img_idx`` (an int, or an index
    tensor of any shape: a 0-d one is not read back to the host)."""
    ae = take_rows(params["autoexpo"], img_idx)
    return torch.abs(ae[..., 0]) + 0.5, ae[..., 1]
