"""SuperPoint, the keypoint detector and descriptor in front of SuperGlue.

Port of the network the JAX package runs through ``transformers``
(``SuperPointForKeypointDetection``, ``models/superpoint/
modeling_superpoint.py``), written here so that the port needs no
``transformers``: the same modules under the same parameter names
(``encoder.conv_blocks.N.conv_a``, ``keypoint_decoder.conv_score_a``,
``descriptor_decoder.conv_descriptor_a``, ...), so a state dict of that
model loads with ``strict=True``, and the same operations in the same order.

The configuration is a plain dict shaped like that model's
``config.json``; :data:`DEFAULTS` fills the keys it lacks.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

DEFAULTS = {
    "encoder_hidden_sizes": [64, 64, 128, 128],
    "decoder_hidden_size": 256,
    "keypoint_decoder_dim": 65,
    "descriptor_decoder_dim": 256,
    "keypoint_threshold": 0.005,
    "max_keypoints": -1,
    "nms_radius": 4,
    "border_removal_distance": 4,
}


def device_pair(a, b, like: torch.Tensor) -> torch.Tensor:
    """``[a, b]`` on ``like``'s device and dtype, made by two fills: no copy
    from the host, so no wait for the device."""
    return torch.stack([like.new_full((), a), like.new_full((), b)])


def superpoint_config(config: dict | None = None) -> dict:
    """``config`` over :data:`DEFAULTS`."""
    return {**DEFAULTS, **{k: v for k, v in (config or {}).items() if k in DEFAULTS}}


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Non-maximum suppression of a ``(B, H, W)`` score map: the local maxima
    in a ``2 r + 1`` window, then two rounds that recover maxima freed by
    the suppression."""
    if nms_radius < 0:
        raise ValueError("Expected positive values for nms_radius")

    def max_pool(x):
        return F.max_pool2d(x, kernel_size=nms_radius * 2 + 1, stride=1, padding=nms_radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, pool: bool):
        super().__init__()
        self.conv_a = nn.Conv2d(in_channels, out_channels, kernel_size=3, stride=1, padding=1)
        self.conv_b = nn.Conv2d(out_channels, out_channels, kernel_size=3, stride=1, padding=1)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv_a(x))
        x = F.relu(self.conv_b(x))
        return F.max_pool2d(x, kernel_size=2, stride=2) if self.pool else x


class Encoder(nn.Module):
    """Four VGG blocks on the grey image; all but the last halve it."""

    def __init__(self, sizes: list):
        super().__init__()
        channels = [1] + list(sizes)
        self.conv_blocks = nn.ModuleList(
            ConvBlock(channels[i], channels[i + 1], pool=i < len(sizes) - 1)
            for i in range(len(sizes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.conv_blocks:
            x = block(x)
        return x


class KeypointDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.conv_score_a = nn.Conv2d(cfg["encoder_hidden_sizes"][-1], cfg["decoder_hidden_size"],
                                      kernel_size=3, stride=1, padding=1)
        self.conv_score_b = nn.Conv2d(cfg["decoder_hidden_size"], cfg["keypoint_decoder_dim"],
                                      kernel_size=1, stride=1, padding=0)

    def forward(self, encoded: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Keypoints ``(N, 2)`` as (x, y) pixels and their scores ``(N,)`` of
        one image's encoding ``(1, C, h, w)``."""
        scores = self.conv_score_b(F.relu(self.conv_score_a(encoded)))
        scores = F.softmax(scores, 1)[:, :-1]  # drop the dustbin
        b, _, h, w = scores.shape
        scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
        scores = scores.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)
        scores = simple_nms(scores, cfg["nms_radius"])[0]

        # The threshold and the border in one mask, so one nonzero (one wait
        # for the device) finds the keypoints, in the order the threshold's
        # nonzero followed by the border filter gives. transformers' filter
        # is handed 8 times this map's size as its far limits, so only the
        # top and left borders go; the port keeps that.
        border = cfg["border_removal_distance"]
        keep = scores > cfg["keypoint_threshold"]
        keep[:border] = False
        keep[:, :border] = False
        keypoints = torch.nonzero(keep)
        scores = scores[keypoints[:, 0], keypoints[:, 1]]
        k = cfg["max_keypoints"]
        if 0 <= k < len(keypoints):
            scores, indices = torch.topk(scores, k, dim=0)
            keypoints = keypoints[indices]
        return torch.flip(keypoints, [1]).to(scores.dtype), scores


class DescriptorDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.conv_descriptor_a = nn.Conv2d(cfg["encoder_hidden_sizes"][-1],
                                           cfg["decoder_hidden_size"],
                                           kernel_size=3, stride=1, padding=1)
        self.conv_descriptor_b = nn.Conv2d(cfg["decoder_hidden_size"],
                                           cfg["descriptor_decoder_dim"],
                                           kernel_size=1, stride=1, padding=0)

    def forward(self, encoded: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
        """Unit descriptors ``(N, D)`` at one image's keypoints ``(N, 2)``."""
        descriptors = self.conv_descriptor_b(F.relu(self.conv_descriptor_a(encoded)))
        descriptors = F.normalize(descriptors, p=2, dim=1)
        return sample_descriptors(keypoints[None], descriptors, 8)[0].transpose(0, 1)


def sample_descriptors(keypoints: torch.Tensor, descriptors: torch.Tensor,
                       scale: int = 8) -> torch.Tensor:
    """Bilinear samples ``(B, C, N)`` of a ``(B, C, h, w)`` descriptor map at
    pixel keypoints ``(B, N, 2)``, normalised: the map's cell centres sit at
    ``s/2 - 0.5`` pixels, at ``align_corners=True``."""
    b, c, h, w = descriptors.shape
    keypoints = keypoints - scale / 2 + 0.5
    divisor = device_pair(w * scale - scale / 2 - 0.5, h * scale - scale / 2 - 0.5, keypoints)
    keypoints = keypoints / divisor[None]
    keypoints = keypoints * 2 - 1
    keypoints = keypoints.view(b, 1, -1, 2)
    descriptors = F.grid_sample(descriptors, keypoints, mode="bilinear", align_corners=True)
    return F.normalize(descriptors.reshape(b, c, -1), p=2, dim=1)


class SuperPoint(nn.Module):
    """Grey images ``(B, 1, H, W)`` in [0, 1] to keypoints, scores and
    descriptors, each image's padded to the batch's largest count.

    Its thresholds (``keypoint_threshold``, ``max_keypoints``,
    ``nms_radius``, ``border_removal_distance``) are read from
    ``self.config`` on each call.
    """

    def __init__(self, config: dict | None = None):
        super().__init__()
        self.config = superpoint_config(config)
        self.encoder = Encoder(self.config["encoder_hidden_sizes"])
        self.keypoint_decoder = KeypointDecoder(self.config)
        self.descriptor_decoder = DescriptorDecoder(self.config)

    def forward(self, pixel_values: torch.Tensor):
        """Returns (keypoints ``(B, N, 2)`` relative to ``(W, H)``, scores
        ``(B, N)``, descriptors ``(B, N, D)``, mask ``(B, N)`` int32, 1 where
        a keypoint is)."""
        b, _, height, width = pixel_values.shape
        encoded = self.encoder(pixel_values)
        found = [self.keypoint_decoder(e[None], self.config) for e in encoded]
        descs = [self.descriptor_decoder(e[None], kp)
                 for e, (kp, _) in zip(encoded, found)]
        n = max(kp.shape[0] for kp, _ in found)
        device = pixel_values.device
        keypoints = torch.zeros((b, n, 2), device=device)
        scores = torch.zeros((b, n), device=device)
        descriptors = torch.zeros((b, n, self.config["descriptor_decoder_dim"]), device=device)
        mask = torch.zeros((b, n), device=device, dtype=torch.int)
        for i, ((kp, sc), d) in enumerate(zip(found, descs)):
            keypoints[i, :kp.shape[0]] = kp
            scores[i, :sc.shape[0]] = sc
            descriptors[i, :d.shape[0]] = d
            mask[i, :sc.shape[0]] = 1
        keypoints = keypoints / device_pair(width, height, keypoints)
        return keypoints, scores, descriptors, mask
