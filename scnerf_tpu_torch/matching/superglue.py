"""SuperGlue, the attentional matcher over SuperPoint's keypoints.

Port of the network the JAX package runs through ``transformers``
(``SuperGlueForKeypointMatching``, ``models/superglue/
modeling_superglue.py``): the keypoint encoder, the attentional GNN of
``self`` and ``cross`` layers, the final projection, log-space Sinkhorn
with the learned dustbin score and the mutual-nearest-neighbour
extraction, under that model's parameter names (``keypoint_detector.*``,
``keypoint_encoder.encoder.N``, ``gnn.layers.N.attention.self.query``,
``final_projection.final_proj``, ``bin_score``), so its state dict loads
with ``strict=True``.

Attention is plain ``matmul`` and ``softmax`` in the same order as that
model's eager path; a fused attention kernel would sum in another order.
The pair is padded to its larger keypoint count through Sinkhorn, whose
marginals count the padded rows and columns, as that model's do.

The configuration is a plain dict shaped like that model's ``config.json``,
with ``keypoint_detector_config`` nested; :data:`DEFAULTS` fills the keys
it lacks but ``keypoint_encoder_sizes`` and ``gnn_layers_types``, which it
must name.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from scnerf_tpu_torch.matching.superpoint import SuperPoint, device_pair

DEFAULTS = {
    "hidden_size": 256,
    "num_attention_heads": 4,
    "sinkhorn_iterations": 100,
    "matching_threshold": 0.0,
}
REQUIRED = ("keypoint_encoder_sizes", "gnn_layers_types")


def superglue_config(config: dict) -> dict:
    """``config`` over :data:`DEFAULTS`; raises where it lacks a key of
    :data:`REQUIRED` or names a layer type other than ``self`` and
    ``cross``."""
    missing = [k for k in REQUIRED if config.get(k) is None]
    if missing:
        raise ValueError(f"a SuperGlue config must name {missing}")
    cfg = {**DEFAULTS, **config}
    if not all(t in ("self", "cross") for t in cfg["gnn_layers_types"]):
        raise ValueError("All gnn_layers_types must be either 'self' or 'cross'")
    if cfg["hidden_size"] % cfg["num_attention_heads"]:
        raise ValueError("hidden_size % num_attention_heads is different from zero")
    return cfg


def normalize_keypoints(keypoints: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Pixel keypoints ``(B, N, 2)`` about the image centre, over 0.7 of its
    longer side."""
    size = device_pair(width, height, keypoints)[None]
    center = size / 2
    scaling = size.max(1, keepdim=True).values * 0.7
    return (keypoints - center[:, None, :]) / scaling[:, None, :]


def log_sinkhorn_iterations(couplings, log_mu, log_nu, iterations: int) -> torch.Tensor:
    log_u = torch.zeros_like(log_mu)
    log_v = torch.zeros_like(log_nu)
    for _ in range(iterations):
        log_u = log_mu - torch.logsumexp(couplings + log_v.unsqueeze(1), dim=2)
        log_v = log_nu - torch.logsumexp(couplings + log_u.unsqueeze(2), dim=1)
    return couplings + log_u.unsqueeze(2) + log_v.unsqueeze(1)


def log_optimal_transport(scores: torch.Tensor, bin_score: torch.Tensor,
                          iterations: int) -> torch.Tensor:
    """Log of the optimal transport ``(B, M+1, N+1)`` of ``scores`` ``(B, M,
    N)`` with a dustbin row and column of ``bin_score``, times ``M + N``."""
    b, m, n = scores.shape
    ms, ns = scores.new_full((), m), scores.new_full((), n)
    bins0 = bin_score.expand(b, m, 1)
    bins1 = bin_score.expand(b, 1, n)
    alpha = bin_score.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, alpha], -1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    log_mu, log_nu = log_mu[None].expand(b, -1), log_nu[None].expand(b, -1)
    z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iterations)
    return z - norm  # multiply probabilities by M+N


class MLPLayer(nn.Module):
    """Linear, batch norm over the channels, ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        self.batch_norm = nn.BatchNorm1d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        x = self.batch_norm(x.transpose(-1, -2)).transpose(-1, -2)
        return F.relu(x)


def mlp(channels: list) -> nn.ModuleList:
    """MLP layers between ``channels``, the last a plain linear layer."""
    layers = [MLPLayer(channels[i - 1], channels[i]) for i in range(1, len(channels) - 1)]
    return nn.ModuleList(layers + [nn.Linear(channels[-2], channels[-1])])


class KeypointEncoder(nn.Module):
    def __init__(self, sizes: list, hidden: int):
        super().__init__()
        self.encoder = mlp([3] + list(sizes) + [hidden])

    def forward(self, keypoints: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        x = torch.cat([keypoints, scores.unsqueeze(2)], dim=2)
        for layer in self.encoder:
            x = layer(x)
        return x


class SelfAttention(nn.Module):
    """Queries from one set, keys and values from another (the same set in a
    ``self`` layer), over ``heads`` heads."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads, self.head_size = heads, hidden // heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, source: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]

        def split(t):
            return t.view(b, -1, self.heads, self.head_size).transpose(1, 2)

        key, value, query = split(self.key(source)), split(self.value(source)), split(self.query(x))
        scores = torch.matmul(query, key.transpose(-1, -2))
        scores = scores / math.sqrt(self.head_size) + mask
        context = torch.matmul(F.softmax(scores, dim=-1), value)
        context = context.permute(0, 2, 1, 3).contiguous()
        return context.view(context.size()[:-2] + (self.heads * self.head_size,))


class AttentionOutput(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.self = SelfAttention(hidden, heads)
        self.output = AttentionOutput(hidden)

    def forward(self, x, source, mask):
        return self.output.dense(self.self(x, source, mask))


class AttentionalPropagation(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.attention = Attention(hidden, heads)
        self.mlp = mlp([hidden * 2, hidden * 2, hidden])

    def forward(self, x, source, mask):
        x = torch.cat([x, self.attention(x, source, mask)], dim=2)
        for layer in self.mlp:
            x = layer(x)
        return x


class AttentionalGNN(nn.Module):
    def __init__(self, hidden: int, heads: int, layer_types: list):
        super().__init__()
        self.hidden, self.layer_types = hidden, list(layer_types)
        self.layers = nn.ModuleList(AttentionalPropagation(hidden, heads) for _ in layer_types)

    def forward(self, descriptors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``descriptors`` ``(2 B, N, D)``, the pair's two images next to each
        other; ``mask`` ``(2 B, 1, 1, N)`` additive. A ``cross`` layer
        attends to the other image of the pair."""
        b, n, _ = descriptors.shape
        for layer, kind in zip(self.layers, self.layer_types):
            source, source_mask = descriptors, mask
            if kind == "cross":
                source = descriptors.reshape(-1, 2, n, self.hidden).flip(1).reshape(b, n, self.hidden)
                source_mask = mask.reshape(-1, 2, 1, 1, n).flip(1).reshape(b, 1, 1, n)
            descriptors = descriptors + layer(descriptors, source, source_mask)
        return descriptors


class FinalProjection(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.final_proj = nn.Linear(hidden, hidden, bias=True)


class SuperGlue(nn.Module):
    """SuperPoint and SuperGlue over image pairs.

    :meth:`forward` takes grey pairs ``(B, 2, 1, H, W)`` in [0, 1] and returns
    a dict: ``keypoints`` ``(B, 2, N, 2)`` relative to ``(W, H)``, ``mask``
    ``(B, 2, N)`` int32, ``matches`` ``(B, 2, N)`` (the index in the other
    image, -1 for none), ``matching_scores`` ``(B, 2, N)``, and
    ``log_assignment`` ``(B, N+1, N+1)`` (None without keypoints). It runs
    :meth:`detect`, :meth:`score` and :meth:`assign`, which a caller may
    time apart. ``config["sinkhorn_iterations"]`` and
    ``config["matching_threshold"]`` are read on each call, as are the
    detector's thresholds in ``keypoint_detector.config``.
    """

    def __init__(self, config: dict):
        super().__init__()
        self.config = superglue_config(config)
        hidden, heads = self.config["hidden_size"], self.config["num_attention_heads"]
        self.keypoint_detector = SuperPoint(self.config.get("keypoint_detector_config"))
        self.keypoint_encoder = KeypointEncoder(self.config["keypoint_encoder_sizes"], hidden)
        self.gnn = AttentionalGNN(hidden, heads, self.config["gnn_layers_types"])
        self.final_projection = FinalProjection(hidden)
        self.register_parameter("bin_score", nn.Parameter(torch.tensor(1.0)))

    def detect(self, pixel_values: torch.Tensor):
        """SuperPoint on both images of each pair: (keypoints ``(B, 2, N, 2)``
        relative, scores ``(B, 2, N)``, descriptors ``(B, 2, N, D)``, mask
        ``(B, 2, N)``)."""
        b, _, c, h, w = pixel_values.shape
        keypoints, scores, descriptors, mask = self.keypoint_detector(
            pixel_values.reshape(b * 2, c, h, w))
        return (keypoints.reshape(b, 2, -1, 2).to(pixel_values),
                scores.reshape(b, 2, -1).to(pixel_values),
                descriptors.reshape(b, 2, -1, self.config["hidden_size"]).to(pixel_values),
                mask.reshape(b, 2, -1))

    def score(self, keypoints, scores, descriptors, mask, height: int, width: int):
        """The GNN and the final projection: the pair's score matrix ``(B, N,
        N)`` over ``sqrt(hidden)``, ``finfo.min`` where either keypoint is
        padding."""
        hidden = self.config["hidden_size"]
        b, _, n, _ = keypoints.shape
        absolute = keypoints.clone()
        absolute[:, :, :, 0] = absolute[:, :, :, 0] * width
        absolute[:, :, :, 1] = absolute[:, :, :, 1] * height
        absolute = normalize_keypoints(absolute.reshape(b * 2, n, 2), height, width)
        descriptors = descriptors.reshape(b * 2, n, hidden)
        descriptors = descriptors + self.keypoint_encoder(absolute, scores.reshape(b * 2, n))
        flat = mask.reshape(b * 2, n)[:, None, None, :].to(descriptors.dtype)
        additive = (1.0 - flat) * torch.finfo(descriptors.dtype).min
        descriptors = self.final_projection.final_proj(self.gnn(descriptors, additive))
        descriptors = descriptors.reshape(b, 2, n, hidden)
        pair = descriptors[:, 0] @ descriptors[:, 1].transpose(1, 2)
        pair = pair / hidden**0.5
        both = torch.logical_and(mask[:, 0].unsqueeze(2), mask[:, 1].unsqueeze(1))
        return pair.masked_fill(both == 0, torch.finfo(pair.dtype).min)

    def assign(self, pair_scores: torch.Tensor):
        """Sinkhorn and the mutual nearest neighbours above the matching
        threshold: (log assignment, matches ``(B, 2, N)``, matching scores
        ``(B, 2, N)``)."""
        b = pair_scores.shape[0]
        z = log_optimal_transport(pair_scores, self.bin_score,
                                  iterations=self.config["sinkhorn_iterations"])
        max0, max1 = z[:, :-1, :-1].max(2), z[:, :-1, :-1].max(1)
        indices0, indices1 = max0.indices, max1.indices
        arange0 = indices0.new_ones(indices0.shape[1]).cumsum(0) - 1
        arange1 = indices1.new_ones(indices1.shape[1]).cumsum(0) - 1
        mutual0 = arange0[None] == indices1.gather(1, indices0)
        mutual1 = arange1[None] == indices0.gather(1, indices1)
        scores0 = torch.where(mutual0, max0.values.exp(), 0.0)
        scores0 = torch.where(scores0 > self.config["matching_threshold"], scores0, 0.0)
        scores1 = torch.where(mutual1, scores0.gather(1, indices1), 0.0)
        valid0 = mutual0 & (scores0 > 0)
        valid1 = mutual1 & valid0.gather(1, indices1)
        matches0 = torch.where(valid0, indices0, -1)
        matches1 = torch.where(valid1, indices1, -1)
        return (z, torch.cat([matches0, matches1], dim=1).reshape(b, 2, -1),
                torch.cat([scores0, scores1], dim=1).reshape(b, 2, -1))

    def forward(self, pixel_values: torch.Tensor) -> dict:
        height, width = pixel_values.shape[-2:]
        keypoints, scores, descriptors, mask = self.detect(pixel_values)
        out = {"keypoints": keypoints, "mask": mask, "log_assignment": None}
        if keypoints.shape[2] == 0:
            shape = keypoints.shape[:-1]
            out.update(matches=keypoints.new_full(shape, -1, dtype=torch.int),
                       matching_scores=keypoints.new_zeros(shape))
            return out
        pair = self.score(keypoints, scores, descriptors, mask, height, width)
        out["log_assignment"], out["matches"], out["matching_scores"] = self.assign(pair)
        return out
