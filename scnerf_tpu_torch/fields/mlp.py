"""Dense layers as plain dicts of tensors.

Port of ``scnerf_tpu/fields/mlp.py``: ``{"w": (in, out), "b": (out,)}``, the
JAX layout, so parameters cross between the packages without transposes.
Xavier-uniform init with the activation's gain (sqrt(2) for relu, 1 for
linear), zero bias.
"""
from __future__ import annotations

import math

import torch

from scnerf_tpu_torch.fields.encoding import EncodingConfig, positional_encoding_into
from scnerf_tpu_torch.kernels.dense_lt import dense_into


def init_dense(in_dim: int, out_dim: int, activation: str = "relu", *,
               generator: torch.Generator | None = None,
               device: torch.device | str = "cuda",
               dtype: torch.dtype = torch.float32) -> dict:
    """Draws on the CPU from ``generator`` (a CPU generator), so a seed gives
    the same weights whatever ``device`` they are then moved to."""
    gain = math.sqrt(2.0) if activation == "relu" else 1.0
    limit = gain * math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((in_dim, out_dim), generator=generator, dtype=dtype)
    w = (w * (2.0 * limit) - limit).to(device)
    return {"w": w, "b": torch.zeros((out_dim,), dtype=dtype, device=device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last axis of ``x``."""
    w, b = params["w"], params["b"]
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[1])


def dense_relu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``relu(x @ w + b)`` for 2-D ``x``, the bias and the ReLU in the
    matrix product's epilogue (``torch._addmm_activation``: cuBLASLt's
    RELU_BIAS on the card), the values of ``torch.relu(dense(params, x))``.
    Inference only: the serve path's field twins call it."""
    return torch._addmm_activation(params["b"], x, params["w"])


def relu_trunk_fused(layers: list, skips, x: torch.Tensor, enc: EncodingConfig) -> torch.Tensor:
    """The ReLU trunk of a NeRF MLP or a NeRF++ MLPNet for inference, from
    points ``x (M, D)``: ``h = relu(dense(layer, h))`` for each of
    ``layers``, starting from the encoding, with ``h = [encoding, h]`` after
    each layer ``i`` in ``skips``; returns the last ``h`` (2-D). The values
    are the plain functions', bit for bit, with no concatenation or
    activation pass: the encoding is written into the first columns of the
    skip layers' input buffer, and each skip layer's output straight into
    the columns after it (:func:`dense_into`); every other layer is
    :func:`dense_relu`."""
    enc_dim = enc.out_dim
    width = layers[0]["w"].shape[1] if skips else 0
    buf = x.new_empty((x.shape[0], enc_dim + width))
    positional_encoding_into(x, enc, buf[:, :enc_dim])
    h = buf[:, :enc_dim]
    for i, layer in enumerate(layers):
        if i not in skips:
            h = dense_relu(layer, h)
            continue
        if h is buf:  # two skips in a row: this layer reads the buffer
            buf = torch.empty_like(buf)
            buf[:, :enc_dim].copy_(h[:, :enc_dim])
        dense_into(layer, h, buf[:, enc_dim:], relu=True)
        h = buf
    return h
