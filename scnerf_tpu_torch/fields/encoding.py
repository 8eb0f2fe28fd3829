"""Sinusoidal positional encoding.

Port of ``scnerf_tpu/fields/encoding.py``. Feature order per frequency is
``[sin(f·x) (D), cos(f·x) (D)]``, after the raw ``x``:
``[x, sin(f0 x), cos(f0 x), sin(f1 x), ...]``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    input_dim: int = 3
    n_freqs: int = 10
    max_freq_log2: float | None = None  # default n_freqs - 1
    include_input: bool = True
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        d = self.input_dim if self.include_input else 0
        return d + self.input_dim * self.n_freqs * 2


def freq_bands(cfg: EncodingConfig, *, device: torch.device | str = "cpu") -> torch.Tensor:
    max_freq = cfg.max_freq_log2 if cfg.max_freq_log2 is not None else cfg.n_freqs - 1
    if cfg.log_sampling:
        return 2.0 ** torch.linspace(0.0, max_freq, cfg.n_freqs, device=device)
    return torch.linspace(2.0**0.0, 2.0**max_freq, cfg.n_freqs, device=device)


def positional_encoding(x: torch.Tensor, cfg: EncodingConfig) -> torch.Tensor:
    """Encode ``(..., input_dim)`` -> ``(..., out_dim)``."""
    if cfg.n_freqs == 0:
        return x
    freqs = freq_bands(cfg, device=x.device).to(x.dtype)  # (F,)
    xb = x[..., None, :] * freqs[:, None]  # (..., F, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # (..., F, 2D)
    enc = enc.reshape(*x.shape[:-1], cfg.n_freqs * 2 * x.shape[-1])
    if cfg.include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def positional_encoding_into(x: torch.Tensor, cfg: EncodingConfig,
                             out: torch.Tensor) -> torch.Tensor:
    """:func:`positional_encoding` of ``x (M, input_dim)`` written into
    ``out (M, out_dim)``, a view with unit column stride (the first columns
    of a wider buffer), with no concatenation: the same values, bit for bit.
    Returns ``out``."""
    if cfg.n_freqs == 0:
        return out.copy_(x)
    d = x.shape[-1]
    sincos = out
    if cfg.include_input:
        out[:, :d].copy_(x)
        sincos = out[:, d:]
    freqs = freq_bands(cfg, device=x.device).to(x.dtype)
    xb = x[:, None, :] * freqs[:, None]  # (M, F, D)
    parts = sincos.unflatten(-1, (cfg.n_freqs, 2, d))
    torch.sin(xb, out=parts[:, :, 0])
    torch.cos(xb, out=parts[:, :, 1])
    return out
