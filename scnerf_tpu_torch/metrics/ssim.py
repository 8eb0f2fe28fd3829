"""SSIM.

Port of ``scnerf_tpu/metrics/ssim.py``: Wang et al.'s formulation with an
11x11 Gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03 and value range 1
(piqa's defaults, which the reference reports), the window applied in valid
mode, channel by channel.

The variances are ``E[x^2] - mu^2``, a cancellation: JAX forces
``Precision.HIGHEST`` because its TPU default made them negative and SSIM
blew up to 14.7 on a 32 dB render. The same cancellation turns any change
in the rounding of the window or of its sums into a change of SSIM: on a
fern-sized render one float32 ulp in the window's sum moves SSIM by
1.1e-5, and with ``F.conv2d`` in float32 the card's SSIM lay 9.2e-6 from
the CPU's with the window computed on the card (``exp`` rounds
differently there) and 1.5e-6 with PyTorch's own convolution (cuDNN off)
(``chip_smoke.py`` phase 17). So the window is separable here: its 1-D
weights are computed once on the CPU, and each pass is a running sum of
shifted slices times a weight, elementwise float32 operations in a fixed
order that round alike on every device. The port then agrees with itself
across devices to the final mean's rounding, and with float64 to about
1e-8 (JAX's float32 conv: 1.4e-5 off float64 on a 378x504 pair, a few
1e-7 on the tests' small ones).
"""
from __future__ import annotations

import torch


def _window(size: int, sigma: float) -> list[float]:
    """The 1-D Gaussian weights, in float32 on the CPU, as Python floats
    (each the exact float32 value)."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return (g / torch.sum(g)).tolist()


def _filter2d(img: torch.Tensor, weights: list[float]) -> torch.Tensor:
    """Valid-mode Gaussian filtering of an (H, W, C) image: along the rows,
    then along the columns."""
    n = len(weights)
    H, W = img.shape[0] - n + 1, img.shape[1] - n + 1
    rows = weights[0] * img[:, 0:W]
    for k in range(1, n):
        rows = rows + weights[k] * img[:, k:k + W]
    out = weights[0] * rows[0:H]
    for k in range(1, n):
        out = out + weights[k] * rows[k:k + H]
    return out


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    k1: float = 0.01,
    k2: float = 0.03,
    win_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) float32 images in [0, 1], as a 0-d
    tensor on their device."""
    weights = _window(win_size, sigma)
    c1 = k1**2
    c2 = k2**2
    mu_x = _filter2d(pred, weights)
    mu_y = _filter2d(target, weights)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    # Variances are nonnegative by definition; the subtraction can round
    # slightly below zero, so clamp (keeps the denominator >= c2 > 0).
    sigma_xx = torch.clamp(_filter2d(pred * pred, weights) - mu_xx, min=0.0)
    sigma_yy = torch.clamp(_filter2d(target * target, weights) - mu_yy, min=0.0)
    sigma_xy = _filter2d(pred * target, weights) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    return torch.mean(num / den)
