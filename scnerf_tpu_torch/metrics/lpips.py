"""LPIPS (VGG16 flavour) on PyTorch.

Port of ``scnerf_tpu/metrics/lpips.py``: VGG16 conv features at relu1_2 ..
relu5_3, unit-normalised per channel, squared differences weighed by the
learned 1x1 linear heads, averaged over the image and summed over the
layers. The convolutions are ``F.conv2d`` in float32, under ``serve.fp32``
(TF32 off for cuDNN too).

No weights ship with the repository and none are downloaded:
:func:`load_weights` reads the same ``.npz`` as the JAX package, at
``$SCNERF_LPIPS_WEIGHTS`` unless a path is given, so one file serves both.
:func:`lpips_available` gates the metric; the evaluation reports LPIPS only
when a weight file exists. Layout of the file:

  ``conv{i}_w``: (kh, kw, cin, cout) for the 13 VGG16 convs, i in [0, 13)
  ``conv{i}_b``: (cout,)
  ``lin{j}_w``: (c_j,) diagonal 1x1 head weights of the 5 tap layers
  ``shift``: (3,), ``scale``: (3,) input normalisation
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from scnerf_tpu_torch.serve import fp32

# VGG16: output channels of each conv, "tap" where the relu output feeds an
# LPIPS head, "M" a 2x2 max pool.
_VGG16_PLAN = [64, 64, "tap", "M", 128, 128, "tap", "M", 256, 256, 256, "tap", "M",
               512, 512, 512, "tap", "M", 512, 512, 512, "tap"]

_DEFAULT_ENV = "SCNERF_LPIPS_WEIGHTS"


def lpips_available(path: str | None = None) -> bool:
    path = path or os.environ.get(_DEFAULT_ENV, "")
    return bool(path) and os.path.exists(path)


def load_weights(path: str | None = None, *,
                 device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """The weight file's arrays as float32 tensors on ``device``, in the
    file's layout."""
    path = path or os.environ.get(_DEFAULT_ENV)
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(device)
                for k in data.files}


def _features(img: torch.Tensor, weights: dict) -> list[torch.Tensor]:
    """The tap layers' activations, NCHW, of one ``(H, W, 3)`` image."""
    x = (img[None] * 2.0 - 1.0 - weights["shift"]) / weights["scale"]
    x = x.permute(0, 3, 1, 2)
    feats, ci = [], 0
    for item in _VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        elif item == "tap":
            feats.append(x)
        else:
            w = weights[f"conv{ci}_w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
            x = torch.relu(F.conv2d(x, w, weights[f"conv{ci}_b"], padding="same"))
            ci += 1
    return feats


def lpips(pred: torch.Tensor, target: torch.Tensor, weights: dict) -> torch.Tensor:
    """LPIPS distance between ``(H, W, 3)`` images in [0, 1], a 0-d tensor
    on their device."""
    with fp32(), torch.no_grad():
        total = pred.new_zeros(())
        for j, (a, b) in enumerate(zip(_features(pred, weights), _features(target, weights))):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            total = total + torch.mean(torch.sum(d * weights[f"lin{j}_w"][:, None, None], dim=1))
        return total
