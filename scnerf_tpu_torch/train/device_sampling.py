"""Ray-batch sampling on the device.

Port of ``scnerf_tpu/train/device_sampling.py``: the training images stay on
the device, and each step draws the image index and pixel coordinates from a
``torch.Generator`` on that device and gathers the target colours there, so
the host loop is ``state, metrics = step(state, generator)`` with no
host-to-device copy. The same semantics as the reference's per-step
sampling: one random image (or one per ray), uniform pixels, optional centre
precrop. The NeRF++ variant draws one image a step as a 0-d tensor and
gathers the mask and per-pixel min depth besides.
"""
from __future__ import annotations

import torch

from scnerf_tpu_torch.camera.rays import rays_opencv


def sample_batch_on_device(
    images: torch.Tensor,
    generator: torch.Generator,
    n_rand: int,
    n_images: int | None = None,
    precrop_frac: float | None = None,
    single_image: bool = True,
) -> dict[str, torch.Tensor]:
    """Draw a pixel batch from images on the device.

    Args:
      images: ``(N, H, W, 3)`` float images (pass the same tensor every
        step).
      generator: the draws' source, on ``images``' device.
      n_rand: rays per batch.
      n_images: draw from the first ``n_images`` images (default all).
      precrop_frac: optional centre-crop fraction (early-iteration precrop).
      single_image: one image per batch (the reference's no-batching mode)
        or one per ray.
    Returns:
      ``px``, ``py`` float32 ``(n_rand,)``; ``img_idx`` int64 ``(n_rand,)``;
      ``target`` ``(n_rand, 3)``.
    """
    N, H, W = images.shape[:3]
    n_images = n_images or N
    device = images.device

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator, device=device)

    if single_image:
        img_idx = randint(0, n_images, (1,)).expand(n_rand)
    else:
        img_idx = randint(0, n_images, (n_rand,))
    if precrop_frac is not None:
        dh = int(H // 2 * precrop_frac)
        dw = int(W // 2 * precrop_frac)
        px = randint(W // 2 - dw, W // 2 + dw, (n_rand,))
        py = randint(H // 2 - dh, H // 2 + dh, (n_rand,))
    else:
        px = randint(0, W, (n_rand,))
        py = randint(0, H, (n_rand,))
    return {
        "px": px.to(torch.float32),
        "py": py.to(torch.float32),
        "img_idx": img_idx,
        "target": images[img_idx, py, px],
    }


def make_device_sampling_step(base_step, images: torch.Tensor, n_rand: int,
                              precrop_frac: float | None = None,
                              single_image: bool = True):
    """Wrap a train step from ``make_train_step`` with sampling on the
    device: returns ``step(state, generator) -> (state, metrics)``, which
    draws the batch and then the step's own randoms from ``generator`` (on
    ``images``' device)."""

    def step(state, generator: torch.Generator):
        batch = sample_batch_on_device(images, generator, n_rand,
                                       precrop_frac=precrop_frac,
                                       single_image=single_image)
        return base_step(state, batch, generator)

    return step


def sample_nerfpp_batch(images: torch.Tensor, generator: torch.Generator, n_rand: int,
                        masks: torch.Tensor | None = None,
                        min_depths: torch.Tensor | None = None,
                        default_min_depth: float = 1e-4,
                        intrinsics: torch.Tensor | None = None,
                        poses: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Draw a NeRF++ pixel batch on ``images``' device: one image as a 0-d
    tensor (autoexpo indexes a per-image table with it) and ``n_rand``
    uniform pixels of it; the target colours and, when given, the mask and
    the per-pixel min depth (``(N, H, W)`` each; else ``default_min_depth``
    everywhere) gathered there. With ``intrinsics`` and ``poses`` (``(N, 4,
    4)`` each) the batch also carries the rays (:func:`rays_opencv`, the path
    without a camera model)."""
    N, H, W = images.shape[:3]
    device = images.device
    img = torch.randint(0, N, (), generator=generator, device=device)
    px = torch.randint(0, W, (n_rand,), generator=generator, device=device)
    py = torch.randint(0, H, (n_rand,), generator=generator, device=device)
    per_ray = img.expand(n_rand)
    batch = {
        "px": px.to(torch.float32),
        "py": py.to(torch.float32),
        "img_idx": img,
        "target": images[per_ray, py, px],
        "min_depth": (min_depths[per_ray, py, px] if min_depths is not None else
                      torch.full((n_rand,), default_min_depth, device=device)),
    }
    if intrinsics is not None and poses is not None:
        one = img.reshape(1)
        batch["rays_o"], batch["rays_d"] = rays_opencv(
            intrinsics.index_select(0, one)[0], poses.index_select(0, one)[0],
            batch["px"], batch["py"])
    if masks is not None:
        batch["mask"] = masks[per_ray, py, px].to(torch.float32)
    return batch


def make_nerfpp_device_sampling_step(base_step, images: torch.Tensor, n_rand: int, **sampling):
    """The NeRF++ variant of :func:`make_device_sampling_step`, around a step
    from ``train/nerfpp_step.py:make_nerfpp_train_step``: returns
    ``step(state, generator) -> (state, metrics)``, which draws the batch by
    :func:`sample_nerfpp_batch` (``sampling``: its ``masks``,
    ``min_depths``, ``default_min_depth``, ``intrinsics`` and ``poses``) and
    then the step's own randoms from ``generator``."""

    def step(state, generator: torch.Generator):
        return base_step(state, sample_nerfpp_batch(images, generator, n_rand, **sampling),
                         generator)

    return step
