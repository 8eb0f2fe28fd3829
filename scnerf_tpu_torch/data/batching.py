"""Host-side ray/pixel batching.

Port of ``scnerf_tpu/data/batching.py``, a copy of that numpy module (the
same draws for the same seed):

- ``RayPool``: the ``use_batching`` path without a camera: precomputed rays
  over all train images, shuffled once, drawn in fixed-size batches,
  reshuffled each epoch.
- ``PixelPool``: ``use_batching`` with a camera: shuffled global pixel
  indices decoded into per-ray (image, pixel) triples.
- ``sample_pixels``: the per-image path, including the early-iteration
  centre-crop sampling (``precrop_iters``/``precrop_frac``).
"""
from __future__ import annotations

import numpy as np


class RayPool:
    """Shuffled pool of precomputed (ray_o, ray_d, target) rows."""

    def __init__(self, rays_o, rays_d, targets, seed: int = 777):
        assert rays_o.shape == rays_d.shape and rays_o.shape[0] == targets.shape[0]
        self._data = np.concatenate(
            [rays_o, rays_d, targets], axis=-1
        ).astype(np.float32)  # (N, 9)
        self._rng = np.random.RandomState(seed)
        self._order = self._rng.permutation(self._data.shape[0])
        self._cursor = 0
        self.epoch = 0

    def next_batch(self, n: int) -> dict:
        if self._cursor + n > self._data.shape[0]:
            self._order = self._rng.permutation(self._data.shape[0])
            self._cursor = 0
            self.epoch += 1
        idx = self._order[self._cursor : self._cursor + n]
        self._cursor += n
        rows = self._data[idx]
        return {
            "rays_o": rows[:, 0:3],
            "rays_d": rows[:, 3:6],
            "target": rows[:, 6:9],
        }


class PixelPool:
    """``use_batching`` WITH a camera model: a shuffled pool of global
    pixel indices over the train images (the reference's ``run_nerf.py:303-305,369-407``).

    The reference cannot precompute rays here (they must stay differentiable
    through the camera), so it shuffles flat indices ``image*H*W + y*W + x``
    and decodes each batch into per-ray (image idx, pixel) triples that go
    through ``get_rays_kps_use_camera``; epoch exhaustion reshuffles. This
    is the PUBLISHED main-table path: ``configs/llff_data/*.txt`` leave
    ``no_batching`` unset (False) while every "ours" run adds a camera.

    The returned image indices are CAMERA-TABLE (train-split) positions;
    the caller maps through ``i_train`` for target lookup.
    """

    def __init__(self, n_images: int, H: int, W: int, seed: int = 777,
                 rng: np.random.RandomState | None = None):
        self._H, self._W = H, W
        self._n = n_images * H * W
        self._rng = rng if rng is not None else np.random.RandomState(seed)
        self._idx = np.arange(self._n)
        self._rng.shuffle(self._idx)
        self._cursor = 0
        self.epoch = 0

    def next_batch(self, n: int):
        """(img_idx int32, px float32, py float32), each ``(n,)``.

        Fixed-size batches: reshuffles when fewer than ``n`` remain (the
        reference instead emits one short tail batch, then reshuffles —
        equivalent coverage, but short batches would retrigger jit).
        """
        if self._cursor + n > self._n:
            self._rng.shuffle(self._idx)
            self._cursor = 0
            self.epoch += 1
        sl = self._idx[self._cursor : self._cursor + n]
        self._cursor += n
        hw = self._H * self._W
        img = (sl // hw).astype(np.int32)
        rem = sl % hw
        py = (rem // self._W).astype(np.float32)
        px = (rem % self._W).astype(np.float32)
        return img, px, py


def sample_pixels(
    rng: np.random.RandomState,
    H: int,
    W: int,
    n_rand: int,
    precrop_frac: float | None = None,
):
    """Random pixel coordinates, optionally restricted to a center crop.

    The reference draws a JOINT no-replacement choice over the (cropped)
    coordinate grid (``run_nerf.py:449-453``: ``np.random.choice(W*H,
    [N_rand], replace=False)`` on the x-major meshgrid), so a batch never
    repeats a pixel; reproduced here including the x-major flat-index
    decode. Returns (px, py) float32 arrays of shape (n_rand,).
    """
    if precrop_frac is not None:
        dh = int(H // 2 * precrop_frac)
        dw = int(W // 2 * precrop_frac)
        ys = np.arange(H // 2 - dh, H // 2 + dh)
        xs = np.arange(W // 2 - dw, W // 2 + dw)
    else:
        ys = np.arange(H)
        xs = np.arange(W)
    idx = rng.choice(len(xs) * len(ys), size=n_rand, replace=False)
    px = xs[idx // len(ys)]
    py = ys[idx % len(ys)]
    return px.astype(np.float32), py.astype(np.float32)


def gather_target(images: np.ndarray, img_idx, px, py) -> np.ndarray:
    """Target RGB at integer pixel coords; ``img_idx`` scalar or (N,)."""
    return images[img_idx, py.astype(np.int64), px.astype(np.int64)]
