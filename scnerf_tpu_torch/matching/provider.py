"""Correspondence providers.

Port of ``scnerf_tpu/matching/provider.py``: matching is an offline,
host-side stage that produces fixed-size padded match arrays for the PRD
step.

- :class:`PrecomputedMatches`: load/save an ``.npz`` cache, the JAX
  package's layout (``kps0_{i}_{j}``, ``kps1_{i}_{j}``, ``conf_{i}_{j}``).
- :class:`SIFTMatcher`: OpenCV SIFT + ratio test, when ``cv2`` is
  installed (imported where it is used).

SuperGlue is not ported yet: :func:`matcher_from_config` warns and falls
back to the cache for ``matcher = superglue``. All providers return matches
in the common padded form via :func:`pad_matches`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Protocol

import numpy as np


@dataclass
class PairMatches:
    """Raw (unpadded) matches for one image pair."""

    kps0: np.ndarray  # (M, 2) float32, pixel xy in image i
    kps1: np.ndarray  # (M, 2) float32, pixel xy in image j
    confidence: np.ndarray | None = None  # (M,)


class MatchProvider(Protocol):
    def match(self, img0: np.ndarray, img1: np.ndarray) -> PairMatches: ...


def pad_matches(m: PairMatches, max_matches: int):
    """Fixed-size padded tensors for the jitted PRD loss.

    Returns:
      (kps0 ``(max, 2)``, kps1 ``(max, 2)``, mask ``(max,)`` bool).
      Keeps the top-``max`` by confidence when over-full
      (mirrors ``runSuperGlue``'s top-``match_num`` selection,
      ``reprojection.py:166-206``).
    """
    n = m.kps0.shape[0]
    if n > max_matches:
        if m.confidence is not None:
            order = np.argsort(-m.confidence)[:max_matches]
        else:
            order = np.arange(max_matches)
        kps0, kps1 = m.kps0[order], m.kps1[order]
        n = max_matches
    else:
        kps0, kps1 = m.kps0, m.kps1
    out0 = np.zeros((max_matches, 2), np.float32)
    out1 = np.zeros((max_matches, 2), np.float32)
    mask = np.zeros((max_matches,), bool)
    out0[:n] = kps0
    out1[:n] = kps1
    mask[:n] = True
    return out0, out1, mask


class PrecomputedMatches:
    """Match cache: one ``.npz`` with arrays ``kps0_{i}_{j}``, ``kps1_{i}_{j}``,
    ``conf_{i}_{j}`` per pair (i < j)."""

    def __init__(self, path: str | None = None):
        self._store: dict[tuple[int, int], PairMatches] = {}
        if path is not None and os.path.exists(path):
            self.load(path)

    def put(self, i: int, j: int, m: PairMatches) -> None:
        self._store[(min(i, j), max(i, j))] = m

    def get(self, i: int, j: int) -> PairMatches | None:
        key = (min(i, j), max(i, j))
        m = self._store.get(key)
        if m is None or i <= j:
            return m
        return PairMatches(kps0=m.kps1, kps1=m.kps0, confidence=m.confidence)

    def pairs(self):
        return sorted(self._store.keys())

    def save(self, path: str) -> None:
        arrays = {}
        for (i, j), m in self._store.items():
            arrays[f"kps0_{i}_{j}"] = m.kps0
            arrays[f"kps1_{i}_{j}"] = m.kps1
            if m.confidence is not None:
                arrays[f"conf_{i}_{j}"] = m.confidence
        np.savez_compressed(path, **arrays)

    def load(self, path: str) -> None:
        data = np.load(path)
        for name in data.files:
            if not name.startswith("kps0_"):
                continue
            _, i, j = name.split("_")
            i, j = int(i), int(j)
            conf = data[f"conf_{i}_{j}"] if f"conf_{i}_{j}" in data.files else None
            self.put(i, j, PairMatches(data[name], data[f"kps1_{i}_{j}"], conf))


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """Rec.601 luma, matching the reference's manual conversion
    (``reprojection.py:129-139``)."""
    return (
        0.2989 * img[..., 0] + 0.5870 * img[..., 1] + 0.1140 * img[..., 2]
    ).astype(np.float32)


class SIFTMatcher:
    """OpenCV SIFT + BFMatcher with Lowe ratio test (``reprojection.py:72-115``)."""

    def __init__(self, ratio: float = 0.75):
        import cv2  # lazy; optional dependency

        self._cv2 = cv2
        self._sift = cv2.SIFT_create()
        self._bf = cv2.BFMatcher()
        self.ratio = ratio

    def match(self, img0: np.ndarray, img1: np.ndarray) -> PairMatches:
        cv2 = self._cv2
        g0 = (np.clip(rgb_to_gray(img0), 0, 1) * 255).astype(np.uint8)
        g1 = (np.clip(rgb_to_gray(img1), 0, 1) * 255).astype(np.uint8)
        k0, d0 = self._sift.detectAndCompute(g0, None)
        k1, d1 = self._sift.detectAndCompute(g1, None)
        if d0 is None or d1 is None:
            z = np.zeros((0, 2), np.float32)
            return PairMatches(z, z, np.zeros((0,), np.float32))
        raw = self._bf.knnMatch(d0, d1, k=2)
        kps0, kps1, conf = [], [], []
        for pair in raw:
            if len(pair) < 2:
                continue
            m, n = pair
            if m.distance < self.ratio * n.distance:
                kps0.append(k0[m.queryIdx].pt)
                kps1.append(k1[m.trainIdx].pt)
                conf.append(1.0 - m.distance / max(n.distance, 1e-8))
        return PairMatches(
            np.asarray(kps0, np.float32).reshape(-1, 2),
            np.asarray(kps1, np.float32).reshape(-1, 2),
            np.asarray(conf, np.float32),
        )


def matcher_from_config(cam_cfg):
    """Select the configured live matcher (the reference picks SuperGlue or
    SIFT at startup, ``run_nerf.py:87-90``). ``cam_cfg`` is a
    ``CameraFlags``-shaped object (``matcher`` + the superglue knobs).
    Returns None when the requested matcher is unavailable (the caller falls
    back to the precomputed-match cache): SIFT without ``cv2``, and
    SuperGlue, which the port does not carry yet; it warns for that one, as
    the JAX package does when it finds no SuperGlue weights."""
    if cam_cfg.matcher == "superglue":
        from warnings import warn

        warn("[matching] matcher=superglue is not ported yet; falling back "
             "to the precomputed-match cache")
        return None
    if cam_cfg.matcher == "sift" and sift_available():
        return SIFTMatcher()
    return None


def sift_available() -> bool:
    try:
        import cv2  # noqa: F401

        return hasattr(__import__("cv2"), "SIFT_create")
    except Exception:
        return False


def build_match_cache(
    images: np.ndarray,
    pairs: np.ndarray,
    provider: MatchProvider,
    cache_path: str | None = None,
) -> PrecomputedMatches:
    """Run a provider over all (i, j) pairs and store results."""
    cache = PrecomputedMatches()
    for i, j in pairs:
        cache.put(int(i), int(j), provider.match(images[int(i)], images[int(j)]))
    if cache_path is not None:
        cache.save(cache_path)
    return cache
