"""SuperGlue correspondences in the Hugging Face layout, without
``transformers``.

Port of ``scnerf_tpu/matching/superglue_hf.py``. The JAX package runs
SuperPoint + SuperGlue through ``transformers``; the port runs its own
modules (:mod:`~scnerf_tpu_torch.matching.superpoint`,
:mod:`~scnerf_tpu_torch.matching.superglue`) on weights in the same
layout, and needs neither ``transformers``, ``safetensors``,
``huggingface_hub`` nor PIL:

- the config is a plain dict shaped like ``config.json``
  (:func:`tiny_superglue_config` is the JAX package's test architecture);
- weights load offline from a local directory with ``config.json`` and
  ``model.safetensors`` or ``pytorch_model.bin``, or from a hub id in the
  standard cache layout (:func:`resolve_pretrained`); the safetensors format
  is read here (:func:`read_safetensors`);
- preprocessing is ``SuperGlueImageProcessor``'s, done on the host in numpy
  with PIL's bilinear resample emulated bit for bit (:func:`pil_resize`);
- post-processing is ``post_process_keypoint_matching``'s.

The network runs in full float32 (TF32 off for matmuls and cuDNN, the
caller's flags restored). Returns
:class:`~scnerf_tpu_torch.matching.provider.PairMatches`.
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from scnerf_tpu_torch.matching.provider import PairMatches
from scnerf_tpu_torch.matching.superglue import SuperGlue

# The magic-leap weights as published on the HF hub (indoor/outdoor mirrors
# the reference's --superglue_weight).
HUB_IDS = {
    "outdoor": "magic-leap-community/superglue_outdoor",
    "indoor": "magic-leap-community/superglue_indoor",
}
CONFIG_NAME = "config.json"
PROCESSOR_NAME = "preprocessor_config.json"
WEIGHT_NAMES = ("model.safetensors", "pytorch_model.bin")

# SuperGlueImageProcessor's defaults; resample 2 is PIL's BILINEAR.
PROCESSOR_DEFAULTS = {
    "do_resize": True,
    "size": {"height": 480, "width": 640},
    "resample": 2,
    "do_rescale": True,
    "rescale_factor": 1 / 255,
    "do_grayscale": True,
}
_BILINEAR = 2
_PIL_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


def tiny_superglue_config() -> dict:
    """A small random-init architecture for hermetic tests: the JAX
    package's ``tiny_superglue_config`` as a ``config.json`` dict."""
    return {
        "model_type": "superglue",
        "keypoint_detector_config": {
            "model_type": "superpoint",
            "encoder_hidden_sizes": [16, 16, 32, 32], "decoder_hidden_size": 32,
            "keypoint_decoder_dim": 65, "descriptor_decoder_dim": 64,
            "keypoint_threshold": 0.0, "max_keypoints": 64, "nms_radius": 4,
            "border_removal_distance": 4, "initializer_range": 0.02,
        },
        "hidden_size": 64,
        "keypoint_encoder_sizes": [16, 32, 64],
        "gnn_layers_types": ["self", "cross"] * 2,
        "sinkhorn_iterations": 10,
        "num_attention_heads": 4,
        "matching_threshold": 0.0,
        "initializer_range": 0.02,
    }


def init_weights(model: SuperGlue, generator: torch.Generator | None = None,
                 std: float = 0.02) -> SuperGlue:
    """The ``transformers`` initialisation of a random model: linear and
    conv weights normal with ``std``, biases 0, batch norms the identity,
    ``bin_score`` 1."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
                module.weight.normal_(0.0, std, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, torch.nn.BatchNorm1d):
                module.reset_running_stats()
                module.weight.fill_(1.0)
                module.bias.zero_()
        model.bin_score.fill_(1.0)
    return model


# --------------------------------------------------------------------------
# Offline weights
# --------------------------------------------------------------------------

def hub_cache_dir() -> str:
    """``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache",
                                                      "huggingface")
    return os.path.join(home, "hub")


def _complete(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, CONFIG_NAME)) and any(
        os.path.isfile(os.path.join(directory, name)) for name in WEIGHT_NAMES)


def resolve_pretrained(name: str) -> str | None:
    """The directory that holds ``name``'s config and weights: ``name``
    itself when it is such a directory, else the hub cache's snapshot that
    ``refs/main`` names (``models--{org}--{name}/snapshots/<commit>``); None
    where neither exists."""
    if os.path.isdir(name):
        return name if _complete(name) else None
    repo = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            commit = f.read().strip()
    except OSError:
        return None
    snapshot = os.path.join(repo, "snapshots", commit)
    return snapshot if _complete(snapshot) else None


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header of names, dtypes, shapes and byte offsets,
    then the raw little-endian buffers."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        kind = info["dtype"]
        dtype = np.dtype(np.uint16 if kind == "BF16" else _SAFETENSORS_DTYPES[kind])
        dtype = dtype.newbyteorder("<")
        array = np.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                              offset=begin).reshape(info["shape"])
        tensor = torch.from_numpy(array.astype(dtype.newbyteorder("=")))
        out[name] = tensor.view(torch.bfloat16) if kind == "BF16" else tensor
    return out


def load_pretrained(directory: str) -> tuple[dict, dict, dict[str, torch.Tensor]]:
    """(config, processor settings, state dict) of a weights directory: the
    processor's keys where ``preprocessor_config.json`` has them, its
    defaults where not; ``model.safetensors`` before ``pytorch_model.bin``."""
    with open(os.path.join(directory, CONFIG_NAME)) as f:
        config = json.load(f)
    processor = dict(PROCESSOR_DEFAULTS)
    path = os.path.join(directory, PROCESSOR_NAME)
    if os.path.isfile(path):
        with open(path) as f:
            saved = json.load(f)
        processor.update({k: saved[k] for k in PROCESSOR_DEFAULTS if k in saved})
    weights = os.path.join(directory, WEIGHT_NAMES[0])
    if os.path.isfile(weights):
        state = read_safetensors(weights)
    else:
        state = torch.load(os.path.join(directory, WEIGHT_NAMES[1]), map_location="cpu",
                           weights_only=True)
    return config, processor, state


# --------------------------------------------------------------------------
# SuperGlueImageProcessor on the host
# --------------------------------------------------------------------------

def _bilinear_coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter, then its 8-bit
    fixed-point coefficients: each output's first input and its weights
    ``(out, taps)``. When it shrinks, the triangle widens by the scale."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    first = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    count = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - first
    x = np.arange(taps)
    arg = np.abs((x[None] + first[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((arg < 1.0) & (x[None] < count[:, None]), 1.0 - arg, 0.0)
    total = np.zeros(out_size)
    for k in range(taps):  # in C's order: float sums are not associative
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return first, np.trunc(0.5 + w * (1 << _PIL_PRECISION_BITS)).astype(np.int64)


def _resample_rows(image: np.ndarray, out_size: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along axis 0: for each output,
    ``2^21 + sum(pixel * coefficient)`` over its taps, shifted down 22 bits
    and clipped to uint8. In int32: 255 times the coefficients' sum (2^22
    and a few) stays under 2^31."""
    n = image.shape[0]
    first, kk = _bilinear_coefficients(n, out_size)
    kk = kk.astype(np.int32).reshape((out_size, kk.shape[1]) + (1,) * (image.ndim - 1))
    image = image.astype(np.int32)
    acc = np.full((out_size,) + image.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        acc += image[np.minimum(first + k, n - 1)] * kk[:, k]
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """``PIL.Image.resize((width, height), BILINEAR)`` of a uint8 ``(h, w,
    c)`` image, bit for bit: the horizontal pass, then the vertical one,
    each rounded and clipped to uint8, a pass skipped where its size does
    not change."""
    out = image
    if width != image.shape[1]:  # rows of the transposed image: whole-row gathers
        out = _resample_rows(np.ascontiguousarray(out.swapaxes(0, 1)), width).swapaxes(0, 1)
    if height != image.shape[0]:
        out = _resample_rows(np.ascontiguousarray(out), height)
    return out


def to_u8(img) -> np.ndarray:
    """The JAX matcher's input conversion: float images clipped to [0, 1]
    and scaled to uint8 by truncation; grey images to three channels."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def preprocess(image: np.ndarray, processor: dict | None = None) -> np.ndarray:
    """``SuperGlueImageProcessor.preprocess`` of one ``(h, w, 3)`` uint8
    image: the ``(H, W)`` float32 grey channel it hands the model."""
    p = {**PROCESSOR_DEFAULTS, **(processor or {})}
    if p["do_resize"]:
        if p["resample"] != _BILINEAR:
            raise NotImplementedError(f"resample {p['resample']}: only bilinear (2) is ported")
        image = pil_resize(image, int(p["size"]["height"]), int(p["size"]["width"]))
    if p["do_rescale"]:  # float64 product, then float32: a table of the 256 values
        table = (np.arange(256, dtype=np.float64) * p["rescale_factor"]).astype(np.float32)
        image = table[image]
    grey = (image[..., 0] == image[..., 1]).all() and (image[..., 1] == image[..., 2]).all()
    if p["do_grayscale"] and not grey:
        return (image[..., 0] * 0.2989 + image[..., 1] * 0.5870
                + image[..., 2] * 0.1140).astype(np.float32)
    return image[..., 0].astype(np.float32)


# --------------------------------------------------------------------------
# The matcher
# --------------------------------------------------------------------------

class HFSuperGlueMatcher:
    """SuperPoint + SuperGlue on weights in the Hugging Face layout.

    With ``config`` (a ``config.json`` dict) the model is random (the
    ``transformers`` initialisation, from torch's global generator) and the
    config's own thresholds hold. Otherwise it loads ``pretrained`` (a
    directory or a hub id) or ``HUB_IDS[weights]`` offline, and the runtime
    knobs ``nms_radius``, ``keypoint_threshold``, ``max_keypoints`` and
    ``sinkhorn_iterations`` go onto its config. :meth:`match` is
    :meth:`prepare`, :meth:`run` and :meth:`postprocess`.
    """

    def __init__(
        self,
        pretrained: str | None = None,
        weights: str = "outdoor",
        config: dict | None = None,
        nms_radius: int = 4,
        keypoint_threshold: float = 0.005,
        max_keypoints: int = 1024,
        sinkhorn_iterations: int = 20,
        match_threshold: float = 0.2,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        self.match_threshold = match_threshold
        if config is not None:
            self.model = init_weights(SuperGlue(config))
            self.processor = dict(PROCESSOR_DEFAULTS)
        else:
            name = pretrained or HUB_IDS[weights]
            directory = resolve_pretrained(name)
            if directory is None:
                raise FileNotFoundError(f"no SuperGlue config and weights for {name!r} in a "
                                        f"local directory or under {hub_cache_dir()}")
            config, self.processor, state = load_pretrained(directory)
            config["keypoint_detector_config"] = {
                **config.get("keypoint_detector_config", {}), "nms_radius": nms_radius,
                "keypoint_threshold": keypoint_threshold, "max_keypoints": max_keypoints}
            config["sinkhorn_iterations"] = sinkhorn_iterations
            self.model = SuperGlue(config)
            self.model.load_state_dict(state, strict=True)
        self.model = self.model.eval().to(self.device)

    def prepare(self, img0: np.ndarray, img1: np.ndarray) -> torch.Tensor:
        """The pair preprocessed on the host, ``(1, 2, 1, H, W)`` on the
        device."""
        grey = torch.from_numpy(np.stack([preprocess(to_u8(img), self.processor)
                                          for img in (img0, img1)]))
        if self.device.type == "cuda":  # from pinned memory, the copy does not wait
            grey = grey.pin_memory()
        return grey[None, :, None].to(self.device, non_blocking=True)

    def run(self, pixel_values: torch.Tensor) -> dict:
        from scnerf_tpu_torch.serve import fp32_inference

        with fp32_inference():
            return self.model(pixel_values)

    def postprocess(self, out: dict, shape0, shape1) -> PairMatches:
        """``post_process_keypoint_matching``: keypoints in the original
        pixels, truncated to integers, and the mutual matches scoring over
        ``match_threshold``. One copy to the host."""
        n = out["keypoints"].shape[2]
        packed = torch.cat([out["keypoints"][0].reshape(-1), out["mask"][0].reshape(-1).float(),
                            out["matches"][0, 0].float(), out["matching_scores"][0, 0]]).cpu()
        keypoints, mask, matches, scores = torch.split(packed, [4 * n, 2 * n, n, n])
        keypoints, mask = keypoints.reshape(2, n, 2), mask.reshape(2, n) > 0
        sizes = torch.tensor([shape0[:2], shape1[:2]])  # (h, w) each
        keypoints = (keypoints * sizes.flip(-1).reshape(2, 1, 2)).to(torch.int32)
        kps0, kps1 = keypoints[0][mask[0]], keypoints[1][mask[1]]
        matches, scores = matches.to(torch.int64)[mask[0]], scores[mask[0]]
        valid = torch.logical_and(scores > self.match_threshold, matches > -1)
        return PairMatches(kps0[valid].numpy().astype(np.float32).reshape(-1, 2),
                           kps1[matches[valid]].numpy().astype(np.float32).reshape(-1, 2),
                           scores[valid].numpy().astype(np.float32).reshape(-1))

    def match(self, img0: np.ndarray, img1: np.ndarray) -> PairMatches:
        out = self.run(self.prepare(img0, img1))
        return self.postprocess(out, np.shape(img0), np.shape(img1))


def hf_superglue_available(weights: str = "outdoor", pretrained: str | None = None) -> bool:
    """True iff a config and weights for ``pretrained`` (or
    ``HUB_IDS[weights]``) are on this machine (offline only)."""
    return resolve_pretrained(pretrained or HUB_IDS[weights]) is not None
