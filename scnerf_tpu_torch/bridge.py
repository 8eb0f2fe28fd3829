"""Parameters and configs between the JAX package and the port, as numpy.

The JAX side hands over its pytrees with numpy leaves (``jax.tree.map(
np.asarray, tree)``), so this module imports neither ``jax`` nor
``scnerf_tpu``: it reads the JAX objects by attribute name.

- MLP parameters: nested dicts/lists of ``{"w": (in, out), "b": (out,)}``
  (NeRF's ``{"coarse", "fine"}``, NeRF++'s ``{"levels": [{"fg", "bg",
  "autoexpo"}, ...]}``). The port keeps the JAX layout, so they copy as
  they are.
- The camera: the leaves of ``scnerf_tpu.camera.model.Camera`` by name
  (:data:`CAMERA_LEAVES`), plus its config.
- Configs: a port config is built from the fields of a JAX config with the
  same names; JAX-only fields are checked to be ones the port's values do not
  depend on (``TrainConfig`` and ``Curriculum`` included).
- Training parameters: the JAX train tree (NeRF's ``{"coarse", "fine",
  "camera"}``, NeRF++'s ``{"levels": [{"fg", "bg", "autoexpo"?}, ...],
  "camera"}``) becomes the port's with the trainable leaves requiring grad
  (:func:`train_params_to_torch`), and goes back by JAX leaf name
  (:func:`train_params_to_numpy`).
- SuperGlue: the JAX package's ``transformers`` state dict, by the same
  names (:func:`superglue_state_from_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from scnerf_tpu_torch.camera.model import (
    CAMERA_LEAVES, Camera, CameraConfig, camera_leaves, trainable_camera,
)
from scnerf_tpu_torch.train.optim import named_leaves

# JAX config fields the port leaves out, with the only values whose results
# the port reproduces (None: any value). ``pdf_impl`` picks an
# implementation of the same resampler (the device picks it here; NeRF++'s
# config keeps the name), ``remat_chunk`` is a training lever with identical
# values, and ``fuse_fgbg`` runs the NeRF++ fg and bg nets as one batched
# query, the same function up to float32 reassociation.
_JAX_ONLY = {
    "compute_dtype": ("float32",),
    "remat_stash_bf16": (False,),
    "pdf_impl": None,
    "remat_chunk": None,
    "fuse_fgbg": None,
}


def tree_to_torch(tree: Any, *, device: torch.device | str = "cuda") -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device=device) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree)).to(device)


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts/lists/tuples of tensors -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().cpu().numpy()


def convert_config(cfg: Any, port_cls: type) -> Any:
    """Build ``port_cls`` from a config with the same field names (a JAX
    config, or another dataclass).

    Raises if ``cfg`` sets a JAX-only field to a value that would change the
    results, or lacks a field the port needs.
    """
    names = [f.name for f in dataclasses.fields(cfg)]
    for name in names:
        if name in _JAX_ONLY and _JAX_ONLY[name] is not None:
            value = getattr(cfg, name)
            if value not in _JAX_ONLY[name]:
                raise ValueError(f"the port does not support {name}={value!r}")
    kwargs = {}
    for f in dataclasses.fields(port_cls):
        if f.name not in names:
            raise ValueError(f"{type(cfg).__name__} has no field {f.name}")
        value = getattr(cfg, f.name)
        kwargs[f.name] = tuple(value) if isinstance(value, list) else value
    return port_cls(**kwargs)


def config_to_dict(cfg: Any) -> dict:
    """A port config's fields, to build the JAX twin with ``JaxCls(**d)``."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def camera_from_numpy(camera: Any, *, device: torch.device | str = "cuda") -> Camera:
    """A JAX ``Camera`` with numpy leaves (or a dict of the leaves and
    ``"config"``) -> the port's :class:`Camera`."""
    get = camera.__getitem__ if isinstance(camera, dict) else (
        lambda name: getattr(camera, name))
    leaves = {name: torch.from_numpy(np.array(get(name))).to(device)
              for name in CAMERA_LEAVES}
    return Camera(config=convert_config(get("config"), CameraConfig), **leaves)


def camera_to_numpy(camera: Camera) -> dict[str, np.ndarray]:
    """The port's camera leaves as numpy, by JAX leaf name (feed them to
    ``jax_camera.replace(**leaves)``)."""
    return {name: x.detach().cpu().numpy() for name, x in camera_leaves(camera).items()}


def train_params_to_torch(params: dict, *, device: torch.device | str = "cuda") -> dict:
    """A JAX train tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``: ``{"coarse", "fine", "camera"}`` or ``{"levels",
    "camera"}``, each optional) -> the port's, every MLP leaf, autoexpo
    table and the camera's ``*_noise``/``*_grid`` leaves requiring grad; the
    camera's ``*_init`` leaves do not."""
    out = {}
    for key, sub in params.items():
        if key == "camera":
            out[key] = None if sub is None else trainable_camera(
                camera_from_numpy(sub, device=device))
        else:
            out[key] = tree_to_torch(sub, device=device)
            for x in named_leaves(out[key]).values():
                x.requires_grad_(True)
    return out


def train_params_to_numpy(params: dict) -> dict:
    """The port's train tree -> numpy: the MLPs as :func:`tree_to_numpy`,
    the camera as its leaves by JAX name (feed them to
    ``jax_camera.replace(**leaves)``)."""
    return {key: (camera_to_numpy(sub) if isinstance(sub, Camera) else tree_to_numpy(sub))
            for key, sub in params.items()}


def superglue_state_from_numpy(arrays: dict, device: torch.device | str = "cuda") -> dict:
    """The JAX package's SuperGlue parameters (its ``transformers`` model's
    ``state_dict()`` as numpy arrays) -> a state dict of the port's
    :class:`~scnerf_tpu_torch.matching.superglue.SuperGlue`, which names
    them alike; each array keeps its dtype (the batch norms' counters are
    int64)."""
    out = {}
    for name, array in arrays.items():
        array = np.asarray(array)
        if array.dtype.kind not in "fiub":
            raise TypeError(f"{name}: {array.dtype} is not a parameter's dtype")
        out[name] = torch.from_numpy(np.array(array)).to(device)
    return out
