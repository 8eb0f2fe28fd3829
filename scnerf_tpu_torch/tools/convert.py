"""Reference-checkpoint conversion: the reference's torch state dicts to the
port's parameter trees and back.

Port of ``scnerf_tpu/tools/convert.py``. The port keeps the JAX layout
(dense ``w`` as ``(in, out)``), so the mappings are the JAX package's:

- NeRF MLP: ``pts_linears.{i}.weight`` ``(out, in)`` -> ``["pts"][i]["w"]``
  ``(in, out)``, the bias as it is; the heads ``feature_linear``,
  ``alpha_linear``, ``views_linears.0``, ``rgb_linear`` (or
  ``output_linear``) -> ``feature``, ``alpha``, ``views``, ``rgb`` (or
  ``output``).
- NeRF++ MLPNet: ``base_layers.{i}.0`` -> ``base[i]``, ``sigma_layers.0`` ->
  ``sigma``, ``base_remap_layers.0`` -> ``remap``, ``rgb_layers.{0,2}`` ->
  ``rgb0``/``rgb1``.
- The camera model: ``intrinsics_initial`` -> ``intrinsics_init`` and so
  on (:func:`torch_camera_to_fields`).

State-dict values may be tensors or numpy arrays. The ``torch_*`` functions
return trees of CPU tensors; the ``params_to_torch_*`` and
:func:`camera_fields_to_torch` return state dicts of numpy arrays, as the
JAX package's do. :func:`load_reference_checkpoint` reads a reference
``.tar`` with ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dense(sd: dict, prefix: str) -> dict:
    w = _np(sd[f"{prefix}.weight"])
    b = _np(sd[f"{prefix}.bias"])
    return {"w": torch.from_numpy(np.ascontiguousarray(w.T)), "b": torch.from_numpy(b.copy())}


def torch_nerf_to_params(state_dict: dict, depth: int = 8) -> dict:
    """A reference ``NeRF`` state dict -> the port's MLP tree."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    params = {"pts": [_dense(sd, f"pts_linears.{i}") for i in range(depth)]}
    if "feature_linear.weight" in sd:
        params["feature"] = _dense(sd, "feature_linear")
        params["alpha"] = _dense(sd, "alpha_linear")
        params["views"] = _dense(sd, "views_linears.0")
        params["rgb"] = _dense(sd, "rgb_linear")
    else:
        params["output"] = _dense(sd, "output_linear")
    return params


def torch_mlpnet_to_params(state_dict: dict, depth: int = 8) -> dict:
    """A reference NeRF++ ``MLPNet`` state dict -> the port's tree."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    return {
        "base": [_dense(sd, f"base_layers.{i}.0") for i in range(depth)],
        "sigma": _dense(sd, "sigma_layers.0"),
        "remap": _dense(sd, "base_remap_layers.0"),
        "rgb0": _dense(sd, "rgb_layers.0"),
        "rgb1": _dense(sd, "rgb_layers.2"),
    }


def torch_nerfnet_to_params(state_dict: dict, depth: int = 8) -> dict:
    """A reference ``NerfNet`` / ``NerfNetWithAutoExpo`` state dict -> the
    port's ``{"fg", "bg"}`` level tree."""
    sd = {k.replace("module.", "").replace("nerf_net.", ""): v for k, v in state_dict.items()}
    fg = {k[len("fg_net."):]: v for k, v in sd.items() if k.startswith("fg_net.")}
    bg = {k[len("bg_net."):]: v for k, v in sd.items() if k.startswith("bg_net.")}
    return {"fg": torch_mlpnet_to_params(fg, depth), "bg": torch_mlpnet_to_params(bg, depth)}


_CAMERA_NAMES = {  # the reference's name -> the port's (and the JAX package's) leaf
    "intrinsics_initial": "intrinsics_init",
    "extrinsics_initial": "extrinsics_init",
    "distortion_initial": "distortion_init",
    "intrinsics_noise": "intrinsics_noise",
    "extrinsics_noise": "extrinsics_noise",
    "distortion_noise": "distortion_noise",
    "ray_o_noise": "ray_o_grid",
    "ray_d_noise": "ray_d_grid",
}


def torch_camera_to_fields(state_dict: dict) -> dict:
    """A reference camera-model state dict -> CPU tensors by camera leaf
    name (for ``dataclasses.replace(camera, **fields)``).

    Distortion checkpoints (those with ``distortion_noise``) alias
    ``ray_o_noise`` and ``ray_d_noise`` to one tensor ``s``. A tied camera
    reads each path as the sum of its two grids, so the shared tensor maps
    to ``ray_o_grid = s, ray_d_grid = 0`` (``s`` in both would double the
    noise)."""
    sd = {k.replace("module.", ""): _np(v) for k, v in state_dict.items()}
    out = {ours: torch.from_numpy(sd[theirs].copy())
           for theirs, ours in _CAMERA_NAMES.items() if theirs in sd}
    if "distortion_noise" in sd and "ray_d_noise" in sd:
        out["ray_d_grid"] = torch.zeros_like(out["ray_d_grid"])
    return out


def _put(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(_np(leaf["w"]).T)
    out[f"{name}.bias"] = _np(leaf["b"])


def params_to_torch_nerf(params: dict, prefix: str = "module.") -> dict:
    """The port's MLP tree -> a reference ``NeRF`` state dict of numpy
    arrays (the inverse of :func:`torch_nerf_to_params`)."""
    out = {}
    for i, layer in enumerate(params["pts"]):
        _put(out, f"{prefix}pts_linears.{i}", layer)
    if "feature" in params:
        _put(out, f"{prefix}feature_linear", params["feature"])
        _put(out, f"{prefix}alpha_linear", params["alpha"])
        _put(out, f"{prefix}views_linears.0", params["views"])
        _put(out, f"{prefix}rgb_linear", params["rgb"])
    else:
        _put(out, f"{prefix}output_linear", params["output"])
    return out


def params_to_torch_mlpnet(params: dict, prefix: str = "") -> dict:
    """The port's NeRF++ MLPNet tree -> a reference state dict of numpy
    arrays (the inverse of :func:`torch_mlpnet_to_params`)."""
    out = {}
    for i, layer in enumerate(params["base"]):
        _put(out, f"{prefix}base_layers.{i}.0", layer)
    _put(out, f"{prefix}sigma_layers.0", params["sigma"])
    _put(out, f"{prefix}base_remap_layers.0", params["remap"])
    _put(out, f"{prefix}rgb_layers.0", params["rgb0"])
    _put(out, f"{prefix}rgb_layers.2", params["rgb1"])
    return out


def remap_autoexpo_name(img_path: str) -> str:
    """The reference's autoexpo ``ParameterDict`` key of an image path: dots
    become dashes, the last three path components are kept."""
    name = img_path.replace(".", "-")
    if name.endswith("/"):
        name = name[:-1]
    idx = name.rfind("/")
    for _ in range(2):
        if idx >= 0:
            idx = name[:idx].rfind("/")
    return name[idx + 1:]


def params_to_torch_nerfnet(params: dict, prefix: str = "module.nerf_net.",
                            ddp_prefix: str = "module.",
                            img_paths: list | None = None) -> dict:
    """The port's fg/bg level tree -> a reference ``NerfNetWithAutoExpo``
    state dict of numpy arrays. A level with auto-exposure rows (``(N, 2)``
    by image id) needs the trainer's image paths, in loader order, for the
    name-keyed ``autoexpo_params.<remapped>`` entries."""
    out = {}
    out.update(params_to_torch_mlpnet(params["fg"], prefix=f"{prefix}fg_net."))
    out.update(params_to_torch_mlpnet(params["bg"], prefix=f"{prefix}bg_net."))
    if "autoexpo" in params:
        if img_paths is None:
            raise ValueError("converting autoexpo rows needs the image paths")
        ae = _np(params["autoexpo"])
        if ae.shape[0] != len(img_paths):
            raise ValueError(f"{ae.shape[0]} autoexpo rows but {len(img_paths)} image paths")
        for i, p in enumerate(img_paths):
            out[f"{ddp_prefix}autoexpo_params.{remap_autoexpo_name(p)}"] = (
                np.ascontiguousarray(ae[i]))
    return out


def camera_fields_to_torch(camera) -> dict:
    """The port's ``Camera`` -> a reference camera-model state dict of numpy
    arrays (the inverse of :func:`torch_camera_to_fields`). A pinhole camera
    emits no distortion entries (the reference's pinhole state dicts have
    none); a tied camera emits the effective shared value, the sum of its
    two grids, as both ray-noise entries."""
    cfg = camera.config
    out = {}
    for theirs, ours in _CAMERA_NAMES.items():
        if ours.startswith("distortion") and not cfg.use_distortion:
            continue
        out[theirs] = _np(getattr(camera, ours))
    if cfg.tied_ray_noise:
        s = out["ray_o_noise"] + out["ray_d_noise"]
        out["ray_o_noise"] = s
        out["ray_d_noise"] = s.copy()
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def load_reference_checkpoint(path: str, depth: int = 8, *,
                              device: torch.device | str = "cuda") -> dict:
    """A reference ``.tar`` training checkpoint (``{global_step,
    network_fn_state_dict, network_fine_state_dict, optimizer_state_dict[,
    camera_model]}``) in the port's formats, on ``device``::

        {"step": int, "coarse": <MLP tree>, "fine": <MLP tree or None>,
         "camera_fields": <tensors by camera leaf name, or None>}

    The optimizer state is not converted (Adam restarts). The file is read
    with ``torch.load(weights_only=True)``: tensors, dicts, lists and
    numbers only; anything else raises ``ValueError`` naming the file."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path} holds more than tensors, dicts, lists and numbers, which "
                         f"a reference checkpoint does not: {e}") from e
    if not isinstance(ckpt, dict) or "network_fn_state_dict" not in ckpt:
        raise ValueError(f"{path} is not a reference checkpoint (no network_fn_state_dict)")
    fine = ckpt.get("network_fine_state_dict")
    return {
        "step": int(ckpt.get("global_step", 0)),
        "coarse": _to(torch_nerf_to_params(ckpt["network_fn_state_dict"], depth), device),
        "fine": _to(torch_nerf_to_params(fine, depth), device) if fine else None,
        "camera_fields": (_to(torch_camera_to_fields(ckpt["camera_model"]), device)
                          if "camera_model" in ckpt else None),
    }
