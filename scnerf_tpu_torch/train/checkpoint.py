"""Checkpoint save and restore with ``torch.save``.

Port of ``scnerf_tpu/train/checkpoint.py`` (which writes with orbax):

- periodic save of the step, the parameters (the MLPs' leaves by path, the
  camera's by its JAX leaf names) and the optimizer's moments and count, one
  ``ckpt_{step:09d}.pt`` file each, written to a temporary name and then
  renamed, so a cut run never leaves half a file; ``keep`` prunes the
  oldest;
- the optimizer knobs that change the chain (:func:`optim_knobs`) beside
  them in ``optim_meta.json``, checked on restore;
- auto-resume from the latest checkpoint (:func:`restore_checkpoint`, read
  with ``torch.load(weights_only=True)`` onto the template's device);
- partial loading for warm starts and transfer: :func:`merge_states` copies
  only the leaves whose path and shape match, :func:`restore_camera_partial`
  keeps chosen camera fields of the template.

Curriculum state is not stored: it derives from ``step``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from scnerf_tpu_torch.camera.model import CAMERA_LEAVES, Camera, camera_leaves
from scnerf_tpu_torch.train.optim import OptState, named_leaves
from scnerf_tpu_torch.train.step import TrainState

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")
_OPTIM_META = "optim_meta.json"


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"ckpt_{step:09d}.pt")


def optim_knobs(cfg) -> dict:
    """The ExperimentConfig knobs of the optimizer's multipliers. The JAX
    chain changes its structure with them, so its checkpoints restore only
    under the same knobs; the port keeps the rule, so that a run resumes
    under the schedule it was saved with. Persisted next to every
    checkpoint and validated on restore."""
    o = cfg.optim
    return {
        "camera_lrate_mult": float(o.camera_lrate_mult),
        "camera_lrate_mult_until": int(o.camera_lrate_mult_until),
        "camera_lrate_mult_hold": float(o.camera_lrate_mult_hold),
        "distortion_lrate_mult": float(o.distortion_lrate_mult),
        "distortion_lrate_mult_until": int(o.distortion_lrate_mult_until),
        "distortion_lrate_mult_hold": float(o.distortion_lrate_mult_hold),
    }


def _payload(state: TrainState) -> dict:
    params = {k: v for k, v in state.params.items() if k != "camera"}
    camera = state.params.get("camera")
    return {
        "step": int(state.step),
        "params": {path: x.detach() for path, x in named_leaves(params).items()},
        "camera": None if camera is None else {
            name: x.detach() for name, x in camera_leaves(camera).items()},
        "opt": {"count": int(state.opt_state.count), "mu": state.opt_state.mu,
                "nu": state.opt_state.nu},
    }


def save_checkpoint(ckpt_dir: str, state: TrainState, keep: int = 3,
                    optim_meta: dict | None = None) -> str:
    """Save ``state`` at its step; prune old checkpoints to ``keep``.

    ``optim_meta``: the optimizer knobs (:func:`optim_knobs`), written
    alongside the checkpoints so that a resume can validate them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, int(state.step))
    torch.save(_payload(state), path + ".tmp")
    os.replace(path + ".tmp", path)
    if optim_meta is not None:
        with open(os.path.join(ckpt_dir, _OPTIM_META), "w") as f:
            json.dump(optim_meta, f)
    for s in list_checkpoint_steps(ckpt_dir)[:-keep]:
        os.remove(_ckpt_path(ckpt_dir, s))
    return path


def list_checkpoint_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(ckpt_dir)) if m)


def _with_leaves(tree, leaves: dict, prefix: str = ""):
    """``tree`` with each tensor replaced by ``leaves[path]`` (the paths of
    ``optim.named_leaves``)."""
    if isinstance(tree, Camera):
        return dataclasses.replace(tree, **{n: leaves[f"{prefix}{n}"] for n in CAMERA_LEAVES})
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_leaves(v, leaves, f"{prefix}{i}/") for i, v in enumerate(tree))
    if tree is None:
        return None
    return leaves[prefix[:-1]]


def _check_meta(ckpt_dir: str, optim_meta: dict | None) -> None:
    meta_path = os.path.join(os.path.abspath(ckpt_dir), _OPTIM_META)
    if optim_meta is None or not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        saved = json.load(f)
    diff = {k: (saved[k], optim_meta[k]) for k in saved
            if k in optim_meta and saved[k] != optim_meta[k]}
    if diff:
        raise ValueError(
            f"checkpoint {ckpt_dir} was written with optimizer knobs {saved}, but this "
            f"experiment uses {optim_meta} (mismatch: {diff}); replay them exactly, e.g. "
            "from the expdir's config.json")


def restore_checkpoint(ckpt_dir: str, example: TrainState, step: int | None = None,
                       optim_meta: dict | None = None) -> TrainState | None:
    """The latest (or ``step``'s) checkpoint as a new :class:`TrainState`
    shaped like ``example``, on its device, each leaf requiring grad as
    ``example``'s does; None when there is no checkpoint.

    ``optim_meta``: the restoring experiment's :func:`optim_knobs`; a saved
    meta that disagrees raises ``ValueError``. So does a checkpoint whose
    leaves differ from ``example``'s in name or shape."""
    steps = list_checkpoint_steps(ckpt_dir)
    if not steps:
        return None
    _check_meta(ckpt_dir, optim_meta)
    step = steps[-1] if step is None else step
    want = named_leaves(example.params)
    device = next(iter(want.values())).device
    data = torch.load(_ckpt_path(ckpt_dir, step), map_location=device, weights_only=True)
    saved = dict(data["params"])
    if data["camera"] is not None:
        saved.update({f"camera/{name}": x for name, x in data["camera"].items()})
    shapes = {path: tuple(x.shape) for path, x in saved.items()}
    if shapes != {path: tuple(x.shape) for path, x in want.items()}:
        raise ValueError(f"checkpoint {ckpt_dir} step {step} does not fit this experiment's "
                         f"parameters: {sorted(set(shapes) ^ set(want))}")
    leaves = {path: saved[path].requires_grad_(x.requires_grad) for path, x in want.items()}
    opt = data["opt"]
    return TrainState(step=int(data["step"]), params=_with_leaves(example.params, leaves),
                      opt_state=OptState(count=int(opt["count"]), mu=opt["mu"], nu=opt["nu"]))


def merge_states(template: TrainState, restored: TrainState) -> TrainState:
    """``template`` with the leaves of ``restored`` (parameters, moments,
    step and count) where path and shape match: the reference's
    optimizer-state merge on load. When the two hold different sets of
    leaves, ``template`` as it is (as the JAX package's)."""
    t_leaves, r_leaves = named_leaves(template.params), named_leaves(restored.params)
    t_opt, r_opt = template.opt_state, restored.opt_state
    if set(t_leaves) != set(r_leaves) or set(t_opt.mu) != set(r_opt.mu):
        return template

    def pick(t, r):
        return {k: r[k] if r[k].shape == t[k].shape else t[k] for k in t}

    return TrainState(
        step=restored.step,
        params=_with_leaves(template.params, pick(t_leaves, r_leaves)),
        opt_state=OptState(count=r_opt.count, mu=pick(t_opt.mu, r_opt.mu),
                           nu=pick(t_opt.nu, r_opt.nu)))


def restore_camera_partial(template_camera: Camera, restored_camera: Camera,
                           skip_extrinsics: bool = True) -> Camera:
    """The reference's ``load_camera`` transfer: every calibrated camera
    field from the checkpoint except (optionally) the per-image extrinsics,
    which stay at the template's."""
    cam = restored_camera
    if skip_extrinsics:
        cam = dataclasses.replace(cam, extrinsics_init=template_camera.extrinsics_init,
                                  extrinsics_noise=template_camera.extrinsics_noise)
    return dataclasses.replace(cam, config=template_camera.config)
