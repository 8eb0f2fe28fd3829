"""Frozen copy of ``scnerf_tpu_torch/train/optim.py`` (the benchmark's plain reference).

The optimizer: Adam with an exponential learning-rate decay, L2 decay
folded into the gradient of the camera's noise leaves, and per-group
learning-rate multipliers.

Port of ``scnerf_tpu/train/optim.py:make_optimizer``, the optax chain
``clip -> masked L2 -> scale_by_adam -> scale_by_learning_rate(schedule) ->
masked camera/distortion multipliers -> zero on the frozen leaves``, step
for step:

1. every gradient element clipped to ``[-grad_clip, grad_clip]`` (inf
   becomes the bound);
2. ``weight_decay * param`` added to the gradient of ``ray_o_grid``,
   ``ray_d_grid`` and ``distortion_noise`` only (Adam-L2, not AdamW);
3. Adam with optax's arithmetic: moments ``(1 - b) g + b m``, bias
   corrections ``1 - b^count``, ``eps`` outside the square root;
4. times ``-max(lr_init * decay_factor^(count / decay_steps), lr_floor)``;
5. times ``camera_lr_mult`` on the intrinsics, extrinsics and distortion
   noise and ``distortion_lr_mult`` on the distortion noise, each switched
   to its ``_hold`` value from step ``_until`` on;
6. the camera's ``*_init`` leaves never change.

Every trainable leaf takes part in every step (a leaf without a gradient
gets zeros), so one step count serves all, as optax's does. The leaves are
named by their path in the parameter tree (:func:`named_leaves`); the
camera's keep their JAX names as the last part of the path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.camera import FROZEN_LEAVES, Camera, camera_leaves

DECAYED_LEAVES = ("ray_o_grid", "ray_d_grid", "distortion_noise")
CAMERA_POSE_LEAVES = ("intrinsics_noise", "extrinsics_noise", "distortion_noise")
DISTORTION_LEAVES = ("distortion_noise",)


def named_leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a parameter tree (dicts, lists, a :class:`Camera`) by
    path, ``"coarse/pts/0/w"`` or ``"camera/ray_o_grid"``."""
    if isinstance(tree, Camera):
        return {f"{prefix}{name}": x for name, x in camera_leaves(tree).items()}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, sub in items:
        out.update(named_leaves(sub, f"{prefix}{key}/"))
    return out


def leaf_name(path: str) -> str:
    """The last part of a leaf's path: a camera leaf's JAX name."""
    return path.rsplit("/", 1)[-1]


def trainable_leaves(params) -> dict[str, torch.Tensor]:
    """The leaves the optimizer updates: every leaf but the camera's frozen
    initial values."""
    return {path: x for path, x in named_leaves(params).items()
            if leaf_name(path) not in FROZEN_LEAVES}


@dataclasses.dataclass
class OptState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def _annealed(mult: float, until: int, hold: float, count: int) -> float:
    return mult if until == 0 or count < until else hold


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The chain's hyperparameters, with ``make_optimizer``'s names and
    defaults. ``hold != 1`` with ``until == 0`` raises: the JAX chain drops
    such a hold without a word (it scales by ``mult`` for ever)."""

    lr_init: float
    decay_steps: float
    decay_factor: float = 0.1
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1e6
    lr_floor: float = 0.0
    camera_lr_mult: float = 1.0
    camera_lr_mult_until: int = 0
    camera_lr_mult_hold: float = 1.0
    distortion_lr_mult: float = 1.0
    distortion_lr_mult_until: int = 0
    distortion_lr_mult_hold: float = 1.0

    def __post_init__(self):
        for group in ("camera", "distortion"):
            hold = getattr(self, f"{group}_lr_mult_hold")
            if hold != 1.0 and getattr(self, f"{group}_lr_mult_until") == 0:
                raise ValueError(
                    f"{group}_lr_mult_hold={hold} needs {group}_lr_mult_until > 0 "
                    "(with until == 0 the multiplier holds for ever)")

    @classmethod
    def from_config(cls, train_cfg, **chain) -> "Optimizer":
        """The chain of a train config (``train/step.py``'s
        ``TrainConfig``): its ``lr_init``, ``lr_decay_steps``,
        ``lr_decay_factor`` and ``weight_decay``, and ``chain``'s other
        hyperparameters (clip, Adam, floor, multipliers)."""
        return cls(train_cfg.lr_init, train_cfg.lr_decay_steps,
                   decay_factor=train_cfg.lr_decay_factor,
                   weight_decay=train_cfg.weight_decay, **chain)

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count``, in float32 as optax computes it."""
        lr = np.float32(self.lr_init) * np.float32(self.decay_factor) ** (
            np.float32(count) / np.float32(self.decay_steps))
        return float(max(lr, np.float32(self.lr_floor)) if self.lr_floor > 0.0 else lr)

    def init(self, params) -> OptState:
        leaves = trainable_leaves(params)
        return OptState(
            count=0,
            mu={k: torch.zeros_like(x, memory_format=torch.contiguous_format)
                for k, x in leaves.items()},
            nu={k: torch.zeros_like(x, memory_format=torch.contiguous_format)
                for k, x in leaves.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor | None], state: OptState,
               params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The updates for ``params`` (trainable leaves by path) from
        ``grads`` (the same paths; a missing or None gradient counts as
        zeros). Advances ``state`` in place."""
        count = state.count
        lr = self.learning_rate(count)
        # optax's bias corrections, 1 - b^count in float32: with b2 rounded
        # to float32, 1 - b2 is 1.3e-5 off its decimal value.
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count + 1))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count + 1))
        # All leaves at once (multi-tensor kernels: a few launches a step, not
        # a dozen a leaf), each operation as optax orders it.
        paths = list(state.mu)
        names = [leaf_name(path) for path in paths]
        mus = list(state.mu.values())
        nus = list(state.nu.values())
        gs = [torch.zeros_like(params[path]) if grads.get(path) is None else grads[path]
              for path in paths]
        if self.grad_clip > 0:
            gs = torch._foreach_clamp_max(torch._foreach_clamp_min(gs, -self.grad_clip),
                                          self.grad_clip)
        if self.weight_decay > 0.0:
            gs = [g + self.weight_decay * params[path] if name in DECAYED_LEAVES else g
                  for path, name, g in zip(paths, names, gs)]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - self.b1))
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - self.b2))
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        us = list(torch._foreach_div(torch._foreach_div(mus, bc1), den))
        torch._foreach_mul_(us, -lr)
        camera = _annealed(self.camera_lr_mult, self.camera_lr_mult_until,
                           self.camera_lr_mult_hold, count)
        distortion = _annealed(self.distortion_lr_mult, self.distortion_lr_mult_until,
                               self.distortion_lr_mult_hold, count)
        for i, name in enumerate(names):
            if name in CAMERA_POSE_LEAVES:
                us[i] = us[i] * camera
            if name in DISTORTION_LEAVES:
                us[i] = us[i] * distortion
        state.count = count + 1
        return dict(zip(paths, us))


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], updates: dict[str, torch.Tensor]) -> None:
    """``param += update`` in place, for each path in ``updates``."""
    if updates:
        torch._foreach_add_([params[path] for path in updates], list(updates.values()))
