"""The data axis and batch placement: port of ``scnerf_tpu/distributed/mesh.py``.

The JAX package lays one program over a ``jax.sharding.Mesh`` and lets XLA
insert the gradient ``psum``. Here each rank of a ``torch.distributed``
group is one position on the ``data`` axis: :func:`shard_batch` hands it
its contiguous shard of every ray array (edge-padded to a multiple of the
world size first, as JAX's), :func:`replicate_state` makes the state rank
0's, and the train steps built with ``group=`` reduce the gradients
(:mod:`scnerf_tpu_torch.distributed.reduce`). The ``model`` axis exists
only at size 1: the tensor-parallel layout is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` axes over a process group: ``n_data`` ranks,
    this process at ``rank``; ``group`` None is the default group (or a
    single process)."""

    n_data: int
    n_model: int = 1
    rank: int = 0
    group: Any = None

    axis_names = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: int | None = None, n_model: int = 1, group=None) -> Mesh:
    """The mesh of ``group`` (default: the default group, or this process
    alone). ``n_data`` must be the group's size; ``n_model > 1`` raises."""
    if n_model != 1:
        raise ValueError(f"n_model={n_model}: the port has no tensor-parallel layout "
                         "(one card per process); use n_model=1")
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"make_mesh needs n_data = {n_data} ranks, but the group has {world}")
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, group=group)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad with edge values to a multiple; returns ``(padded,
    original_len)``."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width, mode="edge"), n


def shard_batch(mesh: Mesh, batch: dict, *, pad: bool = True, replicate=(),
                device: torch.device | str = "cuda") -> dict:
    """This rank's part of a host batch, as tensors on ``device``.

    JAX's rule decides: every array whose leading dim is at least the data
    axis's size is sharded over it, edge-padded to the next multiple first
    (``pad=True``) or refused with ``ValueError`` (``pad=False``); scalars
    and shorter arrays are replicated. A rank holds only its own shard, so a
    short array that every rank needs whole but the rule would shard (a
    pair's ``pair_idx`` on two ranks) is named in ``replicate``. Nested
    dicts, lists and tuples (the injected ``rands``) follow the same rule
    leaf by leaf; values that are not arrays (Python numbers) pass
    through.
    """
    n_data = mesh.n_data

    def place(k, v):
        if isinstance(v, dict):
            return {kk: place(f"{k}.{kk}", vv) for kk, vv in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(place(f"{k}.{i}", vv) for i, vv in enumerate(v))
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        elif not isinstance(v, np.ndarray):
            return v
        if v.ndim >= 1 and v.shape[0] >= n_data and k not in replicate:
            if v.shape[0] % n_data != 0:
                if not pad:
                    raise ValueError(
                        f"batch[{k!r}] has leading dim {v.shape[0]}, not divisible by the "
                        f"data axis ({n_data}); pass pad=True or use pad_to_multiple + a mask.")
                v, _ = pad_to_multiple(v, n_data)
            share = v.shape[0] // n_data
            v = v[mesh.rank * share:(mesh.rank + 1) * share]
        return torch.as_tensor(v).to(device)

    return {k: place(k, v) for k, v in batch.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@torch.no_grad()
def replicate_state(mesh: Mesh, state):
    """Make every tensor of ``state`` (parameters, the camera, the
    optimizer's moments) rank 0's, in place by ``broadcast``, and return
    it. Host numbers (the step, the optimizer's count) are each rank's own
    and advance alike. A no-op for a single process."""
    if mesh.n_data > 1:
        src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
        for x in _tensors(state):
            dist.broadcast(x, src=src, group=mesh.group)
    return state
