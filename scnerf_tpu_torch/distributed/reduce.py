"""The reductions of a data-parallel train step.

Under :func:`data_parallel` each rank computes the loss on its shard of the
batch, and every term of it is made the *global* value with the rank's
*share* of the gradient: the ranks' gradients then sum to the gradient of
the loss over the whole batch, which :func:`all_reduce_grads` forms. The
losses ask for two reductions here:

- :func:`batch_mean`, a mean over the batch, which shards in equal parts
  (``shard_batch`` pads it): the rank's share is its own mean over the
  world size; a value every rank holds whole (a 0-d autoexpo scale) gives
  each rank a share of ``1 / world``;
- :func:`global_count` with :func:`share`, a masked mean: the rank's masked
  sum over the count of the whole batch (PRD's valid matches, NeRF++'s
  masked pixels), so that unequal counts on the ranks weigh as in one batch.

Outside the scope (and at world size 1) both are the plain expressions, bit
for bit.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_group = None
_world = 1


@contextlib.contextmanager
def data_parallel(group):
    """Reduce over the process group ``group`` inside the block."""
    global _group, _world
    prev = _group, _world
    _group, _world = group, dist.get_world_size(group)
    try:
        yield
    finally:
        _group, _world = prev


def _summed(x: torch.Tensor) -> torch.Tensor:
    total = x.detach().clone()
    dist.all_reduce(total, group=_group)
    return total


def share(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with the gradient of this rank's
    ``x`` alone; ``x`` itself outside the scope."""
    if _group is None:
        return x
    return x + (_summed(x) - x.detach())


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the ranks."""
    return count if _group is None else _summed(count)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` over the batch of all ranks, as :func:`share` of
    this rank's mean over the world size."""
    mean = torch.mean(x)
    return mean if _group is None else share(mean / _world)


def all_reduce_grads(grads: dict, group) -> dict:
    """Every gradient summed over ``group``, in one flat ``all_reduce``;
    ``None`` entries (leaves the loss does not reach) stay ``None``."""
    present = [k for k, g in grads.items() if g is not None]
    if not present:
        return grads
    flat = torch.cat([grads[k].reshape(-1) for k in present])
    dist.all_reduce(flat, group=group)
    out = dict(grads)
    offset = 0
    for k in present:
        n = grads[k].numel()
        out[k] = flat[offset:offset + n].view_as(grads[k])
        offset += n
    return out
