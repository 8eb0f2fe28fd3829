"""Runtime initialization: port of ``scnerf_tpu/distributed/init.py``.

The JAX package calls ``jax.distributed.initialize``; here
:func:`initialize_runtime` joins a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU) from an explicit address, world size
and rank, and leaves a single process uninitialised, as JAX's no-op does.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def initialize_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> dict:
    """Join the process group and return the topology.

    Args:
      coordinator_address: ``"host:port"`` of rank 0's store (as JAX's), or
        a URL (``tcp://host:port``, ``file:///path``). Without it, a run of
        ``num_processes > 1`` reads ``MASTER_ADDR``/``MASTER_PORT`` from the
        environment (``env://``), and a single process stays uninitialised.
      num_processes, process_id: the world size and this process's rank.
      backend: ``"nccl"`` or ``"gloo"``; by default NCCL when a card is
        visible, else gloo. With NCCL each rank takes card
        ``process_id % device_count``.
      timeout_s: the group's timeout for collectives and the rendezvous.
    Returns:
      ``process_index``, ``process_count``, ``local_devices`` (the devices
      this process drives: one) and ``global_devices`` (one per process).
    """
    if not dist.is_initialized():
        url = None
        if coordinator_address is not None:
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
        elif num_processes not in (None, 1):
            url = "env://"
        if url is not None:
            backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
            rank = process_id or 0
            if backend == "nccl":
                torch.cuda.set_device(rank % torch.cuda.device_count())
            kwargs = {}
            if timeout_s is not None:
                kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
            dist.init_process_group(backend, init_method=url, world_size=num_processes or 1,
                                    rank=rank, **kwargs)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def is_coordinator() -> bool:
    """Rank 0, or a process outside any group (the reference's ``rank ==
    0`` logging and checkpoint gates)."""
    return not dist.is_initialized() or dist.get_rank() == 0
