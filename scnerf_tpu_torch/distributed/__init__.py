"""Data parallelism on ``torch.distributed``: port of ``scnerf_tpu/distributed``.

Each rank drives one device and holds its contiguous shard of every ray
batch (:func:`shard_batch`); the state is the same on every rank
(:func:`replicate_state`), and the train steps built with ``group=`` reduce
every trainable leaf's gradient over the ranks, the camera's included
(:mod:`.reduce`). The JAX package's tensor-parallel layout
(``model_parallel_mlp_sharding``) has no counterpart: the port runs one card
per process.
"""
from scnerf_tpu_torch.distributed.init import initialize_runtime, is_coordinator
from scnerf_tpu_torch.distributed.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, pad_to_multiple, replicate_state, shard_batch,
)
