"""Data parallelism for waveverify_torch (counterpart of
``waveverify_tpu/parallel``): one process per device over
``torch.distributed``, the batch split over the ranks, parameters and
optimizer state replicated, the gradients averaged after each backward.

A multi-process run calls :func:`initialize_distributed` on each rank
(``python -m waveverify_torch.train --num-devices N`` and ``torchrun`` do),
then trains as one process would: the step functions of
``waveverify_torch.train.step`` reduce where the global batch needs it.
"""

from waveverify_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_object,
    all_gather_rows,
    all_reduce_grads,
    barrier,
    broadcast_object,
    broadcast_tensors,
    destroy,
    global_mean,
    global_means,
    global_sum,
    initialize_distributed,
    is_active,
    make_mesh,
    rank,
    rank_device,
    spawn,
    world_size,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "all_gather_object",
    "all_gather_rows",
    "all_reduce_grads",
    "barrier",
    "broadcast_object",
    "broadcast_tensors",
    "destroy",
    "global_mean",
    "global_means",
    "global_sum",
    "initialize_distributed",
    "is_active",
    "make_mesh",
    "rank",
    "rank_device",
    "spawn",
    "world_size",
]
