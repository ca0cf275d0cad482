"""Data parallelism over ``torch.distributed`` (counterpart of
``waveverify_tpu/parallel/mesh.py``).

The JAX package's sharded train step is one program over the global batch:
the batch is split over a ``("data",)`` mesh, parameters and optimizer
state are replicated, and XLA inserts the gradient all-reduce, so N devices
compute what one device computes on the whole batch. Here one process
(rank) drives one device and holds its own rows of the global batch; the
step makes the same program by hand:

- after each ``backward()`` the gradients are averaged over the ranks
  (:func:`all_reduce_grads`, flattened buckets, ``SUM`` then ``/ world``),
  before the clip, so every rank clips and steps on the global gradient;
- a loss that is a ratio of sums over the batch takes its denominator from
  :func:`global_sum`; the scalar losses and metrics the step reports are
  :func:`global_mean` s;
- every random draw is made for the global batch from one seed and each
  rank keeps its rows (``train.watermarking.Draws.rows``).

So the JAX package's ``shard_train_step`` / ``shard_disc_step`` /
``shard_multi_step`` have no counterpart: the step functions reduce where
the program needs it. Nor do ``shard_batch`` / ``shard_stacked_batch`` /
``local_batch_rows``: a rank already holds exactly its own rows, and its
per-sample metrics are those rows' (what ``local_batch_rows`` fetches).

Everything here is a no-op without a process group: one process computes
what it computed before. A process group of one rank reduces (a copy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# Longer than process 0's validation plus checkpoint, which the other ranks
# wait out at a barrier: the JAX loop's barrier timeout (1800 s).
DEFAULT_TIMEOUT = timedelta(seconds=1800)
# Gradient bucket size (DDP's default).
BUCKET_BYTES = 25 * 1024 * 1024


def is_active() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> torch.device:
    """Join the process group of a multi-process run and return this rank's
    device.

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the rendezvous
    (``coordinator_address`` is ``host:port``). One process is a no-op.
    The group's timeout (``DEFAULT_TIMEOUT``) outlasts rank 0's validation
    and checkpoint, which the other ranks wait out at a barrier. The
    backend is ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``; a caller that
    wants another (gloo on ``cuda`` lets two ranks share a card, which
    NCCL refuses) joins the group with ``torch.distributed`` first, and
    the rank is then only bound to its card. On ``cuda`` the rank is bound
    to ``cuda:LOCAL_RANK``, or to the index ``device`` names; a rank with
    no card of its own raises, naming both counts."""
    dev = torch.device(device)
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return dev
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else int(os.environ.get("LOCAL_RANK", process_id)))
        count = torch.cuda.device_count()
        if index >= count:
            raise ValueError(f"rank {process_id} on cuda:{index} needs "
                             f"{index + 1} CUDA devices, {count} visible")
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    if is_active():
        return dev
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=DEFAULT_TIMEOUT)
    return dev


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """The device a rank runs on: a ``cuda`` without an index is the card
    :func:`initialize_distributed` bound the rank to."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_active():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A one-axis ``("data",)`` mesh over the ranks: ``size`` replicas,
    this process holding replica ``index`` on ``device``."""

    size: int
    index: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA_AXIS,)

    def rows(self, batch: int) -> Tuple[int, int]:
        """This replica's rows ``[lo, hi)`` of a global batch; raises
        unless ``batch`` divides over the mesh."""
        if batch % self.size:
            raise ValueError(f"batch_size {batch} must divide over {self.size} "
                             "devices")
        per = batch // self.size
        return self.index * per, (self.index + 1) * per


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """The data mesh over the ranks of the process group (one without
    one), this rank on ``device`` (its card unless the caller names the
    CPU). ``n_devices`` must equal the number of ranks: fewer ranks raise
    the JAX package's error, more raise naming both counts."""
    size = world_size()
    if n_devices is not None:
        if size < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {size} (start one process "
                f"per device: torchrun --nproc_per_node {n_devices}, or the "
                f"trainer's --num-devices {n_devices} outside torchrun)")
        if size > n_devices:
            raise ValueError(f"{size} processes joined the group for a mesh of "
                             f"{n_devices} devices")
    return Mesh(size, rank(), rank_device(device))


def barrier() -> None:
    """Wait for every rank (no-op without a process group); waits up to
    the group's timeout."""
    if is_active():
        dist.barrier()


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int
             ) -> List[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device, each up to
    ``bucket_bytes`` (a larger tensor is a bucket of its own)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        last = out[-1] if out else None
        if (last is None or last[0].dtype != t.dtype or last[0].device != t.device
                or size + nbytes > bucket_bytes):
            out.append([t])
            size = nbytes
        else:
            last.append(t)
            size += nbytes
    return out


def _flat_apply(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` on each bucket of ``tensors`` flattened, and copy
    the result back (``copy_``, which moves each tensor's version)."""
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the gradients of ``params`` over the ranks, in place:
    ``all_reduce(SUM) / world`` on flattened buckets. Call it after each
    ``backward()`` and before any clip, so the clip sees the global
    gradient. A parameter without a gradient is skipped (it has none on
    any rank: the ranks run the same code). No-op without a group."""
    if not is_active():
        return
    n = world_size()
    grads = [p.grad for p in params if p.grad is not None]

    def reduce(flat):
        dist.all_reduce(flat)
        flat.div_(n)

    with torch.no_grad():
        _flat_apply(grads, reduce)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, detached (a new tensor; ``t``
    itself without a group)."""
    if not is_active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, detached (``t`` without a
    group). Over equal shards, the mean of per-rank batch means is the
    global batch's mean."""
    if not is_active():
        return t
    return global_sum(t) / world_size()


def global_means(metrics: dict, names: Iterable[str]) -> dict:
    """``metrics`` with each 0-d tensor named in ``names`` replaced by its
    :func:`global_mean`, in one collective."""
    names = [k for k in names if k in metrics]
    if not is_active() or not names:
        return metrics
    means = global_mean(torch.stack([metrics[k].detach() for k in names]))
    return {**metrics, **{k: means[i] for i, k in enumerate(names)}}


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (each of the same shape), concatenated along dim
    0 in rank order: the global batch of a per-rank input. Detached; ``t``
    without a group."""
    if not is_active():
        return t
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.detach().contiguous())
    return torch.cat(parts)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order; ``[obj]`` without
    a group."""
    if not is_active():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s values, in place, in
    flattened buckets; raises first when the ranks' lists differ in shape
    or dtype. No-op without a group."""
    if not is_active():
        return
    layout = [(tuple(t.shape), str(t.dtype)) for t in tensors]
    layouts = all_gather_object(layout)
    for r, other in enumerate(layouts):
        if other != layouts[src]:
            raise RuntimeError(f"rank {r} holds other tensors than rank {src}: "
                               f"{len(other)} vs {len(layouts[src])} tensors, or "
                               "their shapes or dtypes differ")
    with torch.no_grad():
        _flat_apply(list(tensors), lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if not is_active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def destroy() -> None:
    """Leave the process group, if any."""
    if is_active():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_threads() -> int:
    """A spawned rank's CPU threads: ``OMP_NUM_THREADS`` when it is set,
    else one, as torchrun gives each of several ranks."""
    return int(os.environ.get("OMP_NUM_THREADS") or 1)


def _spawned(index: int, target: Tuple[str, str], n: int, port: int,
             args: tuple) -> None:
    import importlib

    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(rank_threads())
    module, name = target
    getattr(importlib.import_module(module), name)(*args)


def spawn(fn, n: int, *args) -> None:
    """Run ``fn(*args)`` in ``n`` fresh processes, rank ``i`` with
    torchrun's environment (``RANK`` = ``LOCAL_RANK`` = i, ``WORLD_SIZE``
    = n, a rendezvous on localhost) and :func:`rank_threads` CPU threads
    (``OMP_NUM_THREADS``, else one, as torchrun), and wait for all of
    them. A rank that raises ends the others, and its error is raised here
    (``torch.multiprocessing.ProcessRaisedException``). ``fn`` must be a
    module-level function; the ranks import it by name (from the module
    ``python -m`` ran, when it lives there)."""
    import sys

    import torch.multiprocessing as mp

    module = fn.__module__
    if module == "__main__":
        module = sys.modules["__main__"].__spec__.name
    mp.start_processes(_spawned, args=((module, fn.__name__), n, free_port(), args),
                       nprocs=n, join=True, start_method="spawn")
