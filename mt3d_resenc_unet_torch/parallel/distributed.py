"""Multi-process distribution layer over ``torch.distributed``.

The port of ``mt3d_resenc_unet_tpu/parallel/distributed.py``. JAX runs one
process per host over a mesh of GLOBAL devices, and XLA turns a step
jitted over a sharded global batch into per-device work plus the
collectives. PyTorch runs eagerly, so this module does by hand what XLA
did:

* :func:`initialize` forms the process group from explicit arguments or
  the launchers' environment (JAX's names and torchrun's), over NCCL for
  the card and gloo for the CPU unless the caller names a backend; a group
  that fails to form raises. Each rank drives one device,
  ``cuda:{LOCAL_RANK % device_count}`` (:func:`local_device_index`).
* ``global_mesh`` / ``make_global_batch`` have no counterpart object: the
  process group is the mesh, and the batch a rank loads IS its shard of
  the global batch (:func:`process_batch_slice`); nothing is assembled.
* The step computes the gradient of the GLOBAL batch's loss, as the jitted
  JAX step does. Inside :func:`global_batch` the losses reduce their
  sufficient statistics (sums, Dice's intersections and denominators,
  mask counts) over the ranks with :func:`global_sum`, whose backward is
  the identity, so each rank's gradient is its samples' share of the
  global gradient; :func:`all_reduce_grads` then SUMS the shares in a few
  flat buckets, before the clip. Random draws made per sample (dropout,
  DropPath, the device augmentation) draw for the global batch and keep
  this rank's rows (:func:`global_rows`), so N processes equal one.
* :func:`broadcast_params` is JAX's ``replicate``: rank 0's parameters
  to every rank.
* :func:`is_main_process` / :func:`sync_global_devices`: process 0 writes
  checkpoints, metrics and finals; a barrier orders the rest.

Single-process (no group, or a group of one) every helper is the identity
or a no-op, so the trainer and the engine run one code path.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from typing import Iterable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

# gradients are summed in flat buffers of at most this many bytes
BUCKET_BYTES = 256 * 2 ** 20

# inside global_batch(): the batch in hand is one rank's shard
_GLOBAL_BATCH = contextvars.ContextVar("global_batch", default=False)


def _env(*names: str) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """Form the process group when running multi-process.

    The arguments may come from the caller or from the environment: JAX's
    ``JAX_COORDINATOR_ADDRESS`` / ``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` / ``NUM_PROCESSES``, ``JAX_PROCESS_ID`` /
    ``PROCESS_ID``, or torchrun's ``MASTER_ADDR`` + ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``. ``backend`` defaults to ``nccl`` where CUDA
    is available and ``gloo`` elsewhere; two ranks that share one card
    need ``gloo`` (NCCL refuses two ranks on one device). Returns True when
    more than one process is in the group, False single-process; a group
    that fails to form raises, it never carries on alone."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = coordinator_address or _env("JAX_COORDINATOR_ADDRESS",
                                       "COORDINATOR_ADDRESS")
    if addr is None and _env("MASTER_ADDR") and _env("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        raw = _env("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE")
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = _env("JAX_PROCESS_ID", "PROCESS_ID", "RANK")
        process_id = int(raw) if raw else None
    if addr is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes but no coordinator "
                             "address (JAX_COORDINATOR_ADDRESS or "
                             "MASTER_ADDR/MASTER_PORT)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {addr} given without the number of "
                         "processes and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(local_device_index(process_id))
        kwargs["device_id"] = torch.device("cuda",
                                           local_device_index(process_id))
    dist.init_process_group(
        backend,
        init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Destroy the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on process 0, the only process that writes checkpoints, metric
    files, the final weights and the engine's finals (every rank holds the
    same parameters, so one writer suffices)."""
    return process_index() == 0


def local_device_index(rank: Optional[int] = None) -> int:
    """The CUDA card of this rank: ``LOCAL_RANK`` (else the rank) modulo
    the cards this process sees, so ranks beyond the card count share."""
    raw = _env("LOCAL_RANK")
    local = int(raw) if raw else (process_index() if rank is None else rank)
    return local % max(1, torch.cuda.device_count())


def sync_global_devices(name: str = "sync") -> None:
    """Barrier across all processes (no-op single-process). ``name`` is the
    JAX signature's label of the point; torch's barrier takes none."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[local_device_index()])
    else:
        dist.barrier()


def process_batch_slice(global_batch: int) -> slice:
    """The [start, stop) sample range of the global batch this process
    feeds. ``global_batch`` must divide evenly by the process count
    (callers round up with ``parallel.mesh.pad_batch_to_devices``)."""
    n_proc = process_count()
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count "
            f"{n_proc}")
    per = global_batch // n_proc
    i = process_index()
    return slice(i * per, (i + 1) * per)


# ----------------------------------------------------------------------
# the step over the global batch
# ----------------------------------------------------------------------

@contextlib.contextmanager
def global_batch() -> Iterator[None]:
    """Within: the batch a rank holds is its equal shard of the global
    batch, so :func:`global_sum` reduces over the ranks and
    :func:`global_rows` draws for the global batch. Without a process
    group it changes nothing."""
    token = _GLOBAL_BATCH.set(dist.is_available() and dist.is_initialized())
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_shards() -> int:
    """The number of equal shards the batch in hand is one of: the process
    count inside :func:`global_batch`, else 1."""
    return dist.get_world_size() if _GLOBAL_BATCH.get() else 1


class _GlobalSum(torch.autograd.Function):
    """The sum over the ranks in the forward, the identity in the backward:
    a rank's gradient flows through its own terms only, and the summed
    gradients of all ranks are the gradient of the global statistic."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks inside :func:`global_batch` (a local
    partial sum becomes the global one), else ``x`` itself."""
    return _GlobalSum.apply(x) if _GLOBAL_BATCH.get() else x


def global_rows(n_local: int) -> Tuple[int, slice]:
    """(rows of the global batch, this rank's rows of it) for a per-sample
    draw: draw ``n_global`` rows and keep ``rows``."""
    shards = batch_shards()
    i = process_index() if shards > 1 else 0
    return n_local * shards, slice(i * n_local, (i + 1) * n_local)


def _buckets(tensors: List[torch.Tensor],
             limit: int) -> Iterator[List[torch.Tensor]]:
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > limit
                       or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in flat buckets of at
    most BUCKET_BYTES (one collective a bucket, not one a tensor).
    No-op without a process group. Every rank must hold the same set of
    gradients in the same order (the same model, the same path)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads, BUCKET_BYTES):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def broadcast_params(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank (JAX's ``replicate``);
    no-op without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
