"""Data-parallel training over processes, the counterpart of
``histogan_tpu/parallel/mesh.py``.

The JAX package jits the step over a 1-D ``('data',)`` mesh: the batch
is sharded, the state replicated, and XLA inserts the gradient ``psum``.
Here each process (rank, one per GPU, launched by ``torchrun``) holds the
whole state and computes its slice ``[rank * b, (rank + 1) * b)`` of the
global batch, and the step reduces across ranks by hand:

- ``all_reduce_mean_`` averages each phase's gradients (one coalesced
  ``all_reduce`` of a flat buffer per dtype) before DiffGrad;
- ``global_sum`` is a differentiable all-reduce (its backward sums the
  cotangents over the ranks too), through which the losses that are not
  per-sample means (the Hellinger loss's norm over the whole batch, the
  path length's std over the batch, the variance loss's batch sum) take
  the global batch's value on every rank;
- ``mean_across_ranks`` averages the metrics and the path length, and
  ``sum_across_ranks_`` the VQ codebook's batch statistics;
- ``all_gather`` and ``reduce_scatter`` move flat buffers for the sharded
  state (``parallel/fsdp.py``) and the sharded device dataset.

So N ranks compute what one process computes on the global batch, as
GSPMD does, up to the order of the sums. ``DistributedDataParallel`` is not
used: its reducer fires on ``.backward()``, which the port never calls
(it takes gradients with ``torch.autograd.grad``), and it does not support
the gradient penalty's double backward.

Every helper is the identity at world size 1 (no process group), so a
single process runs exactly the code it ran before.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torchrun's variables; without them maybe_initialize_distributed does nothing
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank())) if is_distributed() else 0


def is_main() -> bool:
    """The rank that writes files (``jax.process_index() == 0``)."""
    return rank() == 0


def maybe_initialize_distributed(backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the env
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a no-op without them, or when a group exists. The
    backend follows the device that training will use: NCCL for a CUDA
    device when CUDA is available, else gloo (``backend`` overrides: gloo
    also reduces CUDA tensors, and puts several ranks on one GPU, which
    NCCL refuses). Call it first, before any CUDA work. Returns whether a
    group exists. A failed initialisation raises."""
    if is_distributed():
        return True
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return False
    on_cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    backend = backend or ("nccl" if on_cuda else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


def resolve_num_devices(num_devices: Optional[int]) -> int:
    """The trainers' ``num_devices``: the world size. None takes it; a
    number must equal it, and more than one needs a process group."""
    n = world_size()
    if num_devices is None:
        return n
    num_devices = int(num_devices)
    if not is_distributed() and num_devices > 1:
        raise ValueError(
            f"num_devices={num_devices} runs one process per GPU: launch with "
            f"`torchrun --nproc_per_node {num_devices} -m histogan_tpu_torch.cli.histogan ... "
            f"--num_devices {num_devices}` (from Python, call "
            f"histogan_tpu_torch.parallel.maybe_initialize_distributed() first)")
    if num_devices != n:
        raise ValueError(f"num_devices={num_devices} but the process group has {n} ranks")
    return n


def train_device(device) -> torch.device:
    """``cuda:{LOCAL_RANK}`` for a plain ``"cuda"`` in a process group (one
    GPU per rank); any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        return torch.device("cuda", local_rank())
    return dev


def local_shard_info(global_batch: int) -> Tuple[int, int, int]:
    """(local batch, shard index, number of shards) of this rank's slice of
    ``global_batch``; a batch the ranks do not divide raises."""
    n = world_size()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the {n} data-parallel ranks; "
            f"pick a per-step batch that is a multiple of {n} (or launch fewer ranks)")
    return global_batch // n, rank(), n


def local_slice(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along its batch dimension ``dim``."""
    if world_size() == 1:
        return x
    b, r, _ = local_shard_info(x.shape[dim])
    return x.narrow(dim, r * b, b)


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def _all_reduce_(tensors: Sequence[torch.Tensor], divide_by: int = 1) -> None:
    """Sum ``tensors`` in place across the ranks, then divide them by
    ``divide_by``: one ``all_reduce`` of a flat buffer per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if divide_by != 1:
            flat.div_(divide_by)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def _host_staged(x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` copies it through the host: a CUDA
    tensor on gloo, which does not run every collective on CUDA tensors
    (``all_gather_into_tensor`` and the reduce-scatter among them)."""
    return x.is_cuda and dist.get_backend() == "gloo"


def all_gather(flat: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``flat`` (equal sizes), concatenated in rank order:
    one all-gather; ``flat`` itself at world size 1."""
    n = world_size()
    if n == 1:
        return flat
    x = flat.cpu() if _host_staged(flat) else flat
    out = x.new_empty((n * x.numel(),))
    dist.all_gather_into_tensor(out, x.contiguous())
    return out.to(flat.device)


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """Chunk ``rank()`` of the sum over the ranks of the 1-D ``flat``, whose
    size the ranks divide: one reduce-scatter; ``flat`` itself at world
    size 1."""
    n = world_size()
    if n == 1:
        return flat
    x = flat.cpu() if _host_staged(flat) else flat
    out = x.new_empty((x.numel() // n,))
    dist.reduce_scatter_tensor(out, x.contiguous())
    return out.to(flat.device)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` (a phase's gradients) in place across the ranks:
    XLA's ``psum`` over 'data', then the mean's scale."""
    if world_size() > 1:
        _all_reduce_(tensors, world_size())


def sum_across_ranks_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` in place across the ranks (no gradient)."""
    if world_size() > 1:
        _all_reduce_(tensors)


def mean_across_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (no gradient); ``x`` itself at
    world size 1."""
    n = world_size()
    if n == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / n


def mean_metrics_across_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each 0-d metric averaged over the ranks, in one ``all_reduce``;
    ``metrics`` itself at world size 1."""
    if world_size() == 1:
        return metrics
    names = sorted(metrics)
    means = mean_across_ranks(torch.stack([metrics[k].float() for k in names]))
    return dict(zip(names, means.unbind()))


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the cotangent:
    every rank's loss reads the global sum, so the sum's cotangent on a
    rank is the sum of all ranks' cotangents."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _GlobalSum.apply(grad)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks; ``x`` at world size 1."""
    return x if world_size() == 1 else _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of all entries of ``x`` over every rank's ``x`` (equal
    shapes), differentiable; ``torch.mean(x)`` at world size 1."""
    n = world_size()
    if n == 1:
        return torch.mean(x)
    return global_sum(torch.sum(x)) / (x.numel() * n)


def batch_var(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The unbiased variance over the global batch along ``dim`` (kept),
    differentiable; ``torch.var`` at world size 1."""
    n = world_size()
    if n == 1:
        return torch.var(x, dim=dim, keepdim=True, correction=1)
    count = x.shape[dim] * n
    mean = global_sum(x.sum(dim=dim, keepdim=True)) / count
    return global_sum(torch.square(x - mean).sum(dim=dim, keepdim=True)) / (count - 1)
