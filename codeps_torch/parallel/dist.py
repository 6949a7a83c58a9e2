"""Data parallelism over processes.

Counterpart of ``codeps_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a device mesh: the batch is sharded over the ``data``
axis, the parameters are replicated, and XLA reduces every batch
statistic over the global batch. The port runs one process per card
under ``torch.distributed`` (``python -m torch.distributed.run``), and
this module holds what those processes share:

  - the process group, made from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) by
    ``process_group``, with the rank's device;
  - the rank, the world and ``shard_rows``, a rank's rows of a global
    batch;
  - the collectives, differentiable where a gradient crosses them.

Every rank holds the same modules (a seeded initialization), takes an
equal share of the global batch and computes each batch statistic over
the global batch where it is computed: BatchNorm's train statistics
(``models/resnet.py``), the semantic top-k threshold (``ops/topk.py``),
the flow head's auto-mask mean, the confusion matrix and the depth
metrics. A loss that is a mean over the rank's rows stays a local mean;
``average_gradients`` then gives every rank the gradient of the global
batch's loss.

A gradient that reaches a rank through a collective is the sum over the
ranks of their losses' gradients (the backward of ``all_gather`` and
``all_reduce`` sums), so a term that every rank computes from gathered
values (the global top-k mean) reaches each rank's inputs ``world``
times; ``average_gradients`` divides by the world, which gives that term
once and each rank's local mean its share.

Outside a process group, or inside ``replicated()``, every function here
is the single-process answer: the reductions are the identity.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Iterator

import torch
import torch.distributed as dist

from codeps_torch.device import resolve_device

# set by ``replicated()``: every rank computes the same whole batch
_REPLICATED = {"on": False}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    """The number of processes; 1 outside a process group."""
    return dist.get_world_size() if initialized() else 1


def is_lead() -> bool:
    """Whether this process writes files (rank 0)."""
    return rank() == 0


def active() -> bool:
    """Whether batch statistics reduce over the ranks: inside a process
    group and outside ``replicated()``."""
    return initialized() and not _REPLICATED["on"]


def group_size() -> int:
    """The ranks a batch statistic reduces over: the world while
    ``active()``, else 1."""
    return world_size() if active() else 1


@contextlib.contextmanager
def replicated() -> Iterator[None]:
    """Within the block every rank computes the same whole batch, so the
    reductions stay local (the JAX package replicates a validation batch
    that does not divide over the mesh)."""
    before = _REPLICATED["on"]
    _REPLICATED["on"] = True
    try:
        yield
    finally:
        _REPLICATED["on"] = before


def shard_rows(rows: int, index: int | None = None,
               count: int | None = None) -> slice:
    """The contiguous rows of rank ``index`` of ``count`` in a global batch
    of ``rows``, which must divide: every rank holds the same number of
    rows, as the collectives of a step need. By default this rank of
    ``group_size()`` (the whole batch under ``replicated()``)."""
    if index is None:
        index = rank() if active() else 0
    count = group_size() if count is None else count
    if rows % count:
        raise ValueError(f"{rows} rows do not divide over {count} ranks")
    per_rank = rows // count
    return slice(index * per_rank, (index + 1) * per_rank)


def torchrun_env() -> tuple[int, int, int] | None:
    """(rank, world size, local rank) from torchrun's environment, or None
    when the process was not started by it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    global_rank = int(os.environ["RANK"])
    return (global_rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", global_rank)))


def rank_device(device: str | torch.device | None,
                local_rank: int) -> torch.device:
    """The device of a rank: a CUDA device without an index is card
    ``local_rank``, which must exist; an explicit ``cuda:K`` puts every
    rank on card K; the CPU stays the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"local rank {local_rank} needs card "
                           f"cuda:{local_rank}, but {count} are visible")
    return torch.device("cuda", local_rank)


def default_backend(device: str | torch.device | None) -> str:
    """NCCL for ranks on cards of their own (``cuda`` without an index),
    gloo for the CPU and for ranks that share a card (an explicit
    ``cuda:K``): NCCL refuses two ranks on one card."""
    dev = torch.device("cuda" if device is None else device)
    return "nccl" if dev.type == "cuda" and dev.index is None else "gloo"


@contextlib.contextmanager
def process_group(device: str | torch.device | None = None
                  ) -> Iterator[torch.device]:
    """Joins the process group that torchrun's environment describes for
    the block, over ``default_backend(device)``, and yields this rank's
    device (``rank_device``). Without that environment, or inside a group
    made elsewhere, it yields the device and makes no group."""
    env = torchrun_env()
    if env is None or initialized():
        yield resolve_device(device)
        return
    global_rank, world, local_rank = env
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(default_backend(device),
                            init_method="env://", rank=global_rank,
                            world_size=world)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def global_normal(shape, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """This rank's rows of a standard-normal draw from ``generator`` at the
    global batch's shape (``shape[0] * group_size()`` rows): N ranks whose
    generators are in the same state draw what one process draws."""
    rows = shape[0] * group_size()
    draw = torch.randn((rows, *shape[1:]), generator=generator,
                       device=device)
    return draw[shard_rows(rows)]


def barrier() -> None:
    """Waits for every rank (after a write that others read)."""
    if initialized():
        dist.barrier()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[dist.get_rank()]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(group_size(), *x.shape): every rank's ``x``, which must have the
    same shape on each. Differentiable: a rank's input gets the sum over
    the ranks of the gradients of its slice."""
    if not active():
        return x[None]
    return _AllGather.apply(x)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks. Differentiable: the gradient is
    summed over the ranks too."""
    if not active():
        return x
    return _AllReduce.apply(x)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks: the global batch's value of a
    mean over each rank's equal share."""
    return all_reduce(x) / group_size()


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if not active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def average_gradients(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its mean over the ranks, in
    one all-reduce of the flattened gradients, so that every rank takes
    the same optimizer step. A parameter that no rank gave a gradient
    keeps none."""
    _reduce_gradients(parameters, average=True)


def sum_gradients(parameters: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its sum over the ranks, in one
    all-reduce of the flattened gradients: the gradient of the sum of the
    ranks' losses (the row split's shares, ``parallel/spatial.py``). A
    parameter that no rank gave a gradient keeps none."""
    _reduce_gradients(parameters, average=False)


def _reduce_gradients(parameters, average: bool) -> None:
    """Every rank sends the same layout: each parameter that requires a
    gradient (zeros where this rank has none: a row split's rank with
    empty slabs may reach fewer parameters than the others), then a flag
    a parameter, 1 where this rank has a gradient. A parameter gets the
    reduced gradient where any rank had one."""
    if not active():
        return
    params = [p for p in parameters if p.requires_grad]
    if not params:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flags = torch.tensor([p.grad is not None for p in params],
                         dtype=grads[0].dtype, device=grads[0].device)
    flat = torch.cat([g.reshape(-1) for g in grads] + [flags])
    dist.all_reduce(flat)
    if average:
        flat /= dist.get_world_size()
    # the flags reach the host only where this rank lacks a gradient
    held = ((flat[-len(params):] > 0).tolist()
            if any(p.grad is None for p in params) else [True] * len(params))
    offset = 0
    for param, grad, has in zip(params, grads, held):
        part = flat[offset:offset + grad.numel()].view_as(grad)
        if param.grad is not None:
            grad.copy_(part)
        elif has:
            param.grad = part.clone()
        offset += grad.numel()
