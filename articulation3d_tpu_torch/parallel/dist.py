"""Process-group runtime: init, rank queries, gathers and all-reduces.

Counterpart of `articulation3d_tpu/parallel/dist.py` in PyTorch's idiom:
one process per card joined by `torch.distributed` (NCCL on the cards,
gloo on the CPU or for several ranks on one card), the reference's d2
`launch` contract (`tools/train_net.py:107-117` there).  Without a process
group every helper here is the one-process identity, so one-process runs
take exactly the code path they took before data parallelism existed.
"""

from __future__ import annotations

import itertools
import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(dist_url: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group; returns whether one was formed.

    The arguments fall back to torchrun's environment (`MASTER_ADDR` /
    `MASTER_PORT` as `tcp://addr:port`, `WORLD_SIZE`, `RANK`), as the JAX
    package falls back to `JAX_*`; with neither it is a no-op (one
    process).  `dist_url` is any `init_method` (`tcp://host:port`,
    `file:///path`).  Unless `backend` is "gloo" (a CPU run), a machine
    with cards makes card `LOCAL_RANK` (else the rank) modulo the number of
    cards this process's current device.  The backend defaults to NCCL
    when every rank on the host has its own card and to gloo
    otherwise: without cards, or with more ranks than cards (NCCL refuses
    two ranks on one device).  The ranks on the host are
    `LOCAL_WORLD_SIZE` (torchrun sets it; set it when the processes span
    several hosts), else all of them.  A group that fails to form raises.
    Call before anything touches the card."""
    if dist.is_initialized():
        return True
    if dist_url is None and "MASTER_ADDR" in os.environ:
        dist_url = (f"tcp://{os.environ['MASTER_ADDR']}:"
                    f"{os.environ.get('MASTER_PORT', '29500')}")
    if dist_url is None:
        return False
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("a process group needs the number of processes and this "
                         "process's rank (arguments or WORLD_SIZE / RANK)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    on_cards = backend != "gloo" and n_cards > 0
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        backend = "nccl" if local_world <= n_cards else "gloo"
    if on_cards:
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=dist_url, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def gather_predictions(predictions: List) -> List:
    """All-gather every process's list of picklable predictions and chain
    them in rank order (JAX `process_allgather` of the pickled lists; the
    reference's `comm.gather`, `evaluation/arti_evaluation.py:193-200`)."""
    if process_count() == 1:
        return list(predictions)
    gathered: List = [None] * process_count()
    dist.all_gather_object(gathered, list(predictions))
    return list(itertools.chain(*gathered))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks' output
    gradients: each rank's loss is its share of the global loss, so the
    global loss's gradient with respect to a rank's input sums every rank's
    share."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, differentiable (the identity, and `x`
    itself, without a group)."""
    if process_count() == 1:
        return x
    return _AllReduceSum.apply(x)


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A detached count or normaliser summed over the ranks (`x` itself
    without a group)."""
    if process_count() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def mean_over_ranks(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' mean of each float32 tensor, in one all-reduce of their
    concatenation: the sum, then over W, as JAX's `psum(flat) / n_dev`
    (the tensors themselves without a group)."""
    if process_count() == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    flat = flat / torch.tensor(float(process_count()), device=flat.device)
    return [v.reshape(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]),
                                               tensors)]


def bf16_grad_sync_hook(process_group, bucket) -> torch.futures.Future:
    """DDP communication hook of `solver.grad_sync_dtype: bfloat16` (the
    `Trainer` registers it; any other value keeps DDP's float32 mean), in the
    order of JAX's sharded step (`train_step.py:288-302`): the bucket over
    W in float32, cast to bfloat16, summed over the ranks in bfloat16, and
    cast back to float32.  (torch's `bf16_compress_hook` casts first and
    divides in bfloat16, which rounds differently where W is not a power of
    two.)  The divisor is a tensor on the bucket's device: a CUDA division
    by a Python scalar multiplies by its float32 reciprocal instead."""
    group = process_group if process_group is not None else dist.group.WORLD
    buf = bucket.buffer()
    world = torch.tensor(float(dist.get_world_size(group)), device=buf.device)
    half = (buf / world).to(torch.bfloat16)
    fut = dist.all_reduce(half, group=group, async_op=True).get_future()

    def unpack(f):
        buf.copy_(f.value()[0])
        return buf

    return fut.then(unpack)
