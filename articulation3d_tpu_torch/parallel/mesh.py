"""Data-parallel layout over the process group: who holds which rows.

Counterpart of `articulation3d_tpu/parallel/mesh.py`.  JAX runs one SPMD
program over a 1-D device mesh, shards the batch along it and replicates
the parameters; XLA inserts the gradient psum.  Here each card is its own
process (`torch.distributed`, `parallel/dist.py`) and DistributedDataParallel
all-reduces the gradients, so each JAX object has a process-group
counterpart:

  * `make_mesh` -> a `Mesh` record of the world group: this process's
    rank and the number of processes (the mesh size);
  * `batch_sharding(mesh, n)` -> the slice of a global batch of `n` rows
    that this rank holds: contiguous, rank-major, as a 1-D `data`-axis
    sharding lays rows out;
  * `shard_batch` -> this rank's rows of every array of a host batch;
  * `replicated(mesh)` -> the rank every replica is copied from (0), and
    `replicate` -> a broadcast of tensors from that rank (DDP does the same
    for the model's parameters and buffers when it wraps them);
  * `pad_to_multiple` is the JAX function unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from .dist import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data-parallel world: `rank` of `size` processes."""

    rank: int = 0
    size: int = 1


def make_mesh() -> Mesh:
    """The world of the current process group (a mesh of one without one)."""
    return Mesh(rank=process_index(), size=process_count())


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a global batch of `n`; `n` must be a
    multiple of the mesh size (pad with `pad_to_multiple`)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} processes")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh) -> int:
    """The source rank of replicated values."""
    return 0


def shard_batch(mesh: Mesh, batch: Dict[str, Any], axis: int = 0) -> Dict[str, Any]:
    """This rank's slice, along `axis`, of every array or tensor of a
    global host batch (other entries are kept whole)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            rows = batch_sharding(mesh, v.shape[axis])
            index = (slice(None),) * axis + (rows,)
            out[k] = v[index]
        else:
            out[k] = v
    return out


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every tensor of a module, state dict, list or tensor from
    `replicated(mesh)` in place; returns `tree`."""
    if mesh.size == 1:
        return tree
    src = replicated(mesh)
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        tensors = list(tree)
    else:
        tensors = [tree]
    with torch.no_grad():
        for t in tensors:
            if torch.is_tensor(t):
                dist.broadcast(t.data, src)
    return tree


def pad_to_multiple(batch: Dict[str, np.ndarray], multiple: int
                    ) -> tuple[Dict[str, np.ndarray], int]:
    """Pad the leading axis of every array to a multiple of the mesh size.

    Returns (padded batch, original length) so callers can trim outputs.
    Video clips rarely divide the device count evenly; padding with repeats
    of the last frame keeps shapes static across steps.
    """
    n = next(iter(batch.values())).shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], rem, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, n
