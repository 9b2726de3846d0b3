"""Data parallelism over `torch.distributed`: one process per card."""

from .dist import (all_reduce_sum, barrier, bf16_grad_sync_hook, gather_predictions,
                   global_count, init_distributed, is_main_process, mean_over_ranks,
                   process_count, process_index)
from .mesh import (Mesh, batch_sharding, make_mesh, pad_to_multiple, replicate,
                   replicated, shard_batch)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_batch",
           "replicate", "pad_to_multiple", "init_distributed",
           "is_main_process", "process_count", "gather_predictions",
           "Mesh", "process_index", "barrier", "all_reduce_sum", "global_count",
           "mean_over_ranks", "bf16_grad_sync_hook"]
