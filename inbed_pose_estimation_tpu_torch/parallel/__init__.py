from .mesh import (
    all_reduce_, all_reduce_numpy, all_reduce_sum, barrier, broadcast_object, gather_rows,
    initialize_distributed, is_initialized, local_rows, pad_to_multiple, rank, replicate,
    same_on_every_rank, shard_batch, shutdown, sync_gradients, world_size,
)

__all__ = [
    "all_reduce_",
    "all_reduce_numpy",
    "all_reduce_sum",
    "barrier",
    "broadcast_object",
    "gather_rows",
    "initialize_distributed",
    "is_initialized",
    "local_rows",
    "pad_to_multiple",
    "rank",
    "replicate",
    "same_on_every_rank",
    "shard_batch",
    "shutdown",
    "sync_gradients",
    "world_size",
]
