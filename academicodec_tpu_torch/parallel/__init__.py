"""Data parallelism of the port: process groups for training, device lists for serving."""

from academicodec_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_mean_grads,
    all_reduce_mean_metrics,
    all_reduce_sum_,
    init_from_env,
    microbatches,
    missing_torchrun_env,
    module_replicas,
    rank,
    replicate,
    serving_devices,
    shard_batch,
    split_rows,
    world_size,
)

__all__ = [
    "all_gather_rows", "all_reduce_mean_grads", "all_reduce_mean_metrics", "all_reduce_sum_", "init_from_env", "microbatches",
    "missing_torchrun_env", "module_replicas", "rank", "replicate", "serving_devices", "shard_batch",
    "split_rows", "world_size",
]
