"""Parallelism of the port: process groups for data-parallel training, device
lists for data-parallel and time-sharded serving."""

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
from academicodec_tpu_torch.parallel.sequence import (
    TimeShardedSoundStream,
    TimeShardedVQVAE,
    TimeShards,
    halo_exchange,
    time_blocks,
)

__all__ = [
    "all_gather_rows", "all_reduce_mean_grads", "all_reduce_mean_metrics", "all_reduce_sum_", "init_from_env", "microbatches",
    "missing_torchrun_env", "module_replicas", "rank", "replicate", "serving_devices", "shard_batch",
    "split_rows", "world_size", "TimeShardedSoundStream", "TimeShardedVQVAE", "TimeShards", "halo_exchange",
    "time_blocks",
]
