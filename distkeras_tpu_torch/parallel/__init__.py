"""Data parallelism over ``torch.distributed`` (the data group, ZeRO-1,
the multi-process bootstrap), single-device attention (dense, blockwise,
the hook helpers) and the single-device mixture-of-experts layer."""

from distkeras_tpu_torch.parallel.expert_parallel import (
    MoE,
    moe_ffn,
    switch_route,
)
from distkeras_tpu_torch.parallel.mesh import (
    DataMesh,
    ZeroShards,
    all_reduce_mean,
    attach_data_group,
    detach_data_group,
    host_gather,
    local_devices,
    make_mesh,
    replicate,
    shard_batch,
    shard_opt_state_zero,
    zero_leaf_sharding,
)
from distkeras_tpu_torch.parallel.ring_attention import (
    attach_blockwise_attention,
    blockwise_attention,
    dense_attention,
    detach_ring_attention,
)
