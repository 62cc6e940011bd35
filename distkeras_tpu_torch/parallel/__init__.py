"""Data parallelism over ``torch.distributed`` (the data group, ZeRO-1,
the multi-process bootstrap), the 2-D grids of tensor, sequence, expert
and pipeline parallelism (``mesh.GridMesh``, ``tensor_parallel``, the
ring and Ulysses attention, the expert mesh, ``pipeline_parallel``), the
3-D pipeline x data x tensor grid (``mesh.Grid3D``), the backend
bootstrap of the examples (``backend.setup_backend``), the
serving mesh (``serving_mesh``, ``shard_decode_params``),
single-device attention (dense, blockwise, the hook helpers) and the
mixture-of-experts layer. JAX's ``force_cpu_mesh``, ``batch_sharding``
and ``replicated_sharding`` have no counterpart: they make JAX sharding
objects over virtual devices, and the port's ranks are processes."""

from distkeras_tpu_torch.parallel.expert_parallel import (
    MoE,
    attach_expert_mesh,
    detach_expert_mesh,
    moe_ffn,
    shard_moe_params,
    switch_route,
)
from distkeras_tpu_torch.parallel.mesh import (
    DataMesh,
    Grid3D,
    GridMesh,
    ServingMesh,
    ZeroShards,
    all_reduce_mean,
    attach_data_group,
    attach_seq_group,
    detach_data_group,
    detach_seq_group,
    host_gather,
    local_devices,
    make_grid,
    make_grid_3d,
    make_mesh,
    replicate,
    serving_mesh,
    shard_batch,
    shard_opt_state_zero,
    zero_leaf_sharding,
)
from distkeras_tpu_torch.parallel.pipeline_parallel import (
    pipeline_apply,
    shard_stacked_params,
    stack_block_params,
    unstack_block_params,
)
from distkeras_tpu_torch.parallel.ring_attention import (
    attach_blockwise_attention,
    attach_ring_attention,
    blockwise_attention,
    dense_attention,
    detach_ring_attention,
    ring_attention,
    shard_sequence,
)
from distkeras_tpu_torch.parallel.tensor_parallel import (
    PartitionSpec,
    attach_model_group,
    decode_param_specs,
    describe_decode_shardings,
    describe_shardings,
    detach_model_group,
    leaf_partition_spec,
    make_dp_tp_mesh,
    shard_decode_params,
    shard_params,
)
from distkeras_tpu_torch.parallel.ulysses import (
    attach_ulysses_attention,
    ulysses_attention,
)
