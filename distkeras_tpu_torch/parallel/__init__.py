"""Single-device attention (dense, blockwise, the hook helpers) and the
single-device mixture-of-experts layer."""

from distkeras_tpu_torch.parallel.expert_parallel import (
    MoE,
    moe_ffn,
    switch_route,
)
from distkeras_tpu_torch.parallel.ring_attention import (
    attach_blockwise_attention,
    blockwise_attention,
    dense_attention,
    detach_ring_attention,
)
