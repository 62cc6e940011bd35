"""Core utilities (PyTorch port of ``distkeras_tpu.utils``): parameter-dict
arithmetic, serialization, the RNG, training history and checkpoints;
the device contract (``device``) and the JAX weight bridge (``convert``)
are the port's own. ``enable_compile_cache`` has no counterpart: it
turns on XLA's persistent compile cache, and the port's counterpart is
the kernel build cache (``kernels/_build``), always on."""

from distkeras_tpu_torch.utils.checkpoint import Checkpointer
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.utils.rng import RngSeq
from distkeras_tpu_torch.utils.serialization import (
    deserialize_model,
    deserialize_params,
    deserialize_serving_bundle,
    load_params,
    load_serving_bundle,
    save_params,
    save_serving_bundle,
    serialize_model,
    serialize_params,
    serialize_serving_bundle,
)
from distkeras_tpu_torch.utils.tree import (
    tree_add,
    tree_allclose,
    tree_dot,
    tree_mean,
    tree_norm,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

__all__ = [
    "Checkpointer",
    "RngSeq",
    "TrainingHistory",
    "deserialize_model",
    "deserialize_params",
    "deserialize_serving_bundle",
    "load_params",
    "load_serving_bundle",
    "save_params",
    "save_serving_bundle",
    "serialize_model",
    "serialize_params",
    "serialize_serving_bundle",
    "tree_add",
    "tree_allclose",
    "tree_dot",
    "tree_mean",
    "tree_norm",
    "tree_scale",
    "tree_sub",
    "tree_zeros_like",
]
