"""Compute ops (PyTorch port of ``distkeras_tpu.ops``): losses, metrics,
optimizer and schedule resolution, weight-only quantization, and the
wrappers of the hand-written kernels (``fused_layernorm``,
``flash_attention``, ``pallas_kernels``; imported on their own, so that
importing this package loads no kernel)."""

from distkeras_tpu_torch.ops.losses import categorical_crossentropy, get_loss, mse
from distkeras_tpu_torch.ops.metrics import accuracy
from distkeras_tpu_torch.ops.optimizers import get_optimizer, get_schedule
from distkeras_tpu_torch.ops.quantization import (
    Int4Weight,
    dequantize,
    qmatmul,
    quantize_int4,
    quantize_int8,
    quantize_model,
    quantize_params,
)

__all__ = [
    "Int4Weight",
    "accuracy",
    "categorical_crossentropy",
    "dequantize",
    "get_loss",
    "get_optimizer",
    "get_schedule",
    "mse",
    "qmatmul",
    "quantize_int4",
    "quantize_int8",
    "quantize_model",
    "quantize_params",
]
