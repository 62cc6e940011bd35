"""Layers, the Sequential container and the model zoo (PyTorch port of
``distkeras_tpu.models``). JAX's ``Model``, the built handle, has no
counterpart: ``Sequential.build`` returns the module itself."""

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.layers import (
    Activation,
    AvgPool2D,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Flatten,
    GlobalAvgPool2D,
    Layer,
    MaxPool2D,
)
from distkeras_tpu_torch.models.sequential import Sequential

__all__ = [
    "Activation",
    "AvgPool2D",
    "BatchNorm",
    "Conv2D",
    "Dense",
    "Dropout",
    "Flatten",
    "GlobalAvgPool2D",
    "Layer",
    "MaxPool2D",
    "Sequential",
    "zoo",
]
