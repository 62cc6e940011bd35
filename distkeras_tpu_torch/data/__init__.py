"""Host-side data pipeline (PyTorch port of ``distkeras_tpu.data``):
the columnar ``Dataset`` (a copy of the JAX package's numpy-only one),
the feature transformers and the loaders. Batches are built on the host
as numpy; the trainers move them to the device."""

from distkeras_tpu_torch.data import loaders
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    Transformer,
)

__all__ = [
    "Dataset",
    "DenseTransformer",
    "LabelIndexTransformer",
    "MinMaxTransformer",
    "OneHotTransformer",
    "ReshapeTransformer",
    "Transformer",
    "loaders",
]
