"""Feature-preprocessing transformers (PyTorch port of
``distkeras_tpu.data.transformers``: plain numpy over whole columns, no
tensor code, so a copy rather than a translation).

Mirrors the reference's transformer zoo and semantics (reference:
distkeras/transformers.py -> MinMaxTransformer, OneHotTransformer,
DenseTransformer, ReshapeTransformer, LabelIndexTransformer): each is an
object built once on the host whose ``transform(dataset)`` appends or
replaces columns. The math runs vectorized over whole numpy columns instead of
per-row Spark closures — exactness of MinMax/OneHot is what makes accuracy
parity attributable to the optimizers, not data skew.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


class Transformer:
    """Base: transform(Dataset) -> Dataset."""

    def transform(self, ds: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, ds: Dataset) -> Dataset:
        return self.transform(ds)


class MinMaxTransformer(Transformer):
    """Rescale a numeric column from data range [o_min, o_max] ("old") to
    output range [n_min, n_max] ("new").

    Same parameterization as the reference: e.g. MNIST pixels use
    ``MinMaxTransformer(n_min=0, n_max=1, o_min=0, o_max=255)``.
    """

    def __init__(
        self,
        n_min=0.0,
        n_max=1.0,
        o_min=0.0,
        o_max=255.0,
        input_col="features",
        output_col=None,
    ):
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.input_col = input_col
        self.output_col = output_col or input_col

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col].astype(np.float32)
        scale = (self.n_max - self.n_min) / (self.o_max - self.o_min)
        y = (x - self.o_min) * scale + self.n_min
        return ds.with_column(self.output_col, y)


class OneHotTransformer(Transformer):
    """Integer label column -> one-hot float32 vectors of width num_classes."""

    def __init__(self, num_classes, input_col="label", output_col="label_onehot"):
        self.num_classes = int(num_classes)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, ds: Dataset) -> Dataset:
        ids = ds[self.input_col].astype(np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_classes):
            raise ValueError(
                f"labels out of range [0, {self.num_classes}): "
                f"[{ids.min()}, {ids.max()}]"
            )
        out = np.zeros((len(ids), self.num_classes), np.float32)
        out[np.arange(len(ids)), ids] = 1.0
        return ds.with_column(self.output_col, out)


class DenseTransformer(Transformer):
    """Assemble a dense float feature matrix from one or more columns.

    The reference converts sparse Spark vectors to DenseVector; here the
    analog is stacking scalar/array columns into one (N, F) float32 matrix.
    """

    def __init__(self, input_cols, output_col="features"):
        self.input_cols = (
            [input_cols] if isinstance(input_cols, str) else list(input_cols)
        )
        self.output_col = output_col

    def transform(self, ds: Dataset) -> Dataset:
        parts = []
        for c in self.input_cols:
            v = ds[c].astype(np.float32)
            parts.append(v.reshape(len(v), -1))
        return ds.with_column(self.output_col, np.concatenate(parts, axis=1))


class ReshapeTransformer(Transformer):
    """Reshape each row of a column, e.g. (784,) -> (28, 28, 1) for convnets."""

    def __init__(self, input_col, output_col, shape):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(int(d) for d in shape)

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col]
        return ds.with_column(self.output_col, x.reshape(len(x), *self.shape))


class LabelIndexTransformer(Transformer):
    """Prediction vectors -> integer class index column (argmax over classes).

    Matches the reference's use: turning predictor output into a label index
    for the evaluator (reference: distkeras/transformers.py ->
    LabelIndexTransformer feeding AccuracyEvaluator).
    """

    def __init__(self, output_dim=None, input_col="prediction",
                 output_col="prediction_index"):
        self.output_dim = output_dim  # kept for signature parity; unused
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col]
        idx = np.argmax(x, axis=-1).astype(np.int64)
        return ds.with_column(self.output_col, idx)


class StandardScaleTransformer(Transformer):
    """(x - mean) / std per feature (Higgs pipeline).

    By default the stats are fit on the data being transformed. For a
    leak-free train/test pipeline, ``fit(train)`` first — the stored
    train statistics are then applied to every later ``transform`` (the
    held-out rows must not shape the normalization they are judged
    under)."""

    def __init__(self, input_col="features", output_col=None, epsilon=1e-8):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.epsilon = float(epsilon)
        self._mean = None
        self._std = None

    def fit(self, ds: Dataset) -> "StandardScaleTransformer":
        x = ds[self.input_col].astype(np.float32)
        self._mean = x.mean(axis=0, keepdims=True)
        self._std = x.std(axis=0, keepdims=True)
        return self

    def transform(self, ds: Dataset) -> Dataset:
        x = ds[self.input_col].astype(np.float32)
        if self._mean is None:
            mean = x.mean(axis=0, keepdims=True)
            std = x.std(axis=0, keepdims=True)
        else:
            mean, std = self._mean, self._std
        return ds.with_column(self.output_col, (x - mean) / (std + self.epsilon))
