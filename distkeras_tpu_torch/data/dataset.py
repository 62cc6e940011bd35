"""Columnar in-memory Dataset — the Spark-DataFrame stand-in (a copy of
``distkeras_tpu.data.dataset`` for the PyTorch port, which imports nothing
of the JAX package).

The reference's trainers consume Spark DataFrames with ``features``/``label``
columns and control distribution via ``repartition(num_workers)`` /
``coalesce(1)`` (reference: distkeras/trainers.py -> DistributedTrainer.train).
``Dataset`` reproduces that contract on host numpy arrays:

- named columns (dict of equal-length ndarrays)
- ``shuffle(seed)`` — deterministic global shuffle
  (reference: distkeras/utils.py -> shuffle)
- ``partition(num_workers)`` — deterministic contiguous split by worker index
  (the ``repartition`` analog; workers get disjoint shards)
- ``batches(batch_size)`` — minibatch assembly, the executor-side row->numpy
  loop (reference: distkeras/workers.py -> Worker minibatch assembly)

Batching drops the trailing ragged remainder so every compiled step sees one
static batch shape — a TPU/XLA requirement the Spark version didn't have.
"""

from __future__ import annotations

import numpy as np


def _take_rows(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather behind shuffle/partition: the native C++ memcpy path for
    contiguous float32 columns (distkeras_tpu_torch/native), numpy
    otherwise. Negative or out-of-range indices take the numpy path so
    semantics (negative wrap, IndexError) never depend on the toolchain."""
    if (
        col.dtype == np.float32
        and col.flags["C_CONTIGUOUS"]
        and idx.size > 0
        and 0 <= idx.min()
        and idx.max() < col.shape[0]
    ):
        from distkeras_tpu_torch.data import native

        if native.available():
            return native.gather_rows(col, idx)
    return col[idx]


class Dataset:
    def __init__(self, columns: dict):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column length mismatch: {lens}")
        self._cols = {k: np.asarray(v) for k, v in columns.items()}

    # -- basic accessors ----------------------------------------------------

    def __len__(self):
        return len(next(iter(self._cols.values())))

    @property
    def columns(self):
        return list(self._cols)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, (np.ndarray, list)):
            idx = np.asarray(key)
            if idx.dtype.kind in "iu":  # row materialization (shuffle/partition)
                return Dataset(
                    {k: _take_rows(v, idx) for k, v in self._cols.items()}
                )
            return Dataset({k: v[idx] for k, v in self._cols.items()})
        if isinstance(key, slice):
            return Dataset({k: v[key] for k, v in self._cols.items()})
        raise TypeError(f"bad key {key!r}")

    def with_column(self, name, values) -> "Dataset":
        values = np.asarray(values)
        if len(values) != len(self):
            raise ValueError("column length mismatch")
        cols = dict(self._cols)
        cols[name] = values
        return Dataset(cols)

    def select(self, names) -> "Dataset":
        return Dataset({k: self._cols[k] for k in names})

    def drop(self, names) -> "Dataset":
        names = {names} if isinstance(names, str) else set(names)
        return Dataset({k: v for k, v in self._cols.items() if k not in names})

    def take(self, n: int) -> "Dataset":
        return self[: min(n, len(self))]

    def concat(self, other: "Dataset") -> "Dataset":
        if set(self.columns) != set(other.columns):
            raise ValueError("column sets differ")
        return Dataset(
            {k: np.concatenate([self._cols[k], other._cols[k]]) for k in self._cols}
        )

    # -- distribution contract ---------------------------------------------

    def shuffle(self, seed: int = 0) -> "Dataset":
        perm = np.random.default_rng(seed).permutation(len(self))
        return self[perm]

    def partition(self, num_workers: int):
        """Disjoint, near-equal contiguous shards — repartition(num_workers)."""
        idx = np.array_split(np.arange(len(self)), num_workers)
        return [self[i] for i in idx]

    def split(self, fraction: float, seed: int = 0):
        """(train, test) random split — the examples' randomSplit analog."""
        ds = self.shuffle(seed)
        n = int(len(ds) * fraction)
        return ds[:n], ds[n:]

    def batches(self, batch_size: int, columns=None, drop_remainder=True):
        """Yield dicts of ndarray minibatches with static shapes."""
        cols = columns or self.columns
        n = len(self)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            yield {k: self._cols[k][i : i + batch_size] for k in cols}

    def num_batches(self, batch_size: int, drop_remainder=True) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    def __repr__(self):
        shapes = {k: v.shape for k, v in self._cols.items()}
        return f"Dataset(len={len(self)}, columns={shapes})"
