"""File-sharded streaming Dataset — the beyond-RAM input pipeline (a copy
of ``distkeras_tpu.data.streaming`` for the PyTorch port, which imports
nothing of the JAX package; the shard format is the same, so shards either
package writes open in the other).

The reference's data plane is Spark: DataFrames partitioned across executor
JVMs meant a dataset never had to fit on one host (reference:
distkeras/trainers.py -> DistributedTrainer.train repartitions the frame;
workers iterate partition rows). An in-memory ``Dataset`` is capped at host
RAM; ``StreamingDataset`` replaces Spark's storage tier:

- data lives in numbered ``.npz`` shards on disk (one zip of named column
  arrays each, written by :func:`write_shards`, plus a ``shards.json``
  sidecar with per-shard row counts so opening a dataset reads zero rows);
- iteration loads ONE shard at a time, so peak host memory is one shard
  regardless of dataset size;
- ``batches()`` carries remainder rows across shard boundaries — batch
  shapes stay static and rows are never dropped at shard seams, only the
  final global remainder;
- ``shuffle(seed)`` permutes shard order and rows within each shard
  deterministically (the standard out-of-core approximation of a global
  shuffle — exact global shuffles would need all rows resident);
- ``partition(n)`` deals whole shards round-robin to workers — the
  ``repartition(num_workers)`` analog at shard granularity;
- ``map(fn)`` applies a per-chunk transform (e.g. the preprocessing
  transformers) lazily as each shard is loaded.

Trainers accept a StreamingDataset anywhere they accept a Dataset — the
contract is ``__len__`` / ``columns`` / ``shuffle`` / ``partition`` /
``batches``.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np

_META = "shards.json"


class ShardWriter:
    """Incremental shard writer: ``add(columns_dict)`` appends one shard
    file; ``close()`` publishes the ``shards.json`` sidecar. Lets a
    generator larger than RAM be sharded chunk by chunk into ONE directory
    that :func:`open_shards` round-trips."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._paths = []
        self._rows = []
        self._columns = None

    def add(self, columns: dict) -> str:
        cols = {k: np.asarray(v) for k, v in columns.items()}
        names = sorted(cols)
        if self._columns is None:
            self._columns = names
        elif names != self._columns:
            raise ValueError(
                f"shard columns {names} != first shard's {self._columns}"
            )
        lens = {k: len(v) for k, v in cols.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column length mismatch within shard: {lens}")
        path = os.path.join(self.out_dir, f"shard_{len(self._paths):05d}.npz")
        np.savez(path, **cols)
        self._paths.append(path)
        self._rows.append(len(next(iter(cols.values()))))
        return path

    def close(self) -> list:
        if not self._paths:
            raise ValueError("no shards written")
        with open(os.path.join(self.out_dir, _META), "w") as f:
            json.dump(
                {
                    "shards": [os.path.basename(p) for p in self._paths],
                    "rows": self._rows,
                    "columns": self._columns,
                },
                f,
            )
        return list(self._paths)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        return False


def write_shards(dataset, out_dir: str, rows_per_shard: int) -> list:
    """Split ``dataset`` (Dataset or dict of column arrays) into ``.npz``
    shards under ``out_dir``; returns the shard paths. Also writes the
    ``shards.json`` sidecar (row counts + columns) so reopening is O(1)."""
    cols = (
        {k: np.asarray(dataset[k]) for k in dataset.columns}
        if hasattr(dataset, "columns")
        else {k: np.asarray(v) for k, v in dataset.items()}
    )
    n = len(next(iter(cols.values())))
    rows_per_shard = int(rows_per_shard)
    if rows_per_shard <= 0:
        raise ValueError("rows_per_shard must be positive")
    with ShardWriter(out_dir) as writer:
        for start in range(0, n, rows_per_shard):
            stop = min(start + rows_per_shard, n)
            writer.add({k: v[start:stop] for k, v in cols.items()})
    return writer._paths


def _peek_npz_rows(path: str) -> int:
    """Leading-axis length of the arrays in an ``.npz`` without reading any
    array data: parse the first member's npy header through the zip."""
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        if not names:
            raise ValueError(f"empty npz shard {path!r}")
        with z.open(names[0]) as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
    return shape[0] if shape else 0


def _peek_npz_columns(path: str) -> list:
    """Column names of an ``.npz`` shard from the zip directory alone."""
    with zipfile.ZipFile(path) as z:
        return sorted(
            name[: -len(".npy")] for name in z.namelist() if name.endswith(".npy")
        )


def open_shards(directory: str) -> "StreamingDataset":
    """Open a shard directory written by :func:`write_shards` (or any
    directory of homogeneous ``.npz`` files)."""
    meta_path = os.path.join(directory, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        paths = [os.path.join(directory, name) for name in meta["shards"]]
        return StreamingDataset(
            paths, rows=meta["rows"], columns=meta.get("columns")
        )
    paths = sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.endswith(".npz")
    )
    if not paths:
        raise FileNotFoundError(f"no .npz shards in {directory!r}")
    return StreamingDataset(paths)


class StreamingDataset:
    """Dataset streamed shard-by-shard from ``.npz`` files (see module doc)."""

    def __init__(self, shard_paths, rows=None, transforms=(), seed=None, columns=None):
        self._paths = list(shard_paths)
        if not self._paths:
            raise ValueError("StreamingDataset needs at least one shard")
        self._rows = (
            [int(r) for r in rows]
            if rows is not None
            else [_peek_npz_rows(p) for p in self._paths]
        )
        if len(self._rows) != len(self._paths):
            raise ValueError("rows metadata does not match shard count")
        self._transforms = tuple(transforms)
        self._seed = seed  # None = no shuffle; int = shard+row permutation
        # known only without transforms (a map() can rename columns)
        self._columns = list(columns) if columns and not transforms else None

    # -- Dataset contract ----------------------------------------------------

    def __len__(self):
        return sum(self._rows)

    @property
    def columns(self):
        if self._columns is None:
            # no transforms: names come from the zip directory, no data read;
            # with transforms the first chunk must actually run through them
            self._columns = (
                _peek_npz_columns(self._paths[0])
                if not self._transforms
                else sorted(self._load_chunk(0).keys())
            )
        return list(self._columns)

    def shuffle(self, seed) -> "StreamingDataset":
        """Deterministic out-of-core shuffle: permute shard order and the
        rows within each shard (chunk-local; see module doc)."""
        return StreamingDataset(
            self._paths,
            self._rows,
            self._transforms,
            seed=int(seed),
            columns=self._columns,
        )

    def partition(self, num_workers: int):
        """Deal whole shards round-robin; every worker streams its own
        subset of files (the repartition analog). Requires at least one
        shard per worker."""
        num_workers = int(num_workers)
        if num_workers > len(self._paths):
            raise ValueError(
                f"{num_workers} workers need >= {num_workers} shards, "
                f"have {len(self._paths)} — re-shard with smaller "
                "rows_per_shard"
            )
        parts = []
        for w in range(num_workers):
            idx = list(range(w, len(self._paths), num_workers))
            parts.append(
                StreamingDataset(
                    [self._paths[i] for i in idx],
                    [self._rows[i] for i in idx],
                    self._transforms,
                    self._seed,
                    columns=self._columns,
                )
            )
        return parts

    def map(self, fn) -> "StreamingDataset":
        """Lazy per-chunk transform: ``fn(dict of arrays) -> dict`` runs as
        each shard is loaded (how preprocessing composes with streaming)."""
        return StreamingDataset(
            self._paths, self._rows, (*self._transforms, fn), self._seed
        )

    def batches(self, batch_size: int, columns=None, drop_remainder=True):
        """Yield static-shape minibatches, carrying remainders across shard
        seams; only the final global remainder is dropped."""
        batch_size = int(batch_size)
        order = list(range(len(self._paths)))
        rng = (
            np.random.default_rng(self._seed) if self._seed is not None else None
        )
        if rng is not None:
            order = list(rng.permutation(len(self._paths)))
        carry = None
        for shard_i in order:
            chunk = self._load_chunk(shard_i)
            if rng is not None:
                perm = rng.permutation(len(next(iter(chunk.values()))))
                chunk = {k: v[perm] for k, v in chunk.items()}
            cols = columns or sorted(chunk)
            chunk = {k: chunk[k] for k in cols}
            if carry is not None:
                chunk = {
                    k: np.concatenate([carry[k], chunk[k]]) for k in cols
                }
            n = len(next(iter(chunk.values())))
            stop = (n // batch_size) * batch_size
            for i in range(0, stop, batch_size):
                yield {k: v[i : i + batch_size] for k, v in chunk.items()}
            carry = (
                {k: v[stop:] for k, v in chunk.items()} if stop < n else None
            )
        if carry is not None and not drop_remainder:
            yield carry

    def num_batches(self, batch_size: int, drop_remainder=True) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else -(-n // batch_size)

    # -- internals -----------------------------------------------------------

    def _load_chunk(self, shard_i: int) -> dict:
        with np.load(self._paths[shard_i], allow_pickle=False) as z:
            chunk = {k: z[k] for k in z.files}
        for fn in self._transforms:
            chunk = fn(chunk)
        return chunk

    def __repr__(self):
        return (
            f"StreamingDataset(shards={len(self._paths)}, rows={len(self)}, "
            f"seed={self._seed})"
        )
