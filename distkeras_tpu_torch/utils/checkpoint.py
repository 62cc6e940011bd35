"""Checkpoint / resume store (PyTorch port of
``distkeras_tpu.utils.checkpoint``).

``Checkpointer``: step-numbered, atomic, retained-N on-disk snapshots of
named trees plus a JSON metadata dict. Directory layout::

    <dir>/ckpt_0000000042/
        params.tree     (structure + npz, via utils.serialization)
        opt_state.tree
        meta.json

Writes land in a temp dir first and are published with ``os.replace``, so
a crash mid-save never leaves a readable-but-corrupt checkpoint. The
frames are the JAX package's, so the port reads a checkpoint the JAX
trainers wrote (its optax states decode as anonymous namedtuples;
``utils.convert.opt_state_from_jax`` brings them into the port's layout).

What the trainers store: ``SingleTrainer`` every ``checkpoint_every``
epochs (params, model state, optimizer state, rng — a resume is
bit-identical to an uninterrupted run on the CPU), the asynchronous
trainers every ``checkpoint_every`` parameter-server commits (center, PS
meta with DynSGD's version and the exactly-once dedup table, and each
worker's latest committed local state).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    serialize_params,
)
from distkeras_tpu_torch.utils.tree import to_host

_PREFIX = "ckpt_"
_WIDTH = 10


class Checkpointer:
    """Atomic on-disk checkpoints of named trees + JSON metadata."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:0{_WIDTH}d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX):
                try:
                    steps.append(int(name[len(_PREFIX) :]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore ------------------------------------------------------

    def save(
        self,
        step: int,
        trees: dict | None = None,
        meta: dict | None = None,
        overwrite: bool = False,
    ):
        """Write checkpoint ``step``. Returns False if it already exists
        (concurrent committers may race to the same step; first wins).
        ``overwrite=True`` replaces an existing step instead — for the
        end-of-run save, whose payload supersedes a same-numbered periodic
        snapshot (fresher worker states, identical center). Every tensor
        is copied to the host, in one pass, before anything is written."""
        step = int(step)
        final = self._step_dir(step)
        host = to_host(trees or {})
        with self._lock:
            if os.path.exists(final) and not overwrite:
                return False
            tmp = os.path.join(
                self.directory,
                f".tmp_{step}_{os.getpid()}_{threading.get_ident()}",
            )
            os.makedirs(tmp, exist_ok=True)
            try:
                # serialize FULLY into tmp before touching an existing
                # checkpoint: a failure here must never destroy a prior
                # valid step
                for name, tree in host.items():
                    with open(os.path.join(tmp, f"{name}.tree"), "wb") as f:
                        f.write(serialize_params(tree))
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta or {}, f)
                if os.path.exists(final):
                    if not overwrite:
                        # cross-process race (the lock is per process):
                        # another committer won — first wins
                        return False
                    shutil.rmtree(final, ignore_errors=True)
                try:
                    os.replace(tmp, final)
                except OSError:
                    if overwrite:
                        raise
                    # a concurrent committer published between exists()
                    # and replace(): the same first-wins outcome
                    return False
            finally:
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            self._retain()
        return True

    def restore(self, step: int | None = None):
        """Return ``(step, trees, meta)`` for ``step`` (default: latest),
        numpy leaves. Raises FileNotFoundError if there is nothing to
        restore."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(int(step))
        if not os.path.isdir(d):
            raise FileNotFoundError(d)
        trees = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".tree"):
                with open(os.path.join(d, name), "rb") as f:
                    trees[name[: -len(".tree")]] = deserialize_params(f.read())
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return int(step), trees, meta

    def _retain(self):
        steps = self.all_steps()
        for step in steps[: -self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
