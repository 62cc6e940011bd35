"""Training history & wall-clock bookkeeping (a copy of
``distkeras_tpu.utils.history`` for the PyTorch port, which imports
nothing of the JAX package).

Parity with the reference's Trainer bookkeeping (reference:
distkeras/trainers.py -> Trainer.record_training_start/record_training_end/
get_training_time/get_history): per-worker batch histories plus start/stop
wall-clock timing.
"""

from __future__ import annotations

import time
from collections import defaultdict


class TrainingHistory:
    """Accumulates per-step metrics, per worker, plus wall-clock timing."""

    def __init__(self):
        self._records = defaultdict(list)  # worker_id -> list of dict
        self._windows = defaultdict(list)  # worker_id -> list of (samples, sec)
        self._validation = []  # per-epoch val_* metric dicts
        self._t_start = None
        self._t_end = None

    def record_training_start(self):
        self._t_start = time.time()

    def record_training_end(self):
        self._t_end = time.time()

    def get_training_time(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.time()
        return end - self._t_start

    def append(self, worker_id: int, **metrics):
        self._records[worker_id].append(
            {k: float(v) for k, v in metrics.items()}
        )

    def extend(self, worker_id: int, records):
        for r in records:
            self.append(worker_id, **r)

    def get_history(self, worker_id=None):
        if worker_id is not None:
            return list(self._records[worker_id])
        merged = []
        for wid in sorted(self._records):
            merged.extend(self._records[wid])
        return merged

    def num_updates(self) -> int:
        return sum(len(v) for v in self._records.values())

    # -- per-epoch validation (Keras-style val_* metrics) -------------------

    def record_validation(self, epoch: int, metrics: dict):
        self._validation.append(
            {"epoch": int(epoch), **{k: float(v) for k, v in metrics.items()}}
        )

    def get_validation_history(self):
        return list(self._validation)

    # -- throughput bookkeeping (profiling subsystem; absent upstream) ------

    def record_window(self, worker_id: int, samples: int, seconds: float):
        """One dispatched window: how many samples, how long (wall)."""
        self._windows[worker_id].append((int(samples), float(seconds)))

    def get_timings(self, worker_id=None):
        if worker_id is not None:
            return list(self._windows[worker_id])
        merged = []
        for wid in sorted(self._windows):
            merged.extend(self._windows[wid])
        return merged

    def total_samples(self) -> int:
        return sum(s for s, _ in self.get_timings())

    def samples_per_second(self) -> float:
        """Aggregate throughput: total samples / total wall time. Windows
        overlap across workers (async), so wall time, not summed window time,
        is the honest denominator."""
        t = self.get_training_time()
        return self.total_samples() / t if t > 0 else 0.0

    def averages(self) -> dict:
        merged = self.get_history()
        if not merged:
            return {}
        keys = merged[-1].keys()
        return {
            k: sum(r[k] for r in merged if k in r)
            / max(1, sum(1 for r in merged if k in r))
            for k in keys
        }
