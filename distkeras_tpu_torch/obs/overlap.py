"""Overlap ledger — the zero-bubble decode instrumentation (PyTorch
port: a copy of ``distkeras_tpu.obs.overlap``; pure Python, so both
packages' ledgers give the same snapshot for the same stamps).

The serving loop alternates host scheduling work (admission, chunked
prefill, QoS decisions, page bookkeeping, stream pushes) with the
device decode step. Sequentially those phases add; with async
dispatch they overlap, and the *bubble* — iteration wall-clock the
device spent idle waiting on the host — is the number the overlap
refactor exists to shrink. This ledger makes it a first-class,
time-series-visible metric instead of a one-off bench printout:

- ``serving_step_bubble_seconds`` (histogram): per scheduler
  iteration, ``iteration_wall - device_wall`` clipped at zero, where
  iteration wall is collect-to-collect and device wall is
  dispatch-to-ready for that iteration's step.
- ``serving_overlap_efficiency`` (gauge): cumulative
  ``device_seconds / iteration_seconds`` — the fraction of decode
  wall-clock the device was actually computing (1.0 = zero bubble).
  ``1 - efficiency`` is the bubble fraction ``dkt_top`` renders.

The batcher stamps three instants per iteration through this ledger:
``note_dispatch()`` when the decode step is enqueued,
``note_ready()`` when device completion is first *observed* (an
opportunistic poll between host phases, or implicitly at collect),
and ``note_collect()`` when the tokens are materialized. Device wall
is measured, not inferred: if readiness was never observed before the
blocking collect, the device ran right up to the collect and the
bubble for that interval is honestly zero. The clock is injectable so
the arithmetic is unit-testable without sleeping.

Both loop modes feed the same ledger — the sequential control stamps
dispatch/ready/collect back-to-back around its blocking step, so the
committed overlapped-vs-sequential A/B reads the bubble from the same
instrument on both sides.
"""

from __future__ import annotations

import time


class OverlapLedger:
    """Per-iteration dispatch/ready/collect bookkeeping over a
    ``MetricsRegistry``. Single-writer (the scheduler thread); the
    gauge callback tolerates a torn read like every other scrape."""

    def __init__(self, registry, clock=time.monotonic):
        self._clock = clock
        # 1 µs .. ~67 s: decode bubbles on a warm CPU engine are
        # tens of microseconds; a compile stall is tens of seconds
        self.bubble = registry.histogram(
            "serving_step_bubble_seconds",
            help="per-iteration host bubble: iteration wall minus "
                 "device wall",
            start=1e-6, factor=2.0, num_buckets=26,
        )
        registry.gauge(
            "serving_overlap_efficiency",
            help="cumulative device_wall / iteration_wall (1.0 = "
                 "zero bubble)",
            fn=lambda: self.efficiency,
        )
        self.iterations = 0
        self.device_seconds = 0.0
        self.iteration_seconds = 0.0
        self._dispatched_at = None
        self._ready_at = None
        self._last_collect = None

    # -- the three stamps (scheduler thread only) ---------------------------

    def note_dispatch(self) -> None:
        """The decode step for this iteration was just enqueued."""
        self._dispatched_at = self._clock()
        self._ready_at = None

    def note_ready(self) -> None:
        """Device completion observed (first observation wins — later
        polls and the implicit collect stamp never move it back)."""
        if self._ready_at is None and self._dispatched_at is not None:
            self._ready_at = self._clock()

    def note_collect(self) -> None:
        """Tokens materialized: close this iteration's ledger entry.
        No-op when nothing was dispatched (idle scheduler passes)."""
        now = self._clock()
        if self._dispatched_at is None:
            return
        ready = self._ready_at if self._ready_at is not None else now
        device = min(max(0.0, ready - self._dispatched_at),
                     max(0.0, now - self._dispatched_at))
        # iteration wall: collect-to-collect once steady, else
        # dispatch-to-collect (the first iteration has no predecessor)
        base = (
            self._last_collect
            if self._last_collect is not None
            and self._last_collect <= self._dispatched_at
            else self._dispatched_at
        )
        iter_wall = max(0.0, now - base)
        device = min(device, iter_wall)
        self.bubble.observe(iter_wall - device)
        self.iterations += 1
        self.device_seconds += device
        self.iteration_seconds += iter_wall
        self._dispatched_at = None
        self._ready_at = None
        self._last_collect = now

    def discard(self) -> None:
        """Drop an in-flight entry without closing it (the step was
        abandoned — scheduler stop with a handle still in the air)."""
        self._dispatched_at = None
        self._ready_at = None

    # -- read side ----------------------------------------------------------

    @property
    def efficiency(self):
        """Cumulative device/iteration wall fraction; None before the
        first completed iteration (a gauge gap, not a fake 0 or 1)."""
        if self.iteration_seconds <= 0.0:
            return None
        return min(1.0, self.device_seconds / self.iteration_seconds)

    @property
    def bubble_fraction(self):
        """``1 - efficiency``; None before the first iteration."""
        eff = self.efficiency
        return None if eff is None else 1.0 - eff

    def snapshot(self) -> dict:
        """JSON-able summary for ``health``/bench blocks."""
        eff = self.efficiency
        return {
            "iterations": self.iterations,
            "device_seconds": round(self.device_seconds, 6),
            "iteration_seconds": round(self.iteration_seconds, 6),
            "efficiency": None if eff is None else round(eff, 4),
            "bubble_fraction": (
                None if eff is None else round(1.0 - eff, 4)
            ),
        }
