"""Runtime ledger of program mints — the compile black box (PyTorch
port: the class is a copy of ``distkeras_tpu.obs.compile_ledger``, and
it keeps the JAX package's metric and event names — ``serving_compiles``,
``serving_compile_seconds``, ``serving_compile_storms``,
``xla.compile``, ``xla.compile.storm`` — so the same SLO specs and tools
read either package's registry).

The port has no XLA. What it mints, and what the serving thread loses
to it, is one of two things:

- **a kernel library build and load**: the first use of a hand-written
  CUDA kernel in a process runs ``nvcc`` on its source and ``dlopen``s
  the result (``kernels/build.py``; seconds per source). ``build``
  reports the kernels built and the wall seconds of the compile plus the
  load to its observers; the engine records them here under the key
  ``build[<kernel>]``;
- **the first call of a stepper program on a stepper generation**: the
  first ``admit[pb]``, ``chunk[cb]``, ``step[plain]`` or ``ctx_row`` call
  of a ``DecodeStepper`` (the JAX package's program keys and pow2
  buckets, its first-call-per-program detection). On the card such a
  call pays CUDA's lazy module loading and the matrix library's
  heuristics for a new shape; the stepper times it to the end of its
  device work.

Every mint records:

- ``key`` — the program family and bucket (``"admit[16]"``,
  ``"build[layernorm_fwd]"``);
- ``seconds`` — the wall time the calling thread lost to the mint;
- ``trigger`` — ``"warmup"`` (inside ``DecodeStepper.warmup()`` or
  ``warm_prefill_buckets()``, the off-path place mints belong) or
  ``"serving"`` (the live path);
- ``inflight`` — how many requests were queued/active at mint time
  (the blast radius);
- ``rewarm`` — True when this (key, signature) was already minted by an
  earlier stepper generation: a supervisor restart re-running a known
  program is expected, not a storm.

**Compile-storm detection**: once :meth:`CompileLedger.mark_warmed`
has been called (a harness's explicit "the warm set is complete"
boundary, after ``warmup()`` + the ``warm_prefill_buckets`` its traffic
needs), any serving-path mint of a program signature never seen before
is a STORM — it records an ``xla.compile.storm`` flight-recorder event
and ticks the ``serving_compile_storms`` gauge.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class CompileLedger:
    """Engine-owned mint ledger, shared across supervisor-rebuilt
    stepper generations (restart recompiles are attributed, and the
    counters never reset mid-window underneath ``MetricsHistory``).

    ``registry``: registers ``<prefix>_compiles`` /
    ``<prefix>_compile_seconds`` counters and the
    ``<prefix>_compile_storms`` / ``<prefix>_compile_warmed`` gauges.
    ``recorder``: every mint lands as an ``xla.compile`` event (storms
    additionally as ``xla.compile.storm``). ``inflight_fn``: cheap
    callable for the requests-in-flight stamp (the engine wires the
    scheduler's occupancy)."""

    def __init__(self, registry=None, recorder=None,
                 prefix: str = "serving", capacity: int = 256,
                 inflight_fn=None):
        self._records: deque = deque(maxlen=int(capacity))
        self._seen: set = set()
        self._lock = threading.Lock()
        self.recorder = recorder
        self.inflight_fn = inflight_fn
        self.warmed = False
        self.total = 0
        self.warmup_mints = 0
        self.serving_mints = 0
        self.rewarms = 0
        self.storms = 0
        self.seconds = 0.0
        self._compiles_counter = None
        self._seconds_counter = None
        if registry is not None:
            # counters (not gauges): mints only accumulate, and the
            # history layer computes windowed compile RATES from them
            self._compiles_counter = registry.counter(
                f"{prefix}_compiles",
                help="programs minted (built or first called) at runtime",
            )
            self._seconds_counter = registry.counter(
                f"{prefix}_compile_seconds",
                help="wall seconds serving threads lost to mints",
            )
            registry.gauge(
                f"{prefix}_compile_storms",
                fn=lambda: self.storms,
                help="post-warmup serving-path mints of never-seen "
                     "programs",
            )
            registry.gauge(
                f"{prefix}_compile_warmed",
                fn=lambda: self.warmed,
                help="1 once warmup completed (storm detection armed)",
            )

    # -- warmup boundary ----------------------------------------------------

    def mark_warmed(self) -> None:
        """Arm storm detection: everything compiled so far was warmup
        or acknowledged cold-start; from here, a serving-path mint of
        a new program signature is a storm. A HARNESS-level
        declaration, made after the full warm set its traffic needs
        (live warm drives + the stepper's ``warm_*_buckets`` warms) —
        ``DecodeStepper.warmup()`` deliberately does not call it,
        because it covers only the step/verify families."""
        self.warmed = True

    # -- recording (the stepper's first calls, the kernel build hook) -------

    def record_mint(self, key: str, seconds: float, signature=(),
                    warming: bool = False, generation=None) -> dict:
        """One program mint. ``signature`` is the hashable shape/dtype
        tuple of the call's arguments — (key, signature) identity is
        what distinguishes a supervisor restart recompiling a known
        program (``rewarm``) from a genuinely new program appearing
        mid-serving (a storm candidate)."""
        sig = (str(key), signature)
        inflight = None
        fn = self.inflight_fn
        if fn is not None:
            try:
                inflight = fn()
            except Exception:  # noqa: BLE001 — observability boundary
                inflight = None
        with self._lock:
            rewarm = sig in self._seen
            self._seen.add(sig)
            trigger = "warmup" if warming else "serving"
            storm = self.warmed and not warming and not rewarm
            rec = {
                "t": time.time(),
                "key": str(key),
                "seconds": round(float(seconds), 4),
                "trigger": trigger,
                "inflight": inflight,
                "rewarm": rewarm,
                "storm": storm,
            }
            if generation is not None:
                rec["generation"] = generation
            self._records.append(rec)
            self.total += 1
            self.seconds += float(seconds)
            if warming:
                self.warmup_mints += 1
            else:
                self.serving_mints += 1
                if rewarm:
                    self.rewarms += 1
            if storm:
                self.storms += 1
        if self._compiles_counter is not None:
            self._compiles_counter.inc()
            self._seconds_counter.inc(float(seconds))
        if self.recorder is not None:
            self.recorder.record("xla.compile", **{
                k: rec[k] for k in
                ("key", "seconds", "trigger", "inflight", "rewarm")
            })
            if storm:
                # the page-now event: a compile landed on the serving
                # path AFTER warmup claimed coverage — either warmup
                # has a hole or a compile key regressed to something
                # traffic-shape-dependent
                self.recorder.record(
                    "xla.compile.storm", key=rec["key"],
                    seconds=rec["seconds"], inflight=inflight,
                )
        return rec

    # -- reading ------------------------------------------------------------

    def tail(self, n: int) -> list:
        """The most recent ``n`` mint records (newest last)."""
        if n <= 0:
            return []
        with self._lock:
            return list(self._records)[-n:]

    def mints(self) -> list:
        with self._lock:
            return list(self._records)

    def snapshot(self) -> dict:
        """The JSON-able ledger summary ``stats()`` and the soak
        summaries carry."""
        with self._lock:
            return {
                "total": self.total,
                "warmup": self.warmup_mints,
                "serving": self.serving_mints,
                "rewarms": self.rewarms,
                "storms": self.storms,
                "seconds": round(self.seconds, 4),
                "warmed": self.warmed,
                "recent": [
                    {k: r[k] for k in
                     ("key", "seconds", "trigger", "inflight",
                      "rewarm", "storm")}
                    for r in list(self._records)[-8:]
                ],
            }
