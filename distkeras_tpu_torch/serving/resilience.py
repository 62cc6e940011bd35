"""Client-side resilience primitives (PyTorch port of the client half of
``distkeras_tpu.serving.resilience``; pure Python copies, so budgets and
hedge delays answer the same on the same inputs).

- :class:`RetryBudget` — a token bucket fed by attempts, not time: every
  first attempt deposits ``ratio`` tokens, every retry (or hedge)
  withdraws one. Shared per client (``ServingClient(retry_budget=...)``),
  so retries stay a bounded fraction of traffic and a refused grant
  surfaces the original typed error at once.
- :class:`LatencyTracker` — a bounded window of completed-call latencies
  that resolves ``hedge_after="p95"`` into a concrete delay
  (:func:`resolve_hedge_delay`).

The server half (``CircuitBreaker``, ``AdmissionController``) comes with
the fleet router.
"""

from __future__ import annotations

import collections
import threading
import time


class RetryBudget:
    """A retry token bucket fed by attempts: each ORIGINAL attempt
    deposits ``ratio`` tokens (capped at ``burst``), each retry (or
    hedge — a hedge is a retry that didn't wait for the failure)
    withdraws one. ``acquire()`` is the gate: True = the retry may
    proceed (a "grant"), False = the budget is exhausted and the
    caller must surface the ORIGINAL typed error immediately.

    Starts full (``burst`` tokens) so a cold client can still retry a
    transient: the budget bounds sustained amplification, not the
    first hiccup. The ``retries <= grants`` pairing the bench gates on
    falls out by construction — a retry happens only through a grant.

    Thread-safe; one instance may be shared across clients (that IS
    the point: the budget caps the FLEET's amplification, not one
    socket's)."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0,
                 clock=time.monotonic):
        if ratio < 0:
            # ratio=0 is legal: a pure-burst budget ("at most N
            # retries, ever, until operator reset") for drills/tests
            raise ValueError(f"ratio must be >= 0; got {ratio}")
        if burst < 1.0:
            raise ValueError(f"burst must be >= 1; got {burst}")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._clock = clock  # kept for API symmetry; unused by the math
        self._tokens = float(burst)
        self._lock = threading.Lock()
        self.attempts = 0   # deposits (original attempts seen)
        self.grants = 0     # successful acquire()s
        self.exhausted = 0  # refused acquire()s

    def note_attempt(self, n: int = 1) -> None:
        """An original (non-retry) attempt happened: deposit
        ``ratio * n`` tokens, capped at ``burst``."""
        with self._lock:
            self.attempts += int(n)
            self._tokens = min(self.burst, self._tokens + self.ratio * n)

    def acquire(self, n: float = 1.0) -> bool:
        """Withdraw ``n`` tokens for a retry/hedge; False = exhausted
        (the caller surfaces the original error, never amplifies)."""
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                self.grants += 1
                return True
            self.exhausted += 1
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tokens": round(self._tokens, 3),
                "attempts": self.attempts,
                "grants": self.grants,
                "exhausted": self.exhausted,
            }


def as_retry_budget(spec):
    """Coerce a retry-budget spec: an instance is used as-is, True
    builds the defaults, a dict feeds the constructor, falsy is None
    (budgets stay opt-in — the pre-budget retry behavior is the
    default wire contract)."""
    if not spec:
        return None
    if isinstance(spec, RetryBudget):
        return spec
    if spec is True:
        return RetryBudget()
    if isinstance(spec, dict):
        return RetryBudget(**spec)
    raise TypeError(f"cannot build a RetryBudget from {spec!r}")


class LatencyTracker:
    """Bounded window of completed-request latencies; ``quantile(q)``
    resolves ``hedge_after="p95"`` into seconds. Returns None until
    ``min_samples`` latencies arrive — hedging stays off until there
    is evidence to size the delay from (an unseeded hedge delay of
    ~0 would double every request)."""

    def __init__(self, capacity: int = 256, min_samples: int = 8):
        self.min_samples = int(min_samples)
        self._samples = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def note(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if len(self._samples) < self.min_samples:
                return None
            xs = sorted(self._samples)
        # nearest-rank on the sorted window (no numpy: the client
        # must stay importable without the numeric stack loaded)
        i = min(len(xs) - 1, max(0, int(q * len(xs))))
        return xs[i]


def resolve_hedge_delay(hedge_after, tracker: LatencyTracker | None):
    """Resolve a ``hedge_after`` spec into seconds or None (no hedge):
    a number is used as-is; ``"p95"``-style strings read the tracker's
    quantile (None until it has enough samples)."""
    if hedge_after is None:
        return None
    if isinstance(hedge_after, str):
        if not hedge_after.startswith("p"):
            raise ValueError(
                f"hedge_after must be seconds or 'p<q>'; got {hedge_after!r}"
            )
        q = float(hedge_after[1:]) / 100.0
        if not 0.0 < q < 1.0:
            raise ValueError(f"hedge_after quantile out of (0, 100): "
                             f"{hedge_after!r}")
        if tracker is None:
            return None
        return tracker.quantile(q)
    d = float(hedge_after)
    if d < 0:
        raise ValueError(f"hedge_after must be >= 0; got {d}")
    return d
