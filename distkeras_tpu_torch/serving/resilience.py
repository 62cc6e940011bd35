"""Overload defense and gray-failure resilience primitives (PyTorch port
of ``distkeras_tpu.serving.resilience``; pure Python copies, so budgets,
hedge delays, breakers and the shed gate decide the same on the same
clocked inputs).

- :class:`RetryBudget` — a token bucket fed by attempts, not time: every
  first attempt deposits ``ratio`` tokens, every retry (or hedge)
  withdraws one. Shared per client (``ServingClient(retry_budget=...)``),
  so retries stay a bounded fraction of traffic and a refused grant
  surfaces the original typed error at once.
- :class:`LatencyTracker` — a bounded window of completed-call latencies
  that resolves ``hedge_after="p95"`` into a concrete delay
  (:func:`resolve_hedge_delay`).
- :class:`CircuitBreaker` — a per-replica closed -> open -> half-open
  state machine: trips on a windowed typed-error rate and on consecutive
  latency-outlier judgments, recovers through a single half-open probe
  (``as_breaker_config`` coerces the router's knob).
- :class:`AdmissionController` — the engine-door load shedder: a
  CoDel-style queue-sojourn gate (shed when queueing delay sits above
  ``target_ms`` for a full ``interval_ms``) plus a brownout ladder driven
  by the engine's burn-rate verdicts: rung 1 sheds the lowest QoS priority
  class, rung 2 also clamps ``max_new_tokens``, rung 3 refuses everything,
  each refusal typed ``overloaded`` with a ``retry_after_ms`` taken from
  the observed sojourn (``as_shed_gate`` coerces ``ServingEngine(shed=)``).

Every class takes an injectable ``clock``, so tests drive the state
machines under a fake clock instead of sleeping.
"""

from __future__ import annotations

import collections
import threading
import time

# breaker states (string-valued so they ride health replies and
# ``dkt_top`` columns verbatim)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: brownout ladder rungs, in increasing severity: 0 admits everything,
#: 1 sheds the lowest priority class, 2 additionally clamps
#: ``max_new_tokens``, 3 refuses all admissions typed ``overloaded``.
RUNG_OK, RUNG_SHED, RUNG_CLAMP, RUNG_REFUSE = 0, 1, 2, 3

#: burn-rate verdict -> brownout rung (the burn verdicts'
#: vocabulary: ``burning`` = budget eroding, ``spiking`` = happening now,
#: ``breach`` = both). Unknown verdicts are neutral — absence of
#: evidence never sheds a request.
BURN_RUNGS = {"ok": RUNG_OK, "burning": RUNG_SHED,
              "spiking": RUNG_CLAMP, "breach": RUNG_REFUSE}


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


class CircuitBreaker:
    """Per-replica circuit breaker: closed -> open -> half-open.

    Two independent trip conditions, because gray failures come in two
    flavors:

    - **error rate**: over the last ``window`` seconds, at least
      ``min_requests`` outcomes recorded and the failure fraction
      >= ``failure_threshold``. Failures are connection deaths and
      typed ``internal`` replies — NOT ``overloaded`` (backpressure is
      the replica working correctly under load).
    - **latency outlier**: ``outlier_trips`` CONSECUTIVE sweep
      evaluations judged this replica's windowed latency quantile an
      outlier vs the fleet median (the router's sweep computes the
      judgment from its ``MetricsHistory`` ring and reports it via
      ``note_latency``). This is the condition binary health cannot
      express — the replica answers every poll, slowly.

    Open blocks all routing for ``open_secs``, then the next routing
    decision claims a half-open PROBE: one live request through, its
    outcome decides (success -> closed with a clean window, failure ->
    open again with a fresh timer). ``try_probe(force=True)`` is the
    all-breakers-open escape hatch: the router would rather probe the
    least-recently-opened replica early than refuse the whole fleet.

    State-changing methods return ``(old, new)`` on a transition and
    ``None`` otherwise, so the call site — which knows the endpoint —
    owns counters and recorder events. Thread-safe leaf lock: never
    calls out under it."""

    def __init__(self, window: float = 30.0, min_requests: int = 5,
                 failure_threshold: float = 0.5, open_secs: float = 5.0,
                 outlier_trips: int = 3, clock=time.monotonic):
        self.window = float(window)
        self.min_requests = int(min_requests)
        self.failure_threshold = float(failure_threshold)
        self.open_secs = float(open_secs)
        self.outlier_trips = int(outlier_trips)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.opened_at = None       # instant of the LAST open transition
        self.open_cause = None      # "error_rate" | "latency_outlier" | "probe_failed"
        self._events = collections.deque()  # (t, ok) outcome window
        self._outlier_streak = 0
        self._probe_inflight = False

    # -- outcome recording (closed-state inputs) ----------------------------

    def _trim(self, now: float) -> None:
        horizon = now - self.window
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def record_success(self):
        with self._lock:
            now = self._clock()
            self._events.append((now, True))
            self._trim(now)
        return None

    def record_failure(self):
        """A hard failure (connection death / typed internal). May trip
        closed -> open on the windowed rate."""
        with self._lock:
            now = self._clock()
            self._events.append((now, False))
            self._trim(now)
            if self.state != CLOSED:
                return None
            total = len(self._events)
            if total < self.min_requests:
                return None
            fails = sum(1 for _, ok in self._events if not ok)
            if fails / total < self.failure_threshold:
                return None
            return self._open_locked(now, "error_rate")

    def note_latency(self, outlier: bool):
        """One sweep's latency judgment (the router computes it from
        the history ring). ``outlier_trips`` consecutive True
        judgments trip a closed breaker; any False resets the streak.
        Sweeps with no data for this replica must simply not call —
        unknown is neither an outlier nor a recovery."""
        with self._lock:
            if not outlier:
                self._outlier_streak = 0
                return None
            self._outlier_streak += 1
            if self.state != CLOSED:
                return None
            if self._outlier_streak < self.outlier_trips:
                return None
            return self._open_locked(self._clock(), "latency_outlier")

    def _open_locked(self, now: float, cause: str):
        old = self.state
        self.state = OPEN
        self.opened_at = now
        self.open_cause = cause
        self._probe_inflight = False
        return (old, OPEN)

    # -- routing-decision face (the router's _pick) -------------------------

    def probe_due(self) -> bool:
        """True when the next routing decision should claim a probe:
        open past ``open_secs``, or half-open with no probe in
        flight (a probe's connection died without an outcome)."""
        with self._lock:
            if self.state == OPEN:
                return (
                    self.opened_at is not None
                    and self._clock() - self.opened_at >= self.open_secs
                )
            if self.state == HALF_OPEN:
                return not self._probe_inflight
            return False

    def try_probe(self, force: bool = False):
        """Claim the half-open probe: ``(granted, change)``. ``force``
        skips the ``open_secs`` wait — the every-breaker-open escape
        hatch. At most one probe is in flight at a time; its outcome
        arrives via ``record_probe``."""
        with self._lock:
            if self.state == CLOSED:
                return False, None
            if self._probe_inflight:
                return False, None
            now = self._clock()
            if self.state == OPEN:
                due = (
                    self.opened_at is not None
                    and now - self.opened_at >= self.open_secs
                )
                if not (due or force):
                    return False, None
                self.state = HALF_OPEN
                self._probe_inflight = True
                return True, (OPEN, HALF_OPEN)
            # HALF_OPEN, no probe in flight: re-claim
            self._probe_inflight = True
            return True, None

    def record_probe(self, ok: bool):
        """The probe's outcome: success closes (clean window), failure
        re-opens with a fresh timer."""
        with self._lock:
            self._probe_inflight = False
            if self.state == CLOSED:
                # a raced regular outcome already closed us
                return None
            now = self._clock()
            if ok:
                old = self.state
                self.state = CLOSED
                self._events.clear()
                self._outlier_streak = 0
                self.open_cause = None
                return (old, CLOSED)
            return self._open_locked(now, "probe_failed")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "cause": self.open_cause,
                "outlier_streak": self._outlier_streak,
                "window_outcomes": len(self._events),
            }


def as_breaker_config(spec) -> dict | None:
    """Coerce a breaker spec into constructor kwargs: True = defaults,
    a dict = those kwargs, falsy = disabled (None). The router builds
    ONE breaker per replica from this config."""
    if not spec:
        return None
    if spec is True:
        return {}
    if isinstance(spec, dict):
        return dict(spec)
    raise TypeError(f"cannot build a CircuitBreaker config from {spec!r}")


class AdmissionController:
    """The engine-door load shedder: CoDel-style sojourn gate plus the
    burn-driven brownout ladder.

    **Sojourn gate** (the CoDel shape, adapted to admission): the
    scheduler reports each admitted request's queue sojourn via
    ``note_delay``. When sojourn sits above ``target_ms`` continuously
    for ``interval_ms``, the gate enters shedding (rung >= 1); the
    first sojourn back under target — or ``2 * interval_ms`` with no
    admissions at all (an empty queue cannot be congested) — exits it.
    Judging DELAY instead of depth is the point: a deep queue that
    drains fast is healthy, a shallow one that doesn't is not.

    **Brownout ladder** (severity = max of the sojourn rung and the
    burn rung, re-read from ``burn_fn`` at most every
    ``burn_interval`` seconds):

    ==== =========================================================
    rung action
    ==== =========================================================
    0    admit everything
    1    shed arrivals with priority <= ``shed_priority_max``
         (typed ``overloaded``, honest ``retry_after_ms``)
    2    rung 1 + clamp admitted ``max_new_tokens`` to
         ``clamp_frac`` of the ask (deterministic decode means the
         clamped reply is an exact PREFIX of the full one)
    3    refuse every admission typed ``overloaded``
    ==== =========================================================

    ``retry_after_ms`` on every refusal is the recent observed sojourn
    (EWMA), clamped to [25, 5000] ms — the honest "come back when the
    queue you'd join has drained" number, not a constant.

    ``admit()`` is called on the submit path OUTSIDE the scheduler
    lock; internal state is behind this class's own leaf lock, and
    ``burn_fn`` (the engine's cadence-guarded ``burn_verdict``) is
    invoked outside it."""

    def __init__(self, target_ms: float = 50.0, interval_ms: float = 500.0,
                 shed_priority_max: int = 0, clamp_frac: float = 0.25,
                 burn_fn=None, burn_interval: float = 1.0,
                 clock=time.monotonic):
        if target_ms <= 0 or interval_ms <= 0:
            raise ValueError("target_ms and interval_ms must be > 0")
        if not 0.0 < clamp_frac <= 1.0:
            raise ValueError(f"clamp_frac must be in (0, 1]; got {clamp_frac}")
        self.target = float(target_ms) / 1e3
        self.interval = float(interval_ms) / 1e3
        self.shed_priority_max = int(shed_priority_max)
        self.clamp_frac = float(clamp_frac)
        self.burn_fn = burn_fn
        self.burn_interval = float(burn_interval)
        self._clock = clock
        self._lock = threading.Lock()
        self._above_since = None   # first instant of the current
        #                            above-target sojourn streak
        self._last_note = None     # last note_delay instant
        self._shedding = False     # the sojourn-gate rung-1 latch
        self._sojourn_ewma = None  # seconds (the retry_after source)
        self._burn_rung = RUNG_OK
        self._burn_at = None       # last burn_fn refresh instant
        self._last_rung = RUNG_OK  # for transition reporting
        self._transition = None    # (old, new) awaiting poll
        # lifetime decision tallies: the gate outlives scheduler
        # generations (it rides the engine's batcher config through
        # watchdog restarts), so these are the restart-proof shed
        # ledger — the per-generation batcher counters are not
        self.sheds = 0
        self.clamps = 0
        self.refusals = 0

    # -- scheduler-side input -----------------------------------------------

    def note_delay(self, sojourn_s: float) -> None:
        """One admitted request's queue sojourn (submit -> admission),
        reported by the scheduler's admission phase."""
        now = self._clock()
        with self._lock:
            self._last_note = now
            self._sojourn_ewma = (
                sojourn_s if self._sojourn_ewma is None
                else 0.8 * self._sojourn_ewma + 0.2 * sojourn_s
            )
            if sojourn_s <= self.target:
                self._above_since = None
                self._shedding = False
                return
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= self.interval:
                self._shedding = True

    # -- submit-side gate ---------------------------------------------------

    def _refresh_burn(self, now: float) -> None:
        """Re-read the burn verdict at most every ``burn_interval``
        seconds. Called outside the gate lock — ``burn_fn`` walks the
        history ring and the metrics registry."""
        if self.burn_fn is None:
            return
        with self._lock:
            if (self._burn_at is not None
                    and now - self._burn_at < self.burn_interval):
                return
            self._burn_at = now
        verdict = None
        try:
            verdict = self.burn_fn()
        except Exception:  # noqa: BLE001 — observability must not shed
            pass
        worst = (verdict or {}).get("burn") if isinstance(verdict, dict) \
            else verdict
        with self._lock:
            self._burn_rung = BURN_RUNGS.get(worst, RUNG_OK)

    def rung(self) -> int:
        """Current brownout rung: max(sojourn gate, burn ladder)."""
        now = self._clock()
        self._refresh_burn(now)
        with self._lock:
            if self._shedding and self._last_note is not None and (
                now - self._last_note > 2 * self.interval
            ):
                # no admissions for two full intervals: the queue is
                # empty or stalled, not congested — stop shedding on
                # stale evidence
                self._shedding = False
                self._above_since = None
            codel = RUNG_SHED if self._shedding else RUNG_OK
            return max(codel, self._burn_rung)

    def retry_after_ms(self) -> float:
        with self._lock:
            ewma = self._sojourn_ewma
        base = (ewma if ewma is not None else 4 * self.target) * 1e3
        return max(25.0, min(5000.0, base))

    def admit(self, priority: int, max_new_tokens: int):
        """One admission decision: ``(action, retry_after_ms, clamp)``.
        ``action`` is ``"admit"`` / ``"shed"`` / ``"refuse"``;
        ``clamp`` is the clamped ``max_new_tokens`` for rung-2
        admissions (None = leave the ask alone). ``shed`` and
        ``refuse`` both surface as typed ``overloaded`` — they are
        split so the counters can tell priority-class shedding from a
        full brownout."""
        r = self.rung()
        with self._lock:
            if r != self._last_rung:
                self._transition = (self._last_rung, r)
                self._last_rung = r
        if r >= RUNG_REFUSE:
            with self._lock:
                self.refusals += 1
            return "refuse", self.retry_after_ms(), None
        if r >= RUNG_SHED and priority <= self.shed_priority_max:
            with self._lock:
                self.sheds += 1
            return "shed", self.retry_after_ms(), None
        if r >= RUNG_CLAMP:
            clamp = max(1, int(max_new_tokens * self.clamp_frac))
            if clamp < max_new_tokens:
                with self._lock:
                    self.clamps += 1
                return "admit", None, clamp
        return "admit", None, None

    def poll_transition(self):
        """The rung change since the last poll, once — ``(old, new)``
        or None. The scheduler turns it into ONE recorder event per
        transition instead of one per shed request."""
        with self._lock:
            t, self._transition = self._transition, None
            return t

    def state(self) -> dict:
        """The health-reply face (rides ``engine.health()['shed']``)."""
        with self._lock:
            return {
                "rung": self._last_rung,
                "shedding": self._shedding,
                "burn_rung": self._burn_rung,
                "sojourn_ms": (
                    None if self._sojourn_ewma is None
                    else round(self._sojourn_ewma * 1e3, 3)
                ),
                "target_ms": self.target * 1e3,
                "sheds": self.sheds,
                "clamps": self.clamps,
                "refusals": self.refusals,
            }


def as_shed_gate(spec, burn_fn=None) -> AdmissionController | None:
    """Coerce the engine's ``shed=`` knob: falsy = disabled, True =
    defaults, a dict = constructor kwargs, an instance = as-is. The
    engine passes its cadence-guarded ``burn_verdict`` as ``burn_fn``
    unless the spec already carries one."""
    if not spec:
        return None
    if isinstance(spec, AdmissionController):
        return spec
    if spec is True:
        return AdmissionController(burn_fn=burn_fn)
    if isinstance(spec, dict):
        kw = dict(spec)
        kw.setdefault("burn_fn", burn_fn)
        return AdmissionController(**kw)
    raise TypeError(f"cannot build an AdmissionController from {spec!r}")
