"""Multi-tenant QoS primitives for the serving tier — pure host logic
(PyTorch port of ``distkeras_tpu.serving.qos``, kept line for line).

- :class:`QosPolicy` — per-tenant weighted fair queuing plus strict
  priority classes for the ``ContinuousBatcher``. Admission scans
  priority classes DESCENDING (a priority-2 request is always served
  before a priority-0 one; sustained high-priority load starves the
  lower classes by design); within a class, tenants share capacity by
  weighted fair queuing over TOKENS ACTUALLY GENERATED (virtual time +=
  emitted / weight), so a weight-3 tenant earns 3x the decode throughput
  of a weight-1 tenant when both are saturated, and an idle tenant's
  unused share redistributes automatically.
- :class:`_QosQueues` — the queue behind it: one FIFO deque per
  (priority, tenant), behind the plain deque's
  ``append``/``appendleft``/``popleft``/``__len__``/``__iter__`` face, so
  the scheduler's head-of-line discipline (pop, does not fit, push back,
  wait) is unchanged. A newly active tenant's virtual time is lagged to
  the current floor (it must not burn "savings" banked while idle).
- :class:`TokenBucket` — a per-tenant admission rate limiter: ``rate``
  tokens/second refill up to ``burst``. A refused take returns the
  seconds until the bucket could cover it — the ``retry_after_ms`` hint
  of a typed ``quota_exhausted`` reply.

Preemption (the scheduler's side; the knobs live here): with
``preempt=True``, a queued request whose priority exceeds a decodable
slot's may DISPLACE it when admission is blocked (no free slot, or the
page pool cannot cover the reservation): the victim's KV is copied out
to host memory in the ``PrefixStore`` row format
(``DecodeStepper.swap_out``), its pages freed, and the victim re-queued
at the FRONT of its tenant class with the swap state riding the request;
resume is restore + re-reserve (``swap_in``), token-identical across the
boundary (the position-keyed RNG makes this hold for sampled streams
too). ``max_preemptions`` bounds how often one request can be displaced
(a request preempted that many times becomes immune, so nothing
livelocks).
"""

from __future__ import annotations

import collections
import threading
import time


#: bound on DISTINCT tenant label values any one registry/bucket map
#: will grow. ``tenant`` rides the unauthenticated wire header, and
#: unbounded client-chosen label cardinality is a slow memory DoS
#: (every unique string would mint counters/histograms/buckets that
#: are never evicted and ride every metrics scrape). Past the cap,
#: new tenant names fold into this label — totals stay correct, the
#: long tail loses per-name attribution. Operator-CONFIGURED tenants
#: (quota specs, policy weights) are always honored by name.
MAX_TENANT_LABELS = 64
OTHER_TENANTS = "__other__"


def fold_tenant(seen: set, tenant: str) -> str:
    """The label to use for ``tenant``: itself while the caller's
    distinct-label ledger (``seen``, mutated here) has room, else
    :data:`OTHER_TENANTS`."""
    if tenant in seen:
        return tenant
    if len(seen) < MAX_TENANT_LABELS:
        seen.add(tenant)
        return tenant
    return OTHER_TENANTS


class QosPolicy:
    """Scheduler-side multi-tenant policy: WFQ weights per tenant,
    strict priority classes, and the preemption knobs.

    ``weights``: tenant name -> relative decode share (within one
    priority class; unknown tenants get ``default_weight``).
    ``preempt``: allow a higher-priority arrival to displace the
    lowest-priority decodable slot by KV swap-out when admission is
    blocked. ``max_preemptions``: times ONE request may be displaced
    before it becomes immune (the livelock bound)."""

    def __init__(self, weights=None, default_weight: float = 1.0,
                 preempt: bool = True, max_preemptions: int = 2):
        self.weights = dict(weights or {})
        for t, w in self.weights.items():
            if float(w) <= 0:
                raise ValueError(
                    f"tenant {t!r} weight must be > 0; got {w}"
                )
        self.default_weight = float(default_weight)
        if self.default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0; got {default_weight}"
            )
        self.preempt = bool(preempt)
        self.max_preemptions = int(max_preemptions)
        if self.max_preemptions < 0:
            raise ValueError(
                f"max_preemptions must be >= 0; got {max_preemptions}"
            )

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def describe(self) -> dict:
        return {
            "weights": dict(self.weights),
            "default_weight": self.default_weight,
            "preempt": self.preempt,
            "max_preemptions": self.max_preemptions,
        }


class _QosQueues:
    """Priority-then-WFQ request queues behind the plain-deque face
    the scheduler already speaks (``append``/``appendleft``/
    ``popleft``/``len``/``iter``), so the head-of-line discipline —
    pop a candidate, push it back and wait when it does not fit — is
    unchanged; only WHICH request is at the head becomes policy.

    Not self-locking: the owning ``ContinuousBatcher`` serializes
    every call under its own lock, exactly as it did for the deque.
    """

    def __init__(self, policy: QosPolicy):
        self.policy = policy
        # priority -> tenant -> deque (insertion order per tenant)
        self._q: dict[int, dict[str, collections.deque]] = {}
        self._vtime: dict[str, float] = {}  # tenant -> service / weight
        self._len = 0

    # -- deque face ---------------------------------------------------------

    def _deque(self, req) -> collections.deque:
        if self._len == 0:
            # the whole system went idle: virtual time restarts from
            # zero (standard WFQ idle reset). Without this, fairness
            # after an idle period would depend on ARRIVAL ORDER — a
            # historically-busy tenant re-activating after a fresh
            # tenant would inherit its full lifetime service debt and
            # starve until the newcomer caught up.
            self._vtime.clear()
        tier = self._q.setdefault(int(req.priority), {})
        dq = tier.get(req.tenant)
        if dq is None:
            dq = tier[req.tenant] = collections.deque()
        if not dq:
            # a tenant activating after idling must start at the
            # current virtual-time floor, not at savings it banked
            # while absent (classic WFQ start-time lag)
            active = [
                self._vtime.get(t, 0.0)
                for tier2 in self._q.values()
                for t, d in tier2.items()
                if d
            ]
            floor = min(active) if active else 0.0
            self._vtime[req.tenant] = max(
                self._vtime.get(req.tenant, 0.0), floor
            )
        return dq

    def append(self, req) -> None:
        self._deque(req).append(req)
        self._len += 1

    def appendleft(self, req) -> None:
        """Head of the request's OWN (priority, tenant) class — how a
        blocked candidate or a preempted victim keeps its place."""
        self._deque(req).appendleft(req)
        self._len += 1

    def popleft(self):
        """The queue's head under policy: highest priority class with
        work; within it, the tenant with the LEAST normalized service
        (ties broken by tenant name for determinism)."""
        if not self._len:
            raise IndexError("pop from an empty QoS queue")
        for prio in sorted(self._q, reverse=True):
            tier = self._q[prio]
            best = None
            for tenant in sorted(tier):
                if not tier[tenant]:
                    continue
                vt = self._vtime.get(tenant, 0.0)
                if best is None or vt < best[0]:
                    best = (vt, tenant)
            if best is not None:
                self._len -= 1
                return tier[best[1]].popleft()
        raise IndexError("pop from an empty QoS queue")  # unreachable

    def charge(self, tenant: str, tokens: int) -> None:
        """WFQ service accounting: ``tokens`` decode tokens were just
        generated for ``tenant``."""
        self._vtime[tenant] = (
            self._vtime.get(tenant, 0.0)
            + tokens / self.policy.weight(tenant)
        )

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        """Priority-descending, tenant-sorted, FIFO within — the
        inflight-snapshot / stop() walk order."""
        for prio in sorted(self._q, reverse=True):
            for tenant in sorted(self._q[prio]):
                yield from self._q[prio][tenant]

    def service_snapshot(self) -> dict:
        """Per-tenant normalized service (virtual time) — stats()."""
        return {t: round(v, 3) for t, v in sorted(self._vtime.items())}


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/second refill up to
    ``burst``. ``take(n)`` returns 0.0 on grant (n consumed) or the
    seconds until the bucket could cover ``n`` (nothing consumed) —
    the Retry-After hint a ``quota_exhausted`` reply ships."""

    def __init__(self, rate: float, burst: float | None = None,
                 clock=time.monotonic):
        self.rate = float(rate)
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s; got {rate}")
        # a defaulted burst floors at 1: sub-1 rates (one request per
        # N seconds) are legitimate quotas and must not be rejected
        # for implying a bucket that can never hold a whole token
        self.burst = (
            max(1.0, self.rate) if burst is None else float(burst)
        )
        if self.burst < 1:
            raise ValueError(
                f"burst must be >= 1; got {self.burst}"
            )
        self._clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate
        )
        self._stamp = now

    def take(self, n: float = 1.0) -> float:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


def as_bucket(spec) -> TokenBucket | None:
    """Coerce a quota spec into a :class:`TokenBucket`: an existing
    bucket passes through, a number is ``rate`` (burst = rate), a
    dict carries ``rate``/``burst``, a 2-tuple is ``(rate, burst)``,
    None disables the quota."""
    if spec is None:
        return None
    if isinstance(spec, TokenBucket):
        return spec
    if isinstance(spec, dict):
        return TokenBucket(spec["rate"], spec.get("burst"))
    if isinstance(spec, (tuple, list)):
        rate, burst = spec
        return TokenBucket(rate, burst)
    return TokenBucket(float(spec))
