"""Deterministic fault injection (PyTorch port: a copy of
``distkeras_tpu.faults``). The port wires the ``ps.*`` and ``net.*``
seams; the serving seams in the catalogue are names until the port's
serving modules that fire them exist.

The recovery paths in ``serving/`` (slot blame + quarantine, the
supervisor watchdog, client retry/reconnect) are unprovable without a
way to make the underlying failures happen ON DEMAND and REPEATABLY.
This module is that switch: production code registers named injection
seams at explicit hook points (``fire("stepper.step", ...)``) and a
test arms a seeded :class:`FaultPlan` against them. Disarmed — the
default, always, in production — every seam is a module-global load
plus a ``None`` check; no locks, no allocation, no branches on state
that could drift.

Seam catalogue (the hook points that exist today)::

    scheduler.loop      engine scheduler thread, top of every iteration
    stepper.step        DecodeStepper.step, before any device work
    stepper.verify      DecodeStepper.spec_step, before the compiled
                        speculative verify (drafts already proposed)
    stepper.prefill     begin_admit / prefill_chunk, before device work
    prefix_cache.fetch  PrefixStore.lookup (engine degrades to a miss)
    kv.alloc            paging.PageAllocator.alloc, before any pool
                        state changes — an injected raise makes page
                        exhaustion / allocator failure happen on
                        demand; the scheduler surfaces an exhausted
                        admission as typed retriable ``overloaded``,
                        never a hung slot or a corrupt stream
    kv.swap             DecodeStepper.swap_out / swap_in (QoS
                        preemption), before any device work or state
                        change; ``ctx["direction"]`` is "out"/"in".
                        A failed swap-out ABORTS the preemption (the
                        victim keeps decoding untouched); a failed
                        swap-in fails only the preempted request,
                        typed — the scheduler never wedges and no
                        page or host swap state leaks
    kv.transfer         the disaggregated prefill/decode transfer hop
                        (serving/kv_transfer.py): fires in
                        ``ServingEngine.prefill`` before the finished
                        slot's state is encoded for the wire
                        (``ctx["direction"]`` "send") and in
                        ``ServingEngine.resume`` before a received
                        frame is decoded ("recv"). A send failure
                        fails only its own request, typed; a recv
                        failure replies typed to the router, which
                        retries the SAME bytes on a sibling decode
                        worker (bounded) — no direction can hang a
                        client or strand a slot
    kv.peer             the fleet KV fabric's worker-to-worker paths
                        (serving/kv_transfer.py ``PeerFabric`` and the
                        engine's ``kv.fetch`` serving half), fired
                        BEFORE any state changes; ``ctx["direction"]``
                        is "fetch" (requester about to dial a sibling
                        for prefix pages), "push" (prefill worker about
                        to push a DKTX frame point-to-point to its
                        paired decode worker), or "serve" (a sibling's
                        fetch request about to be answered). Every
                        failure direction degrades: a failed fetch
                        falls back to local recompute (token-identical
                        to the never-fetched run), a failed push
                        returns the frame to the router's relay path,
                        a failed serve replies typed — no direction
                        can hang a request or corrupt a cache
    server.dispatch     ServingServer verb dispatch (typed-reply path)
    server.reply        ServingServer before sending a reply frame
    router.dispatch     FleetRouter verb dispatch, before a replica is
                        picked — an injected typed ServingError rides
                        the normal typed-reply path to the client
    router.health       FleetRouter health poll, per replica per sweep,
                        before the replica is dialed — an injected
                        raise counts as a failed poll (enough of them
                        ejects the replica until a clean poll rejoins
                        it)
    net.send            networking.send_data (both PS and serving wire)
    net.recv            networking.recv_data
    net.delay           ServingServer data-path verbs (generate /
                        predict / prefill / kv.transfer), fired with
                        ``ctx["verb"]`` and ``ctx["port"]`` before the
                        verb runs — arm with ``action="delay"`` and a
                        ``when`` filter on the port to make ONE
                        replica slow while its health polls stay
                        green: the gray failure binary health can't
                        see, which the router's per-replica circuit
                        breakers (latency-outlier trip) must catch
    ps.pull             ParameterServer.pull, client-facing entry (both
                        the in-process and socket transports), before
                        any state is read
    ps.commit           ParameterServer.commit, client-facing entry,
                        before decompress/dedup/apply — an injected
                        raise rejects the commit wholesale, so the
                        worker's commit_id resend is the recovery path
                        (replication applies are NOT client commits and
                        do not re-fire this seam)
    ps.replicate        primary-side replication sink, before the
                        commit record is forwarded to a warm standby
                        (failure detaches the sink; the standby
                        re-syncs with a fresh snapshot attach)

Actions::

    raise     raise ``exc`` (default ``InjectedFault``) at the seam
    delay     sleep ``delay`` seconds, then continue (slow step/peer)
    drop      server.reply only: close the connection without replying
    reset     net.send only: send a partial frame, then RST the socket
    truncate  net.send only: declare the full length, send half, FIN
    corrupt   net.send only: flip a byte mid-payload, send normally

Determinism: triggering is COUNTED, not timed — ``after`` skips the
first N matching events, ``times`` bounds how often the seam fires
(``None`` = every match), ``when(ctx)`` filters on the call context
(e.g. the step's active mask). ``probability`` draws from the plan's
own seeded RNG, so even probabilistic chaos replays exactly.

Usage::

    plan = FaultPlan(seed=0)
    plan.arm("stepper.step", exc=RuntimeError("boom"))       # once
    plan.arm("net.send", action="reset", after=2)
    with plan:                      # activate / deactivate
        ...drive the engine...
    assert plan.fired("stepper.step") == 1

Only one plan is active per process at a time (the seams are global,
like the failures they stand in for); nesting raises.
"""

from __future__ import annotations

import random
import threading
import time


SITES = frozenset(
    {
        "scheduler.loop",
        "stepper.step",
        "stepper.verify",
        "stepper.prefill",
        "prefix_cache.fetch",
        "kv.alloc",
        "kv.swap",
        "kv.transfer",
        "kv.peer",
        "server.dispatch",
        "server.reply",
        "router.dispatch",
        "router.health",
        "net.send",
        "net.recv",
        "net.delay",
        "ps.pull",
        "ps.commit",
        "ps.replicate",
    }
)

ACTIONS = frozenset(
    {"raise", "delay", "drop", "reset", "truncate", "corrupt"}
)


class InjectedFault(RuntimeError):
    """Default exception raised by an armed ``raise`` seam — typed so
    tests (and the blame machinery's counters) can tell an injected
    failure from an organic one."""


_ACTIVE: "FaultPlan | None" = None
_ACTIVE_LOCK = threading.Lock()

# armed-fire observers (the flight recorder's tap): called with
# (site, action, ctx) AFTER a seam matched and BEFORE it acts, so a
# ``raise`` seam's firing is on the record before the exception that
# kills the component it hit. Observers run only on the ARMED path —
# the disarmed fast path in :func:`fire` never reads this list.
_OBSERVERS: list = []
_OBSERVERS_LOCK = threading.Lock()


def add_observer(fn) -> None:
    """Register ``fn(site, action, ctx)`` to be called on every armed
    seam firing (e.g. ``FlightRecorder.fault_observer``). Observers
    must not raise; failures are swallowed — observability must never
    change what an injected fault does."""
    with _OBSERVERS_LOCK:
        if fn not in _OBSERVERS:
            _OBSERVERS.append(fn)


def remove_observer(fn) -> None:
    with _OBSERVERS_LOCK:
        if fn in _OBSERVERS:
            _OBSERVERS.remove(fn)


def _notify(site: str, action: str, ctx: dict) -> None:
    with _OBSERVERS_LOCK:
        observers = list(_OBSERVERS)
    for fn in observers:
        try:
            fn(site, action, ctx)
        except Exception:  # noqa: BLE001 — observers are best-effort
            pass


def describe_active() -> list | None:
    """JSON-able arming state of the active plan (None when disarmed)
    — what a post-mortem bundle records so "was chaos armed, and what
    had fired" is answerable from the bundle alone."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.describe()


def fire(site: str, **ctx) -> str | None:
    """The seam. Disarmed: one global read, one ``None`` check, return.
    Armed: returns the triggered action name for caller-implemented
    behaviors (``drop``/``reset``/``truncate``/``corrupt``), handles
    ``raise`` and ``delay`` in place, returns ``None`` when no seam
    matched this event."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan._fire(site, ctx)


class _Seam:
    __slots__ = (
        "site", "action", "times", "after", "probability", "when",
        "exc", "delay", "fired",
    )

    def __init__(self, site, action, times, after, probability, when,
                 exc, delay):
        self.site = site
        self.action = action
        self.times = times  # None = unbounded
        self.after = int(after)
        self.probability = float(probability)
        self.when = when
        self.exc = exc
        self.delay = float(delay)
        self.fired = 0


class FaultPlan:
    """A seeded, countable set of armed injection seams.

    Thread-safe: seams fire from the scheduler thread, server
    connection threads, and client threads concurrently; all matching
    and bookkeeping happens under one lock (the armed path is test-only
    — the disarmed fast path in :func:`fire` never touches it)."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._seams: dict[str, list[_Seam]] = {}
        self._lock = threading.Lock()

    # -- arming -------------------------------------------------------------

    def arm(self, site: str, action: str = "raise", *, times: int | None = 1,
            after: int = 0, probability: float = 1.0, when=None,
            exc: BaseException | None = None,
            delay: float = 0.0) -> "FaultPlan":
        """Arm ``site`` with ``action``. ``times``: fires before the
        seam exhausts (``None`` = forever). ``after``: matching events
        to let pass first. ``when(ctx)``: context predicate. ``exc``:
        the exception instance a ``raise`` seam throws (default
        ``InjectedFault(site)``). Returns ``self`` for chaining."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; known: "
                             f"{sorted(SITES)}")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; known: "
                             f"{sorted(ACTIONS)}")
        if times is not None and int(times) < 1:
            raise ValueError(f"times must be >= 1 or None; got {times}")
        seam = _Seam(site, action, None if times is None else int(times),
                     after, probability, when, exc, delay)
        with self._lock:
            self._seams.setdefault(site, []).append(seam)
        return self

    # -- activation ---------------------------------------------------------

    def activate(self) -> "FaultPlan":
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None and _ACTIVE is not self:
                raise RuntimeError(
                    "another FaultPlan is already active; deactivate it "
                    "first (seams are process-global)"
                )
            _ACTIVE = self
        return self

    def deactivate(self) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.activate()

    def __exit__(self, *exc) -> None:
        self.deactivate()

    # -- firing -------------------------------------------------------------

    def _fire(self, site: str, ctx: dict) -> str | None:
        with self._lock:
            seam = self._match(site, ctx)
            if seam is None:
                return None
            seam.fired += 1
            action, exc, delay = seam.action, seam.exc, seam.delay
        # act OUTSIDE the lock: a delay seam must not serialize every
        # other seam behind its sleep. Observers see the firing FIRST,
        # so a raise lands in the flight recorder before it propagates.
        _notify(site, action, ctx)
        if action == "raise":
            raise exc if exc is not None else InjectedFault(
                f"injected fault at {site}"
            )
        if action == "delay":
            time.sleep(delay)
        return action

    def _match(self, site: str, ctx: dict) -> _Seam | None:
        """First armed seam for ``site`` whose gates all pass. Caller
        holds the lock."""
        for seam in self._seams.get(site, ()):
            if seam.times is not None and seam.fired >= seam.times:
                continue
            if seam.when is not None and not seam.when(ctx):
                continue
            if seam.after > 0:
                seam.after -= 1
                continue
            if seam.probability < 1.0 and (
                self._rng.random() >= seam.probability
            ):
                continue
            return seam
        return None

    # -- observability ------------------------------------------------------

    def fired(self, site: str | None = None) -> int:
        """Total fires, for one site or the whole plan."""
        with self._lock:
            seams = (
                self._seams.get(site, ())
                if site is not None
                else [s for lst in self._seams.values() for s in lst]
            )
            return sum(s.fired for s in seams)

    def describe(self) -> list:
        """JSON-able arming state: one row per armed seam with its
        gates and fire count — the ``fault_seams`` section of a
        post-mortem bundle."""
        with self._lock:
            return [
                {
                    "site": s.site,
                    "action": s.action,
                    "times": s.times,
                    "after": s.after,
                    "probability": s.probability,
                    "fired": s.fired,
                }
                for lst in self._seams.values()
                for s in lst
            ]
