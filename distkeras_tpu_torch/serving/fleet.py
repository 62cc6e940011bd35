"""Serving fleet: N engine replicas behind a prefix-affinity router
(PyTorch port of ``distkeras_tpu.serving.fleet``; the wire, the affinity
keys and the books are the JAX package's, so a router of either package
fronts replicas of either).

One ``ServingEngine`` process is a vertical ceiling and a single point
of failure — the serving sibling of the problem the replicated
parameter server solved for training. This module is the fleet
front-end over the existing DKT1 wire:

- :class:`FleetRouter` — a TCP router speaking the SAME protocol as
  ``ServingServer`` (a ``ServingClient`` pointed at the router cannot
  tell the difference), forwarding ``generate``/``predict`` to one of
  N replica servers and answering ``health``/``stats``/``metrics``
  with the fleet-level view (``metrics`` aggregates every replica's
  typed-registry snapshot, labeled ``replica="host:port"``; a traced
  request gets a ``router.route`` span recording the affinity
  decision and every failover hop). Replica selection is

  * **health-gated**: a background sweep polls each replica's
    ``health`` verb; ``degraded``/``draining`` replicas and replicas
    that stop answering are EJECTED from rotation and rejoin only
    after a clean poll (``networking.probe`` cheaply re-tests ejected
    listeners before a full health round-trip is spent on them);
  * **prefix-affine**: a ``generate`` routes by rendezvous hash of the
    prompt's longest pow2 ladder key — the exact granularity
    ``PrefixStore`` stores — so shared-header traffic lands on the
    replica whose store already holds that KV. Honest limit: a suffix
    that pushes the prompt past its next power of two changes the key
    (the same exact-ladder granularity the store itself has);
  * **load-accounted**: the router counts its own in-flight forwards
    per replica against the capacity the replica's health advertises
    (``num_slots + queue_capacity``); a saturated affinity home SPILLS
    down the hash order, and only when EVERY replica in rotation is
    saturated (or replies ``overloaded``) does the client see a
    retriable ``overloaded`` with a ``retry_after_ms`` hint;
  * **failover-transparent**: a replica that dies mid-forward is
    ejected and the request is resent to a sibling — bounded (each
    replica tried at most once per request) and only for the verbs
    that are idempotent by the protocol's construction (``generate``/
    ``predict``; the router never forwards ``stop``, the one
    non-idempotent verb, so a failover can never duplicate a
    side-effect). All siblings dead ⇒ typed ``unavailable`` naming
    every endpoint tried and its cause, never a silent hang.

- :class:`FleetController` — owns the replica processes/objects plus
  the router, and implements **rolling bundle upgrade**:
  ``rollover(bundle)`` walks the fleet one replica at a time — boot a
  replacement from the new bundle, health-gate it into rotation, DRAIN
  the old replica at the router (no new work; in-flight forwards
  finish), stop it gracefully (``ServingServer.shutdown(drain=True)``
  — anything it already admitted completes), remove it — so a
  training-tier checkpoint reaches every replica without dropping or
  duplicating a request. Fleet capacity never dips below N during the
  walk because the replacement joins before the old replica leaves.

Fault seams (``distkeras_tpu_torch/faults.py``): ``router.dispatch`` fires
at verb dispatch before a replica is picked (an injected
``ServingError`` rides the typed-reply path; anything else replies
typed ``internal``), ``router.health`` fires per replica per sweep (an
injected raise counts as a failed poll — enough of them ejects the
replica until a clean poll rejoins it).
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time

import numpy as np

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.networking import probe, recv_data, send_data
from distkeras_tpu_torch.obs import stamp_error_trace as _stamp_trace
from distkeras_tpu_torch.serving.prefix_cache import _pow2_ladder, ladder_hashes
from distkeras_tpu_torch.serving.qos import as_bucket
from distkeras_tpu_torch.serving.scheduler import (
    QuotaExhaustedError,
    ServingError,
    ShedError,
)
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    pack_frame,
    unpack_frame,
)

_PROTOCOL = 1


def affinity_key(prompt, min_len: int = 8) -> bytes | None:
    """The routing key of ``prompt``: its longest pow2 ladder prefix —
    the longest prefix ``PrefixStore`` could possibly hold for it — as
    bytes. ``None`` when the prompt is shorter than ``min_len`` (too
    short for the store to ever cache; such requests route least-loaded
    instead)."""
    tokens = np.asarray(prompt, np.int32).reshape(-1)
    lens = _pow2_ladder(int(tokens.size), min_len=min_len)
    if not lens:
        return None
    return np.ascontiguousarray(tokens[: lens[-1]]).tobytes()


def _rendezvous(key: bytes, endpoint) -> int:
    """Highest-random-weight score of ``(key, endpoint)``. Process- and
    run-independent (no builtin ``hash``: PYTHONHASHSEED must not move
    traffic between replicas across restarts)."""
    h = hashlib.blake2b(key, digest_size=8)
    h.update(f"@{endpoint[0]}:{endpoint[1]}".encode())
    return int.from_bytes(h.digest(), "big")


# replica rotation states
JOINING = "joining"    # registered, no clean health poll yet
ACTIVE = "active"      # in rotation
EJECTED = "ejected"    # failed polls / died mid-forward; rejoin on a
                       # clean poll
DRAINING = "draining"  # router-initiated: no new work, in-flight
                       # finishes; sticky until remove_replica


class _RetrySibling(Exception):
    """Internal control flow of the streaming relay: the current
    replica refused/died before any chunk reached the client — move
    to the next candidate."""


class _Replica:
    """Router-side book of one replica endpoint."""

    def __init__(self, endpoint, breaker=None, hist=None):
        self.endpoint = (endpoint[0], int(endpoint[1]))
        self.state = JOINING
        self.fails = 0          # consecutive failed health polls
        self.capacity = None    # num_slots + queue_capacity, from health
        self.in_flight = 0      # router-side forwards outstanding
        self.forwards = 0
        self.failovers = 0      # forwards that died here and moved on
        self.slo_breaches = 0   # consecutive polls reporting slo breach
        self.last_health = None
        # fleet KV fabric, parsed out of the replica's health reply:
        # the KV epoch its frames/digests are stamped with, the
        # prefix-page digest as a membership set (page-aware routing
        # tests rung hashes against it), and when the digest was last
        # refreshed (its AGE is the staleness bound digest routing
        # accepts — at most one health interval behind the store)
        self.kv_epoch = None
        self.kv_digest = None       # frozenset of 4-byte key hashes
        self.kv_digest_gen = None
        self.kv_digest_at = None    # monotonic stamp of last refresh
        # gray-failure defense (None on a breaker-less router): the
        # per-replica circuit breaker and the labeled forward-latency
        # histogram its latency-outlier judgment is computed from
        self.breaker = breaker
        self.hist = hist

    def snapshot(self) -> dict:
        h = self.last_health or {}
        return {
            "endpoint": [self.endpoint[0], self.endpoint[1]],
            "state": self.state,
            "in_flight": self.in_flight,
            "capacity": self.capacity,
            "forwards": self.forwards,
            "failovers": self.failovers,
            "consecutive_poll_failures": self.fails,
            "consecutive_slo_breaches": self.slo_breaches,
            # per-replica decode geometry ("tp:N" / None), from the
            # replica's own health: the autoscaler places models that
            # need N devices only where an N-way replica runs, and the
            # router's books show a heterogeneous fleet honestly
            "mesh": h.get("mesh"),
            # the replica's disaggregation role (prefill / decode /
            # unified), from its health — what role-aware dispatch
            # keys on, and the role column the books render
            "role": h.get("role"),
            # the replica's transfer ledger (pending/sends/recvs/
            # errors/bytes), so the fleet books show where transfer
            # traffic queues without a per-replica metrics scrape
            "transfer": h.get("transfer"),
            # the autoscale signal set, republished from the replica's
            # own health reply: queue occupancy, paged-KV pool
            # pressure, the windowed admission-failure rate and
            # queue-depth slope, and the burn-rate verdict — the
            # policy reads the whole fleet from one in-process
            # ``router.replicas()`` snapshot, no extra scrape
            "queue_depth": h.get("queue_depth"),
            "queue_capacity": h.get("queue_capacity"),
            "kv_page_util": h.get("kv_page_util"),
            "pool_exhausted_rate": h.get("pool_exhausted_rate"),
            "queue_depth_trend": h.get("queue_depth_trend"),
            "burn": h.get("burn"),
            # circuit-breaker state (None on a breaker-less router):
            # closed / open / half_open + the cause of the last open —
            # rides health replies and the dkt_top fleet table
            "breaker": (
                None if self.breaker is None else self.breaker.snapshot()
            ),
            # fleet KV fabric books: the replica's KV epoch, the size/
            # generation/age of its advertised prefix digest, and its
            # own peer-transfer counters republished from health —
            # the dkt_top fabric columns read these without a
            # per-replica metrics scrape
            "kv_fabric": (
                None if self.kv_epoch is None else {
                    "epoch": self.kv_epoch,
                    "digest_n": (
                        None if self.kv_digest is None
                        else len(self.kv_digest)
                    ),
                    "digest_gen": self.kv_digest_gen,
                    "digest_age_s": (
                        None if self.kv_digest_at is None
                        else round(
                            time.monotonic() - self.kv_digest_at, 3
                        )
                    ),
                    "peer": (h.get("kv_fabric") or {}).get("peer"),
                }
            ),
        }


class FleetRouter:
    """DKT1 router over N ``ServingServer`` replicas. ``port=0`` binds
    an ephemeral port (read it back from ``.port``). Start with
    ``start()``; a plain ``ServingClient`` pointed at ``(host, port)``
    speaks to the fleet as if it were one server."""

    #: verbs safe to resend to a sibling after a mid-forward death —
    #: re-running one produces the same answer (greedy decode is
    #: deterministic; a duplicated generate costs compute, never
    #: correctness). ``stop`` is deliberately NOT forwarded at all.
    IDEMPOTENT = frozenset({"generate", "predict"})

    def __init__(self, endpoints=(), host="127.0.0.1", port=0,
                 backlog=64, max_frame_bytes=64 << 20,
                 health_interval=0.25, health_timeout=2.0,
                 eject_after=2, connect_timeout=2.0,
                 request_timeout=120.0, retry_after_ms=50.0,
                 affinity=True, affinity_min_len=8,
                 postmortem_dir=None, eject_on_slo_breach=0,
                 recorder_capacity=1024, tenant_quotas=None,
                 quota_default=None, breaker=None, retry_budget=None,
                 hedge_after=None):
        """``eject_after``: consecutive failed health polls before an
        ACTIVE replica leaves rotation (a mid-forward connection death
        ejects immediately — the poll budget is for the quiet path).
        ``connect_timeout``: dial budget per forward attempt, kept
        short so a silently dead replica fails over in seconds while
        ``request_timeout`` stays long enough for a full generate.
        ``affinity=False`` degrades ``generate`` routing to
        least-loaded (the A/B baseline of affinity placement).

        ``postmortem_dir``: where every replica EJECTION dumps the
        router's post-mortem bundle (recorder ring + rotation books +
        metrics; None keeps only the latest in memory, still served by
        the ``postmortem`` verb). ``eject_on_slo_breach``: when > 0, a
        replica whose health reply reports ``slo: "breach"`` for that
        many CONSECUTIVE polls is ejected like a degraded one, and
        cannot rejoin until a poll shows the breach cleared (0 — the
        default — never ejects on SLO: verdicts stay advisory).

        ``tenant_quotas``: per-tenant admission rate limits — tenant
        name -> a ``qos.TokenBucket``, a ``{"rate":, "burst":}`` dict,
        a ``(rate, burst)`` pair, or a bare rate (requests/second).
        A ``generate`` whose tenant's bucket cannot cover it is
        refused AT THE DOOR with typed retriable ``quota_exhausted``
        carrying the bucket's honest refill time as
        ``retry_after_ms`` — one tenant's burst is shed before it
        holds pages or queue slots anywhere in the fleet.
        ``quota_default``: the bucket spec applied to tenants not
        named in ``tenant_quotas`` (None = unlimited).

        ``breaker``: per-replica circuit breakers (None — the default
        — disables them; True = defaults; a dict passes
        ``resilience.CircuitBreaker`` kwargs, plus three router-side
        sweep knobs it may carry: ``outlier_factor`` (trip when a
        replica's windowed forward p-quantile exceeds factor × the
        fleet median, default 3.0), ``min_latency`` (seconds — below
        this, never an outlier: microsecond jitter is not gray
        failure; default 0.010), ``quantile`` (default 0.99)).
        Breakers trip on typed-error rate AND on latency outliers —
        the slow-but-health-green replica binary ejection can't see —
        and COMPOSE with ejection: a dead replica still ejects, a
        gray one opens its breaker and stops receiving traffic until
        a half-open probe proves it recovered.

        ``retry_budget``: a fleet-wide ``resilience.RetryBudget``
        (True = defaults, dict = kwargs, instance = as-is) enforced on
        retry-MARKED requests (clients stamp resends with a ``retry``
        header field): original attempts deposit, retries withdraw,
        and an exhausted budget refuses the retry typed ``overloaded``
        (``serving_retry_budget_exhausted`` counter) so a thousand
        clients' individually-sane retries cannot compound into a
        storm that keeps the brownout alive.

        ``hedge_after``: router-side request hedging for idempotent
        verbs — seconds, or ``"p95"`` style (resolved from the
        router's own windowed forward-latency history). When the
        primary forward is still in flight after the delay, a sibling
        forward launches against a DIFFERENT replica and the first ok
        reply wins; hedges spend the retry budget when one is set."""
        self.max_frame_bytes = int(max_frame_bytes)
        self.health_interval = float(health_interval)
        self.health_timeout = float(health_timeout)
        self.eject_after = int(eject_after)
        self.connect_timeout = float(connect_timeout)
        self.request_timeout = float(request_timeout)
        self.retry_after_ms = float(retry_after_ms)
        self.affinity = bool(affinity)
        self.affinity_min_len = int(affinity_min_len)
        self.postmortem_dir = postmortem_dir
        self.eject_on_slo_breach = int(eject_on_slo_breach)
        # per-tenant admission buckets, built lazily from the specs
        # (a bucket's refill clock starts at first sight of the
        # tenant). Cardinality-bounded for DEFAULT-quota tenants:
        # tenant is a client-chosen wire string, so past
        # qos.MAX_TENANT_LABELS distinct unconfigured names the tail
        # SHARES one bucket/label — bounded memory beats per-name
        # isolation for an unauthenticated long tail; operator-named
        # tenants in ``tenant_quotas`` are always honored by name
        self._quota_specs = dict(tenant_quotas or {})
        self._quota_default = quota_default
        self._quota_buckets: dict[str, object] = {}
        self._quota_counters: dict[str, object] = {}
        self._quota_seen: set[str] = set(self._quota_specs)
        # overload / gray-failure defense config (resilience.py)
        from distkeras_tpu_torch.serving.resilience import (
            as_breaker_config,
            as_retry_budget,
            resolve_hedge_delay,
        )

        cfg = as_breaker_config(breaker)
        self.breaker_outlier_factor = 3.0
        self.breaker_min_latency = 0.010
        self.breaker_quantile = 0.99
        if cfg is not None:
            self.breaker_outlier_factor = float(cfg.pop("outlier_factor", 3.0))
            self.breaker_min_latency = float(cfg.pop("min_latency", 0.010))
            self.breaker_quantile = float(cfg.pop("quantile", 0.99))
        self._breaker_cfg = cfg
        self.breaker_window = float((cfg or {}).get("window", 30.0))
        self.retry_budget = as_retry_budget(retry_budget)
        self.hedge_after = hedge_after
        if isinstance(hedge_after, (str, int, float)):
            resolve_hedge_delay(hedge_after, None)  # validate the spec
        self.last_postmortem = None
        self.last_postmortem_path = None
        self._lock = threading.Lock()
        self._replicas: dict[tuple, _Replica] = {}
        self._pools: dict[tuple, list] = {}   # idle forward clients
        self._health_clients: dict[tuple, object] = {}
        # per-endpoint poll serialization: the sweep thread and a
        # wait_in_rotation caller must not interleave frames on the
        # one persistent health connection
        self._poll_locks: dict[tuple, threading.Lock] = {}
        self._drained = threading.Condition(self._lock)
        from distkeras_tpu_torch.obs import MetricsRegistry

        # router-owned registry: the old counter dict becomes a
        # CounterGroup (``fleet_router_<key>``; every existing call
        # site and stats() reader keeps working), plus rotation gauges
        # and a forward-latency histogram — the ``metrics`` verb ships
        # these next to every replica's own labeled samples
        self.registry = MetricsRegistry()
        self.counters = self.registry.group(
            "fleet_router",
            (
                "forwards",
                "affinity_routed",  # generate landed on its hash home
                "spilled",        # hash home saturated, next in order
                "least_loaded_routed",
                "failovers",
                "fleet_overloaded",  # every replica saturated/refusing
                "unavailable",    # every replica unreachable
                "ejections",
                "rejoins",
                "quota_rejections",  # per-tenant admission refusals
                # disaggregated dispatch (0 on a role-less fleet).
                # Pairing invariant at quiescence: transfer_sends ==
                # transfer_ok + transfer_typed — every transfer hop
                # dispatched ends in a relayed reply or a typed
                # failure, never a stranded client
                "disagg_routed",   # generates taking the two-hop path
                "transfer_sends",  # kv.transfer hops dispatched
                "transfer_ok",     # ... that completed ok
                "transfer_typed",  # ... that ended typed (any error)
                "transfer_retries",  # mid-hop deaths retried on a
                # sibling decode worker (same bytes, bounded)
                # fleet KV fabric (0 before any fabric traffic).
                # Direct-push pairing ledger, invariant at quiescence:
                # peer_sends == peer_ok + peer_typed + peer_degraded —
                # every prefill dispatched WITH a ``push_to`` pairing
                # settles exactly once: the pushed decode reply relayed
                # (ok), the request concluded typed on the prefill hop
                # (typed), or the blob handed back and relayed over the
                # classic hop-2 path (degraded) — never a stranded
                # client, never a double count
                "peer_sends",      # prefills dispatched with push_to
                "peer_ok",         # ... whose pushed decode reply won
                "peer_typed",      # ... that concluded typed on hop 1
                "peer_degraded",   # ... that fell back to hop-2 relay
                "digest_routed",   # generates routed to the sibling
                # whose advertised prefix digest holds the pages,
                # over the bare rendezvous order
                # circuit breakers (0 on a breaker-less router)
                "breaker_opens",       # closed/half_open -> open
                "breaker_half_opens",  # open -> half_open (probe armed)
                "breaker_closes",      # half_open -> closed (recovered)
                "breaker_probes",      # live requests routed as probes
                "breaker_bypass_forwards",  # non-probe forwards to a
                # non-closed breaker — 0 BY CONSTRUCTION (no
                # breaker-open replica receives a non-probe request)
                # router-side hedging (0 without hedge_after). Pairing
                # invariant at quiescence: launched == wins + losers
                "hedges_launched",
                "hedge_wins",
                "hedge_losers",
            ),
        )
        # the fleet-wide retry-budget refusal counter: refusals here
        # are typed ``overloaded`` replies that deliberately did NOT
        # amplify a retry storm
        self.retry_budget_exhausted = self.registry.counter(
            "serving_retry_budget_exhausted", fresh=True
        )
        if self._breaker_cfg is not None:
            # how many replicas are currently cut off (open or probing)
            # — the dkt_top header column; registered only on a
            # breaker-enabled router so default metric sets are
            # byte-identical to before
            self.registry.gauge(
                "fleet_router_breaker_open_replicas",
                fn=lambda: sum(
                    1 for r in list(self._replicas.values())
                    if r.breaker is not None and r.breaker.state != "closed"
                ),
            )
        self._transfer_inflight = 0
        self.registry.gauge(
            "fleet_router_transfer_inflight",
            fn=lambda: self._transfer_inflight,
        )
        self.registry.gauge(
            "fleet_router_replicas", fn=lambda: len(self._replicas)
        )
        self.registry.gauge(
            "fleet_router_active_replicas",
            fn=lambda: sum(
                r.state == ACTIVE for r in list(self._replicas.values())
            ),
        )
        self.registry.gauge(
            "fleet_router_in_flight",
            fn=lambda: sum(
                r.in_flight for r in list(self._replicas.values())
            ),
        )
        self.registry.gauge(
            "fleet_router_open_connections", fn=lambda: len(self._conns)
        )
        self._forward_hist = self.registry.histogram(
            "fleet_router_forward_seconds"
        )
        # the router's black box: routing/ejection/failover decisions,
        # always-on (the engine-side twin records scheduler events)
        from distkeras_tpu_torch.obs import COLLECTOR, FlightRecorder

        self.recorder = FlightRecorder(capacity=recorder_capacity)
        self.recorder.register_gauges(self.registry, "fleet")
        # router spans land in the process-wide collector; its drops
        # become scrapeable here (the router has no private span ring)
        self.registry.gauge(
            "fleet_router_trace_collector_dropped",
            fn=lambda: COLLECTOR.dropped_total,
        )
        # the router's own performance time-series ring, snapped from
        # the health sweep's existing cadence loop (no new thread):
        # windowed forward rates / ejection trends for the timeseries
        # verb, next to every replica's own windowed digests
        from distkeras_tpu_torch.obs import MetricsHistory

        self.history = MetricsHistory(
            self.registry.snapshot, interval=1.0, capacity=600,
        )
        for ep in endpoints:
            self._replicas[(ep[0], int(ep[1]))] = self._new_replica(ep)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(int(backlog))
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = None
        self._health_thread = None
        self._conn_threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._stopping = threading.Event()
        self._shutdown_done = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._accept_thread is None:
            # armed fault-seam firings (router.dispatch/router.health/
            # net.*) land in the ring, so an ejection bundle names the
            # injections that preceded it
            faults.add_observer(self.recorder.fault_observer)
            self._health_sweep()  # synchronous first sweep: a router
            # that starts with live replicas routes from request one
            self._health_thread = threading.Thread(
                target=self._health_loop, name="fleet-health", daemon=True
            )
            self._health_thread.start()
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="fleet-accept", daemon=True
            )
            self._accept_thread.start()
        return self

    def shutdown(self, drain=True):
        """Close the listener and stop routing. Replicas are NOT
        stopped — the router does not own them (``FleetController``
        does). Idempotent and awaitable, like ``ServingServer``."""
        with self._lock:
            first = not self._stopping.is_set()
            self._stopping.set()
        if not first:
            self._shutdown_done.wait(timeout=90)
            return
        try:
            # shutdown BEFORE close: a bare close does not wake a
            # thread blocked in accept(), which would leak it and
            # stall the join below for its full timeout
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            with self._lock:
                threads = list(self._conn_threads)
            deadline = time.monotonic() + (5 if drain else 0)
            for th in threads:
                th.join(timeout=max(0.0, deadline - time.monotonic()))
            with self._lock:
                lingering = list(self._conns)
            for conn in lingering:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            for th in threads:
                th.join(timeout=5)
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=5)
            if self._health_thread is not None:
                self._health_thread.join(timeout=5)
            with self._lock:
                pools = list(self._pools.values())
                self._pools.clear()
                health = list(self._health_clients.values())
                self._health_clients.clear()
            for pool in pools:
                for cli in pool:
                    cli.close()
            for cli in health:
                cli.close()
        finally:
            faults.remove_observer(self.recorder.fault_observer)
            self._shutdown_done.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # -- rotation management (the controller's face) ------------------------

    def _new_replica(self, ep):
        """Build a ``_Replica``, attaching a circuit breaker and a
        per-replica labeled forward-latency histogram when breakers are
        configured. Breaker-less routers keep the exact metric set they
        had before (no stray labeled series)."""
        if self._breaker_cfg is None:
            return _Replica(ep)
        from distkeras_tpu_torch.serving.resilience import CircuitBreaker

        hist = self.registry.histogram(
            "fleet_router_forward_seconds",
            labels={"replica": f"{ep[0]}:{ep[1]}"},
        )
        return _Replica(
            ep, breaker=CircuitBreaker(**self._breaker_cfg), hist=hist
        )

    def add_replica(self, endpoint) -> None:
        """Register an endpoint. It enters rotation only after a clean
        health poll (health-gated admission) — call
        ``wait_in_rotation`` to block on that."""
        ep = (endpoint[0], int(endpoint[1]))
        with self._lock:
            rep = self._replicas.get(ep)
            if rep is None:
                self._replicas[ep] = self._new_replica(ep)
            elif rep.state == DRAINING:
                # re-adding a drained replica UN-drains it (the aborted-
                # rollover path); it still re-enters via the health gate
                rep.state = JOINING

    def remove_replica(self, endpoint) -> None:
        ep = (endpoint[0], int(endpoint[1]))
        with self._lock:
            self._replicas.pop(ep, None)
            pool = self._pools.pop(ep, [])
            health = self._health_clients.pop(ep, None)
            self._poll_locks.pop(ep, None)
        for cli in pool:
            cli.close()
        if health is not None:
            health.close()

    def drain_replica(self, endpoint) -> None:
        """Take ``endpoint`` out of rotation WITHOUT ejecting it: no
        new requests route there, in-flight forwards complete. Sticky —
        health polls cannot rejoin a draining replica; only
        ``remove_replica`` (or re-``add_replica``) clears the state."""
        ep = (endpoint[0], int(endpoint[1]))
        with self._lock:
            rep = self._replicas.get(ep)
            if rep is not None:
                rep.state = DRAINING
                self.recorder.record(
                    "router.drain", endpoint=f"{ep[0]}:{ep[1]}",
                    in_flight=rep.in_flight,
                )

    def wait_drained(self, endpoint, timeout=60.0) -> bool:
        """Block until the router has ZERO in-flight forwards to
        ``endpoint`` (or it was removed). True on drained."""
        ep = (endpoint[0], int(endpoint[1]))
        deadline = time.monotonic() + float(timeout)
        with self._lock:
            while True:
                rep = self._replicas.get(ep)
                if rep is None or rep.in_flight == 0:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._drained.wait(timeout=min(left, 0.5))

    def wait_in_rotation(self, endpoint, timeout=30.0) -> bool:
        """Block until ``endpoint`` is ACTIVE (health-gated in). The
        wait polls the replica directly rather than riding the sweep
        cadence, so controller rollovers are not paced by
        ``health_interval``."""
        ep = (endpoint[0], int(endpoint[1]))
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                rep = self._replicas.get(ep)
            if rep is None:
                return False
            if rep.state == ACTIVE:
                return True
            self._poll_one(ep)
            time.sleep(min(0.05, self.health_interval))
        return False

    def replicas(self) -> list[dict]:
        with self._lock:
            return [r.snapshot() for r in self._replicas.values()]

    # -- health sweep -------------------------------------------------------

    def _health_loop(self):
        while not self._stopping.is_set():
            self._health_sweep()
            # the time-series cadence rides the sweep loop (cadence-
            # guarded inside: one float compare between snapshots)
            self.history.maybe_snap()
            self._stopping.wait(self.health_interval)

    def _health_sweep(self):
        with self._lock:
            states = {ep: r.state for ep, r in self._replicas.items()}

        def sweep_one(ep, state):
            if self._stopping.is_set():
                return
            if state == EJECTED:
                # cheap dial-probe of an EJECTED listener first: a dead
                # process costs one refused connect, not a full health
                # client + RTT
                err = probe([ep], timeout=self.health_timeout)[ep]
                if err is not None:
                    self._poll_failed(ep)
                    return
            self._poll_one(ep)

        # poll CONCURRENTLY: one unreachable-but-not-refusing endpoint
        # (dropped packets, a stopped process) blocks its own poll for
        # health_timeout; serialized, it would stall ejection of every
        # OTHER replica and grow the sweep cadence with fleet size
        threads = [
            threading.Thread(
                target=sweep_one, args=(ep, st),
                name="fleet-poll", daemon=True,
            )
            for ep, st in states.items()
        ]
        for th in threads:
            th.start()
        deadline = time.monotonic() + self.health_timeout + 2.0
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        # gray-failure detection rides the sweep cadence: compare each
        # replica's windowed forward quantile against the fleet median
        self._breaker_latency_sweep()

    def _poll_one(self, ep):
        with self._lock:
            plock = self._poll_locks.setdefault(ep, threading.Lock())
        try:
            faults.fire("router.health", endpoint=ep)
            with plock:
                cli = self._health_client(ep)
                h = cli.health()
        except Exception:  # noqa: BLE001 — any poll failure counts once
            # close the stale client UNDER the poll lock: a concurrent
            # poller (wait_in_rotation bypasses the sweep cadence) may
            # be mid-health() on this very socket, and a close landing
            # under it would turn a healthy reply into a second failed
            # poll — enough to eject a healthy replica at eject_after=2
            with plock:
                with self._lock:
                    stale = self._health_clients.pop(ep, None)
                if stale is not None:
                    stale.close()
            self._poll_failed(ep)
            return
        dump = None
        with self._lock:
            rep = self._replicas.get(ep)
            if rep is None:
                return
            rep.last_health = h
            # fleet KV fabric: cache the replica's epoch + prefix-page
            # digest as a membership set. A malformed/absent block
            # clears the books (a pre-fabric build mid-rollout must
            # not keep a stale digest routable); the gen guard skips
            # the set rebuild when the store has not moved
            kf = h.get("kv_fabric")
            if isinstance(kf, dict):
                try:
                    rep.kv_epoch = int(kf["epoch"])
                    dg = kf.get("digest")
                    if isinstance(dg, dict):
                        gen = int(dg.get("gen", 0))
                        if (gen != rep.kv_digest_gen
                                or rep.kv_digest is None):
                            rep.kv_digest = frozenset(
                                int(x) for x in (dg.get("h") or ())
                            )
                            rep.kv_digest_gen = gen
                        rep.kv_digest_at = time.monotonic()
                    else:
                        rep.kv_digest = None
                        rep.kv_digest_gen = None
                        rep.kv_digest_at = None
                except (KeyError, TypeError, ValueError):
                    rep.kv_epoch = None
                    rep.kv_digest = None
                    rep.kv_digest_gen = None
                    rep.kv_digest_at = None
            else:
                rep.kv_epoch = None
                rep.kv_digest = None
                rep.kv_digest_gen = None
                rep.kv_digest_at = None
            if h.get("num_slots") is not None:
                rep.capacity = int(h["num_slots"]) + int(
                    h.get("queue_capacity") or 0
                )
            slo_breach = h.get("slo") == "breach"
            if h.get("status") == "serving":
                rep.fails = 0
                if self.eject_on_slo_breach and slo_breach:
                    # the replica serves but violates its SLOs: after
                    # enough CONSECUTIVE breached polls it leaves
                    # rotation like a degraded one, and stays out
                    # until a poll shows the breach cleared
                    rep.slo_breaches += 1
                    if (
                        rep.state == ACTIVE
                        and rep.slo_breaches >= self.eject_on_slo_breach
                    ):
                        self.counters["ejections"] += 1
                        rep.state = EJECTED
                        dump = self._record_eject(
                            ep, "slo_breach",
                            violations=h.get("slo_violations"),
                        )
                else:
                    rep.slo_breaches = 0
                    if rep.state in (JOINING, EJECTED):
                        if rep.state == EJECTED:
                            self.counters["rejoins"] += 1
                            self.recorder.record(
                                "router.rejoin",
                                endpoint=f"{ep[0]}:{ep[1]}",
                            )
                        rep.state = ACTIVE
            else:  # degraded | draining: the replica said so itself
                if rep.state == ACTIVE:
                    self.counters["ejections"] += 1
                    rep.state = EJECTED
                    dump = self._record_eject(
                        ep, str(h.get("status")),
                    )
                rep.fails = max(rep.fails, self.eject_after)
        if dump is not None:
            self._dump_postmortem("replica_ejected", detail=dump)

    def _record_eject(self, ep, cause, **extra) -> dict:
        """Record the ejection in the ring (caller may hold the lock —
        the recorder's own lock is a leaf) and return the post-mortem
        detail dict the caller dumps AFTER releasing the lock."""
        detail = {"endpoint": f"{ep[0]}:{ep[1]}", "cause": cause, **extra}
        self.recorder.record("router.eject", **detail)
        return detail

    def _poll_failed(self, ep):
        dump = None
        with self._lock:
            rep = self._replicas.get(ep)
            if rep is None:
                return
            rep.fails += 1
            if rep.state == ACTIVE and rep.fails >= self.eject_after:
                self.counters["ejections"] += 1
                rep.state = EJECTED
                dump = self._record_eject(
                    ep, "health_polls_failed", fails=rep.fails,
                )
        if dump is not None:
            self._dump_postmortem("replica_ejected", detail=dump)

    def _health_client(self, ep):
        from distkeras_tpu_torch.serving.client import ServingClient

        with self._lock:
            cli = self._health_clients.get(ep)
        if cli is None:
            cli = ServingClient(
                ep[0], ep[1], timeout=self.health_timeout,
                connect_timeout=self.health_timeout, retry=False,
            )
            with self._lock:
                prior = self._health_clients.get(ep)
                if prior is not None:
                    cli.close()
                    return prior
                self._health_clients[ep] = cli
        return cli

    # -- forward-connection pool --------------------------------------------

    def _checkout(self, ep):
        from distkeras_tpu_torch.serving.client import ServingClient

        with self._lock:
            pool = self._pools.setdefault(ep, [])
            if pool:
                return pool.pop()
        return ServingClient(
            ep[0], ep[1], timeout=self.request_timeout,
            connect_timeout=self.connect_timeout, retry=False,
        )

    def _checkin(self, ep, cli):
        with self._lock:
            if ep in self._replicas and not self._stopping.is_set():
                self._pools.setdefault(ep, []).append(cli)
                return
        cli.close()

    # -- connection handling (client side of the router) --------------------

    def _accept_loop(self):
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            th = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="fleet-conn", daemon=True,
            )
            with self._lock:
                self._conn_threads = [
                    t for t in self._conn_threads if t.is_alive()
                ]
                self._conn_threads.append(th)
                self._conns.add(conn)
            th.start()

    def _serve_conn(self, conn):
        try:
            self._serve_frames(conn)
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_frames(self, conn):
        while True:
            try:
                frame = recv_data(conn, max_len=self.max_frame_bytes)
            except ValueError:
                try:
                    send_data(conn, pack_frame(
                        {"ok": False, "error": "frame_too_large",
                         "fatal": True,
                         "max_frame_bytes": self.max_frame_bytes,
                         "detail": f"limit {self.max_frame_bytes} bytes"}
                    ))
                except (ConnectionError, OSError):
                    pass
                return
            except (ConnectionError, OSError):
                return
            req_header = {}
            try:
                req_header, payload = unpack_frame(frame)
                if req_header.get("stream") and (
                    req_header.get("verb") == "generate"
                ):
                    # streaming relay: the router pumps the replica's
                    # chunk frames through to the client itself
                    if not self._stream_route(conn, req_header, payload):
                        return
                    if self._stopping.is_set():
                        return
                    continue
                reply = self._dispatch(req_header, payload)
            except ServingError as e:
                header = {"ok": False, "error": e.code, "detail": str(e)}
                if getattr(e, "retry_after", None) is not None:
                    header["retry_after_ms"] = e.retry_after * 1e3
                elif e.code == "overloaded":
                    header["retry_after_ms"] = self.retry_after_ms
                _stamp_trace(header, req_header, e)
                reply = pack_frame(header)
            except (ConnectionError, OSError) as e:
                # forward-side wire death that escaped failover — only
                # reachable if a non-idempotent verb is ever routed
                # (today none is); typed, never a silent close
                header = {"ok": False, "error": "unavailable",
                          "detail": repr(e),
                          "retry_after_ms": self.retry_after_ms}
                _stamp_trace(header, req_header, e)
                reply = pack_frame(header)
            except Exception as e:  # noqa: BLE001 — wire boundary
                header = {"ok": False, "error": "internal",
                          "detail": repr(e)}
                _stamp_trace(header, req_header, e)
                reply = pack_frame(header)
            try:
                send_data(conn, reply)
            except (ConnectionError, OSError):
                return
            if self._stopping.is_set():
                return

    # -- verbs --------------------------------------------------------------

    def _bucket_for(self, tenant: str):
        bucket = self._quota_buckets.get(tenant)
        if bucket is None:
            spec = self._quota_specs.get(tenant, self._quota_default)
            bucket = as_bucket(spec)
            if bucket is None:
                return None
            with self._lock:
                bucket = self._quota_buckets.setdefault(tenant, bucket)
        return bucket

    def _check_quota(self, header: dict) -> None:
        """Per-tenant admission: a ``generate`` whose tenant's token
        bucket cannot cover it is shed AT THE DOOR — typed retriable
        ``quota_exhausted`` with the bucket's refill time as the
        backoff hint — instead of after it holds pages on a replica."""
        from distkeras_tpu_torch.serving.qos import fold_tenant

        tenant = str(header.get("tenant") or "default")
        with self._lock:
            tenant = fold_tenant(self._quota_seen, tenant)
        bucket = self._bucket_for(tenant)
        if bucket is None:
            return
        wait = bucket.take()
        if wait <= 0:
            return
        with self._lock:
            self.counters["quota_rejections"] += 1
            c = self._quota_counters.get(tenant)
            if c is None:
                c = self._quota_counters[tenant] = self.registry.counter(
                    "serving_quota_rejections",
                    labels={"tenant": tenant},
                )
            c.inc()
        self.recorder.record(
            "qos.quota_reject", tenant=tenant,
            retry_after_ms=round(wait * 1e3, 3),
        )
        raise QuotaExhaustedError(
            f"tenant {tenant!r} admission quota exhausted",
            retry_after_ms=wait * 1e3,
        )

    def _check_retry_budget(self, header: dict) -> None:
        """Fleet-side retry-storm damping: original attempts deposit
        into the shared budget, retry-marked requests (the client
        stamps resends with a ``retry`` header field) withdraw — and
        when the fleet-wide budget is dry the retry is refused typed
        ``overloaded`` IMMEDIATELY, without touching a replica. This
        is the second enforcement point behind the client's own
        budget: a thousand clients each retrying within their
        individual budgets still cannot compound into a fleet-wide
        amplification storm."""
        if self.retry_budget is None:
            return
        if not header.get("retry"):
            self.retry_budget.note_attempt()
            return
        if self.retry_budget.acquire():
            return
        self.retry_budget_exhausted.inc()
        self.recorder.record(
            "router.retry_budget_exhausted",
            verb=header.get("verb"),
            attempt=header.get("retry"),
        )
        raise ShedError(
            "fleet retry budget exhausted; not amplifying retries",
            retry_after_ms=self.retry_after_ms,
        )

    def _roles(self):
        """Role partition of the ACTIVE rotation: ``(prefill_n,
        decode_n, disagg)`` — disagg dispatch engages only when BOTH
        roles are represented (a half-provisioned role split keeps
        routing to whatever can serve alone)."""
        with self._lock:
            pre = sum(
                r.state == ACTIVE
                and (r.last_health or {}).get("role") == "prefill"
                for r in self._replicas.values()
            )
            dec = sum(
                r.state == ACTIVE
                and (r.last_health or {}).get("role") == "decode"
                for r in self._replicas.values()
            )
        return pre, dec, bool(pre and dec)

    def _dispatch(self, header: dict, payload: bytes) -> bytes:
        verb = header.get("verb")
        faults.fire("router.dispatch", verb=verb)
        if verb in ("generate", "predict"):
            self._check_retry_budget(header)
        if verb == "generate":
            self._check_quota(header)
            if self._roles()[2]:
                # role-split fleet: prompts prefill on a prefill
                # worker, the finished slot resumes on a decode
                # worker — the two-hop disaggregated path
                reply, body = self._route_disagg(header, payload)
                return pack_frame(reply, body)
        if verb in ("generate", "predict"):
            reply, body = self._route_maybe_hedged(header, payload)
            return pack_frame(reply, body)
        if verb == "health":
            return pack_frame(self._health_reply())
        if verb == "stats":
            return pack_frame({"ok": True, "stats": self.stats()})
        if verb == "metrics":
            return pack_frame(self._metrics_reply(header))
        if verb == "timeseries":
            return pack_frame(self._timeseries_reply(header))
        if verb == "postmortem":
            # the ROUTER's latest bundle (replica ejections); replica
            # engines serve their own over their own ports
            bundle, path = self.postmortem()
            return pack_frame(
                {"ok": True, "postmortem": bundle, "path": path}
            )
        if verb == "stop":
            # stop THE ROUTER (reply first, drain on a side thread,
            # mirroring ServingServer). Replica lifecycle belongs to
            # the controller: forwarding stop would tear down capacity
            # behind its back, and stop is the one non-idempotent verb.
            threading.Thread(
                target=self.shutdown, kwargs={"drain": True}, daemon=True
            ).start()
            return pack_frame({"ok": True, "stopping": True})
        raise ValueError(f"unknown verb {verb!r}")

    def _health_reply(self) -> dict:
        with self._lock:
            reps = [r.snapshot() for r in self._replicas.values()]
        active = sum(r["state"] == ACTIVE for r in reps)
        if self._stopping.is_set():
            status = "draining"
        elif active > 0:
            status = "serving"
        else:
            status = "degraded"
        roles: dict = {}
        for r in reps:
            if r["state"] == ACTIVE:
                roles[r.get("role") or "unified"] = (
                    roles.get(r.get("role") or "unified", 0) + 1
                )
        return {
            "ok": True,
            "protocol": _PROTOCOL,
            "role": "router",
            "status": status,
            "endpoint": [self.host, int(self.port)],
            "max_frame_bytes": self.max_frame_bytes,
            "replicas": reps,
            "active_replicas": active,
            # the role census + whether two-hop dispatch is engaged —
            # a half-provisioned role split is visible here, not just
            # as mysteriously-unified routing
            "roles": roles,
            "disagg": bool(
                roles.get("prefill") and roles.get("decode")
            ),
        }

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["replicas"] = [r.snapshot() for r in self._replicas.values()]
            out["open_connections"] = len(self._conns)
        out["affinity_enabled"] = self.affinity
        return out

    def _dump_postmortem(self, reason: str, detail=None):
        """The router's post-mortem bundle (shared schema): recorder
        ring, its own metrics samples, the per-replica rotation books
        as the in-flight table, and the routing config. Never called
        under the router lock — the dump walks the registry and may
        touch disk."""
        from distkeras_tpu_torch.obs import dump_postmortem as _dump

        bundle, path = _dump(
            self.postmortem_dir, "fleet_router", reason,
            recorder=self.recorder, metrics=self.registry.snapshot(),
            in_flight=self.replicas(),
            config={
                "affinity": self.affinity,
                "eject_after": self.eject_after,
                "health_interval": self.health_interval,
                "eject_on_slo_breach": self.eject_on_slo_breach,
            },
            detail=detail,
        )
        self.last_postmortem = bundle
        self.last_postmortem_path = path
        return bundle, path

    def postmortem(self):
        """Latest router bundle (in-memory first, then the newest file
        in ``postmortem_dir``); ``(None, None)`` when no replica has
        ever been ejected."""
        if self.last_postmortem is not None:
            return self.last_postmortem, self.last_postmortem_path
        if self.postmortem_dir is not None:
            from distkeras_tpu_torch.obs import latest_postmortem

            return latest_postmortem(self.postmortem_dir)
        return None, None

    def _metrics_reply(self, header: dict) -> dict:
        """The fleet-level ``metrics`` verb: the router's own registry
        samples labeled ``replica="router"`` plus every registered
        replica's ``metrics`` snapshot labeled with its endpoint —
        one scrape shows the whole fleet, per-replica attributed. A
        replica that fails the scrape is named in ``unreachable``
        rather than silently missing (rotation is untouched: scraping
        is observability, ejection belongs to the health sweep)."""
        from distkeras_tpu_torch.obs import label_samples, render_prometheus

        samples = label_samples(self.registry.snapshot(), replica="router")
        unreachable = []
        eps, results, errors = self._scrape_replicas(
            lambda cli: cli.metrics(), "fleet-scrape"
        )
        for ep in eps:
            if ep in results:
                samples += label_samples(results[ep],
                                         replica=f"{ep[0]}:{ep[1]}")
            else:
                unreachable.append({
                    "endpoint": [ep[0], ep[1]],
                    "error": errors.get(ep, "scrape timed out"),
                })
        reply = {"ok": True, "unreachable": unreachable}
        if header.get("format") == "prometheus":
            reply["format"] = "prometheus"
            reply["text"] = render_prometheus(samples)
        else:
            reply["metrics"] = samples
        return reply

    def _scrape_replicas(self, call, thread_name: str):
        """Concurrently run ``call(client)`` against every registered
        replica's persistent health client (under its poll lock so a
        concurrent sweep never interleaves frames); returns ``(eps,
        results, errors)`` keyed by endpoint. A failing client may be
        mid-frame desynced: it is dropped (the next poll redials) and
        reported, never ejected — scraping is observability, ejection
        belongs to the health sweep. Serialized scraping would stall
        the whole fleet scrape (and dkt_top) by health_timeout PER
        dead replica while holding its poll lock, hence the fan-out.
        Shared by the ``metrics`` and ``timeseries`` verbs."""
        with self._lock:
            eps = list(self._replicas)
        results: dict = {}
        errors: dict = {}

        def scrape_one(ep):
            with self._lock:
                plock = self._poll_locks.setdefault(ep, threading.Lock())
            try:
                with plock:
                    results[ep] = call(self._health_client(ep))
            except Exception as e:  # noqa: BLE001 — scrape best-effort
                with plock:
                    with self._lock:
                        stale = self._health_clients.pop(ep, None)
                    if stale is not None:
                        stale.close()
                errors[ep] = repr(e)

        threads = [
            threading.Thread(target=scrape_one, args=(ep,),
                             name=thread_name, daemon=True)
            for ep in eps
        ]
        for th in threads:
            th.start()
        deadline = time.monotonic() + self.health_timeout + 2.0
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        return eps, results, errors

    def _timeseries_reply(self, header: dict) -> dict:
        """The fleet-level ``timeseries`` verb: the router's own
        windowed digest (series labeled ``replica="router"``) plus
        every registered replica's ``timeseries`` reply, each series
        row endpoint-labeled and merged into ONE flat ``series`` list
        (the same shape ``metrics`` aggregation ships, so dkt_top
        renders either). Per-replica burn verdicts land under
        ``burn`` keyed by endpoint; a replica that fails the scrape
        is named in ``unreachable``, never silently missing; a
        HEALTHY replica that refuses the verb typed (history=False,
        or a pre-timeseries build mid-rollout) is named in
        ``no_history`` — not a fleet hole."""
        from distkeras_tpu_torch.obs import label_samples

        window = header.get("window")
        points = int(header.get("points") or 30)
        names = header.get("names")
        self.history.maybe_snap()
        own = self.history.digest(
            window=60.0 if window is None else float(window),
            names=names, points=points,
        )
        series = label_samples(own.pop("series"), replica="router")
        reply = {
            "ok": True,
            **own,
            "burn": {},
            "unreachable": [],
        }
        from distkeras_tpu_torch.serving.scheduler import ServingError

        def ts_one(cli):
            try:
                return cli.timeseries(
                    window=window, names=names, points=points,
                )
            except ServingError as e:
                # a typed bad_request is a HEALTHY replica that cannot
                # serve the verb (history=False, or a pre-timeseries
                # build mid-rollout): a clean reply, so the shared
                # health client is NOT desynced — absorb it instead of
                # letting the scrape close/redial the client every
                # poll and render the replica as a fleet hole
                if getattr(e, "code", "") == "bad_request":
                    return {"series": [], "burn": None,
                            "no_history": True}
                raise

        eps, results, errors = self._scrape_replicas(
            ts_one, "fleet-ts-scrape"
        )
        reply["no_history"] = []
        for ep in eps:
            label = f"{ep[0]}:{ep[1]}"
            if ep in results:
                r = results[ep]
                series += label_samples(
                    r.get("series") or [], replica=label
                )
                if r.get("burn") is not None:
                    reply["burn"][label] = r["burn"]
                if r.get("no_history"):
                    reply["no_history"].append(label)
            else:
                reply["unreachable"].append({
                    "endpoint": [ep[0], ep[1]],
                    "error": errors.get(ep, "scrape timed out"),
                })
        reply["series"] = series
        return reply

    # -- routing ------------------------------------------------------------

    def _affinity_key(self, verb, payload):
        return self._affinity_info(verb, payload)[0]

    def _affinity_info(self, verb, payload):
        """``(key, rungs)`` of one generate payload: the rendezvous
        routing key, plus the prompt's pow2-ladder digest hashes
        ``[(p, h)]`` that page-aware routing and peer-fetch hints test
        against replica digests. ``(None, None)`` for non-generate
        verbs, affinity-off routers, prompts too short to cache, and
        undecodable payloads (routing must not pre-judge what the
        replica will refuse typed ``bad_request``)."""
        if verb != "generate" or not self.affinity:
            return None, None
        try:
            prompt = deserialize_params(payload)
        except Exception:  # noqa: BLE001 — let the replica reply typed
            return None, None
        key = affinity_key(prompt, min_len=self.affinity_min_len)
        if key is None:
            return None, None
        return key, ladder_hashes(prompt, min_len=self.affinity_min_len)

    def _peer_hints(self, chosen, rungs, cap=2):
        """Sibling peer-fetch hints for one generate landing on
        ``chosen`` (caller holds the lock): up to ``cap`` ACTIVE
        replicas whose advertised digest holds a rung of this prompt,
        longest-held first, each as ``{"endpoint", "epoch", "len"}``.
        The engine fetches fail-soft: a stale digest (at most one
        health interval old) costs one refused/missed fetch and a
        local recompute, never a wrong token."""
        scored = []
        for r in self._replicas.values():
            if r.endpoint == chosen or r.state != ACTIVE:
                continue
            held = r.kv_digest
            if not held:
                continue
            p = max((p for p, hsh in rungs if hsh in held), default=0)
            if p:
                scored.append((p, r))
        scored.sort(key=lambda t: -t[0])
        return [
            {
                "endpoint": [r.endpoint[0], r.endpoint[1]],
                "epoch": r.kv_epoch,
                "len": int(p),
            }
            for p, r in scored[:cap]
        ]

    def _pick_decode_for_push(self, key, rungs):
        """Reserve the decode half of one direct-push pairing (caller
        holds the lock): ACTIVE decode-role replicas whose breaker is
        CLOSED and that have capacity, preferring the digest holder,
        then rendezvous order (least-loaded when the prompt has no
        key). Returns ``(replica, how)`` or ``(None, None)``.
        Half-open/open breakers deliberately disqualify here rather
        than probe: probe grant/settle semantics live in
        ``_forward_loop``, and a push outcome reported second-hand by
        the prefill worker is too indirect to settle a canary — such
        pairings fall back to the classic relay, which probes
        properly."""
        cands = [
            r for r in self._replicas.values()
            if r.state == ACTIVE
            and (r.last_health or {}).get("role") == "decode"
            and (r.breaker is None or r.breaker.state == "closed")
            and (r.capacity is None or r.in_flight < r.capacity)
        ]
        if not cands:
            return None, None
        if key is not None:
            order = sorted(
                cands,
                key=lambda r: _rendezvous(key, r.endpoint),
                reverse=True,
            )
            if rungs:
                best = best_i = None
                best_p = 0
                for i, rep in enumerate(order):
                    held = rep.kv_digest
                    if not held:
                        continue
                    p = max(
                        (p for p, hsh in rungs if hsh in held),
                        default=0,
                    )
                    if p > best_p:
                        best, best_i, best_p = rep, i, p
                if best is not None:
                    return best, (
                        "affinity" if best_i == 0 else "digest"
                    )
            return order[0], "affinity"
        order = sorted(
            cands,
            key=lambda r: (
                r.in_flight / r.capacity if r.capacity else r.in_flight
            ),
        )
        return order[0], "least_loaded"

    def _pick(self, key, excluded, roles=None, rungs=None):
        """One routing decision under the lock: ``(replica, how,
        probe)`` or ``(None, why, False)`` — ``why`` is "empty"
        (nothing in rotation), "tried" (every rotation member already
        excluded this request), or "saturated" (members remain but
        none has capacity). ``probe`` is True when the pick is a
        half-open breaker probe: the request is the live canary that
        decides whether the breaker closes.
        ``roles``: restrict candidates to replicas whose health
        advertises one of these disaggregation roles (None = any —
        the role-less fleet's behavior, byte-for-byte).
        ``rungs``: the prompt's pow2-ladder digest hashes ``[(p, h)]``
        — page-aware routing: the candidate whose advertised prefix
        digest holds the LONGEST rung wins over the bare rendezvous
        order (the pages are warm there NOW; the hash only predicts
        where they would have been inserted). Rendezvous order breaks
        ties so equally-warm siblings cannot flap, and the rendezvous
        home keeps its "affinity" label when it is itself the best
        holder — "digest" marks a real deviation."""
        cands = [
            r for r in self._replicas.values()
            if r.state == ACTIVE and (
                roles is None
                or (r.last_health or {}).get("role") in roles
            )
        ]
        if not cands:
            return None, "empty", False
        fresh = [r for r in cands if r.endpoint not in excluded]
        if not fresh:
            return None, "tried", False
        if self._breaker_cfg is not None:
            from distkeras_tpu_torch.serving import resilience

            # probes preempt normal routing: an open breaker must not
            # starve its own recovery behind healthy siblings
            due = [
                r for r in fresh
                if r.breaker is not None and r.breaker.probe_due()
            ]
            if due:
                rep = min(due, key=lambda r: r.breaker.opened_at or 0.0)
                granted, change = rep.breaker.try_probe()
                if granted:
                    self._breaker_change(rep.endpoint, change)
                    return rep, "probe", True
            allowed = [
                r for r in fresh
                if r.breaker is None
                or r.breaker.state == resilience.CLOSED
            ]
            if not allowed:
                # every candidate's breaker is open/probing: force one
                # probe through rather than refusing a fleet that may
                # have recovered (least-recently-opened goes first)
                for rep in sorted(
                    fresh, key=lambda r: r.breaker.opened_at or 0.0
                ):
                    granted, change = rep.breaker.try_probe(force=True)
                    if granted:
                        self._breaker_change(rep.endpoint, change)
                        return rep, "probe", True
                return None, "saturated", False
            fresh = allowed
        if key is not None:
            order = sorted(
                fresh,
                key=lambda r: _rendezvous(key, r.endpoint),
                reverse=True,
            )
            if rungs:
                best = best_i = None
                best_p = 0
                for i, rep in enumerate(order):
                    held = rep.kv_digest
                    if not held or not (
                        rep.capacity is None
                        or rep.in_flight < rep.capacity
                    ):
                        continue
                    p = max(
                        (p for p, hsh in rungs if hsh in held),
                        default=0,
                    )
                    if p > best_p:
                        best, best_i, best_p = rep, i, p
                if best is not None:
                    return best, (
                        "affinity" if best_i == 0 else "digest"
                    ), False
            for i, rep in enumerate(order):
                if rep.capacity is None or rep.in_flight < rep.capacity:
                    return rep, ("affinity" if i == 0 else "spill"), False
            return None, "saturated", False
        order = sorted(
            fresh,
            key=lambda r: (
                r.in_flight / r.capacity if r.capacity else r.in_flight
            ),
        )
        for rep in order:
            if rep.capacity is None or rep.in_flight < rep.capacity:
                return rep, "least_loaded", False
        return None, "saturated", False

    _HOW_COUNTER = {
        "affinity": "affinity_routed",
        "spill": "spilled",
        "least_loaded": "least_loaded_routed",
        "probe": "breaker_probes",
        "digest": "digest_routed",
    }

    def _breaker_change(self, ep, change, cause=None):
        """Account a breaker state transition (counter + recorder).
        Lock-free leaves only — safe under or outside the router
        lock; no-op when ``change`` is None."""
        if change is None:
            return
        old, new = change
        from distkeras_tpu_torch.serving import resilience

        key = {
            resilience.OPEN: "breaker_opens",
            resilience.HALF_OPEN: "breaker_half_opens",
            resilience.CLOSED: "breaker_closes",
        }[new]
        self.counters[key] += 1
        self.recorder.record(
            "router.breaker", endpoint=f"{ep[0]}:{ep[1]}",
            old=old, new=new, cause=cause,
        )

    def _note_breaker(self, ep, ok, probe):
        """Feed one forward outcome to ``ep``'s breaker (no-op on a
        breaker-less router). ``probe`` outcomes settle the half-open
        state; normal outcomes feed the windowed error rate."""
        if self._breaker_cfg is None:
            return
        with self._lock:
            rep = self._replicas.get(ep)
            br = rep.breaker if rep is not None else None
        if br is None:
            return
        if probe:
            change = br.record_probe(ok)
        elif ok:
            change = br.record_success()
        else:
            change = br.record_failure()
        self._breaker_change(ep, change, cause=br.open_cause)

    def _breaker_latency_sweep(self):
        """Latency-outlier detection: compare each ACTIVE replica's
        windowed forward-latency quantile against the fleet median and
        feed ``note_latency`` streaks. This is the gray-failure seam —
        a replica whose health polls stay green but whose forwards run
        3× the fleet is tripped here, where binary ejection never
        would. Replicas with no windowed data are SKIPPED (unknown is
        neutral, not healthy: a silent streak reset would mask an
        outlier that briefly stopped receiving traffic)."""
        if self._breaker_cfg is None or self.history is None:
            return
        with self._lock:
            reps = [
                r for r in self._replicas.values()
                if r.state == ACTIVE and r.breaker is not None
            ]
        if len(reps) < 2:
            return
        vals = {}
        for r in reps:
            ep = r.endpoint
            q = self.history.quantile_over(
                "fleet_router_forward_seconds",
                window=self.breaker_window, q=self.breaker_quantile,
                labels={"replica": f"{ep[0]}:{ep[1]}"},
            )
            if q is not None:
                vals[ep] = q
        if len(vals) < 2:
            return
        ordered = sorted(vals.values())
        # LOWER median: with 2 replicas the upper median IS the slow
        # one's own quantile, which could never exceed 3× itself — a
        # two-replica fleet with one gray member must still trip
        med = ordered[(len(ordered) - 1) // 2]
        for r in reps:
            ep = r.endpoint
            if ep not in vals:
                continue  # no data: neither outlier nor reset
            v = vals[ep]
            outlier = (
                v > self.breaker_outlier_factor * max(med, 1e-9)
                and v >= self.breaker_min_latency
            )
            change = r.breaker.note_latency(outlier)
            self._breaker_change(
                ep, change, cause=r.breaker.open_cause
            )

    def _route(self, header: dict, payload: bytes, picked=None,
               pre_excluded=None):
        """Pick a replica, forward, failover. Returns ``(reply, body)``
        to relay verbatim (the replica's typed errors — deadline,
        internal, bad_request — pass through untouched; only fleet-wide
        saturation and fleet-wide death are the router's own replies).

        Tracing: a request carrying a ``trace`` header field gets a
        ``router.route`` span recording the routing decision (affinity
        key, chosen replica, affinity/spill/least-loaded, every
        failover hop) — appended to the reply's timeline when the
        client asked for it, and parenting the replica's own server
        span (each forward attempt carries a fresh child context)."""
        from distkeras_tpu_torch.obs import TraceContext, start_span

        verb = header.get("verb")
        key, rungs = self._affinity_info(verb, payload)
        ctx = TraceContext.from_wire(header.get("trace"))
        span = None
        hops: list[str] = []
        if ctx is not None:
            span = start_span(
                "router.route", ctx, verb=verb,
                affinity_key=(
                    None if key is None
                    else hashlib.blake2b(key, digest_size=4).hexdigest()
                ),
            )
            header = dict(header)  # per-attempt child contexts below
        # ``picked`` (shared list): a hedged sibling call appends its
        # endpoints here so the hedge excludes them (first-wins only
        # means anything when the two attempts land on DIFFERENT
        # replicas); ``pre_excluded`` is that exclusion set
        excluded: set = set(pre_excluded or ())
        causes = []
        saw_overloaded_hint = None

        def finish(reply, status, how=None, replica=None):
            """End the router span (terminal belongs to the CLIENT) and
            ride the reply: append to a returned timeline, or stamp the
            bare trace id on the router's own typed errors."""
            if span is None:
                return reply
            rec = span.end(
                status=status, how=how, replica=replica, hops=hops,
                failovers=len(causes),
            )
            tr = reply.setdefault("trace", {"id": ctx.trace_id})
            if ctx.want_timeline:
                tr.setdefault("timeline", []).append(rec)
            return reply

        # a prefill-role worker can never serve a plain generate
        # (typed wrong_role) — keep it out of the candidate set even
        # when the decode side of a role split is temporarily gone
        roles = (
            (None, "unified", "decode") if verb == "generate" else None
        )
        if picked is None:
            picked = []
        while True:
            peers = None
            with self._lock:
                rep, how, probe = self._pick(
                    key, excluded, roles=roles, rungs=rungs
                )
                if rep is not None:
                    rep.in_flight += 1
                    rep.forwards += 1
                    self.counters["forwards"] += 1
                    self.counters[self._HOW_COUNTER[how]] += 1
                    ep = rep.endpoint
                    picked.append(ep)
                    if rungs:
                        # fleet KV fabric: name the siblings whose
                        # digests hold this prompt's pages so the
                        # chosen replica can peer-fetch instead of
                        # recomputing the shared prefix
                        peers = self._peer_hints(ep, rungs)
                    if (rep.breaker is not None and not probe
                            and rep.breaker.state != "closed"):
                        # defensive tripwire — 0 by construction
                        self.counters["breaker_bypass_forwards"] += 1
            if rep is not None:
                # per-attempt hints: a failover sibling gets hints
                # computed against ITS endpoint (never pointing a
                # replica at itself), and loses stale ones
                header = dict(header)
                if peers:
                    header["kv_peers"] = peers
                else:
                    header.pop("kv_peers", None)
            if rep is None:
                if how == "saturated" or saw_overloaded_hint is not None:
                    with self._lock:
                        self.counters["fleet_overloaded"] += 1
                    self.recorder.record(
                        "router.route", verb=verb,
                        outcome="fleet_overloaded", hops=hops,
                    )
                    hint = saw_overloaded_hint or self.retry_after_ms
                    return finish({
                        "ok": False, "error": "overloaded",
                        "detail": "every fleet replica is saturated",
                        "retry_after_ms": float(hint),
                    }, "overloaded"), b""
                with self._lock:
                    self.counters["unavailable"] += 1
                detail = "no replica in rotation" if how == "empty" else (
                    "every replica failed: " + "; ".join(
                        f"{h}:{p}: {e!r}" for (h, p), e in causes
                    )
                )
                self.recorder.record(
                    "router.route", verb=verb, outcome="unavailable",
                    hops=hops,
                )
                return finish({
                    "ok": False, "error": "unavailable", "detail": detail,
                    "retry_after_ms": self.retry_after_ms,
                }, "unavailable"), b""
            if ctx is not None:
                # a fresh child per attempt: a failover resend gets its
                # own server-side span id under the same router span
                header["trace"] = ctx.child().to_wire()
            fwd_t0 = time.monotonic()
            try:
                cli = self._checkout(ep)
                try:
                    reply, body = cli._roundtrip(
                        header, payload, raise_on_error=False
                    )
                except BaseException:
                    cli.close()
                    raise
                self._checkin(ep, cli)
            except (ConnectionError, OSError) as e:
                hops.append(f"{ep[0]}:{ep[1]} died")
                self._note_breaker(ep, ok=False, probe=probe)
                self._forward_died(ep, e, causes, excluded)
                # every verb _dispatch routes today IS idempotent, so
                # this always continues (bounded: ep now in excluded);
                # the raise is the safety net for a future non-
                # idempotent routed verb, which must surface the death
                # rather than risk a duplicated side effect
                if verb in self.IDEMPOTENT:
                    continue
                raise
            finally:
                dt = time.monotonic() - fwd_t0
                self._forward_hist.observe(dt)
                with self._lock:
                    r = self._replicas.get(ep)
                    if r is not None:
                        r.in_flight -= 1
                        if r.hist is not None:
                            r.hist.observe(dt)
                        self._drained.notify_all()
            # backpressure (overloaded/quota) is the replica WORKING,
            # not failing — only internal errors count against the
            # breaker's error window
            self._note_breaker(
                ep,
                ok=(bool(reply.get("ok"))
                    or reply.get("error") != "internal"),
                probe=probe,
            )
            if (not reply.get("ok")
                    and reply.get("error") == "overloaded"):
                # replica-level saturation the router's accounting
                # missed (capacity estimate stale): try a sibling; the
                # client only sees overloaded when EVERY one refused
                hops.append(f"{ep[0]}:{ep[1]} overloaded")
                excluded.add(ep)
                hint = reply.get("retry_after_ms")
                if hint is not None:
                    saw_overloaded_hint = max(
                        saw_overloaded_hint or 0.0, float(hint)
                    )
                continue
            hops.append(
                f"{ep[0]}:{ep[1]} "
                + ("ok" if reply.get("ok") else str(reply.get("error")))
            )
            # the always-on black-box line (the trace span above is
            # opt-in per request; the ring is not)
            self.recorder.record(
                "router.route", verb=verb,
                replica=f"{ep[0]}:{ep[1]}", how=how,
                failovers=len(causes),
                outcome=(
                    "ok" if reply.get("ok") else str(reply.get("error"))
                ),
            )
            return finish(
                reply,
                "ok" if reply.get("ok") else str(reply.get("error")),
                how=how, replica=f"{ep[0]}:{ep[1]}",
            ), body

    # -- router-side hedging ------------------------------------------------

    def _route_maybe_hedged(self, header: dict, payload: bytes):
        """``_route``, hedged when configured: when the primary
        forward is still in flight after the hedge delay, launch a
        sibling attempt against a replica the primary has NOT touched
        and return the first ok reply. Safe because every hedged verb
        is idempotent and served decode is deterministic — the two
        replies are token-identical, so first-wins changes latency,
        never content."""
        delay = self._hedge_delay()
        if delay is None:
            return self._route(header, payload)
        return self._route_hedged(header, payload, delay)

    def _hedge_delay(self):
        """Resolve ``hedge_after`` to seconds for THIS request: a
        number is used as-is; a ``"p95"`` spec reads the router's own
        windowed forward-latency history (None — no hedging — until
        that window has data)."""
        if self.hedge_after is None:
            return None
        if isinstance(self.hedge_after, str):
            q = float(self.hedge_after[1:]) / 100.0
            return self.history.quantile_over(
                "fleet_router_forward_seconds", window=60.0, q=q,
            )
        return float(self.hedge_after)

    def _route_hedged(self, header: dict, payload: bytes, delay):
        """First-usable-reply-wins pair of ``_route`` calls. The
        hedge excludes every replica the primary picked (a hedge
        landing on the same gray replica defends nothing); its header
        carries ``hedge: True`` purely for observability. The loser's
        reply is discarded — both attempts run to completion on their
        replicas (the router cannot cancel a forwarded request), which
        is the standard hedging trade: bounded extra work for cut tail
        latency. Hedges spend the retry budget when one is set, so a
        brownout throttles hedging before hedging feeds the brownout."""
        cond = threading.Condition()
        state = {"primary": None, "hedge": None, "winner": None}

        def finish(kind, result):
            with cond:
                state[kind] = result
                if state["winner"] is None and result is not None:
                    reply = result[0]
                    if isinstance(reply, dict) and reply.get("ok"):
                        state["winner"] = kind
                cond.notify_all()

        picked: list = []

        def run_primary():
            try:
                res = self._route(header, payload, picked=picked)
            except BaseException as e:  # noqa: BLE001 — wire boundary
                res = (
                    {"ok": False, "error": "internal",
                     "detail": repr(e)},
                    b"",
                )
            finish("primary", res)

        t_primary = threading.Thread(
            target=run_primary, name="fleet-hedge-primary", daemon=True
        )
        t_primary.start()
        with cond:
            cond.wait_for(
                lambda: state["primary"] is not None, timeout=delay
            )
            primary_done = state["primary"] is not None
        hedged = False
        if not primary_done and (
            self.retry_budget is None or self.retry_budget.acquire()
        ):
            hedged = True
            with self._lock:
                self.counters["hedges_launched"] += 1
            self.recorder.record(
                "router.hedge", verb=header.get("verb"),
                delay_ms=round(delay * 1e3, 3),
            )

            def run_hedge():
                hdr2 = dict(header)
                hdr2["hedge"] = True
                try:
                    res = self._route(
                        hdr2, payload, pre_excluded=set(picked)
                    )
                except BaseException as e:  # noqa: BLE001
                    res = (
                        {"ok": False, "error": "internal",
                         "detail": repr(e)},
                        b"",
                    )
                finish("hedge", res)

            threading.Thread(
                target=run_hedge, name="fleet-hedge", daemon=True
            ).start()
        with cond:
            cond.wait_for(lambda: (
                state["winner"] is not None
                or (state["primary"] is not None
                    and (not hedged or state["hedge"] is not None))
            ))
            winner = state["winner"]
        if hedged:
            # exactly one ledger entry per launched hedge:
            # launched == wins + losers
            with self._lock:
                if winner == "hedge":
                    self.counters["hedge_wins"] += 1
                else:
                    self.counters["hedge_losers"] += 1
        if winner == "hedge":
            return state["hedge"]
        return state["primary"]

    def _forward_loop(self, header, payload, key, roles, hops, causes,
                      ctx=None, retry_counter=None, rungs=None):
        """Bounded forward of ONE request to a role-filtered replica
        set: pick (affinity when ``key``, else least-loaded; digest
        holder first when ``rungs``), forward, fail over on connection
        death / replica ``overloaded`` — each replica tried at most
        once. Returns ``(reply, body, ep)`` on any relayed reply (ok
        or typed), or ``(None, (why, hint), None)`` when no replica
        could take it."""
        excluded: set = set()
        saw_hint = None
        while True:
            with self._lock:
                rep, how, probe = self._pick(
                    key, excluded, roles=roles, rungs=rungs
                )
                if rep is not None:
                    rep.in_flight += 1
                    rep.forwards += 1
                    self.counters["forwards"] += 1
                    self.counters[self._HOW_COUNTER[how]] += 1
                    ep = rep.endpoint
            if rep is None:
                if saw_hint is not None and how != "saturated":
                    how = "saturated"
                return None, (how, saw_hint), None
            if ctx is not None:
                header["trace"] = ctx.child().to_wire()
            fwd_t0 = time.monotonic()
            try:
                cli = self._checkout(ep)
                try:
                    reply, body = cli._roundtrip(
                        header, payload, raise_on_error=False
                    )
                except BaseException:
                    cli.close()
                    raise
                self._checkin(ep, cli)
            except (ConnectionError, OSError) as e:
                hops.append(f"{ep[0]}:{ep[1]} died")
                self._note_breaker(ep, ok=False, probe=probe)
                self._forward_died(ep, e, causes, excluded)
                if retry_counter is not None:
                    with self._lock:
                        self.counters[retry_counter] += 1
                continue
            finally:
                dt = time.monotonic() - fwd_t0
                self._forward_hist.observe(dt)
                with self._lock:
                    r = self._replicas.get(ep)
                    if r is not None:
                        r.in_flight -= 1
                        if r.hist is not None:
                            r.hist.observe(dt)
                        self._drained.notify_all()
            self._note_breaker(
                ep,
                ok=(bool(reply.get("ok"))
                    or reply.get("error") != "internal"),
                probe=probe,
            )
            if (not reply.get("ok")
                    and reply.get("error") == "overloaded"):
                hops.append(f"{ep[0]}:{ep[1]} overloaded")
                excluded.add(ep)
                hint = reply.get("retry_after_ms")
                if hint is not None:
                    saw_hint = max(saw_hint or 0.0, float(hint))
                if retry_counter is not None:
                    with self._lock:
                        self.counters[retry_counter] += 1
                continue
            hops.append(
                f"{ep[0]}:{ep[1]} "
                + ("ok" if reply.get("ok") else str(reply.get("error")))
            )
            return reply, body, ep

    @staticmethod
    def _shrink_deadline(theader: dict, hop_t0: float) -> None:
        """Each server re-anchors ``deadline_ms`` at its own receipt,
        so a two-hop dispatch must charge hop 1's elapsed time against
        the budget before hop 2 — otherwise a role-split fleet quietly
        grants ~double the deadline a unified replica enforces. An
        exhausted budget is floored at 1 ms: the decode worker then
        fails it typed ``deadline_exceeded`` itself (one code path for
        the expiry, not a router-side duplicate)."""
        if theader.get("deadline_ms") is not None:
            theader["deadline_ms"] = max(
                1.0,
                float(theader["deadline_ms"])
                - (time.monotonic() - hop_t0) * 1e3,
            )

    def _no_replica_reply(self, how, hint, causes, what):
        """The router's own typed reply when a role pool could not
        take a hop: fleet ``overloaded`` when members were saturated,
        ``unavailable`` naming every cause otherwise."""
        if how == "saturated":
            with self._lock:
                self.counters["fleet_overloaded"] += 1
            return {
                "ok": False, "error": "overloaded",
                "detail": f"every {what} replica is saturated",
                "retry_after_ms": float(hint or self.retry_after_ms),
            }
        with self._lock:
            self.counters["unavailable"] += 1
        detail = (
            f"no {what} replica in rotation" if how in ("empty", "tried")
            and not causes
            else f"every {what} replica failed: " + "; ".join(
                f"{h}:{p}: {e!r}" for (h, p), e in causes
            )
        )
        return {
            "ok": False, "error": "unavailable", "detail": detail,
            "retry_after_ms": self.retry_after_ms,
        }

    def _route_disagg(self, header: dict, payload: bytes):
        """The disaggregated generate. Fast path — **direct push**:
        the router reserves a decode-role worker up front (digest
        holder first, then page-affinity rendezvous) and hands its
        endpoint to the prefill worker as ``push_to``; the prefill
        worker pushes the transfer frame point-to-point over its
        pooled peer client and relays the decode reply back, so the
        frame crosses the wire ONCE instead of round-tripping through
        the router. The router keeps only the pairing ledger
        (``peer_sends == peer_ok + peer_typed + peer_degraded``).

        Fallback — the classic two-hop relay: (1) the prompt prefills
        on a prefill-role worker (least-loaded — prefill is stateless
        across requests), whose reply payload is the slot's
        ``kv_transfer`` frame; (2) the frame resumes on a decode-role
        worker chosen by page-affinity, relayed back verbatim. The
        relay runs when no decode worker is eligible for a push
        (none ACTIVE / closed-breaker / with capacity), when the
        prefill worker is a pre-push build (no ``pushed`` key in its
        reply), and on ANY push failure — the prefill worker hands
        the frame back ``pushed: False`` and the pairing settles
        ``peer_degraded``, never a stranded client. Streaming disagg
        always relays (``_stream_route``): the client's chunk stream
        terminates at the router, so the decode hop must too. Both
        relay hops fail over bounded and typed: a mid-hop death
        retries a sibling (the transfer frame is re-sent
        byte-identical — resume is deterministic and idempotent), and
        exhaustion is the router's typed ``overloaded``/
        ``unavailable``, never a hang."""
        from distkeras_tpu_torch.obs import TraceContext, start_span

        ctx = TraceContext.from_wire(header.get("trace"))
        span = None
        hops: list[str] = []
        causes: list = []
        key, rungs = self._affinity_info("generate", payload)
        if ctx is not None:
            span = start_span(
                "router.route", ctx, verb="generate", disagg=True,
                affinity_key=(
                    None if key is None
                    else hashlib.blake2b(key, digest_size=4).hexdigest()
                ),
            )

        def finish(reply, status, **attrs):
            if span is None:
                return reply
            rec = span.end(
                status=status, hops=hops, failovers=len(causes),
                **attrs,
            )
            tr = reply.setdefault("trace", {"id": ctx.trace_id})
            if ctx.want_timeline:
                tr.setdefault("timeline", []).append(rec)
            return reply

        with self._lock:
            self.counters["disagg_routed"] += 1
        hop_t0 = time.monotonic()
        # hop 1: prefill (role-filtered; least-loaded — no KV lives
        # anywhere yet, so there is nothing to be affine TO)
        pheader = dict(header)
        pheader["verb"] = "prefill"
        pheader.pop("stream", None)
        # direct push: reserve the decode half of the pairing NOW and
        # hold its in_flight slot for the pairing's duration, so
        # capacity accounting sees the push traffic the router itself
        # never carries. peer_sends counts here — the pairing ledger
        # opens when a prefill is dispatched WITH push_to, and settles
        # exactly once below (ok / typed / degraded)
        drep = dep = dhow = None
        with self._lock:
            drep, dhow = self._pick_decode_for_push(key, rungs)
            if drep is not None:
                drep.in_flight += 1
                dep = drep.endpoint
                self.counters["peer_sends"] += 1
                if dhow == "digest":
                    self.counters["digest_routed"] += 1
                pheader["push_to"] = [dep[0], dep[1]]
        try:
            reply1, blob, ep1 = self._forward_loop(
                pheader, payload, None, ("prefill",), hops, causes,
                ctx=ctx,
            )
        finally:
            if drep is not None:
                with self._lock:
                    r = self._replicas.get(dep)
                    if r is not None:
                        r.in_flight -= 1
                        self._drained.notify_all()
        if reply1 is None:
            how, hint = blob
            if drep is not None:
                # the pairing concluded typed on hop 1 — the decode
                # worker was never touched
                with self._lock:
                    self.counters["peer_typed"] += 1
            self.recorder.record(
                "router.route", verb="generate", disagg=True,
                outcome=f"prefill_{how}", hops=hops,
            )
            return finish(
                self._no_replica_reply(how, hint, causes, "prefill"),
                "prefill_" + how,
            ), b""
        if not reply1.get("ok"):
            # the prefill worker's typed reply relays verbatim
            if drep is not None:
                with self._lock:
                    self.counters["peer_typed"] += 1
            self.recorder.record(
                "router.route", verb="generate", disagg=True,
                outcome=f"prefill_{reply1.get('error')}", hops=hops,
            )
            return finish(reply1, str(reply1.get("error"))), b""
        if drep is not None and reply1.get("pushed") is True:
            # the decode reply rode back through the prefill worker:
            # the frame crossed the wire once, the pairing settles ok.
            # The server only stamps pushed=True on an OK decode
            # reply, so this is the success path by construction
            with self._lock:
                self.counters["peer_ok"] += 1
            self._note_breaker(dep, ok=True, probe=False)
            hops.append(f"{dep[0]}:{dep[1]} pushed")
            self.recorder.record(
                "router.route", verb="generate", disagg=True,
                push=True, prefill=f"{ep1[0]}:{ep1[1]}",
                decode=f"{dep[0]}:{dep[1]}", how=dhow,
                failovers=len(causes), outcome="ok",
            )
            return finish(
                reply1, "ok", push=True,
                prefill=f"{ep1[0]}:{ep1[1]}",
                decode=f"{dep[0]}:{dep[1]}",
            ), blob
        if drep is not None:
            # pushed=False (the prefill worker hands the frame back
            # with the typed cause) or no ``pushed`` key at all (a
            # pre-push build mid-rollout): settle the pairing
            # degraded and relay the frame over the classic hop-2
            # path below. The decode breaker is NOT fed here — a
            # second-hand push failure can be the prefill worker's
            # fault (deadline burned, peer pool refused); the relay
            # contacts decode workers first-hand and feeds breakers
            # from what it observes
            cause = str(reply1.get("push_error") or "not_pushed")
            with self._lock:
                self.counters["peer_degraded"] += 1
            hops.append(f"{dep[0]}:{dep[1]} push:{cause}")
            self.recorder.record(
                "router.peer_degrade",
                prefill=f"{ep1[0]}:{ep1[1]}",
                decode=f"{dep[0]}:{dep[1]}", cause=cause,
                detail=reply1.get("push_detail"),
            )
        # hop 2: kv.transfer (role-filtered; page-affinity). The
        # sampling params already ride INSIDE the transfer frame.
        theader = dict(header)
        theader["verb"] = "kv.transfer"
        theader.pop("sampling", None)
        theader.pop("stream", None)
        self._shrink_deadline(theader, hop_t0)
        with self._lock:
            self.counters["transfer_sends"] += 1
            self._transfer_inflight += 1
        try:
            reply2, body2, ep2 = self._forward_loop(
                theader, blob, key, ("decode",), hops, causes,
                ctx=ctx, retry_counter="transfer_retries", rungs=rungs,
            )
        finally:
            with self._lock:
                self._transfer_inflight -= 1
        if reply2 is None:
            how, hint = body2
            with self._lock:
                self.counters["transfer_typed"] += 1
            self.recorder.record(
                "router.route", verb="generate", disagg=True,
                outcome=f"transfer_{how}", hops=hops,
                prefill=f"{ep1[0]}:{ep1[1]}",
            )
            return finish(
                self._no_replica_reply(how, hint, causes, "decode"),
                "transfer_" + str(how),
            ), b""
        with self._lock:
            self.counters[
                "transfer_ok" if reply2.get("ok") else "transfer_typed"
            ] += 1
        self.recorder.record(
            "router.route", verb="generate", disagg=True,
            prefill=f"{ep1[0]}:{ep1[1]}",
            decode=f"{ep2[0]}:{ep2[1]}",
            failovers=len(causes),
            outcome=(
                "ok" if reply2.get("ok") else str(reply2.get("error"))
            ),
        )
        return finish(
            reply2,
            "ok" if reply2.get("ok") else str(reply2.get("error")),
            prefill=f"{ep1[0]}:{ep1[1]}",
            decode=f"{ep2[0]}:{ep2[1]}",
        ), body2

    # -- streaming relay ----------------------------------------------------

    def _send_client(self, conn, frame) -> bool:
        try:
            send_data(conn, frame)
            return True
        except (ConnectionError, OSError):
            return False

    def _stream_route(self, conn, header: dict, payload: bytes) -> bool:
        """Route one STREAMING generate and pump the serving side's
        frames through to the client. Role-split fleets run the
        prefill hop request/reply first, then stream the
        ``kv.transfer`` hop; role-less fleets stream the generate
        directly. Returns False when the CLIENT connection is gone.

        Failover contract: a replica death BEFORE any chunk was
        relayed retries a sibling transparently (deterministic decode
        makes the resend invisible); a death AFTER tokens reached the
        client cannot be hidden — the client gets a typed retriable
        ``unavailable`` and its ``TokenStream`` resends the whole
        request, skipping the tokens it already delivered."""
        verb = header.get("verb")
        try:
            faults.fire("router.dispatch", verb=verb)
            self._check_retry_budget(header)
            self._check_quota(header)
            if self._roles()[2]:
                # hop 1 (request/reply): prefill the prompt
                hop_t0 = time.monotonic()
                hops: list[str] = []
                causes: list = []
                pheader = dict(header)
                pheader["verb"] = "prefill"
                pheader.pop("stream", None)
                with self._lock:
                    self.counters["disagg_routed"] += 1
                reply1, blob, _ep1 = self._forward_loop(
                    pheader, payload, None, ("prefill",), hops, causes,
                )
                if reply1 is None:
                    how, hint = blob
                    return self._send_client(conn, pack_frame(
                        self._no_replica_reply(
                            how, hint, causes, "prefill"
                        )
                    ))
                if not reply1.get("ok"):
                    return self._send_client(conn, pack_frame(reply1))
                theader = dict(header)
                theader["verb"] = "kv.transfer"
                theader.pop("sampling", None)
                self._shrink_deadline(theader, hop_t0)
                key, rungs = self._affinity_info("generate", payload)
                with self._lock:
                    self.counters["transfer_sends"] += 1
                    self._transfer_inflight += 1
                try:
                    outcome = self._relay_stream(
                        conn, theader, blob, key, ("decode",),
                        retry_counter="transfer_retries", rungs=rungs,
                    )
                finally:
                    with self._lock:
                        self._transfer_inflight -= 1
                with self._lock:
                    self.counters[
                        "transfer_ok" if outcome == "ok"
                        else "transfer_typed"
                    ] += 1
                return outcome != "client_gone"
            # role-less fleet (or a half-provisioned role split):
            # stream the generate itself — never to a prefill-role
            # replica, which can only refuse it typed
            key, rungs = self._affinity_info("generate", payload)
            outcome = self._relay_stream(
                conn, header, payload, key,
                (None, "unified", "decode"), rungs=rungs,
            )
            return outcome != "client_gone"
        except ServingError as e:
            h = {"ok": False, "error": e.code, "detail": str(e)}
            if getattr(e, "retry_after", None) is not None:
                h["retry_after_ms"] = e.retry_after * 1e3
            _stamp_trace(h, header, e)
            return self._send_client(conn, pack_frame(h))
        except Exception as e:  # noqa: BLE001 — wire boundary
            h = {"ok": False, "error": "internal", "detail": repr(e)}
            _stamp_trace(h, header, e)
            return self._send_client(conn, pack_frame(h))

    def _relay_stream(self, conn, header, payload, key, roles,
                      retry_counter=None, rungs=None) -> str:
        """Forward a streaming request to a (role-filtered) replica
        and pump its frames to the client until the terminal one.
        Returns "ok", "typed" (terminal relayed either way),
        "failed" (router's own typed reply sent), or "client_gone"."""
        excluded: set = set()
        causes: list = []
        hops: list[str] = []
        saw_hint = None
        while True:
            peers = None
            with self._lock:
                rep, how, probe = self._pick(
                    key, excluded, roles=roles, rungs=rungs
                )
                if rep is not None:
                    rep.in_flight += 1
                    rep.forwards += 1
                    self.counters["forwards"] += 1
                    self.counters[self._HOW_COUNTER[how]] += 1
                    ep = rep.endpoint
                    if rungs and header.get("verb") == "generate":
                        peers = self._peer_hints(ep, rungs)
            if rep is not None and header.get("verb") == "generate":
                # same per-attempt peer-fetch hints the non-streamed
                # path attaches (a kv.transfer hop carries its KV in
                # the frame — nothing for the decode worker to fetch)
                header = dict(header)
                if peers:
                    header["kv_peers"] = peers
                else:
                    header.pop("kv_peers", None)
            if rep is None:
                what = "decode" if roles == ("decode",) else "serving"
                sent = self._send_client(conn, pack_frame(
                    self._no_replica_reply(
                        how if saw_hint is None else "saturated",
                        saw_hint, causes, what,
                    )
                ))
                return "failed" if sent else "client_gone"
            forwarded = 0
            cli = None
            try:
                try:
                    # checkout INSIDE the wire-death handler: the
                    # pooled client dials eagerly, so a hard-killed
                    # replica fails right here and must ride the same
                    # eject-and-retry path as a mid-stream death
                    cli = self._checkout(ep)
                    send_data(cli._sock, pack_frame(header, payload))
                    while True:
                        raw = recv_data(cli._sock)
                        reply, body = unpack_frame(raw)
                        terminal = (
                            not reply.get("ok")
                            or reply.get("stream") == "end"
                            or reply.get("stream") is None
                        )
                        if reply.get("error") == "overloaded" and (
                            forwarded == 0
                        ):
                            # replica-level saturation: try a sibling
                            # (the client never sees this refusal)
                            self._checkin(ep, cli)
                            cli = None
                            hops.append(f"{ep[0]}:{ep[1]} overloaded")
                            excluded.add(ep)
                            hint = reply.get("retry_after_ms")
                            if hint is not None:
                                saw_hint = max(
                                    saw_hint or 0.0, float(hint)
                                )
                            if retry_counter is not None:
                                with self._lock:
                                    self.counters[retry_counter] += 1
                            raise _RetrySibling()
                        if terminal:
                            # placement truth on the terminal frame:
                            # the replica that streamed, not the router
                            reply.setdefault(
                                "served_by", [ep[0], int(ep[1])]
                            )
                            raw = pack_frame(reply, body)
                        if not self._send_client(conn, raw):
                            if terminal:
                                # stream fully consumed: the pooled
                                # connection is at a frame boundary
                                self._checkin(ep, cli)
                            else:
                                # MID-STREAM: the replica will keep
                                # sending this stream's frames — a
                                # check-in would poison the pool (the
                                # next checkout reads leftover chunks
                                # as its own reply)
                                cli.close()
                            cli = None
                            return "client_gone"
                        if terminal:
                            self._checkin(ep, cli)
                            cli = None
                            self._note_breaker(
                                ep,
                                ok=(bool(reply.get("ok"))
                                    or reply.get("error") != "internal"),
                                probe=probe,
                            )
                            self.recorder.record(
                                "router.route", verb="generate",
                                stream=True,
                                replica=f"{ep[0]}:{ep[1]}",
                                failovers=len(causes),
                                outcome=(
                                    "ok" if reply.get("ok")
                                    else str(reply.get("error"))
                                ),
                            )
                            return (
                                "ok" if reply.get("ok") else "typed"
                            )
                        forwarded += 1
                except (ConnectionError, OSError) as e:
                    if cli is not None:
                        cli.close()
                        cli = None
                    hops.append(f"{ep[0]}:{ep[1]} died")
                    self._note_breaker(ep, ok=False, probe=probe)
                    self._forward_died(ep, e, causes, excluded)
                    if retry_counter is not None:
                        with self._lock:
                            self.counters[retry_counter] += 1
                    if forwarded == 0:
                        raise _RetrySibling() from None
                    # tokens already reached the client: the death
                    # cannot be hidden — typed retriable, and the
                    # client's TokenStream resend-and-skip recovers
                    sent = self._send_client(conn, pack_frame({
                        "ok": False, "error": "unavailable",
                        "detail": (
                            f"decode worker died after {forwarded} "
                            "streamed chunks; resend replays the "
                            "stream deterministically"
                        ),
                        "retry_after_ms": self.retry_after_ms,
                    }))
                    return "failed" if sent else "client_gone"
            except _RetrySibling:
                continue
            finally:
                with self._lock:
                    r = self._replicas.get(ep)
                    if r is not None:
                        r.in_flight -= 1
                        self._drained.notify_all()

    def _forward_died(self, ep, exc, causes, excluded):
        """A forward connection died mid-request: eject the replica now
        (health polls will rejoin it when it answers again) and record
        the cause for the all-dead reply."""
        causes.append((ep, exc))
        excluded.add(ep)
        dump = None
        with self._lock:
            rep = self._replicas.get(ep)
            if rep is not None:
                rep.failovers += 1
                rep.fails = max(rep.fails, self.eject_after)
                if rep.state == ACTIVE:
                    self.counters["ejections"] += 1
                    rep.state = EJECTED
                    dump = self._record_eject(
                        ep, "died_mid_forward", error=repr(exc)[:200],
                    )
            self.counters["failovers"] += 1
            self.recorder.record(
                "router.failover", endpoint=f"{ep[0]}:{ep[1]}",
                error=repr(exc)[:200],
            )
            pool = self._pools.pop(ep, [])
        for cli in pool:  # siblings of a dead connection are suspect
            cli.close()
        if dump is not None:
            self._dump_postmortem("replica_ejected", detail=dump)


# --------------------------------------------------------------- controller


class _LocalReplica:
    """One in-process replica: engine + ``ServingServer``. The default
    ``FleetController`` backend (tests, the example, single-host
    fleets); any other replica backend (a subprocess spawner, say)
    implements the same protocol — ``endpoint``, ``stop(drain=)``, ``alive()``."""

    def __init__(self, engine, server):
        self.engine = engine
        self.server = server
        self.endpoint = (server.host, int(server.port))

    def stop(self, drain=True):
        self.server.shutdown(drain=drain)

    def alive(self) -> bool:
        th = self.server._accept_thread
        return th is not None and th.is_alive()

    def warm(self):
        """Pre-compile the serving path (decode buckets, prefill
        chunks, restore shapes) and arm the compile ledger's storm
        detector. ``scale_up`` calls this BEFORE the replica enters
        rotation, so a join under live traffic mints no program —
        the zero-compile-storms-on-join invariant."""
        stepper = self.engine._stepper
        stepper.warmup()
        stepper.warm_prefill_buckets()
        stepper.warm_restore_buckets()
        self.engine.compile_ledger.mark_warmed()


def local_replica_factory(host="127.0.0.1", **engine_kw):
    """Factory of in-process replicas: ``factory(bundle)`` boots a
    ``ServingEngine`` from ``bundle`` (a serving-bundle path, or a
    model instance for tests) behind its own ``ServingServer`` on an
    ephemeral port."""

    def factory(bundle):
        from distkeras_tpu_torch.serving.engine import ServingEngine
        from distkeras_tpu_torch.serving.server import ServingServer

        engine = (
            ServingEngine.from_bundle(bundle, **engine_kw)
            if isinstance(bundle, str)
            else ServingEngine(bundle, **engine_kw)
        )
        server = ServingServer(engine, host=host).start()
        return _LocalReplica(engine, server)

    return factory


class FleetController:
    """Owns N replicas plus their router; implements rolling upgrade.

    ``bundle``: what replicas boot from — a serving-bundle path (the
    production flow) or a model instance. ``factory``: replaces the
    local in-process backend (a subprocess spawner, say). ``router_kw`` feeds ``FleetRouter``; ``engine_kw`` feeds
    each local replica's engine."""

    def __init__(self, bundle, replicas=2, factory=None,
                 router_kw=None, **engine_kw):
        if int(replicas) < 1:
            raise ValueError("a fleet needs at least 1 replica")
        self._bundle = bundle
        self._n = int(replicas)
        self._factory = factory or local_replica_factory(**engine_kw)
        self._router_kw = dict(router_kw or {})
        self.replicas: list = []
        self.router: FleetRouter | None = None
        self.rollovers = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetController":
        if self.router is not None:
            return self
        try:
            for _ in range(self._n):
                self.replicas.append(self._factory(self._bundle))
            self.router = FleetRouter(
                endpoints=[r.endpoint for r in self.replicas],
                **self._router_kw,
            ).start()
            # the fleet size as a first-class time-series on the
            # router registry (its history ring snaps every sweep):
            # the ``timeseries`` verb sparklines it
            self.router.registry.gauge(
                "fleet_replicas", fn=lambda: len(self.replicas)
            )
            for r in self.replicas:
                if not self.router.wait_in_rotation(r.endpoint):
                    raise RuntimeError(
                        f"replica {r.endpoint} never became healthy"
                    )
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self):
        """Router first (clients get typed failures, not forwards into
        stopping replicas), then each replica gracefully."""
        if self.router is not None:
            self.router.shutdown()
            self.router = None
        for r in self.replicas:
            try:
                r.stop(drain=True)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self.replicas = []

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def endpoint(self):
        """The router's ``(host, port)`` — what clients dial."""
        return (self.router.host, self.router.port)

    def client(self, **kw):
        from distkeras_tpu_torch.serving.client import ServingClient

        return ServingClient(self.router.host, self.router.port, **kw)

    def reap_dead(self) -> list:
        """Drop replicas whose process/server is gone (e.g. a kill -9
        victim) from the controller's book and the router's
        rotation. Returns the reaped handles."""
        gone = [r for r in self.replicas if not r.alive()]
        for r in gone:
            self.router.remove_replica(r.endpoint)
            self.replicas.remove(r)
        return gone

    # -- elastic scaling ----------------------------------------------------

    def scale_up(self, count=1, timeout=120.0) -> list:
        """Grow the fleet by ``count`` replicas through the same
        boot → pre-warm → health-gated-join path a rollover uses:
        each new replica is warmed (every decode/prefill/restore
        bucket compiled, storm detector armed) BEFORE it enters the
        router's rotation, so a scale-up under live traffic never
        compile-storms. Returns the added handles; on failure the
        half-joined replica is removed and stopped, and the fleet is
        exactly as before."""
        if self.router is None:
            raise RuntimeError("controller not started")
        added = []
        for _ in range(int(count)):
            new = self._factory(self._bundle)
            try:
                warm = getattr(new, "warm", None)
                if warm is not None:
                    warm()
                self.router.add_replica(new.endpoint)
                if not self.router.wait_in_rotation(
                    new.endpoint, timeout=timeout
                ):
                    raise RuntimeError(
                        f"scale-up replica {new.endpoint} never "
                        "became healthy"
                    )
            except BaseException:
                self.router.remove_replica(new.endpoint)
                try:
                    new.stop(drain=False)
                except Exception:  # noqa: BLE001 — best-effort abort
                    pass
                raise
            self.replicas.append(new)
            added.append(new)
        return added

    def scale_down(self, endpoint=None, timeout=120.0):
        """Shrink the fleet by one replica without dropping work:
        drain it at the router (new work routes elsewhere, in-flight
        forwards complete), then remove it from rotation and stop it
        gracefully. ``endpoint`` names the victim (the policy passes
        its least-loaded pick); default is the replica with the least
        router-side in-flight. Refuses to empty the fleet; a drain
        that wedges past ``timeout`` puts the replica back in
        rotation and raises — capacity is never silently lost."""
        if self.router is None:
            raise RuntimeError("controller not started")
        if len(self.replicas) <= 1:
            raise RuntimeError("refusing to scale below 1 replica")
        if endpoint is None:
            books = {
                tuple(row["endpoint"]): row
                for row in self.router.replicas()
            }
            victim = min(
                self.replicas,
                key=lambda r: books.get(
                    tuple(r.endpoint), {}
                ).get("in_flight") or 0,
            )
        else:
            endpoint = (endpoint[0], int(endpoint[1]))
            victim = next(
                (r for r in self.replicas
                 if tuple(r.endpoint) == endpoint), None
            )
            if victim is None:
                raise KeyError(f"no replica at {endpoint}")
        self.router.drain_replica(victim.endpoint)
        if not self.router.wait_drained(victim.endpoint, timeout=timeout):
            self.router.add_replica(victim.endpoint)
            raise RuntimeError(
                f"replica {victim.endpoint} still has in-flight work "
                f"after {timeout}s; scale-down aborted"
            )
        self.router.remove_replica(victim.endpoint)
        victim.stop(drain=True)
        self.replicas.remove(victim)
        return victim

    # -- rolling upgrade ----------------------------------------------------

    def rollover(self, bundle=None, timeout=120.0) -> dict:
        """Upgrade every replica to ``bundle`` (default: the boot
        bundle) one at a time, never dropping a request:

        1. boot a REPLACEMENT from the new bundle (capacity never dips);
        2. health-gate it into the router's rotation;
        3. DRAIN the old replica at the router — new work routes
           elsewhere, in-flight forwards complete (``wait_drained``);
        4. remove it from rotation and stop it gracefully
           (``shutdown(drain=True)``: anything it already admitted —
           e.g. work that arrived before the drain — still completes);
        5. next replica.

        Nothing is resent during a rollover, so nothing can be
        duplicated; nothing is refused that a healthy sibling could
        serve, so nothing is dropped. Returns the rollover ledger."""
        if self.router is None:
            raise RuntimeError("controller not started")
        bundle = self._bundle if bundle is None else bundle
        self._bundle = bundle
        ledger = {"replaced": [], "seconds": 0.0}
        t0 = time.monotonic()
        for i, old in enumerate(list(self.replicas)):
            new = self._factory(bundle)
            try:
                self.router.add_replica(new.endpoint)
                if not self.router.wait_in_rotation(
                    new.endpoint, timeout=timeout
                ):
                    raise RuntimeError(
                        f"replacement {new.endpoint} never became "
                        "healthy; rollover aborted (old replica still "
                        "serving)"
                    )
            except BaseException:
                self.router.remove_replica(new.endpoint)
                new.stop(drain=False)
                raise
            self.router.drain_replica(old.endpoint)
            if not self.router.wait_drained(old.endpoint, timeout=timeout):
                # never strand client work: put the old replica back
                # and surface the wedge instead of killing it mid-flight.
                # The replacement must not leak either — it is already
                # in rotation and may have taken traffic, so drain it
                # out and stop it, restoring the pre-rollover fleet
                self.router.add_replica(old.endpoint)
                self.router.drain_replica(new.endpoint)
                self.router.wait_drained(new.endpoint, timeout=timeout)
                self.router.remove_replica(new.endpoint)
                try:
                    new.stop(drain=True)
                except Exception:  # noqa: BLE001 — abort is best-effort
                    pass
                raise RuntimeError(
                    f"replica {old.endpoint} still has in-flight work "
                    f"after {timeout}s; rollover aborted"
                )
            self.router.remove_replica(old.endpoint)
            old.stop(drain=True)
            self.replicas[self.replicas.index(old)] = new
            ledger["replaced"].append(
                {"old": list(old.endpoint), "new": list(new.endpoint)}
            )
        self.rollovers += 1
        ledger["seconds"] = round(time.monotonic() - t0, 3)
        return ledger
