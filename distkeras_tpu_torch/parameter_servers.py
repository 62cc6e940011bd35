"""Parameter servers for the asynchronous trainers (PyTorch port of
``distkeras_tpu.parameter_servers``; reference:
distkeras/parameter_servers.py -> ParameterServer / SocketParameterServer /
DeltaParameterServer / ADAGParameterServer / DynSGDParameterServer).

The center variable stays host-resident numpy, as in the JAX package: a
dict of float32 arrays keyed by parameter name, in the JAX package's leaf
order (``Sequential.get_weights``' order, the parameter-server wire
format), so the same center can sit behind either package's workers.
In-process workers (threads driving per-device windows) call ``pull`` /
``commit`` directly under one lock. Commits are exactly-once under retry
(per-worker commit sequences), pulls and commits double as heartbeats,
and committers may hand their local state to the PS in the commit's locked
section (worker-snapshot custody). Commits may arrive compressed (int8 or
top-k, ``utils/compression.py``) and are reconstructed before the rule;
``pull_compress`` ships the pulled center bf16- or int8-encoded.

``SocketParameterServer`` serves the same PS object over TCP with the
reference's one-byte action protocol (b"p" pull, b"c" commit, b"s" stop)
extended with b"a" (replica attach), b"m" (metrics), b"t" (time-series
digest) and a one-byte reply status (b"k" ok / b"e" + typed error frame).
The frames are ``utils.serialization``'s pickle-free DKT1 frames, byte for
byte the JAX package's, so a port worker can commit to a JAX-package PS
and the reverse.

Replication and failover:

- any ``ParameterServer`` can stream to warm standbys: ``attach_replica``
  hands the sink a consistent snapshot (center + meta + dedup table +
  worker snapshots) taken inside the commit lock, then every post-dedup
  commit is forwarded in apply order, semi-synchronously (the
  committer's ack implies the standby applied);
- ``SocketParameterServer(standby_of=(host, port))`` runs the standby
  side: sync on start, follow the replication stream, re-attach (fresh
  snapshot) if only the stream dies, and promote to primary when the
  primary itself is gone; in standby role client verbs are refused with
  a typed ``standby`` error;
- ``RemoteParameterServerClient`` accepts an endpoint list and fails over
  through ``networking.RetryPolicy``, resending ``commit_id``-tagged
  commits — exactly-once, because the dedup table rode the replication
  stream.

Each PS keeps its own books (``obs``): a metrics registry (pull/commit
counters, commit-interval histograms, a straggler gauge, ledger gauges),
a time-series history served over b"t", and a flight recorder whose ring
a promoting standby dumps as a post-mortem bundle. ``faults`` seams fire
at ``ps.pull``, ``ps.commit`` and ``ps.replicate`` (and ``net.send`` /
``net.recv`` in ``networking``).

Every commit rule is also a pure function
(``center', meta' = RULE(center, meta, delta, tag)``), so tests can hold
staleness/normalization semantics exactly.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch import faults, networking
from distkeras_tpu_torch.obs import (
    FlightRecorder,
    MetricsHistory,
    MetricsRegistry,
    dump_postmortem,
)
from distkeras_tpu_torch.utils.compression import (
    bf16_encode_tree,
    int8_encode_tree,
    maybe_decompress,
    validate_pull_compress,
)
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    pack_frame,
    serialize_params,
    unpack_frame,
)

logger = logging.getLogger(__name__)


def _to_host(tree):
    """Host numpy copies (from tensors or arrays) of a parameter dict,
    nested dicts walked, with float leaves normalized to float32.

    Integer and bool leaves keep their dtype: the compressed wire formats
    (int8 ``q`` trees, uint16 bf16 payloads, int32 top-k indices) must not
    be re-inflated to 4-byte floats on the way to the socket."""

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.array(a, copy=True)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            return a
        return a.astype(np.float32, copy=False)

    return conv(tree)


def _copy(tree):
    return {k: np.copy(v) for k, v in tree.items()}


# -------------------------------------------------------------- typed errors


class ParameterServerError(ConnectionError):
    """Typed PS protocol failure. Subclasses ``ConnectionError`` on
    purpose: every retry surface (``RetryPolicy.call``'s default
    ``retry_on``, the client's failover wrapper, worker retry) treats
    connection errors as retriable, and every PS protocol error IS
    retriable — commits are exactly-once under resend by the dedup table,
    pulls are idempotent."""

    # a typed error FRAME arrived, so the connection is still framed
    # correctly: the client may retry in place without redialing.
    # Subclasses born from a dead/desynced stream override this.
    stream_in_sync = True

    def __init__(self, code: str, detail=None):
        msg = f"parameter server error: {code}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.code = code
        self.detail = detail


class StandbyError(ParameterServerError):
    """The dialed endpoint is a warm standby that has not (yet) promoted.
    Retriable by design: during a failover there is a window between the
    primary dying and the standby noticing; a policy-paced retry rides it
    out."""

    def __init__(self, detail=None):
        super().__init__("standby", detail)


class CommitNotAcknowledgedError(ParameterServerError):
    """A commit's ack never arrived (stream died, or the reply was not a
    valid status byte). Carries ``commit_id`` so the caller knows WHICH
    commit is in doubt; with a ``commit_id`` the resend is exactly-once
    (PS dedup), without one the commit must count as lost."""

    stream_in_sync = False  # the ack never framed: the stream is suspect

    def __init__(self, commit_id=None, detail=None):
        msg = f"commit {commit_id} not acknowledged"
        if detail:
            msg += f" ({detail})"
        ConnectionError.__init__(self, msg)
        self.code = "commit_not_acknowledged"
        self.detail = detail
        self.commit_id = commit_id


# ------------------------------------------------------- commit wire helpers
# One encoding of a commit (and one decoder) shared by the worker->PS path
# and the primary->standby replication stream, so the two cannot drift.


def _pack_commit(tree_delta, tag, commit_id, local_snap) -> bytes:
    header = {
        "tag": tag,
        "commit_id": list(commit_id) if commit_id is not None else None,
    }
    tree = tree_delta
    if local_snap is not None:
        # worker-local checkpoint state rides the same frame ("wrapped"
        # layout), so remote workers — and the standby's custody table —
        # keep resume parity with in-process ones
        header["wrapped"] = True
        tree = {"delta": tree_delta, "snap": local_snap}
    return pack_frame(header, serialize_params(tree))


def _apply_commit_payload(ps: "ParameterServer", data: bytes,
                          _via: str = "client") -> None:
    header, blob = unpack_frame(data)
    commit_id = header.get("commit_id")
    if commit_id is not None:
        commit_id = (commit_id[0], commit_id[1])
    tree = deserialize_params(blob)
    local_snap = None
    if header.get("wrapped"):
        local_snap = tree.get("snap")
        tree = tree["delta"]
    ps.commit(tree, header.get("tag"), commit_id=commit_id,
              local_snap=local_snap, _via=_via)


def _send_error(conn: socket.socket, code: str, **extra) -> None:
    """Typed error reply: status byte b"e" + an error frame. Best-effort —
    the peer may already be gone."""
    try:
        conn.sendall(b"e")
        networking.send_data(conn, pack_frame({"error": code, **extra}))
    except OSError:
        pass


# --------------------------------------------------------------------- rules


def _wid_key(k):
    """Worker ids round-trip through JSON meta as strings; normalize back
    to int where possible."""
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def delta_rule(center, meta, delta, tag=None):
    """center += delta (DOWNPOUR / AEASGD / EAMSGD / ADAG commits)."""
    new_center = {k: c + np.asarray(delta[k]) for k, c in center.items()}
    meta = dict(meta)
    meta["num_updates"] = meta.get("num_updates", 0) + 1
    return new_center, meta


def dynsgd_rule(center, meta, delta, tag):
    """Staleness-aware: center += delta / (staleness + 1).

    ``tag`` is the update counter the worker saw at pull time; staleness is
    how many commits landed since (reference: distkeras/parameter_servers.py
    -> DynSGDParameterServer.handle_commit).
    """
    meta = dict(meta)
    version = meta.get("version", 0)
    staleness = max(0, version - int(tag))
    scale = 1.0 / (staleness + 1.0)
    new_center = {
        k: c + scale * np.asarray(delta[k]) for k, c in center.items()
    }
    meta["version"] = version + 1
    meta["num_updates"] = meta.get("num_updates", 0) + 1
    return new_center, meta


# -------------------------------------------------------------------- servers


class ParameterServer:
    """Base PS: owns the center (name -> float32 array) and the update
    counter under one lock."""

    commit_rule = staticmethod(delta_rule)

    def __init__(self, params, pull_compress=None):
        # pull_compress: None, "bfloat16" or "int8" — the encoding of the
        # pulled center (workers decode on receipt)
        self.pull_compress = validate_pull_compress(pull_compress)
        self._center = _to_host(params)
        self._meta = {"num_updates": 0}
        self._lock = threading.Lock()
        self.stopped = threading.Event()
        # (every, fn): fn(n, center_copy, meta_copy, worker_snaps) fires
        # every `every` commits with copies taken INSIDE the commit's locked
        # section — the state labelled n really is the n-update state even
        # while other workers keep committing
        self._snapshot_listeners = []
        # exactly-once under retry: per-worker highest absorbed commit
        # sequence; last pull/commit times are the heartbeat
        self._seen_seq = {}  # worker_id -> highest committed seq
        self._activity = {}  # worker_id -> last pull/commit monotonic time
        # worker-local state handed over with commits (commit(local_snap=)),
        # stored in-lock so a snapshot never holds a worker state ahead of
        # the center it is saved with
        self._worker_snaps = {}
        # warm-standby replication: sinks registered by attach_replica.
        # Applied (post-dedup) commits forward to every sink INSIDE the
        # commit lock — apply order IS replication order — and each sink
        # awaits the standby's ack before returning, so by the time the
        # committing worker gets ITS ack the standby has applied too. A
        # failing sink is detached and closed; its standby re-syncs with a
        # fresh snapshot attach rather than trusting a gapped log.
        self._replicas = []
        self.replication_drops = 0
        # durability gate (require_replicas): when > 0, client commits are
        # REFUSED (typed, retriable "no_replica") while fewer than this
        # many sinks are live — including the resend of a commit that was
        # applied right as its sink died. The goal is kept separately so
        # promotion can relax the gate (sole survivor: availability over
        # durability) and a rejoining standby's attach re-arms it.
        self.min_replicas = 0
        self._min_replicas_goal = 0
        # the PS's books: a per-PS registry (standby pairs in one process
        # keep separate books), the time-series ring snapped from the
        # traffic path (served over the socket tier's b"t"), and the
        # flight recorder a promotion or stand-down dumps
        self.registry = MetricsRegistry()
        self.history = MetricsHistory(
            self.registry.snapshot, interval=1.0, capacity=600,
        )
        self._metrics = self.registry.group(
            "training_ps",
            ("pulls", "commits", "commits_refused_no_replica"),
        )
        self.recorder = FlightRecorder(capacity=1024)
        self.recorder.register_gauges(self.registry, "training")
        # per-worker commit cadence: one aggregate histogram (registered
        # FIRST, so name-indexed consumers see the fleet-wide one) plus a
        # labeled histogram per worker, and the straggler gauge = max /
        # median of the per-worker mean intervals
        self._interval_hist = self.registry.histogram(
            "training_ps_commit_interval_seconds", start=1e-3,
        )
        self._interval_hists = {}  # wid -> labeled Histogram
        self._commit_last = {}  # wid -> last commit monotonic instant
        self._commit_stats = {}  # wid -> [count, interval_sum]

        def _straggler():
            means = [s[1] / s[0] for s in list(self._commit_stats.values())
                     if s[0] > 0]
            if len(means) < 2:
                return None  # one worker has no one to straggle behind
            means.sort()
            median = means[len(means) // 2]
            return means[-1] / max(median, 1e-9)

        self.registry.gauge("training_ps_straggler", fn=_straggler)
        for name, fn in (
            ("training_ps_updates",
             lambda: self._meta.get("num_updates", 0)),
            ("training_ps_duplicates",
             lambda: self._meta.get("num_duplicates", 0)),
            ("training_ps_version", lambda: self._meta.get("version", 0)),
            ("training_ps_replicas", lambda: len(self._replicas)),
            ("training_ps_min_replicas", lambda: self.min_replicas),
            ("training_ps_replication_drops",
             lambda: self.replication_drops),
            ("training_ps_workers_seen", lambda: len(self._seen_seq)),
        ):
            self.registry.gauge(name, fn=fn)

    # -- protocol verbs -----------------------------------------------------

    def pull(self, worker_id=None, _via="client"):
        """Return (copy of the center, tag), the center encoded per
        ``pull_compress``. Tag is None unless versioned; ``worker_id``
        doubles as the heartbeat. ``_via="client"`` (worker-facing, either
        transport) fires the ``ps.pull`` seam and counts the pull."""
        if _via == "client":
            faults.fire("ps.pull", worker_id=worker_id)
            self.history.maybe_snap()  # traffic IS the cadence
        with self._lock:
            if _via == "client":
                # counter increments ride the commit lock (the registry's
                # counters leave serialization to callers)
                self._metrics.inc("pulls")
            center = _copy(self._center)
            tag = self._pull_tag()
            if worker_id is not None:
                self._activity[worker_id] = time.monotonic()
        if self.pull_compress == "bfloat16":
            center = bf16_encode_tree(center)
        elif self.pull_compress == "int8":
            center = int8_encode_tree(center)
        return center, tag

    def commit(self, delta, tag=None, commit_id=None, local_snap=None,
               _via="client"):
        """Apply a delta (name -> array, every leaf of the center).
        ``commit_id=(worker_id, seq)`` makes the commit exactly-once: a
        retried worker re-sends seq numbers the PS has already absorbed and
        they are dropped (counted in meta ``num_duplicates``) instead of
        double-applied. ``local_snap``: the committer's host-copied local
        state, stored in the same locked section as the commit (stored even
        for a deduped replay, which is at or behind the center).

        Int8-quantized and top-k-sparsified deltas (the workers'
        ``compress=`` wire formats) are reconstructed here, before the
        rule; replication forwards the reconstructed tree, so a standby
        applies bit-identical values whatever the worker's wire format.

        ``_via``: "client" for worker-facing commits (the ``ps.commit``
        seam fires, before any state changes, so an injected raise rejects
        the commit wholesale and the ``commit_id`` resend recovers it);
        "replicate" for a standby applying its primary's stream (no seam,
        no gate)."""
        if _via == "client":
            faults.fire("ps.commit", commit_id=commit_id, tag=tag)
            self.history.maybe_snap()
        delta = maybe_decompress(delta)
        if delta.keys() != self._center.keys():
            raise ParameterServerError(
                "bad_delta", detail="delta leaves differ from the center's"
            )
        snap = None
        with self._lock:
            if _via == "client":
                self._metrics.inc("commits")
            if (_via == "client" and self.min_replicas
                    and len(self._replicas) < self.min_replicas):
                # durability gate: nothing — new commit OR dedup resend —
                # is acked while replication is below requirement; the
                # caller's policy-paced retry rides out the standby's
                # re-attach (whose fresh snapshot covers everything
                # applied meanwhile)
                self._metrics.inc("commits_refused_no_replica")
                self.recorder.record(
                    "ps.gate_refused", replicas=len(self._replicas),
                    required=self.min_replicas,
                )
                raise ParameterServerError(
                    "no_replica",
                    detail=f"{len(self._replicas)} of {self.min_replicas} "
                           "required replicas attached",
                )
            if commit_id is not None:
                wid, seq = commit_id
                now_m = time.monotonic()
                self._activity[wid] = now_m
                if _via == "client":
                    self._observe_interval(wid, now_m)
                if local_snap is not None:
                    self._worker_snaps[wid] = local_snap
                if seq <= self._seen_seq.get(wid, -1):
                    # deduped replay: NOT forwarded — the standby saw the
                    # original via the stream
                    self._meta["num_duplicates"] = (
                        self._meta.get("num_duplicates", 0) + 1
                    )
                    return
                self._seen_seq[wid] = seq
            self._center, self._meta = type(self).commit_rule(
                self._center, self._meta, delta, tag
            )
            # the commit-stream position: a promoted standby's bundle
            # shows how far its stream reached before failover
            self.recorder.record(
                "ps.commit", position=self._meta.get("num_updates", 0),
                commit_id=None if commit_id is None else list(commit_id),
                via=_via,
            )
            if self._replicas:
                self._forward_to_replicas(delta, tag, commit_id, local_snap)
            # the sink died DURING this commit's forward: applied locally
            # but not durably — refuse the ack, raised only AFTER the
            # snapshot bookkeeping below (the commit IS applied and its
            # checkpoint cadence slot must not be lost: the deduped resend
            # early-returns and never revisits it)
            repl_lost = (_via == "client" and self.min_replicas
                         and len(self._replicas) < self.min_replicas)
            n = self._meta.get("num_updates", 0)
            due = [fn for every, fn in self._snapshot_listeners
                   if n % every == 0]
            if due:
                snap = (_copy(self._center), self._meta_copy(),
                        dict(self._worker_snaps))
        # listeners run outside the lock; a listener's failure is logged,
        # never surfaced to the committing worker (retrying it would
        # re-train a healthy partition)
        if snap is not None:
            for fn in due:
                try:
                    fn(n, *snap)
                except Exception:  # noqa: BLE001 — listener boundary
                    logger.exception(
                        "parameter-server snapshot at step %d failed", n
                    )
        if repl_lost:
            # safe even though a checkpoint may carry this commit: its meta
            # carries the dedup table, so a post-restore resend dedups
            with self._lock:
                self._metrics.inc("commits_refused_no_replica")
            raise ParameterServerError(
                "no_replica",
                detail="replication lost mid-commit; the resend is "
                       "deduplicated once a replica re-attaches",
            )

    def _observe_interval(self, wid, now_m):
        """Per-worker commit cadence (straggler detection): the interval
        since this worker's last commit, fleet-wide and per worker (deduped
        replays count: a resend is still worker activity). Caller holds
        the lock."""
        last = self._commit_last.get(wid)
        if last is not None:
            dt = now_m - last
            self._interval_hist.observe(dt)
            h = self._interval_hists.get(wid)
            if h is None:
                h = self.registry.histogram(
                    "training_ps_commit_interval_seconds",
                    labels={"worker": str(wid)}, start=1e-3,
                )
                self._interval_hists[wid] = h
            h.observe(dt)
            st = self._commit_stats.setdefault(wid, [0, 0.0])
            st[0] += 1
            st[1] += dt
        self._commit_last[wid] = now_m

    # -- checkpoint-cadence listeners ---------------------------------------

    def add_snapshot_listener(self, fn, every=1):
        """Register ``fn(n, center_copy, meta_copy, worker_snaps)`` to fire
        every ``every`` commits, with copies taken inside the commit's
        locked section. Deduped replays do not fire listeners."""
        if int(every) < 1:
            raise ValueError(f"every must be >= 1; got {every}")
        with self._lock:
            self._snapshot_listeners.append((int(every), fn))

    def remove_snapshot_listener(self, fn) -> bool:
        """Detach a listener registered by :meth:`add_snapshot_listener`;
        True if it was present."""
        with self._lock:
            for i, (_, f) in enumerate(self._snapshot_listeners):
                if f == fn:  # a bound method is a new object per access
                    del self._snapshot_listeners[i]
                    return True
        return False

    # -- replication --------------------------------------------------------

    def attach_replica(self, sink, announce=None):
        """Register a replication sink atomically with a consistent
        snapshot of everything failover must preserve: the center, the
        rule meta (DynSGD's version counter included), the exactly-once
        dedup table and the worker-state custody table.

        ``announce(center, meta, worker_snaps)`` — when given — runs INSIDE
        the commit lock, before the sink is registered: the standby's
        snapshot send and the sink's first forwarded commit cannot
        interleave on the wire, so the standby sees exactly
        snapshot-then-every-later-commit. If ``announce`` raises, the sink
        is never registered. Returns the snapshot triple."""
        with self._lock:
            snap = (_copy(self._center), self._meta_copy(),
                    dict(self._worker_snaps))
            if announce is not None:
                announce(*snap)
            self._replicas.append(sink)
            self.recorder.record(
                "ps.attach", replicas=len(self._replicas),
                position=self._meta.get("num_updates", 0),
            )
            # an attach restores durability: re-arm the configured gate
            self.min_replicas = self._min_replicas_goal
        return snap

    def detach_replica(self, sink) -> None:
        with self._lock:
            if sink in self._replicas:
                self._replicas.remove(sink)

    def require_replicas(self, n: int) -> None:
        """Arm the durability gate: client commits are refused (typed,
        retriable ``no_replica``) while fewer than ``n`` sinks are live.
        Re-armed by every later attach; relaxed by
        ``relax_replication_requirement`` (promotion's sole survivor)."""
        with self._lock:
            self.min_replicas = int(n)
            self._min_replicas_goal = int(n)

    def relax_replication_requirement(self) -> None:
        """Drop the ACTIVE durability gate (the promoted sole survivor must
        serve), keeping the goal so a rejoining standby's attach re-arms
        it."""
        with self._lock:
            self.min_replicas = 0

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def _forward_to_replicas(self, delta, tag, commit_id, local_snap):
        """Stream one applied commit to every attached sink. Caller holds
        the lock — apply order is replication order, and the committer's
        ack (sent after this returns) implies every live standby applied.
        A sink that fails is detached and closed: the primary keeps serving
        (counted in ``replication_drops``) and the orphaned standby
        re-syncs with a fresh snapshot attach."""
        payload = _pack_commit(delta, tag, commit_id, local_snap)
        dead = []
        for sink in self._replicas:
            try:
                sink.replicate(payload)
            except Exception:  # noqa: BLE001 — any sink failure detaches it
                logger.exception(
                    "replication to standby failed; detaching sink"
                )
                dead.append(sink)
        for sink in dead:
            self._replicas.remove(sink)
            self.replication_drops += 1
            self.recorder.record(
                "ps.detach", replicas=len(self._replicas),
                position=self._meta.get("num_updates", 0),
            )
            sink.close()

    # -- failure detection --------------------------------------------------

    def suspected_failures(self, timeout: float, now=None):
        """Worker ids whose last pull/commit is older than ``timeout``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return sorted(
                wid for wid, last in self._activity.items()
                if now - last > timeout
            )

    @property
    def num_duplicates(self) -> int:
        with self._lock:
            return self._meta.get("num_duplicates", 0)

    def _pull_tag(self):
        return None

    # -- lifecycle / results ------------------------------------------------

    def start(self):
        self.stopped.clear()

    def stop(self):
        self.stopped.set()

    def get_params(self):
        with self._lock:
            return _copy(self._center)

    def reset(self, params):
        with self._lock:
            self._center = _to_host(params)

    def _meta_copy(self):
        """Checkpoint-bound meta: the commit-rule meta plus the exactly-once
        dedup table (keys as str, as they ride a JSON file). Caller holds
        the lock."""
        meta = dict(self._meta)
        meta["seen_seq"] = {str(k): int(v) for k, v in self._seen_seq.items()}
        return meta

    def snapshot(self):
        """Consistent (center copy, meta copy): DynSGD's version counter and
        the dedup table included, so staleness and exactly-once bookkeeping
        survive a restore."""
        with self._lock:
            return _copy(self._center), self._meta_copy()

    def restore_snapshot(self, center, meta):
        meta = dict(meta)
        seen = meta.pop("seen_seq", {})
        with self._lock:
            self._center = _to_host(center)
            self._meta = meta
            self._seen_seq = {_wid_key(k): int(v) for k, v in seen.items()}

    def worker_snapshots(self):
        """In-lock copy of the committers' local-state snapshots."""
        with self._lock:
            return dict(self._worker_snaps)

    def restore_worker_snapshots(self, snaps: dict):
        """Seed the custody table from a restored snapshot."""
        with self._lock:
            self._worker_snaps = {_wid_key(k): v for k, v in snaps.items()}

    def metrics_snapshot(self) -> list:
        """JSON-able samples of the PS registry (counters, histograms and
        ledger gauges) — what the socket tier's b"m" action ships."""
        return self.registry.snapshot()

    @property
    def num_updates(self) -> int:
        with self._lock:
            return self._meta.get("num_updates", 0)


class DeltaParameterServer(ParameterServer):
    """center += delta — serves DOWNPOUR / AEASGD / EAMSGD."""

    commit_rule = staticmethod(delta_rule)


class ADAGParameterServer(ParameterServer):
    """Applies accumulated-gradient-normalized deltas. The normalization
    (divide the accumulated gradient by the window length) happens
    worker-side (reference: distkeras/workers.py -> ADAGWorker), so the
    server-side rule is the plain delta add."""

    commit_rule = staticmethod(delta_rule)


class DynSGDParameterServer(ParameterServer):
    """Versioned PS: pull returns the update counter; commits are scaled by
    1/(staleness+1)."""

    commit_rule = staticmethod(dynsgd_rule)

    def __init__(self, params, pull_compress=None):
        super().__init__(params, pull_compress=pull_compress)
        self._meta["version"] = 0

    def _pull_tag(self):
        return self._meta.get("version", 0)


# ------------------------------------------------------------ socket serving


class _ReplicaSink:
    """Primary-side handle to one attached warm standby. ``replicate`` runs
    inside the PS commit lock (``_forward_to_replicas``): it sends the
    commit payload and BLOCKS on the standby's 1-byte ack — semi-
    synchronous replication (worker-acked implies standby-applied).

    The socket carries an ack timeout: a standby that stalls without
    closing its socket must become a detached sink after a bounded wait,
    not a primary whose commit lock — and with it every worker — is held
    hostage."""

    ACK_TIMEOUT = 10.0

    def __init__(self, conn: socket.socket, on_close=None):
        conn.settimeout(self.ACK_TIMEOUT)
        self.conn = conn
        self._on_close = on_close

    def replicate(self, payload: bytes) -> None:
        faults.fire("ps.replicate", nbytes=len(payload))
        networking.send_data(self.conn, payload)
        ack = self.conn.recv(1)  # socket.timeout is an OSError: sink fails
        if ack != b"k":
            raise ConnectionError("standby did not acknowledge replication")

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        if self._on_close is not None:
            self._on_close()


class SocketParameterServer:
    """Serves a ParameterServer over TCP for remote workers — as the
    primary, or as a warm standby that follows a primary and promotes on
    its loss.

    Protocol (reference: distkeras/parameter_servers.py ->
    SocketParameterServer.run, extended): a connection sends a 1-byte
    action; every reply leads with a status byte — b"k" (ok) or b"e"
    followed by a typed error frame ``{"error": code, ...}``:

    - b"p": pull -> request frame {"worker_id"} -> b"k" + frame {"tag"}
      + center;
    - b"c": commit -> frame {"tag", "commit_id", "wrapped"} + delta
      (+snap), reply b"k";
    - b"a": replica attach -> request frame (reserved) -> b"k" + snapshot
      frame {"meta"} + {center, workers}; the connection then becomes the
      replication channel — the primary streams every applied commit and
      the standby acks each with b"k";
    - b"m": metrics scrape -> b"k" + frame {"metrics", "role", "port"}
      (served in both roles, so a standby is observable before it
      promotes);
    - b"t": time-series digest; the action byte is followed by a knob
      frame ({"window", "names", "points"}, {} = defaults) -> b"k" +
      frame {"timeseries", "role", "port"};
    - b"s": stop the server;
    - anything else: b"e" + ``unknown_action`` frame and the connection
      closes (an unknown byte never re-reads payload bytes as actions).

    One thread per connection; commits serialize on the PS lock.

    **Standby role** (``standby_of=(host, port)``): ``start()`` dials the
    primary, attaches (consistent snapshot restore — center, meta with
    DynSGD's version counter, dedup table, worker snapshots), then follows
    the replication stream on a background thread. In standby role client
    verbs are refused with a typed ``standby`` error. If the stream dies
    but the primary still answers, the standby re-attaches (fresh
    snapshot); if the primary is unreachable it PROMOTES: the role flips
    to "primary", verbs start serving, a post-mortem bundle is dumped and
    ``on_promote(self)`` fires. A worker's resend of an in-doubt commit is
    applied iff the standby never saw it, deduped iff it did.
    """

    def __init__(self, ps: ParameterServer, host="0.0.0.0", port=0,
                 standby_of=None, auto_promote=True, attach_retry=None,
                 on_promote=None, postmortem_dir=None):
        """``postmortem_dir``: where promotion and stand-down dump a
        post-mortem bundle (the PS's flight-recorder ring, its metrics
        snapshot, the worker-activity table); None keeps the latest bundle
        in memory only (``last_postmortem``)."""
        self.ps = ps
        self.postmortem_dir = postmortem_dir
        self.last_postmortem = None
        self.last_postmortem_path = None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        self.standby_of = tuple(standby_of) if standby_of is not None else None
        self.role = "primary" if standby_of is None else "standby"
        self.promoted = False
        self.promote_reason = None
        self.promoted_at = None  # time.monotonic() of the promotion
        self.auto_promote = bool(auto_promote)
        self.on_promote = on_promote
        self.reattaches = 0
        self.killed = False
        # re-attach pacing: a few quick policy-paced tries tell "the stream
        # hiccuped" (primary alive: re-sync) from "the primary is gone"
        # (every dial refused: promote)
        self._attach_retry = attach_retry or networking.RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.2, budget=2.0
        )
        self._accept_thread = None
        self._repl_thread = None
        self._repl_conn = None  # standby side's stream (closed on stop/kill)
        self._conn_threads = []
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._role_lock = threading.Lock()
        self._running = threading.Event()
        # socket-tier gauges ride the wrapped PS's registry, so one
        # metrics_snapshot() covers commits AND failover posture
        self.ps.registry.gauge(
            "training_ps_socket_reattaches", fn=lambda: self.reattaches
        )
        self.ps.registry.gauge(
            "training_ps_socket_promoted", fn=lambda: self.promoted
        )
        self.ps.registry.gauge(
            "training_ps_socket_open_connections",
            fn=lambda: len(self._conns),
        )

    def start(self):
        self.ps.start()
        self._running.set()
        # armed ps.*/net.* seam firings land in the PS ring, so a promotion
        # bundle names the chaos that preceded the failover
        faults.add_observer(self.ps.recorder.fault_observer)
        if self.role == "standby":
            # synchronous first sync: when start() returns, the standby is
            # commit-identical to the primary and following its stream
            conn = self._attach_to_primary()
            self._repl_thread = threading.Thread(
                target=self._follow, args=(conn,), daemon=True
            )
            self._repl_thread.start()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- standby side -------------------------------------------------------

    def _attach_to_primary(self) -> socket.socket:
        """Dial the primary, attach, restore its consistent snapshot into
        the local PS; returns the (now replication) connection."""
        host, port = self.standby_of
        # short dial timeout: a primary that dies without an RST must not
        # stall each probe 30 s — the promotion decision is budgeted in
        # seconds
        conn = networking.connect(host, port, timeout=2.0)
        try:
            conn.sendall(b"a")
            networking.send_data(conn, pack_frame({"replica_port": self.port}))
            _read_reply_status(conn)
            header, blob = unpack_frame(networking.recv_data(conn))
            tree = deserialize_params(blob)
            self.ps.restore_snapshot(tree["center"], header.get("meta", {}))
            self.ps.restore_worker_snapshots(tree.get("workers", {}))
            self.ps.recorder.record(
                "ps.sync", primary=f"{host}:{port}",
                position=self.ps.num_updates,
            )
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise
        self._repl_conn = conn
        return conn

    def _follow(self, conn: socket.socket):
        """Replication pump: apply each forwarded commit, ack it, repeat.
        Stream death -> re-attach (primary alive) or promote (primary
        gone). Any apply/decode failure also re-syncs from a fresh
        snapshot — a replica never keeps following a stream it may have
        misapplied."""
        while self._running.is_set() and self.role == "standby":
            try:
                data = networking.recv_data(conn)
                _apply_commit_payload(self.ps, data, _via="replicate")
                conn.sendall(b"k")
            except Exception:  # noqa: BLE001 — any failure re-syncs
                try:
                    conn.close()
                except OSError:
                    pass
                if not (self._running.is_set() and self.role == "standby"):
                    return
                conn = self._reattach_or_promote()
                if conn is None:
                    return
        try:
            conn.close()
        except OSError:
            pass

    def _reattach_or_promote(self):
        """The standby's liveness judgment: if the primary still answers,
        re-sync (fresh snapshot) and keep following; if it is gone, promote
        (when ``auto_promote``). Returns the new replication connection, or
        None when the follower thread should exit.

        Only CONNECTION-level failure justifies promotion: a snapshot that
        arrives but fails to decode proves the primary is alive, and
        promoting on it would split the brain. Decode failures retry the
        attach; if they persist, the standby stands down (stops following,
        does NOT promote)."""
        for _ in range(3):
            try:
                conn = self._attach_retry.call(self._attach_to_primary)
                self.reattaches += 1
                self.ps.recorder.record(
                    "ps.reattach", count=self.reattaches,
                    position=self.ps.num_updates,
                )
                logger.warning(
                    "standby on port %d re-attached to primary %s "
                    "(re-sync #%d)", self.port, self.standby_of,
                    self.reattaches,
                )
                return conn
            except (ConnectionError, OSError):
                break  # primary unreachable: promotion territory
            except Exception:  # noqa: BLE001 — decode failure: retry
                logger.exception(
                    "standby re-attach failed on a non-connection error; "
                    "retrying"
                )
        else:
            logger.error(
                "standby on port %d cannot decode the primary's snapshot "
                "but the primary still answers — standing down (not "
                "promoting; a split brain would lose commits)", self.port,
            )
            self.ps.recorder.record("ps.stand_down",
                                    position=self.ps.num_updates)
            self.dump_postmortem(
                "stand_down", detail={"primary": list(self.standby_of)}
            )
            return None
        if self._running.is_set() and self.auto_promote:
            self.promote(reason="primary-lost")
        return None

    def promote(self, reason="manual"):
        """Standby -> primary: flip the role, start serving client verbs.
        Idempotent; fires ``on_promote(self)`` exactly once. The PS state
        needs no fixup — replication kept the center, version counters,
        dedup table and worker snapshots commit-identical."""
        with self._role_lock:
            if self.role == "primary":
                return
            self.role = "primary"
            # reason and instant before the flag: a reader that sees
            # `promoted` sees the whole record
            self.promote_reason = reason
            self.promoted_at = time.monotonic()
            self.promoted = True
        # sole-survivor mode: a durability gate inherited from the dead
        # primary's topology would refuse every commit forever; a rejoining
        # standby's attach re-arms it
        self.ps.relax_replication_requirement()
        self.ps.recorder.record(
            "ps.promoted", reason=reason, position=self.ps.num_updates,
            reattaches=self.reattaches,
        )
        # the ring holds the last evidence of how far the dead primary's
        # stream reached — dump before serving a single commit
        self.dump_postmortem("promotion", detail={"reason": reason})
        logger.warning(
            "parameter-server standby on port %d promoted to primary (%s)",
            self.port, reason,
        )
        cb = self.on_promote
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — callback boundary
                logger.exception("on_promote callback failed")

    def dump_postmortem(self, reason: str, detail=None):
        """The PS tier's post-mortem bundle (``obs.dump_postmortem``'s
        schema): the wrapped PS's recorder ring (commit-stream positions,
        replication attach/detach, gate refusals, armed seam firings), its
        metrics snapshot, the worker-activity table as the in-flight view
        and the failover config. Returns ``(bundle, path)``."""
        with self.ps._lock:
            now = time.monotonic()
            in_flight = [
                {"worker_id": wid, "last_seq": self.ps._seen_seq.get(wid),
                 "idle_seconds": round(now - last, 3)}
                for wid, last in self.ps._activity.items()
            ]
        bundle, path = dump_postmortem(
            self.postmortem_dir, "parameter_server", reason,
            recorder=self.ps.recorder,
            metrics=self.ps.metrics_snapshot(),
            in_flight=in_flight,
            config={
                "role": self.role,
                "standby_of": (None if self.standby_of is None
                               else list(self.standby_of)),
                "port": self.port,
                "min_replicas": self.ps.min_replicas,
                "rule": type(self.ps).__name__,
            },
            detail=detail,
        )
        self.last_postmortem = bundle
        self.last_postmortem_path = path
        return bundle, path

    # -- serving side -------------------------------------------------------

    def _accept_loop(self):
        self._listener.settimeout(0.2)
        while self._running.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            # reap as we go: finished connection threads must not pile up
            # for the server's lifetime under connection churn
            self._conn_threads = [th for th in self._conn_threads
                                  if th.is_alive()]
            self._conn_threads.append(t)

    def _serve(self, conn: socket.socket):
        with self._conns_lock:
            self._conns.add(conn)
        handed_off = False
        try:
            while self._running.is_set():
                action = conn.recv(1)
                if not action:
                    break
                if action == b"p":
                    data = networking.recv_data(conn)
                    if self.role != "primary":
                        _send_error(conn, "standby")
                        continue
                    header, _ = unpack_frame(data)
                    try:
                        center, tag = self.ps.pull(
                            worker_id=header.get("worker_id"))
                    except Exception as e:  # noqa: BLE001 — typed reply
                        # the request frame was consumed, so a typed reply
                        # keeps the stream in sync; the client's
                        # (idempotent) retry recovers
                        _send_error(conn, "internal", detail=repr(e))
                        continue
                    conn.sendall(b"k")
                    networking.send_data(
                        conn, pack_frame({"tag": tag},
                                         serialize_params(center)))
                elif action == b"c":
                    data = networking.recv_data(conn)
                    if self.role != "primary":
                        _send_error(conn, "standby")
                        continue
                    try:
                        _apply_commit_payload(self.ps, data)
                    except ParameterServerError as e:
                        # already typed (the gate's no_replica): forward
                        _send_error(conn, e.code, detail=e.detail)
                        continue
                    except Exception as e:  # noqa: BLE001 — typed reply
                        # rejected BEFORE apply (an armed ps.commit seam):
                        # the commit_id resend is exactly-once under dedup
                        _send_error(conn, "internal", detail=repr(e))
                        continue
                    conn.sendall(b"k")
                elif action == b"a":
                    data = networking.recv_data(conn)
                    if self.role != "primary":
                        # no chained standbys: a replica of a replica
                        # would double the promotion ambiguity
                        _send_error(conn, "standby")
                        continue
                    unpack_frame(data)  # attach header (reserved fields)
                    # on_close keeps _conns bounded across re-syncs
                    sink = _ReplicaSink(
                        conn, on_close=lambda c=conn: self._discard_conn(c)
                    )

                    def announce(center, meta, worker_snaps):
                        # runs INSIDE the PS commit lock: snapshot-then-
                        # stream with no interleaving window
                        conn.sendall(b"k")
                        networking.send_data(conn, pack_frame(
                            {"meta": meta},
                            serialize_params({
                                "center": center,
                                "workers": {str(k): v for k, v in
                                            worker_snaps.items()
                                            if v is not None},
                            }),
                        ))

                    self.ps.attach_replica(sink, announce)
                    # the sink owns this socket now: commits pump it from
                    # inside the PS lock
                    handed_off = True
                    return
                elif action == b"m":
                    conn.sendall(b"k")
                    networking.send_data(conn, pack_frame({
                        "metrics": self.ps.metrics_snapshot(),
                        "role": self.role,
                        "port": self.port,
                    }))
                elif action == b"t":
                    knobs, _ = unpack_frame(networking.recv_data(conn))
                    self.ps.history.maybe_snap()
                    kw = {}
                    if knobs.get("window") is not None:
                        kw["window"] = float(knobs["window"])
                    if knobs.get("names") is not None:
                        kw["names"] = list(knobs["names"])
                    if knobs.get("points") is not None:
                        kw["points"] = int(knobs["points"])
                    conn.sendall(b"k")
                    networking.send_data(conn, pack_frame({
                        "timeseries": self.ps.history.digest(**kw),
                        "role": self.role,
                        "port": self.port,
                    }))
                elif action == b"s":
                    self.stop()
                    break
                else:
                    _send_error(conn, "unknown_action", action=action.hex())
                    break
        except (ConnectionError, OSError):
            pass
        except Exception:  # noqa: BLE001 — a malformed request frame
            # drop the connection; the client's retry takes it from here
            logger.debug("parameter-server connection dropped",
                         exc_info=True)
        finally:
            if not handed_off:
                with self._conns_lock:
                    self._conns.discard(conn)
                try:
                    conn.close()
                except OSError:
                    pass

    # -- lifecycle ----------------------------------------------------------

    def _discard_conn(self, conn) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def _close_all(self, rst=False):
        try:
            self._listener.close()
        except OSError:
            pass
        repl = self._repl_conn
        if repl is not None:
            # unblock a standby's follower from its recv: a close alone
            # does not wake a recv blocked in another thread, a shutdown
            # does (else stop() waits out its join timeout)
            for close in (lambda: repl.shutdown(socket.SHUT_RDWR),
                          repl.close):
                try:
                    close()
                except OSError:
                    pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            if rst:
                try:  # SO_LINGER 0: abort with RST, as a dying process would
                    c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
                except OSError:
                    pass
            try:
                c.close()
            except OSError:
                pass

    def stop(self):
        self._running.clear()
        faults.remove_observer(self.ps.recorder.fault_observer)
        self.ps.stop()
        self._close_all()
        # join what was spawned (not the current thread: stop() runs on a
        # serve thread for the b"s" verb)
        me = threading.current_thread()
        for t in [self._accept_thread, self._repl_thread, *self._conn_threads]:
            if t is not None and t is not me:
                t.join(timeout=2.0)
        self._conn_threads = [t for t in self._conn_threads if t.is_alive()]

    def kill(self):
        """Simulate primary process death (chaos tests and failover
        drills): no drain, no goodbye — the listener and every open
        connection (client AND replication) drop with an RST. The PS object
        is left untouched, as a dead process leaves its state."""
        self.killed = True
        self._running.clear()
        # a dead process's observer cannot fire
        faults.remove_observer(self.ps.recorder.fault_observer)
        self._close_all(rst=True)


def _read_reply_status(sock: socket.socket) -> None:
    """Consume a reply's status byte; raise the typed error a b"e" frame
    carries. The client-side decoder of the status-byte protocol."""
    status = sock.recv(1)
    if status == b"k":
        return
    if status == b"e":
        header, _ = unpack_frame(networking.recv_data(sock))
        code = header.get("error", "error")
        if code == "standby":
            raise StandbyError(header.get("detail"))
        raise ParameterServerError(code, detail=header.get("detail"))
    if not status:
        raise ConnectionError("parameter-server stream closed")
    raise ConnectionError(
        f"parameter-server protocol desync: bad status byte {status!r}"
    )


class RemoteParameterServerClient:
    """Worker-side proxy speaking the socket protocol; drop-in for a local
    PS. With an endpoint list it is failover-aware: the dial is sticky — it
    keeps the endpoint that last worked and rotates onward only when that
    one dies."""

    def __init__(self, host=None, port=None, retry=None, endpoints=None,
                 on_failover=None):
        """``retry``: optional ``networking.RetryPolicy``. It paces
        ``reconnect()`` redials AND the in-operation failover: when a
        pull/commit dies mid-stream, the client redials (rotating
        endpoints) and resends under the policy — pulls always (they are
        idempotent), commits only when a ``commit_id`` is present (the
        dedup table makes the resend exactly-once; an id-less commit
        surfaces its failure instead).

        ``endpoints``: list of ``(host, port)`` alternatives — typically
        ``[primary, standby]``. ``on_failover(endpoint)`` fires whenever
        the dial lands on a different endpoint than before."""
        if endpoints is None:
            if host is None or port is None:
                raise ValueError(
                    "RemoteParameterServerClient needs host+port or an "
                    "endpoints list"
                )
            endpoints = [(host, port)]
        self.endpoints = [tuple(e) for e in endpoints]
        self.retry = retry
        self.on_failover = on_failover
        self.failovers = 0
        # bytes this client put on and took off the wire per verb (action
        # byte, length prefixes, frames, status byte; resends included)
        # and how many of each verb completed
        self.wire_bytes = {"pull": 0, "commit": 0}
        self.wire_ops = {"pull": 0, "commit": 0}
        # per-endpoint dial timeout: a failover must reach the standby in
        # seconds even when the dead primary drops SYNs silently
        self.dial_timeout = 5.0
        self._lock = threading.Lock()
        self._sock, self._ep = networking.connect_any(
            self.endpoints, timeout=self.dial_timeout
        )
        self.host, self.port = self.endpoints[self._ep]

    @property
    def endpoint(self):
        """The ``(host, port)`` currently connected."""
        return self.endpoints[self._ep]

    def _dial_locked(self, start_offset=0):
        """One rotation over the endpoint list starting at the sticky index
        (+``start_offset``); fires ``on_failover`` on a move. Caller holds
        the lock."""
        sock, i = networking.connect_any(
            self.endpoints, start=self._ep + start_offset,
            timeout=self.dial_timeout,
        )
        if i != self._ep:
            self._ep = i
            self.host, self.port = self.endpoints[i]
            self.failovers += 1
            cb = self.on_failover
            if cb is not None:
                try:
                    cb(self.endpoints[i])
                except Exception:  # noqa: BLE001 — observability only
                    logger.exception("on_failover callback failed")
        self._sock = sock

    def _reconnect_locked(self, rotate_first=False):
        """``rotate_first``: start the dial at the NEXT endpoint — the
        current one answered but refused (a live standby), so redialing it
        first would livelock against a healthy, dialable primary."""
        try:
            self._sock.close()
        except OSError:
            pass
        self._dial_locked(start_offset=1 if rotate_first else 0)

    def reconnect(self):
        """Fresh connection — a retried worker must not reuse a stream that
        may have died mid-message. Policy-paced when ``retry`` is set; the
        redial rotates through the endpoint list, so a worker retrying into
        a failover lands on the promoted standby."""
        with self._lock:
            if self.retry is not None:
                self.retry.call(self._reconnect_locked)
            else:
                self._reconnect_locked()

    def _with_failover(self, op, resend_safe=True):
        """Run ``op`` once; on a dead/refusing stream, redial (rotating
        endpoints) and resend under ``self.retry``. A standby refusal
        rotates the next redial past it (a sticky redial would never try
        the healthy primary again)."""
        try:
            return op()
        except (ConnectionError, OSError) as first:
            if self.retry is None or not resend_safe:
                raise
            last = [first]

            def redo():
                e = last[0]
                rotate = isinstance(e, StandbyError)
                # a typed reply on a healthy stream (no_replica, internal)
                # retries in place; redial only when the stream is
                # dead/suspect, or to rotate off a live standby
                if rotate or not getattr(e, "stream_in_sync", False):
                    with self._lock:
                        self._reconnect_locked(rotate_first=rotate)
                try:
                    return op()
                except (ConnectionError, OSError) as err:
                    last[0] = err
                    raise

            return self.retry.call(redo)

    def pull(self, worker_id=None):
        request = pack_frame({"worker_id": worker_id})

        def op():
            with self._lock:
                self._sock.sendall(b"p")
                networking.send_data(self._sock, request)
                _read_reply_status(self._sock)
                data = networking.recv_data(self._sock)
                self.wire_bytes["pull"] += 18 + len(request) + len(data)
                self.wire_ops["pull"] += 1
            header, blob = unpack_frame(data)
            return deserialize_params(blob), header.get("tag")

        return self._with_failover(op)

    def commit(self, delta, tag=None, commit_id=None, local_snap=None):
        payload = _pack_commit(_to_host(delta), tag, commit_id, local_snap)

        def op():
            with self._lock:
                self._sock.sendall(b"c")
                networking.send_data(self._sock, payload)
                self.wire_bytes["commit"] += 10 + len(payload)
                try:
                    _read_reply_status(self._sock)
                except ParameterServerError:
                    raise  # typed reply: the stream is still in sync
                except ConnectionError as e:
                    # the ack never arrived — the commit is IN DOUBT
                    # (applied-but-unacked or never received)
                    raise CommitNotAcknowledgedError(
                        commit_id, detail=str(e)) from e
                self.wire_ops["commit"] += 1

        return self._with_failover(op, resend_safe=commit_id is not None)

    def metrics(self) -> dict:
        """Scrape the connected PS's typed-metrics snapshot (works on a
        standby too): ``{"metrics": samples, "role", "port"}``."""

        def op():
            with self._lock:
                self._sock.sendall(b"m")
                _read_reply_status(self._sock)
                header, _ = unpack_frame(networking.recv_data(self._sock))
            return header

        return self._with_failover(op)

    def timeseries(self, window=None, names=None, points=None) -> dict:
        """The connected PS's windowed time-series digest
        (``obs.MetricsHistory.digest``; works on a standby too):
        ``{"timeseries": digest, "role", "port"}``."""
        knobs = {}
        if window is not None:
            knobs["window"] = float(window)
        if names is not None:
            knobs["names"] = list(names)
        if points is not None:
            knobs["points"] = int(points)

        def op():
            with self._lock:
                self._sock.sendall(b"t")
                networking.send_data(self._sock, pack_frame(knobs))
                _read_reply_status(self._sock)
                header, _ = unpack_frame(networking.recv_data(self._sock))
            return header

        return self._with_failover(op)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
