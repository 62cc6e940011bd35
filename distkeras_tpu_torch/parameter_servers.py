"""Parameter servers for the asynchronous trainers (PyTorch port of the
in-process tier of ``distkeras_tpu.parameter_servers``; reference:
distkeras/parameter_servers.py -> ParameterServer / DeltaParameterServer /
ADAGParameterServer / DynSGDParameterServer).

The center variable stays host-resident numpy, as in the JAX package: a
dict of float32 arrays keyed by parameter name, in the JAX package's leaf
order (``Sequential.get_weights``' order, the parameter-server wire
format), so the same center could sit behind either package's workers.
In-process workers (threads driving per-device windows) call ``pull`` /
``commit`` directly under one lock. Commits are exactly-once under retry
(per-worker commit sequences), pulls and commits double as heartbeats,
and committers may hand their local state to the PS in the commit's locked
section (worker-snapshot custody).

Commits may arrive compressed (int8 or top-k, ``utils/compression.py``)
and are reconstructed before the rule; ``pull_compress`` ships the pulled
center bf16- or int8-encoded. Not ported yet, and refused where a caller
would reach them: the socket tier and warm-standby replication
(``SocketParameterServer``, ``RemoteParameterServerClient``,
``networking.py``), the metrics registry, time-series history and flight
recorder (``obs/*``), and the chaos seams (``faults.py``).

Every commit rule is also a pure function
(``center', meta' = RULE(center, meta, delta, tag)``), so tests can hold
staleness/normalization semantics exactly.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch.utils.compression import (
    bf16_encode_tree,
    int8_encode_tree,
    maybe_decompress,
    validate_pull_compress,
)

logger = logging.getLogger(__name__)


def _to_host(tree):
    """Host numpy copies (from tensors or arrays) with float leaves
    normalized to float32; integer and bool leaves keep their dtype."""

    def conv(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.array(a, copy=True)
        if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            return a
        return a.astype(np.float32, copy=False)

    return {k: conv(v) for k, v in tree.items()}


def _copy(tree):
    return {k: np.copy(v) for k, v in tree.items()}


def _not_ported(what, module):
    raise NotImplementedError(
        f"{what} is not ported yet (it needs {module})"
    )


# -------------------------------------------------------------- typed errors


class ParameterServerError(ConnectionError):
    """Typed PS protocol failure. Subclasses ``ConnectionError`` on
    purpose: the worker retry treats connection errors as retriable, and
    every PS protocol error IS retriable — commits are exactly-once under
    resend by the dedup table, pulls are idempotent."""

    # a typed error arrived, so a stream (once the socket tier is ported)
    # would still be framed correctly
    stream_in_sync = True

    def __init__(self, code: str, detail=None):
        msg = f"parameter server error: {code}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.code = code
        self.detail = detail


class StandbyError(ParameterServerError):
    """The dialed endpoint is a warm standby that has not promoted (raised
    by the socket tier once it is ported; kept for the error vocabulary)."""

    def __init__(self, detail=None):
        super().__init__("standby", detail)


class CommitNotAcknowledgedError(ParameterServerError):
    """A commit's ack never arrived. Carries ``commit_id`` so the caller
    knows WHICH commit is in doubt; with a ``commit_id`` the resend is
    exactly-once (PS dedup), without one the commit must count as lost."""

    stream_in_sync = False

    def __init__(self, commit_id=None, detail=None):
        msg = f"commit {commit_id} not acknowledged"
        if detail:
            msg += f" ({detail})"
        ConnectionError.__init__(self, msg)
        self.code = "commit_not_acknowledged"
        self.detail = detail
        self.commit_id = commit_id


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

    # -- protocol verbs -----------------------------------------------------

    def pull(self, worker_id=None):
        """Return (copy of the center, tag), the center encoded per
        ``pull_compress``. Tag is None unless versioned; ``worker_id``
        doubles as the heartbeat."""
        with self._lock:
            center = _copy(self._center)
            tag = self._pull_tag()
            if worker_id is not None:
                self._activity[worker_id] = time.monotonic()
        if self.pull_compress == "bfloat16":
            center = bf16_encode_tree(center)
        elif self.pull_compress == "int8":
            center = int8_encode_tree(center)
        return center, tag

    def commit(self, delta, tag=None, commit_id=None, local_snap=None):
        """Apply a delta (name -> array, every leaf of the center).
        ``commit_id=(worker_id, seq)`` makes the commit exactly-once: a
        retried worker re-sends seq numbers the PS has already absorbed and
        they are dropped (counted in meta ``num_duplicates``) instead of
        double-applied. ``local_snap``: the committer's host-copied local
        state, stored in the same locked section as the commit (stored even
        for a deduped replay, which is at or behind the center).

        Int8-quantized and top-k-sparsified deltas (the workers'
        ``compress=`` wire formats) are reconstructed here, before the
        rule: every rule sees plain float arrays."""
        delta = maybe_decompress(delta)
        if delta.keys() != self._center.keys():
            raise ParameterServerError(
                "bad_delta", detail="delta leaves differ from the center's"
            )
        snap = None
        with self._lock:
            if commit_id is not None:
                wid, seq = commit_id
                self._activity[wid] = time.monotonic()
                if local_snap is not None:
                    self._worker_snaps[wid] = local_snap
                if seq <= self._seen_seq.get(wid, -1):
                    self._meta["num_duplicates"] = (
                        self._meta.get("num_duplicates", 0) + 1
                    )
                    return
                self._seen_seq[wid] = seq
            self._center, self._meta = type(self).commit_rule(
                self._center, self._meta, delta, tag
            )
            n = self._meta.get("num_updates", 0)
            due = [fn for every, fn in self._snapshot_listeners
                   if n % every == 0]
            if due:
                snap = (_copy(self._center), self._meta_copy(),
                        dict(self._worker_snaps))
        # listeners run outside the lock; a listener's failure is logged,
        # never surfaced to the committing worker (retrying it would
        # re-train a healthy partition)
        if snap is None:
            return
        for fn in due:
            try:
                fn(n, *snap)
            except Exception:  # noqa: BLE001 — listener boundary
                logger.exception(
                    "parameter-server snapshot at step %d failed", n
                )

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
                if f is fn:
                    del self._snapshot_listeners[i]
                    return True
        return False

    # -- not ported yet -----------------------------------------------------

    def attach_replica(self, sink, announce=None):
        _not_ported("warm-standby replication", "SocketParameterServer")

    def metrics_snapshot(self):
        _not_ported("the parameter-server metrics registry", "obs/metrics.py")

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
