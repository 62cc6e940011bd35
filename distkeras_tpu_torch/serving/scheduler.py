"""Request scheduling for the serving runtime — pure host logic (PyTorch
port of the subset of ``distkeras_tpu.serving.scheduler`` the serving
slice runs).

- ``ContinuousBatcher``: iteration-level batching for autoregressive
  decode over a fixed bank of ``num_slots`` sequence slots. Each
  scheduler step recycles expired quarantines, admits queued requests
  into free slots, spends at most ``prefill_chunk`` prompt tokens on
  slots mid-prefill (oldest admission first), advances every decoding
  slot one token (1 to ``draft_k + 1`` over a speculative stepper: the
  variable advance) and evicts finished sequences. FIFO queue with
  bounded-queue backpressure, per-request deadlines, drain / hard stop.
  Over a paged stepper, admission is gated on the KV page pool as well as
  on free slots (the head of the queue waits for evictions), and a
  request that can never fit the pool is refused at ``submit``. With a
  ``qos.QosPolicy`` the queue is priority classes with per-tenant
  weighted fair queuing, and (``preempt=True``) a blocked higher-priority
  request may displace the lowest-priority decoding slot by KV swap
  (``stepper.swap_out`` / ``swap_in``). A request with ``sampling.n > 1``
  is a completion group: one prefill, then ``n - 1`` copy-on-write forks
  (``stepper.fork_slot``) before its first token. With a ``shed_gate``
  (a ``resilience.AdmissionController``) ``submit`` asks the gate first:
  a shed is the typed ``ShedError`` (``overloaded`` with the gate's
  ``retry_after_ms``), a rung-2 clamp trims ``max_new_tokens``, and each
  admission reports its queue sojourn back to the gate.
  Two loop shapes with one contract: ``overlap=False`` dispatches each
  step and waits for it; ``overlap=True`` runs the next iteration's host
  work while the step is on the device and collects it at the last
  moment (emitted token order per request is identical). Both stamp the
  same ``obs.OverlapLedger`` (``serving_step_bubble_seconds``,
  ``serving_overlap_efficiency``).
- ``WindowedBatcher``: size/timeout-windowed batching for batch scoring.

Failures are contained, not fatal: a device-step exception triggers
blame assignment (a masked retry of the newest admission, then
bisection — ``_assign_blame``), so only the culpable request fails
(typed ``InternalError``) and its slot is quarantined for
``quarantine_steps`` iterations, while every surviving stream advances
exactly one token per iteration; a prefill crash fails just its own
request.

Requests carry the JAX package's timestamps and (when traced) its
per-request event ledger, which ``obs.tracing.request_spans`` turns into
the server-side phase timeline (prefill chunks, blame windows, mints of
the stepper's compile ledger); ``stream=True`` requests get each
iteration's emitted tokens pushed into a chunk FIFO before any eviction.
The counters are typed registry counters (``serving_scheduler_<key>``).

A ``prefill_only`` request (the prefill role of a disaggregated pair) is
admitted and prefilled like any other, then, before the decode mask is
computed, its slot is exported through ``stepper.swap_out`` into
``req.export`` and freed: it never takes a decode step.

The device face is an injected stepper (``engine.DecodeStepper``) with
``num_slots``, ``max_len``, ``begin_admit(slot, prompt, sampling, eos_id)
-> left``,
``prefill_chunk(slot, budget) -> left``, ``release(slot)`` and
``step(active) -> (num_slots,) tokens``; it MAY expose
``step_async(active)`` returning a handle with ``ready()`` and
``collect() -> tokens`` (the overlapped loop then really overlaps; without
it the device call runs synchronously at dispatch) and a compile
``ledger``. A paged stepper (``paged`` true) also has ``pages_for(
prompt_len, max_new)``, ``available_pages``, ``total_pages`` and takes
``begin_admit(..., max_new=)``. A speculative stepper (``speculative``
true) also has ``wants_sequences`` (the batcher then passes each active
slot's ``(prompt, emitted)`` host sequence) and ``spec_step(active, seqs)
-> (toks, counts, used_verify)``, ``toks`` (num_slots, w) with row i's
first ``counts[i]`` entries the tokens slot i emits: the budget, EOS and
deadline checks then run per emitted token, in emission order. It is
always dispatched synchronously (the draft-verify path materializes host
state mid-call). A QoS preemption needs ``swap_out(slot) -> state`` and
``swap_in(slot, state, max_new=)``; a completion group needs ``can_fork``,
``fork_slot(src, dst, max_new=, completion=)`` and (paged)
``fork_pages_for(prompt_len, max_new)``.
"""

from __future__ import annotations

import collections
import copy
import queue as _queue
import threading
import time

import numpy as np

from distkeras_tpu_torch.obs.metrics import MetricsRegistry
from distkeras_tpu_torch.obs.overlap import OverlapLedger
from distkeras_tpu_torch.serving.qos import _QosQueues, fold_tenant


_NO_STOP = object()  # a window emitted without reaching a stop


class _Inflight:
    """One dispatched-but-uncollected device step, scheduler-side: the
    active mask and host sequences it was issued against, the wall/mint
    stamps its collect needs for attribution, and exactly one of — a
    stepper ``step_async`` handle, a held synchronous result tuple
    (speculative steppers and those without an async face), or a stashed
    dispatch exception (a failure at dispatch surfaces at the COLLECT of
    its own iteration, where the blame machinery runs)."""

    __slots__ = ("active", "seqs", "t0", "mints0", "handle", "result",
                 "exc")

    def __init__(self, active, seqs, t0, mints0):
        self.active = active
        self.seqs = seqs
        self.t0 = t0
        self.mints0 = mints0
        self.handle = None
        self.result = None
        self.exc = None

    def ready(self) -> bool:
        if self.handle is not None:
            return self.handle.ready()
        return True  # held result / stashed exception: nothing to wait on


class ServingError(RuntimeError):
    """Base class for request-level serving failures; ``code`` is the
    stable error string."""

    code = "error"


class OverloadedError(ServingError):
    """Admission queue full — retry later (explicit backpressure)."""

    code = "overloaded"


class PoolExhaustedError(OverloadedError):
    """A KV page pool cannot cover an allocation — capacity pressure, so
    ``overloaded`` on the wire, with its own ``retry_after_ms`` hint."""

    def __init__(self, msg, retry_after_ms: float = 50.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)
        self.retry_after = self.retry_after_ms / 1e3


class ShedError(OverloadedError):
    """Refused at the door by an adaptive overload gate; plain
    ``overloaded`` on the wire with an honest ``retry_after_ms``."""

    def __init__(self, msg, retry_after_ms: float = 50.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)
        self.retry_after = self.retry_after_ms / 1e3


class QuotaExhaustedError(OverloadedError):
    """A tenant's admission quota cannot cover this request. Retriable
    like ``overloaded``; ``retry_after_ms`` is the refill time."""

    code = "quota_exhausted"

    def __init__(self, msg, retry_after_ms: float = 50.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)
        self.retry_after = self.retry_after_ms / 1e3


class WrongRoleError(ServingError):
    """The verb is not served by this engine's disaggregation role — a
    routing error, never retried."""

    code = "wrong_role"


class PeerError(ServingError):
    """A worker-to-worker KV fabric operation failed (every peer path is
    fail-soft: the requester recomputes)."""

    code = "kv_peer"


class StaleEpochError(PeerError):
    """A peer frame or fetch named a KV epoch this engine no longer
    serves."""

    code = "stale_epoch"


class DeadlineExceededError(ServingError):
    """The request's deadline expired before it finished decoding."""

    code = "deadline_exceeded"


class EngineStoppedError(ServingError):
    """The engine is draining or stopped; no new admissions."""

    code = "stopping"


class InternalError(ServingError):
    """The engine failed this request for an internal reason (a prefill
    crash, or a scheduler crash that aborted it mid-flight)."""

    code = "internal"


class ServeRequest:
    """One generate request riding the continuous batcher.

    ``deadline`` is an absolute ``time.monotonic()`` instant (None = no
    deadline). ``result(timeout)`` blocks until the request finishes and
    returns the full sequence (prompt + generated tokens, cut after the
    first generated ``eos_id`` inclusive) or raises the recorded
    ``ServingError``. ``sampling``: an optional ``SamplingParams``.

    ``trace``: an optional ``obs.tracing.TraceContext``; when set, the
    batcher also keeps the per-request event ledger (one entry per
    prefill chunk) that ``obs.tracing.request_spans`` reads. The
    timestamps are always stamped (they feed ``latency()``).
    ``tenant``/``priority``: the QoS identity (the WFQ share and the
    priority class under a policy; metric labels either way);
    ``preemptions`` counts swap-outs, and ``_swap`` holds the host swap
    state while the request is swapped out (dropped with the request).
    ``sampling.n > 1`` makes a completion group: ``completions`` holds
    each stream's tokens (``tokens`` is ``completions[0]``), ``result()``
    returns the list of n sequences, and any typed failure fails the whole
    group. ``stream``: each scheduler iteration's emitted tokens are pushed
    into a FIFO that ``next_chunk`` drains; ``first_sent`` is stamped by
    the server thread when the first chunk frame has been sent.
    ``prefill_only``: the request completes when its prefill does, with the
    slot's ``swap_out`` state in ``export`` and no tokens (the prefill
    worker's half of a disaggregated hand-off)."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 trace=None, sampling=None, tenant=None, priority=0,
                 stream=False, prefill_only=False):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}"
            )
        with self._ids_lock:
            self.id = next(self._ids)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = None if eos_id is None else int(eos_id)
        self.deadline = None if deadline is None else float(deadline)
        self.tenant = "default" if tenant is None else str(tenant)
        self.priority = int(priority)
        self.preemptions = 0  # times this request was swapped out
        self._swap = None  # the stepper's host swap state while out
        self.sampling = sampling
        self.n = 1 if sampling is None else int(sampling.n)
        self.stream = bool(stream)
        self.prefill_only = bool(prefill_only)
        self.export = None  # the exported swap state of a prefill_only slot
        self._chunks = _queue.SimpleQueue() if self.stream else None
        self.first_sent = None
        self.created = time.monotonic()
        self.started = None  # admission instant (queue wait ends)
        self.prefill_finished = None  # slot became decodable
        self.first_token = None  # first generated token appended
        self.finished = None
        self.completions: list[list[int]] = [[] for _ in range(self.n)]
        self.tokens: list[int] = self.completions[0]
        self.error: ServingError | None = None
        self.trace = trace
        self.events: list[dict] = []  # trace ledger (traced requests only)
        self.prefill_chunks = 0  # stepper.prefill_chunk calls, this request
        self.iterations = 0  # scheduler iterations this slot advanced
        self._done = threading.Event()

    def _finish(self, error: ServingError | None = None):
        self.error = error
        self.finished = time.monotonic()
        self._swap = None  # host K/V rows go with the request
        self._done.set()
        if self._chunks is not None:
            # the terminal sentinel goes in after the result is readable
            self._chunks.put(None)

    def _push_chunk(self, toks) -> None:
        """One iteration's emitted tokens for the draining thread; the
        batcher calls it before any eviction that iteration triggers, so
        the sentinel never overtakes data."""
        if self._chunks is not None:
            self._chunks.put(list(toks))

    def next_chunk(self, timeout=None):
        """Blocking read of the stream FIFO: a list of new tokens, or None
        once the request finished (then read ``error`` / ``result()``).
        Raises ``TimeoutError`` when nothing arrived in ``timeout``."""
        try:
            return self._chunks.get(timeout=timeout)
        except _queue.Empty:
            raise TimeoutError(
                f"request {self.id}: no stream progress in {timeout}s"
            ) from None

    def _expired(self, now) -> bool:
        return self.deadline is not None and now >= self.deadline

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error is not None:
            raise self.error
        if self.n == 1:
            return self._seq(self.tokens)
        return [self._seq(c) for c in self.completions]

    def _seq(self, toks) -> np.ndarray:
        seq = np.concatenate([self.prompt, np.asarray(toks, np.int32)])
        if self.eos_id is not None and self.eos_id in toks:
            seq = seq[: self.prompt.size + toks.index(self.eos_id) + 1]
        return seq

    def latency(self) -> dict:
        """Per-phase seconds: queue wait, prefill, decode, ``ttft`` (to
        the first chunk sent on a stream, else to the first token
        appended) and ``total``; phases never reached stay None."""

        def span(a, b):
            return None if a is None or b is None else b - a

        first = self.first_sent if self.first_sent is not None \
            else self.first_token
        return {
            "queue_wait": span(self.created, self.started),
            "prefill": span(self.started, self.prefill_finished),
            "decode": span(self.prefill_finished, self.finished),
            "ttft": span(self.created, first),
            "total": span(self.created, self.finished),
        }


class ContinuousBatcher:
    """Slot-bank continuous batching around an injected device stepper.
    Thread-safe ``submit``; ``step()`` is driven by exactly one loop (the
    engine thread). Slots go ``queued -> prefilling -> decoding ->
    evicted``; admission is incremental (chunked prefill under the
    per-iteration ``prefill_chunk`` budget; None = whole prompt at once)
    and slots mid-prefill sit out the decode step.

    ``quarantine_steps``: scheduler iterations a slot sits out after a
    device step is blamed on its request; it recycles into the free pool
    once the probation expires. ``registry``: the ``obs.MetricsRegistry``
    the counters and gauges register in (a fresh one when None).
    ``recorder``: an ``obs.FlightRecorder`` that receives an event per
    working iteration and the blame, quarantine and prefill-failure
    events (None records nothing).
    ``overlap``: True runs the overlapped loop — each ``step()`` first does
    the host work (admission, chunked prefill, deadline sweeps) while the
    PREVIOUS iteration's step is on the device, then collects that step
    (emission/eviction — the only host sync), then dispatches the next
    one. A step that fails surfaces at the collect of its own iteration,
    with the same blame/quarantine semantics. False (the default here;
    ``ServingEngine`` defaults to True) dispatches and waits, so one
    ``step()`` call emits its own tokens.

    ``qos``: an optional ``qos.QosPolicy``. None keeps the single FIFO. A
    policy makes the queue priority classes with per-tenant weighted fair
    queuing over emitted tokens, and (``preempt=True``, over a stepper with
    ``swap_out``) lets a queued request that admission cannot place
    displace the lowest-priority decoding slot: the victim's KV goes to
    the host, its slot and pages free, and it re-queues at the front of
    its class; resume is ``swap_in``, token-identical across the boundary.
    The sequential loop preempts in its admission phase; the overlapped
    loop picks the victim after collect (nothing in flight). At most
    ``max_preemptions`` displacements per request. Pairing at quiescence:
    ``preemptions == resumes + swap_in_failures + swapped_failed``.

    ``shed_gate``: an optional ``resilience.AdmissionController`` consulted
    on every ``submit`` before the queue-capacity check (outside the
    batcher lock): ``shed``/``refuse`` raise ``ShedError`` with the gate's
    ``retry_after_ms`` (counted ``shed_overloaded``), a rung-2 clamp lowers
    ``max_new_tokens`` (``shed_clamped``), and a rung change lands one
    ``scheduler.shed_rung`` recorder event. Each first admission reports
    its queue sojourn (``note_delay``), the gate's CoDel signal."""

    def __init__(self, stepper, queue_capacity=64, prefill_chunk=None,
                 quarantine_steps=64, registry=None, recorder=None,
                 qos=None, overlap=False, shed_gate=None):
        self.stepper = stepper
        self.shed_gate = shed_gate
        self.queue_capacity = int(queue_capacity)
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self.qos = qos
        self._preemptible = (qos is not None and qos.preempt
                             and hasattr(stepper, "swap_out"))
        self.prefill_chunk = (
            None if prefill_chunk is None else int(prefill_chunk)
        )
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None; got {prefill_chunk}"
            )
        self.quarantine_steps = int(quarantine_steps)
        if self.quarantine_steps < 1:
            raise ValueError("quarantine_steps must be >= 1")
        # a plain FIFO, or priority classes with per-tenant WFQ behind the
        # same deque face: only WHICH request heads the queue is policy
        self._queue = (
            collections.deque() if qos is None else _QosQueues(qos)
        )
        self._slots: list[ServeRequest | None] = [None] * stepper.num_slots
        # completion groups: the completion index each slot serves (0 for
        # single requests and group primaries) and the reserved slots still
        # waiting for their fork (slot -> completion)
        self._slot_comp = [0] * stepper.num_slots
        self._awaiting_fork: dict[int, int] = {}
        # slot -> prefill positions remaining; membership IS the
        # "prefilling" state, FIFO order = admission order
        self._prefill_left: dict[int, int] = {}
        self._prefill_fifo: collections.deque[int] = collections.deque()
        # blame bookkeeping: per-slot admission sequence (the newest
        # admission is the prime suspect of a step failure) and the
        # quarantine ledger (slot -> scheduler iteration it recycles at)
        self._admit_seq = 0
        self._admit_order = [0] * stepper.num_slots
        self._quarantined: dict[int, int] = {}
        self._sched_iters = 0  # step() calls (not device steps)
        # the dispatched-but-uncollected step (at most one); only the
        # scheduler thread touches it outside stop()
        self.overlap = bool(overlap)
        self._inflight: _Inflight | None = None
        self._lock = threading.Lock()
        self._work = threading.Event()  # signals the engine loop
        self._draining = False
        self._stopped = False
        self.recorder = recorder
        self.registry = registry if registry is not None else MetricsRegistry()
        # the bubble instrument, stamped by BOTH loop modes
        self.overlap_ledger = OverlapLedger(self.registry)
        self.counters = self.registry.group(
            "serving_scheduler",
            (
                "submitted", "rejected_overloaded", "completed",
                "deadline_exceeded", "steps", "occupancy_sum",
                "tokens_generated", "prefill_chunks", "prefill_tokens",
                # the self-healing paths
                "step_failures",  # device step raised
                "blame_probes",  # extra step calls assigning blame
                "internal_errors",  # requests failed InternalError
                "prefill_failures",  # begin_admit/prefill_chunk raised
                "pool_exhausted",  # admissions failed typed overloaded
                # (paged KV: page reservation could not be met)
                "quarantines",  # slots sent to probation
                "streamed_chunks",
                # speculative decode (0 on plain steppers)
                "spec_windows",  # slot-windows processed through a verify
                "spec_tokens",  # tokens emitted from verify windows
                "spec_draft_accepted",  # emitted tokens the draft sourced
                # QoS preemption (0 without a policy)
                "preemptions",  # successful swap-outs (victims)
                "resumes",  # swapped requests restored and decoding
                "preempt_aborted",  # swap-out failed; victim untouched
                "swap_in_failures",  # restore failed; request failed typed
                "swapped_failed",  # failed (stop, deadline) while out
                "swapped_tokens",  # context tokens copied to the host
                # adaptive load shedding (0 without a gate): every shed is
                # a typed overloaded reply
                "shed_overloaded",  # refused at the door by the gate
                "shed_clamped",  # admitted with max_new_tokens clamped
                # disaggregated prefill export (0 on a unified engine)
                "exports",  # prefill-only slots swapped out and completed
                "export_failures",  # swap-out at export raised; typed
            ),
        )
        # requests asking for more than plain greedy, and slots made by
        # completion-group forks (the JAX package's engine-registry names)
        self.sampled_requests = self.registry.counter(
            "serving_sampled_requests", fresh=True)
        self.forked_slots = self.registry.counter(
            "serving_forked_slots", fresh=True)
        # per-tenant serving_preemptions / serving_swapped_tokens, created
        # lazily; tenant labels fold past MAX_TENANT_LABELS names
        self._tenant_counters: dict[tuple, object] = {}
        self._tenant_label_seen: set[str] = set()
        # per-slot acceptance ledger (lifetime): windows and tokens
        self._spec_windows = np.zeros(stepper.num_slots, np.int64)
        self._spec_emitted = np.zeros(stepper.num_slots, np.int64)
        # occupancy gauges, read at scrape time (unlocked: a scrape
        # tolerates a torn read)
        reg = self.registry
        reg.gauge("serving_scheduler_queue_depth", fn=lambda: len(self._queue))
        reg.gauge("serving_scheduler_active_slots",
                  fn=lambda: sum(s is not None for s in self._slots))
        reg.gauge("serving_scheduler_prefilling_slots",
                  fn=lambda: len(self._prefill_left))
        reg.gauge("serving_scheduler_quarantined_slots",
                  fn=lambda: len(self._quarantined))
        reg.gauge("serving_scheduler_num_slots", fn=lambda: len(self._slots))

    def _tenant_counter(self, name: str, tenant: str):
        tenant = fold_tenant(self._tenant_label_seen, tenant)
        key = (name, tenant)
        c = self._tenant_counters.get(key)
        if c is None:
            c = self._tenant_counters[key] = self.registry.counter(
                name, labels={"tenant": tenant})
        return c

    # -- submission ---------------------------------------------------------

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Enqueue or fail fast: ``EngineStoppedError`` while draining or
        stopped, ``ShedError`` when the shed gate refuses it,
        ``OverloadedError`` on a full queue, ``ValueError`` when
        the request can never fit a slot (or, for ``n > 1``, the stepper
        cannot fork, the bank holds fewer than n slots, or it streams or
        is prefill-only; or a prefill-only request streams or meets a
        stepper without ``swap_out``)."""
        if req.prompt.size + req.max_new_tokens > self.stepper.max_len:
            raise ValueError(
                f"prompt ({req.prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the serving capacity "
                f"({self.stepper.max_len})"
            )
        if req.n > 1:
            if not getattr(self.stepper, "can_fork", False):
                raise ValueError(
                    f"n={req.n} parallel completions need CoW slot "
                    "forking — serve with paged=True"
                )
            if req.n > len(self._slots):
                raise ValueError(
                    f"n={req.n} completions exceed the "
                    f"{len(self._slots)}-slot bank"
                )
            if req.stream or req.prefill_only:
                # a completion group has no single token order to stream,
                # and a prefill-only export is one slot's state
                raise ValueError(
                    f"n={req.n} completion groups cannot be streamed "
                    "or prefill-exported"
                )
        if req.prefill_only and req.stream:
            raise ValueError("prefill_only requests produce no tokens to "
                             "stream")
        if req.prefill_only and not hasattr(self.stepper, "swap_out"):
            raise ValueError("prefill export needs a stepper with swap_out "
                             "support")
        if getattr(self.stepper, "paged", False):
            need = self._pages_for_request(req)
            if need > self.stepper.total_pages:
                # can NEVER fit the pool: a caller error, not backpressure
                raise ValueError(
                    f"request needs {need} KV pages but the pool holds "
                    f"{self.stepper.total_pages}"
                )
        if self.shed_gate is not None:
            # the overload door, outside the batcher lock (the gate has its
            # own leaf lock, and its burn_fn walks the metrics registry)
            action, hint_ms, clamp = self.shed_gate.admit(req.priority,
                                                          req.max_new_tokens)
            t = self.shed_gate.poll_transition()
            if t is not None and self.recorder is not None:
                self.recorder.record("scheduler.shed_rung", old=t[0],
                                     new=t[1], **self.shed_gate.state())
            if action != "admit":
                self.counters["shed_overloaded"] += 1
                raise ShedError(
                    "admission shed by overload gate "
                    f"(rung {self.shed_gate.state()['rung']})",
                    retry_after_ms=hint_ms,
                )
            if clamp is not None and clamp < req.max_new_tokens:
                req.max_new_tokens = clamp
                self.counters["shed_clamped"] += 1
        with self._lock:
            if self._draining or self._stopped:
                raise EngineStoppedError("engine is draining; not accepting")
            if len(self._queue) >= self.queue_capacity:
                self.counters["rejected_overloaded"] += 1
                raise OverloadedError(
                    f"admission queue full ({self.queue_capacity})"
                )
            self._queue.append(req)
            self.counters["submitted"] += 1
            if req.sampling is not None and not req.sampling.is_default:
                self.sampled_requests.inc()
        self._work.set()
        return req

    def _pages_for_request(self, req) -> int:
        """KV pages one request reserves end to end: its admission plus
        the fresh pages of its n - 1 forks (history pages are shared)."""
        need = self.stepper.pages_for(req.prompt.size, req.max_new_tokens)
        if req.n > 1:
            fork_for = getattr(self.stepper, "fork_pages_for", None)
            per_fork = (fork_for(req.prompt.size, req.max_new_tokens)
                        if fork_for is not None else need)
            need += (req.n - 1) * per_fork
        return need

    # -- compile attribution (the ledger's trace face) ----------------------

    def _led_total(self) -> int:
        """The stepper's compile-ledger mint count (0 without a ledger),
        read before a device call so a mint inside it can be attributed
        to the traced request(s) it stalled."""
        led = getattr(self.stepper, "ledger", None)
        return 0 if led is None else led.total

    def _note_mints(self, req, n0, t0, t1) -> None:
        """Attribute ledger mints that landed during a device call to a
        TRACED request's event ledger (``request_spans`` renders it as an
        ``xla.compile`` span). Untraced requests cost one compare."""
        if req is None or req.trace is None:
            return
        led = getattr(self.stepper, "ledger", None)
        if led is None:
            return
        n = led.total - n0
        if n <= 0:
            return
        recs = led.tail(n)
        req.events.append({
            "name": "xla.compile",
            "t0": t0, "t1": t1,
            "mints": n,
            "keys": [r["key"] for r in recs],
            "seconds": round(sum(r["seconds"] for r in recs), 4),
            "trigger": recs[-1]["trigger"] if recs else None,
        })

    # -- scheduler iteration ------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: recycle expired quarantines, admit,
        spend the prefill budget, advance every decoding slot one token
        (with blame assignment on a step failure), evict finished
        sequences. Returns True when any slot made progress. Sequential
        mode runs host work -> dispatch+wait -> emit; overlapped mode runs
        host work (the previous step still on the device) -> collect+emit
        that step -> dispatch the next and return without waiting."""
        if self.overlap:
            return self._step_overlapped()
        return self._step_sequential()

    def _step_sequential(self) -> bool:
        """Every phase waits for the previous one, so the device idles
        through the host work and vice versa — the bubble the ledger
        measures."""
        progressed, _ = self._admit_phase(preempt_now=True)
        active, seqs = self._mask_phase()
        if not active.any():
            return progressed
        step_t0 = time.monotonic()
        mints0 = self._led_total()
        self.overlap_ledger.note_dispatch()
        toks, counts, blamed, used = self._step_with_blame(active, seqs)
        self.overlap_ledger.note_collect()
        return self._finish_step(active, step_t0, mints0, toks, counts,
                                 blamed, used)

    def _step_overlapped(self) -> bool:
        """Iteration N+1's host work runs while step N is on the device;
        the host syncs on N's tokens when it needs them (emission and
        eviction), then dispatches N+1 and returns.

        - Admission and prefill device calls are ordered behind the
          in-flight step on the same stream and touch only slots its mask
          excludes, so the collected tokens are unaffected.
        - Slots freed by this call's collect admit on the NEXT call; each
          request's own token stream is unchanged.
        - A step that raises (at dispatch or at collect) surfaces at the
          collect of its own iteration, where the blame probes run
          synchronously against unadvanced state.
        - QoS preemption picks its victim after collect
          (``_preempt_phase``): a swap-out under the in-flight step would
          wait for it and fetch post-step K/V against pre-step host token
          lists.
        """
        inflight = self._inflight
        if inflight is not None and inflight.ready():
            # the device finished while the host was away: stamp it so
            # the device wall is measured, not inferred from the collect
            self.overlap_ledger.note_ready()
        progressed, blocked = self._admit_phase(preempt_now=False)
        if inflight is not None:
            self._inflight = None
            if inflight.ready():
                self.overlap_ledger.note_ready()
            toks, counts, blamed, used = self._collect_with_blame(inflight)
            self.overlap_ledger.note_collect()
            self._finish_step(inflight.active, inflight.t0, inflight.mints0,
                              toks, counts, blamed, used)
            progressed = True
        # before the mask: a prefill-only slot never takes a decode step
        if self._export_prefilled():
            progressed = True
        if blocked is not None and self._preempt_phase(blocked):
            progressed = True
        active, seqs = self._mask_phase()
        if not active.any():
            return progressed
        t0 = time.monotonic()
        mints0 = self._led_total()
        self.overlap_ledger.note_dispatch()
        inflight = self._dispatch(active, seqs, t0, mints0)
        with self._lock:
            if self._stopped:
                # stop() ran between the mask and the dispatch: the
                # step's requests already failed typed; drop it
                self.overlap_ledger.discard()
            else:
                self._inflight = inflight
        return True

    def _dispatch(self, active, seqs, t0, mints0) -> _Inflight:
        """Issue the device step for ``active`` without waiting on it
        (``step_async`` where the stepper has it and is not speculative;
        otherwise the call runs here and its result — or exception — rides
        the handle to this iteration's collect)."""
        inf = _Inflight(active, seqs, t0, mints0)
        st = self.stepper
        try:
            if (not getattr(st, "speculative", False)
                    and hasattr(st, "step_async")):
                inf.handle = st.step_async(active)
            else:
                inf.result = self._device_step(active, seqs)
        except Exception as e:  # noqa: BLE001 — device crash boundary
            inf.exc = e
        return inf

    def _collect_with_blame(self, inf: _Inflight):
        """The overlapped loop's sync point: the in-flight step's tokens,
        or its deferred failure followed by blame exactly as in
        ``_step_with_blame`` (a failed call advanced nothing, so the
        synchronous probes retry from the state the dispatch saw).
        Returns ``(toks, counts, blamed, used_verify)``."""
        try:
            if inf.exc is not None:
                raise inf.exc
            if inf.handle is not None:
                toks, counts = self._one_token(inf.active,
                                               inf.handle.collect())
                return toks, counts, [], np.zeros(len(inf.active), bool)
            toks, counts, used = inf.result
            return toks, counts, [], used
        except Exception:  # noqa: BLE001 — device crash boundary
            with self._lock:
                self.counters["step_failures"] += 1
        return self._assign_blame(inf.active, inf.seqs)

    def _preempt_phase(self, blocked) -> bool:
        """The overlapped loop's deferred preemption, after collect with
        nothing in flight, checked against the post-collect state: an
        eviction that just freed what the blocked request needs makes the
        displacement unnecessary (admission places it next call)."""
        if not self._preemptible:
            return False
        with self._lock:
            free = sum(
                s is None and i not in self._quarantined
                for i, s in enumerate(self._slots)
            )
            fits = free >= blocked.n and (
                not getattr(self.stepper, "paged", False)
                or self._pages_for_request(blocked)
                <= self.stepper.available_pages
            )
            preempt = None if fits else self._pick_victim_locked(blocked)
        if preempt is None:
            return False
        return self._preempt(*preempt)

    def _admit_phase(self, preempt_now: bool):
        """Host work at the top of an iteration: quarantine recycle,
        admission of queued requests into free (not quarantined) slots —
        page-gated over a paged stepper, n slots together for a completion
        group — swap-in resumes, the chunked-prefill budget and the group
        forks. Returns ``(progressed, blocked)``: ``blocked`` is the head
        of the queue admission could not place (the preemption candidate).
        ``preempt_now``: the sequential loop preempts and exports the
        finished prefill-only slots here; the overlapped loop defers both
        until after collect (``_export_prefilled``, ``_preempt_phase``):
        a swap-out under the in-flight step would wait for it."""
        now = time.monotonic()
        admitted = []
        paged = getattr(self.stepper, "paged", False)
        page_budget = self.stepper.available_pages if paged else None
        blocked = preempt = None
        with self._lock:
            self._sched_iters += 1
            for s, until in list(self._quarantined.items()):
                if self._sched_iters >= until:
                    del self._quarantined[s]  # probation served
            free = [
                i for i, slot in enumerate(self._slots)
                if slot is None and i not in self._quarantined
            ]
            taken = 0
            while True:
                req = self._pop_live(now)
                if req is None:
                    break
                if req.n > len(free) - taken:
                    # a completion group takes its n slots together (the
                    # forks run before the primary emits, which keeps
                    # completion j an independent derived-seed admission);
                    # the head of the queue waits for evictions
                    self._queue.appendleft(req)
                    blocked = req
                    break
                if paged:
                    # admission reserves pages, so it is gated on the
                    # pool; the head of the queue WAITS for evictions to
                    # free pages (FIFO fairness), and begin_admit's typed
                    # PoolExhaustedError is the backstop for races
                    need = self._pages_for_request(req)
                    if need > page_budget:
                        self._queue.appendleft(req)
                        blocked = req
                        break
                    page_budget -= need
                group = free[taken : taken + req.n]
                taken += req.n
                if req.started is None:  # a resume keeps its stamps
                    req.started = now
                    if self.shed_gate is not None:
                        # the queue sojourn: the CoDel signal of the gate
                        self.shed_gate.note_delay(now - req.created)
                self._admit_seq += 1
                for j, i in enumerate(group):
                    self._slots[i] = req
                    self._slot_comp[i] = j
                    self._admit_order[i] = self._admit_seq
                    if j > 0:
                        self._awaiting_fork[i] = j
                admitted.append((group[0], req))
            if blocked is not None and self._preemptible and preempt_now:
                # a higher-priority request blocked on capacity may
                # displace the lowest-priority decoding slot: picked under
                # the lock, swapped out outside it (a device fetch)
                preempt = self._pick_victim_locked(blocked)
        preempted = False
        if preempt is not None:
            preempted = self._preempt(*preempt)
        # device work outside the lock: submit() never blocks on a step
        began = []
        for i, req in admitted:
            if req._swap is not None:
                # a preempted request resuming: re-reserve + restore; the
                # slot is decodable at once (its prefill ran before)
                self._resume(i, req)
                continue
            try:
                kw = {"max_new": req.max_new_tokens} if paged else {}
                if req.sampling is not None:
                    kw.update(sampling=req.sampling, eos_id=req.eos_id)
                n0, ta = self._led_total(), time.monotonic()
                began.append((i, req, self.stepper.begin_admit(
                    i, req.prompt, **kw
                )))
                self._note_mints(req, n0, ta, time.monotonic())
            except Exception as e:  # noqa: BLE001 — admission boundary
                self._fail_admission(i, req, e)
        now = time.monotonic()
        with self._lock:
            for i, req, left in began:
                if self._slots[i] is not req:
                    continue  # stopped underneath us
                if left > 0:
                    self._prefill_left[i] = left
                    self._prefill_fifo.append(i)
                else:
                    req.prefill_finished = now
        progressed = self._spend_prefill_budget() or preempted
        if preempt_now:
            progressed = self._export_prefilled() or progressed
        progressed = self._fork_completions() or progressed
        return progressed or bool(admitted), blocked

    def _mask_phase(self):
        """Deadline-sweep the slots that emit nothing (mid-prefill, or
        waiting for their fork: the post-step check never sees them) and
        return the decode mask and, for a ``wants_sequences`` stepper, each
        active slot's zero-copy ``(prompt, emitted)`` host sequence (else
        None). A group's primary and the slots waiting for its forks sit
        the step out: the primary must not emit a token its forks would
        inherit. Runs right before dispatch in both loop modes."""
        now = time.monotonic()
        with self._lock:
            for i, req in enumerate(self._slots):
                if req is None or (i not in self._prefill_left
                                   and i not in self._awaiting_fork):
                    continue
                if req._expired(now):
                    self._evict(i, req, DeadlineExceededError(
                        "deadline passed during prefill"
                    ))
            held = set(self._awaiting_fork)
            for s in self._awaiting_fork:
                req = self._slots[s]
                if req is None:
                    continue
                held.update(i for i, r in enumerate(self._slots)
                            if r is req and self._slot_comp[i] == 0)
            active = np.array(
                [
                    s is not None and i not in self._prefill_left
                    and i not in held
                    for i, s in enumerate(self._slots)
                ],
                bool,
            )
            seqs = None
            if active.any() and getattr(self.stepper, "wants_sequences",
                                        False):
                # only this thread appends to the token lists, and only
                # after the device call, so the drafter may read them as
                # they are
                seqs = [
                    (req.prompt, req.completions[self._slot_comp[i]])
                    if req is not None and active[i] else None
                    for i, req in enumerate(self._slots)
                ]
        return active, seqs

    def _finish_step(self, active, step_t0, mints0, toks, counts, blamed,
                     used_verify) -> bool:
        """Emission and eviction for one collected device step: mint
        attribution, blame eviction + quarantine, then per EMITTED token
        (a slot emits ``counts[i]`` of row ``toks[i]``) the budget, EOS and
        deadline checks in emission order — a window's tail past the first
        stop is never emitted — the stream push before any eviction, and
        the WFQ charge and the speculative acceptance counters."""
        now = time.monotonic()
        if self._led_total() > mints0:
            # a mint landed inside the decode phase: every traced active
            # request was stalled by it (once per request: a group holds
            # several slots)
            noted = set()
            for i, r in enumerate(self._slots):
                if r is not None and active[i] and id(r) not in noted:
                    noted.add(id(r))
                    self._note_mints(r, mints0, step_t0, now)
        with self._lock:
            self.counters["steps"] += 1
            self.counters["occupancy_sum"] += int(active.sum())
            for i in blamed:
                req = self._slots[i]
                if req is None:
                    continue  # stopped underneath the blame probes
                if self.recorder is not None:
                    self.recorder.record(
                        "scheduler.blame", slot=i, request_id=req.id,
                        iter=self._sched_iters,
                        probes=self.counters["blame_probes"],
                    )
                if req.trace is not None:
                    # the blame window (failed step + probes) on the
                    # culprit's own ledger: a scheduler.blame span
                    req.events.append({
                        "name": "scheduler.blame",
                        "t0": step_t0, "t1": now, "slot": i,
                    })
                self._quarantine_locked(i)
                self._evict(i, req, InternalError(
                    f"device step failed and was blamed on this request "
                    f"(slot {i}); slot quarantined for "
                    f"{self.quarantine_steps} iterations"
                ))
            if toks is None:
                if self.recorder is not None:
                    self.recorder.record(
                        "scheduler.iteration", iter=self._sched_iters,
                        active=int(active.sum()), emitted=0, blamed=blamed,
                    )
                return True  # every active slot was blamed this round
            emitted_total = 0
            blamed_set = set(blamed)
            for i, req in enumerate(self._slots):
                if req is None or not active[i] or i in blamed_set:
                    continue
                req.iterations += 1
                comp = req.completions[self._slot_comp[i]]
                new_toks = []
                stop = _NO_STOP  # the eviction waits for the chunk push
                for tok in np.atleast_1d(toks[i])[: int(counts[i])]:
                    tok = int(tok)
                    comp.append(tok)
                    new_toks.append(tok)
                    if req.first_token is None:
                        req.first_token = now
                    self.counters["tokens_generated"] += 1
                    if len(comp) >= req.max_new_tokens or (
                        req.eos_id is not None and tok == req.eos_id
                    ):
                        stop = None
                        break
                    if req._expired(now):
                        stop = DeadlineExceededError(
                            f"deadline passed after {len(req.tokens)} tokens"
                        )
                        break
                if req.stream and new_toks:
                    # pushed before the eviction below: the terminal
                    # sentinel must never overtake the last tokens
                    self.counters["streamed_chunks"] += 1
                    req._push_chunk(new_toks)
                if stop is not _NO_STOP:
                    self._evict(i, req, stop)
                emitted = len(new_toks)
                emitted_total += emitted
                if self.qos is not None and emitted:
                    # WFQ: decode tokens generated, over the tenant's weight
                    self._queue.charge(req.tenant, emitted)
                if used_verify[i]:
                    self.counters["spec_windows"] += 1
                    self.counters["spec_tokens"] += emitted
                    # the window's last token is the target's correction;
                    # the ones before it came from the draft
                    self.counters["spec_draft_accepted"] += max(
                        0, min(emitted, int(counts[i]) - 1)
                    )
                    self._spec_windows[i] += 1
                    self._spec_emitted[i] += emitted
        if self.recorder is not None:
            # one line per WORKING iteration (idle loops record nothing)
            self.recorder.record(
                "scheduler.iteration", iter=self._sched_iters,
                active=int(active.sum()), emitted=emitted_total,
                spec=bool(np.any(used_verify)),
                blamed=blamed if blamed else None,
            )
        return True

    # -- disaggregated prefill export ---------------------------------------

    def _export_prefilled(self) -> bool:
        """Complete every ``prefill_only`` request whose prefill has
        finished: fetch the slot's state through ``stepper.swap_out`` (the
        host format a QoS preemption rides, and the one the transfer frame
        serializes), park it on ``req.export`` and free the slot. Runs
        before the decode mask in both loop shapes. A failed swap-out fails
        only its request, typed (a ``ServingError`` as itself, anything
        else ``internal``), with the exception class on the tape."""
        with self._lock:
            ready = [(i, req) for i, req in enumerate(self._slots)
                     if req is not None and req.prefill_only
                     and i not in self._prefill_left]
        progressed = False
        for i, req in ready:
            try:
                state = self.stepper.swap_out(i)  # the device fetch
            except Exception as e:  # noqa: BLE001 — export boundary
                err = (copy.copy(e) if isinstance(e, ServingError)
                       else InternalError(f"prefill export failed for this "
                                          f"request: {e!r}"))
                with self._lock:
                    self.counters["export_failures"] += 1
                    self._record_swap_error("export", i, req, e)
                    if self._slots[i] is req:
                        self._evict(i, req, err)
                progressed = True
                continue
            with self._lock:
                if self._slots[i] is not req:
                    continue  # stopped underneath the fetch
                req.export = state
                self.counters["exports"] += 1
                self._evict(i, req, None)
            progressed = True
        return progressed

    # -- preemption by KV swap (QoS) ----------------------------------------

    def _record_swap_error(self, op, slot, req, exc):
        """A swallowed swap failure leaves its exception class on the tape
        (a swap path failing every call must not look like a quiet one).
        Caller holds the lock."""
        if self.recorder is not None:
            self.recorder.record(
                "qos.swap_error", op=op, slot=slot, request_id=req.id,
                tenant=req.tenant, error=type(exc).__name__,
                detail=repr(exc)[:200],
            )

    def _pick_victim_locked(self, blocked):
        """The slot a blocked request may displace: DECODING (not
        mid-prefill, not part of a completion group), of strictly lower
        priority, with preemption budget left (``max_preemptions``: a
        request displaced that many times is immune), and short enough that
        its context round-trips the prompt row. Lowest priority first, then
        fewest emitted tokens (cheapest swap), then slot. Caller holds the
        lock. Returns ``(slot, request)`` or None."""
        best = None
        max_len = self.stepper.max_len
        for i, req in enumerate(self._slots):
            if req is None or i in self._prefill_left:
                continue
            if req.n > 1 or i in self._awaiting_fork:
                continue  # completion groups are never preempted
            if req.priority >= blocked.priority:
                continue
            if req.preemptions >= self.qos.max_preemptions:
                continue  # immune: nothing livelocks
            if req.prompt.size + len(req.tokens) >= max_len:
                continue  # the context cannot round-trip the prompt row
            key = (req.priority, len(req.tokens), i)
            if best is None or key < best[0]:
                best = (key, i, req)
        return None if best is None else (best[1], best[2])

    def _preempt(self, slot, vreq) -> bool:
        """Swap the victim out (the device fetch outside the lock), free
        its slot and pages, and re-queue it at the FRONT of its class with
        the swap state riding the request. A failed swap-out aborts the
        preemption (the ``kv.swap`` seam fires before any state changes,
        so the victim decodes on untouched)."""
        try:
            state = self.stepper.swap_out(slot)
        except Exception as e:  # noqa: BLE001 — preemption is optional
            with self._lock:
                self.counters["preempt_aborted"] += 1
                self._record_swap_error("swap_out", slot, vreq, e)
            return False
        with self._lock:
            if self._slots[slot] is not vreq:
                return False  # stopped or evicted underneath the fetch
            vreq._swap = state
            vreq.preemptions += 1
            self.counters["preemptions"] += 1
            self.counters["swapped_tokens"] += int(state["len"])
            self._tenant_counter("serving_preemptions", vreq.tenant).inc()
            self._tenant_counter("serving_swapped_tokens",
                                 vreq.tenant).inc(int(state["len"]))
            self._slots[slot] = None
            self.stepper.release(slot)  # pages freed; the state rides req
            self._queue.appendleft(vreq)
            if self.recorder is not None:
                self.recorder.record(
                    "qos.preempt", slot=slot, request_id=vreq.id,
                    tenant=vreq.tenant, priority=vreq.priority,
                    tokens=int(state["len"]), preemptions=vreq.preemptions,
                )
        self._work.set()
        return True

    def _resume(self, i, req):
        """Swap a preempted request back in (``stepper.swap_in``:
        re-reserve + restore); the slot is decodable at once. A failed
        swap-in fails only this request, typed: a ``ServingError`` (notably
        ``PoolExhaustedError``) as itself, anything else ``internal``."""
        mints0, t0 = self._led_total(), time.monotonic()
        try:
            self.stepper.swap_in(
                i, req._swap, max_new=req.max_new_tokens - len(req.tokens)
            )
            self._note_mints(req, mints0, t0, time.monotonic())
        except Exception as e:  # noqa: BLE001 — admission boundary
            err = (copy.copy(e) if isinstance(e, ServingError)
                   else InternalError(f"swap-in failed for this request: "
                                      f"{e!r}"))
            with self._lock:
                self.counters["swap_in_failures"] += 1
                self._record_swap_error("swap_in", i, req, e)
                if self._slots[i] is req:
                    self._evict(i, req, err)
            return
        with self._lock:
            if self._slots[i] is not req:
                return  # stopped underneath us
            req._swap = None
            if req.prefill_finished is None:
                req.prefill_finished = time.monotonic()
            self.counters["resumes"] += 1
            if self.recorder is not None:
                self.recorder.record(
                    "qos.resume", slot=i, request_id=req.id,
                    tenant=req.tenant, priority=req.priority,
                    tokens=len(req.tokens),
                )

    # -- completion groups --------------------------------------------------

    def _fork_completions(self) -> bool:
        """Fork a completion group's reserved slots from its primary the
        moment the primary's prefill finishes — before it emits a token —
        so completion j is the independent admission under
        ``seed_for_completion(seed, j)``. Device work outside the lock.

        Pool exhaustion at fork time is pressure, not a fault (admission's
        page gate is advisory over a multi-iteration prefill): the group
        waits, the primary held, and the fork retries next iteration (the
        deadline sweep bounds the wait). Any other fork failure fails the
        whole group typed."""
        if not self._awaiting_fork:
            return False
        with self._lock:
            ready = []
            for s, j in list(self._awaiting_fork.items()):
                req = self._slots[s]
                if req is None:
                    self._awaiting_fork.pop(s)
                    continue
                primary = next(
                    (i for i, r in enumerate(self._slots)
                     if r is req and self._slot_comp[i] == 0),
                    None,
                )
                if primary is None:
                    # the primary died (its failure completed the group):
                    # clean the orphaned reservation
                    self._awaiting_fork.pop(s)
                    self._slots[s] = None
                    self.stepper.release(s)
                    continue
                if primary not in self._prefill_left:
                    ready.append((primary, s, j, req))
        progressed = False
        for primary, s, j, req in ready:
            with self._lock:
                if (self._slots[s] is not req
                        or self._slots[primary] is not req):
                    continue  # a sibling's failure evicted the group
            mints0, t0 = self._led_total(), time.monotonic()
            try:
                self.stepper.fork_slot(primary, s, max_new=req.max_new_tokens,
                                       completion=j)
                self._note_mints(req, mints0, t0, time.monotonic())
            except OverloadedError:
                continue  # pool pressure: the group waits for evictions
            except Exception as e:  # noqa: BLE001 — admission boundary
                self._fail_admission(s, req, e)
                continue
            progressed = True
            with self._lock:
                if self._slots[s] is req:
                    self._awaiting_fork.pop(s, None)
                    self.forked_slots.inc()
        return progressed

    # -- blame assignment ----------------------------------------------------

    @staticmethod
    def _one_token(active, toks):
        """A plain step's (B,) tokens in the variable-advance shape:
        ``(toks (B, 1), counts (B,))``."""
        return (np.asarray(toks).reshape(-1, 1),
                np.where(active, 1, 0).astype(np.int64))

    def _device_step(self, active, seqs):
        """One synchronous device advance in the variable-advance shape
        ``(toks (B, w), counts (B,), used_verify (B,))``: a plain step is
        w = 1; a speculative stepper runs ``spec_step`` (1 to ``k + 1``
        tokens per slot). ``used_verify`` is per slot, so a fallback step
        never counts as a verify window."""
        st = self.stepper
        if getattr(st, "speculative", False):
            toks, counts, used = st.spec_step(active, seqs)
            return (np.asarray(toks), np.asarray(counts),
                    np.asarray(active, bool) & bool(used))
        toks, counts = self._one_token(active, st.step(active))
        return toks, counts, np.zeros(len(active), bool)

    def _step_with_blame(self, active, seqs=None):
        """Advance the active slots one window, surviving a poison
        request: when the device step (plain or verify) raises,
        ``_assign_blame`` finds the culprit. Every non-blamed slot
        advances exactly one window (failed calls advance nothing — the
        seams fire before device work, the stepper advances its host
        state only on success, and a retried verify re-verifies the same
        cached proposals), so surviving streams stay token-identical to
        their solo decode. Returns ``(toks, counts, blamed,
        used_verify)``; ``toks`` is None when nothing advanced."""
        try:
            toks, counts, used = self._device_step(active, seqs)
            return toks, counts, [], used
        except Exception:  # noqa: BLE001 — device crash boundary
            with self._lock:
                self.counters["step_failures"] += 1
        return self._assign_blame(active, seqs)

    def _assign_blame(self, active, seqs):
        """The probe cascade after a failed step (shared by both loop
        shapes): retry with the newest admission masked out (established
        streams were stepping fine before it arrived); if that fails too,
        bisect the active set down to the culpable slots. A slot alone in
        the batch is culpable by elimination. Every probe failing blames
        every active slot — the supervisor's restart budget is the
        backstop for a stepper that is dead, not poisoned."""
        none = np.zeros(len(active), bool)
        idxs = [int(i) for i in np.flatnonzero(active)]
        if len(idxs) == 1:
            return None, None, idxs, none
        with self._lock:
            suspect = max(idxs, key=lambda i: self._admit_order[i])
        retry = active.copy()
        retry[suspect] = False
        try:
            with self._lock:
                self.counters["blame_probes"] += 1
            toks, counts, used = self._device_step(retry, seqs)
            return toks, counts, [suspect], used
        except Exception:  # noqa: BLE001
            pass
        # the newest admission alone is not the story: bisect the whole
        # active set (nothing has advanced yet — all probes so far failed)
        got: dict[int, tuple] = {}
        blamed: list[int] = []

        def probe(group):
            mask = np.zeros_like(active)
            mask[group] = True
            try:
                with self._lock:
                    self.counters["blame_probes"] += 1
                t, cnt, u = self._device_step(mask, seqs)
            except Exception:  # noqa: BLE001
                if len(group) == 1:
                    blamed.append(group[0])
                    return
                half = len(group) // 2
                probe(group[:half])
                probe(group[half:])
                return
            for i in group:
                got[i] = (np.atleast_1d(t[i]), int(cnt[i]), bool(u[i]))

        probe(idxs)
        if not got:
            return None, None, blamed, none
        w = max(row.shape[0] for row, _, _ in got.values())
        toks = np.zeros((len(active), w), np.int64)
        counts = np.zeros(len(active), np.int64)
        used = none.copy()
        for i, (row, cnt, u) in got.items():
            toks[i, : row.shape[0]] = row
            counts[i] = cnt
            used[i] = u
        return toks, counts, blamed, used

    def _quarantine_locked(self, i):
        """Send slot ``i`` to probation. Caller holds the lock."""
        self.counters["quarantines"] += 1
        self._quarantined[i] = self._sched_iters + self.quarantine_steps
        if self.recorder is not None:
            self.recorder.record(
                "scheduler.quarantine", slot=i,
                until_iter=self._quarantined[i],
            )

    def _fail_admission(self, i, req, exc):
        """A begin_admit/prefill_chunk crash fails only its own
        (attributable) request, typed, and frees the slot. A
        ``ServingError`` passes through as itself (a fresh copy per
        request: an injected seam re-raises one instance) — notably
        ``PoolExhaustedError``, so pool pressure reaches the client as the
        retriable ``overloaded`` with its ``retry_after_ms``."""
        err = (
            copy.copy(exc)
            if isinstance(exc, ServingError)
            else InternalError(f"prefill failed for this request: {exc!r}")
        )
        with self._lock:
            self.counters["prefill_failures"] += 1
            if self.recorder is not None:
                self.recorder.record(
                    "scheduler.prefill_failure", slot=i,
                    request_id=req.id, error=repr(exc)[:200],
                )
            if self._slots[i] is req:
                self._evict(i, req, err)

    def _spend_prefill_budget(self) -> bool:
        """Advance mid-prefill slots, oldest admission first, spending at
        most ``prefill_chunk`` prompt tokens this iteration. Device calls
        run outside the lock; only the engine thread mutates the prefill
        state."""
        budget = self.prefill_chunk
        spent = 0
        progressed = False
        while True:
            with self._lock:
                if not self._prefill_fifo or (
                    budget is not None and spent >= budget
                ):
                    return progressed
                i = self._prefill_fifo[0]
                req = self._slots[i]
                left = self._prefill_left[i]
                give = left if budget is None else min(left, budget - spent)
            mints0 = self._led_total()
            chunk_t0 = time.monotonic()
            try:
                new_left = self.stepper.prefill_chunk(i, give)
            except Exception as e:  # noqa: BLE001 — admission boundary
                self._fail_admission(i, req, e)
                progressed = True
                continue
            now = time.monotonic()
            self._note_mints(req, mints0, chunk_t0, now)
            with self._lock:
                if self._slots[i] is not req:
                    continue  # stopped/evicted underneath us
                consumed = left - new_left
                req.prefill_chunks += 1
                if req.trace is not None:
                    req.events.append({
                        "name": "serving.prefill_chunk",
                        "t0": chunk_t0, "t1": now,
                        "tokens": int(consumed), "slot": i,
                    })
                if consumed <= 0 and new_left > 0:
                    raise RuntimeError(
                        f"stepper made no prefill progress on slot {i}"
                    )
                spent += consumed
                progressed = progressed or consumed > 0
                self.counters["prefill_chunks"] += 1
                self.counters["prefill_tokens"] += consumed
                self._prefill_left[i] = new_left
                if new_left == 0:
                    self._drop_prefill(i)
                    req.prefill_finished = now

    def _drop_prefill(self, i):
        """Leave the prefilling state. Caller holds the lock."""
        self._prefill_left.pop(i, None)
        try:
            self._prefill_fifo.remove(i)
        except ValueError:
            pass

    def _pop_live(self, now) -> ServeRequest | None:
        """Next queued request whose deadline has not expired; expired
        ones complete with DeadlineExceededError. Caller holds the lock."""
        while self._queue:
            req = self._queue.popleft()
            if req._expired(now):
                self.counters["deadline_exceeded"] += 1
                if req._swap is not None:
                    # a swapped request dying in the queue pairs its swap-out
                    self.counters["swapped_failed"] += 1
                req._finish(DeadlineExceededError("deadline expired in queue"))
                continue
            return req
        return None

    def _evict(self, slot_idx, req, error):
        """Free a slot and complete its request — or, for a completion
        group, one completion of it: a clean finish releases only its slot
        and the request finishes with its LAST completion; an error
        releases every sibling slot and fails the whole request (all
        complete, or all typed). Caller holds the lock."""
        self._slots[slot_idx] = None
        self._drop_prefill(slot_idx)
        self._awaiting_fork.pop(slot_idx, None)
        self.stepper.release(slot_idx)
        if error is None:
            if any(r is req for r in self._slots):
                return  # sibling completions still decoding or forking
            self.counters["completed"] += 1
            req._finish(None)
            return
        for i, r in enumerate(self._slots):
            if r is req:  # the group's siblings die with the request
                self._slots[i] = None
                self._drop_prefill(i)
                self._awaiting_fork.pop(i, None)
                self.stepper.release(i)
        if isinstance(error, InternalError):
            self.counters["internal_errors"] += 1
        elif isinstance(error, OverloadedError):
            self.counters["pool_exhausted"] += 1
        elif isinstance(error, DeadlineExceededError):
            self.counters["deadline_exceeded"] += 1
        req._finish(error)

    # -- drain / shutdown ---------------------------------------------------

    def drain(self):
        """Stop admitting NEW requests; queued and in-flight ones keep
        running (the engine loop steps until ``idle``)."""
        with self._lock:
            self._draining = True
        self._work.set()

    def stop(self, error: ServingError | None = None):
        """Hard stop: fail everything still queued or in flight with
        ``error`` (default ``EngineStoppedError``; the engine supervisor
        passes ``InternalError``), one instance each. A step still in the
        air is dropped uncollected: its requests fail here, and the
        stepper's host state never advances for it."""
        proto = error if error is not None else EngineStoppedError(
            "engine stopped"
        )
        with self._lock:
            self._draining = self._stopped = True
            self._inflight = None
            self.overlap_ledger.discard()
            while self._queue:
                req = self._queue.popleft()
                if req._swap is not None:
                    # a stop racing a swapped-out request: its host state
                    # goes with the typed failure (pairing stays balanced)
                    self.counters["swapped_failed"] += 1
                req._finish(type(proto)(*proto.args))
            self._prefill_left.clear()
            self._prefill_fifo.clear()
            self._awaiting_fork.clear()
            failed = set()  # a completion group holds several slots
            for i, req in enumerate(self._slots):
                if req is not None:
                    self._slots[i] = None
                    self.stepper.release(i)
                    if id(req) not in failed:
                        failed.add(id(req))
                        req._finish(type(proto)(*proto.args))
        self._work.set()

    # -- introspection ------------------------------------------------------

    @property
    def idle(self) -> bool:
        with self._lock:
            return (
                self._inflight is None
                and not self._queue
                and all(s is None for s in self._slots)
            )

    def inflight_snapshot(self) -> list[dict]:
        """The in-flight request table for a post-mortem bundle: every
        queued and slotted request with its trace id (when traced)."""

        def row(req, state, slot=None):
            return {
                "request_id": req.id,
                "state": state,
                "slot": slot,
                "tenant": req.tenant,
                "priority": req.priority,
                "preemptions": req.preemptions,
                "prompt_len": int(req.prompt.size),
                "max_new_tokens": req.max_new_tokens,
                "tokens_emitted": sum(len(c) for c in req.completions),
                "trace_id": (
                    None if req.trace is None else req.trace.trace_id
                ),
            }

        with self._lock:
            out = [row(r, "swapped" if r._swap is not None else "queued")
                   for r in self._queue]
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                state = (
                    "prefilling" if i in self._prefill_left else "decoding"
                )
                out.append(row(req, state, slot=i))
            return out

    def load(self) -> dict:
        """Cheap occupancy snapshot for the health surface."""
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "queue_capacity": self.queue_capacity,
                "active_slots": sum(s is not None for s in self._slots),
                "prefilling_slots": len(self._prefill_left),
                "num_slots": len(self._slots),
                # decode geometry ("tp:N" in the JAX package): the port
                # has no serving meshes yet, so every replica reports None
                "mesh": None,
            }

    def stats(self) -> dict:
        out = self.load()
        with self._lock:
            out.update(self.counters)
            out["sampled_requests"] = self.sampled_requests.value
            out["forked_slots"] = self.forked_slots.value
            out["quarantined_slots"] = len(self._quarantined)
            out["prefill_chunk"] = self.prefill_chunk
            out["draining"] = self._draining
        steps = out["steps"]
        out["mean_batch_occupancy"] = (
            out["occupancy_sum"] / steps if steps else 0.0
        )
        if self.qos is not None:
            out["qos"] = {
                "enabled": True,
                "preempt": self.qos.preempt,
                "max_preemptions": self.qos.max_preemptions,
                "tenant_service": self._queue.service_snapshot(),
            }
        else:
            out["qos"] = {"enabled": False}
        out["overlap"] = {
            "enabled": self.overlap,
            **self.overlap_ledger.snapshot(),
        }
        st = self.stepper
        if getattr(st, "speculative", False):
            drafted = int(getattr(st, "spec_drafted_tokens", 0))
            accepted = out["spec_draft_accepted"]
            windows = out["spec_windows"]
            out["speculative"] = {
                "enabled": True,
                "draft_source": st.drafter.name,
                "draft_k": st.draft_k,
                "verify_steps": int(st.spec_verify_steps),
                "fallback_steps": int(st.spec_fallback_steps),
                "windows": windows,
                "drafted_tokens": drafted,
                "accepted_draft_tokens": accepted,
                "rejected_draft_tokens": max(0, drafted - accepted),
                "emitted_tokens": out["spec_tokens"],
                "mean_tokens_per_window": (
                    round(out["spec_tokens"] / windows, 3)
                    if windows else 0.0
                ),
                "per_slot_acceptance": [
                    round(float(e) / w, 3) if w else None
                    for e, w in zip(self._spec_emitted, self._spec_windows)
                ],
            }
        else:
            out["speculative"] = {"enabled": False}
        return out

    def wait_for_work(self, timeout=0.05):
        """Engine-loop helper: park until a submit/drain signal."""
        self._work.wait(timeout)
        self._work.clear()


class _Ticket:
    """Completion handle for one windowed-batch item."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._error = None

    def _finish(self, result=None, error=None):
        self._result, self._error = result, error
        self._done.set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("predict batch still running")
        if self._error is not None:
            raise self._error
        return self._result


class WindowedBatcher:
    """Size/timeout-windowed batcher for batch scoring: items accumulate
    until ``max_batch`` rows are waiting or ``max_wait`` elapsed since the
    first, then ``run_batch`` scores them as one array and each ticket
    receives its row span."""

    def __init__(self, run_batch, max_batch=64, max_wait=0.005,
                 queue_capacity=256):
        self.run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.queue_capacity = int(queue_capacity)
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="windowed-batcher", daemon=True
            )
            self._thread.start()
        return self

    def submit(self, x) -> _Ticket:
        x = np.asarray(x)
        if x.ndim < 1:
            raise ValueError("predict input must be at least 1-D (rows)")
        if len(x) > self.queue_capacity:
            raise ValueError(
                f"predict request of {len(x)} rows exceeds the queue "
                f"capacity ({self.queue_capacity})"
            )
        ticket = _Ticket()
        with self._lock:
            if self._stop:
                raise EngineStoppedError("predict batcher stopped")
            depth = sum(len(item) for item, _ in self._items)
            if depth + len(x) > self.queue_capacity:
                raise OverloadedError(
                    f"predict queue full ({self.queue_capacity} rows)"
                )
            self._items.append((x, ticket))
        self._work.set()
        return ticket

    def _loop(self):
        while True:
            self._work.wait(0.05)
            self._work.clear()
            batch = self._collect()
            if batch is None:
                if self._stop and not self._items:
                    return
                continue
            xs, tickets = batch
            try:
                ys = self.run_batch(np.concatenate(xs, axis=0))
            except Exception as e:  # noqa: BLE001 — per-window boundary
                for t in tickets:
                    t._finish(error=e)
                continue
            off = 0
            for x, t in zip(xs, tickets):
                t._finish(result=np.asarray(ys[off : off + len(x)]))
                off += len(x)

    def _collect(self):
        """Wait out the window from the first queued item, then take up to
        ``max_batch`` rows (whole items only)."""
        with self._lock:
            if not self._items:
                return None
        deadline = time.monotonic() + self.max_wait
        while time.monotonic() < deadline:
            with self._lock:
                if (
                    sum(len(i) for i, _ in self._items) >= self.max_batch
                    or self._stop
                ):
                    break
            time.sleep(self.max_wait / 10)
        xs, tickets, rows = [], [], 0
        with self._lock:
            while self._items:
                x, t = self._items[0]
                if xs and rows + len(x) > self.max_batch:
                    break
                self._items.popleft()
                xs.append(x)
                tickets.append(t)
                rows += len(x)
        return (xs, tickets) if xs else None

    def close(self):
        with self._lock:
            self._stop = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
