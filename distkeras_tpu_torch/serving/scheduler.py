"""Request scheduling for the serving runtime — pure host logic (PyTorch
port of the subset of ``distkeras_tpu.serving.scheduler`` the serving
slice runs).

- ``ContinuousBatcher``: iteration-level batching for autoregressive
  decode over a fixed bank of ``num_slots`` sequence slots. Each
  scheduler step recycles expired quarantines, admits queued requests
  into free slots, spends at most ``prefill_chunk`` prompt tokens on
  slots mid-prefill (oldest admission first), advances every decoding
  slot one token, and evicts finished sequences. FIFO queue with
  bounded-queue backpressure, per-request deadlines, drain / hard stop.
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

Not ported yet: QoS and preemption, speculative windows, completion
groups (n > 1), prefill export, load shedding.

The device face is an injected stepper (``engine.DecodeStepper``) with
``num_slots``, ``max_len``, ``begin_admit(slot, prompt, sampling) -> left``,
``prefill_chunk(slot, budget) -> left``, ``release(slot)`` and
``step(active) -> (num_slots,) tokens``; it MAY expose
``step_async(active)`` returning a handle with ``ready()`` and
``collect() -> tokens`` (the overlapped loop then really overlaps; without
it the device call runs synchronously at dispatch) and a compile
``ledger``.
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


class _Inflight:
    """One dispatched-but-uncollected device step, scheduler-side: the
    active mask it was issued against, the wall/mint stamps its collect
    needs for attribution, and exactly one of — a stepper ``step_async``
    handle, a held synchronous result (steppers without an async face),
    or a stashed dispatch exception (a failure at dispatch surfaces at the
    COLLECT of its own iteration, where the blame machinery runs)."""

    __slots__ = ("active", "t0", "mints0", "handle", "result", "exc")

    def __init__(self, active, t0, mints0):
        self.active = active
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
    ``tenant``/``priority`` only label the request (no QoS policy here).
    ``stream``: each scheduler iteration's emitted tokens are pushed into
    a FIFO that ``next_chunk`` drains; ``first_sent`` is stamped by the
    server thread when the first chunk frame has been sent."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 trace=None, sampling=None, tenant=None, priority=0,
                 stream=False):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}"
            )
        if sampling is not None and sampling.n != 1:
            raise ValueError(
                f"n={sampling.n} parallel completions need CoW slot "
                "forking, which is not ported yet"
            )
        with self._ids_lock:
            self.id = next(self._ids)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = None if eos_id is None else int(eos_id)
        self.deadline = None if deadline is None else float(deadline)
        self.tenant = "default" if tenant is None else str(tenant)
        self.priority = int(priority)
        self.sampling = sampling
        self.stream = bool(stream)
        self._chunks = _queue.SimpleQueue() if self.stream else None
        self.first_sent = None
        self.created = time.monotonic()
        self.started = None  # admission instant (queue wait ends)
        self.prefill_finished = None  # slot became decodable
        self.first_token = None  # first generated token appended
        self.finished = None
        self.tokens: list[int] = []
        self.error: ServingError | None = None
        self.trace = trace
        self.events: list[dict] = []  # trace ledger (traced requests only)
        self.prefill_chunks = 0  # stepper.prefill_chunk calls, this request
        self.iterations = 0  # scheduler iterations this slot advanced
        self._done = threading.Event()

    def _finish(self, error: ServingError | None = None):
        self.error = error
        self.finished = time.monotonic()
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
        seq = np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])
        if self.eos_id is not None and self.eos_id in self.tokens:
            seq = seq[: self.prompt.size + self.tokens.index(self.eos_id) + 1]
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
    ``step()`` call emits its own tokens."""

    def __init__(self, stepper, queue_capacity=64, prefill_chunk=None,
                 quarantine_steps=64, registry=None, recorder=None,
                 overlap=False):
        self.stepper = stepper
        self.queue_capacity = int(queue_capacity)
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
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
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._slots: list[ServeRequest | None] = [None] * stepper.num_slots
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
                "quarantines",  # slots sent to probation
                "sampled_requests", "streamed_chunks",
            ),
        )
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

    # -- submission ---------------------------------------------------------

    def submit(self, req: ServeRequest) -> ServeRequest:
        """Enqueue or fail fast: ``EngineStoppedError`` while draining or
        stopped, ``OverloadedError`` on a full queue, ``ValueError`` when
        the request can never fit a slot."""
        if req.prompt.size + req.max_new_tokens > self.stepper.max_len:
            raise ValueError(
                f"prompt ({req.prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the serving capacity "
                f"({self.stepper.max_len})"
            )
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
                self.counters["sampled_requests"] += 1
        self._work.set()
        return req

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
        progressed = self._admit_phase()
        active = self._mask_phase()
        if not active.any():
            return progressed
        step_t0 = time.monotonic()
        mints0 = self._led_total()
        self.overlap_ledger.note_dispatch()
        toks, blamed = self._step_with_blame(active)
        self.overlap_ledger.note_collect()
        return self._finish_step(active, step_t0, mints0, toks, blamed)

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
        """
        inflight = self._inflight
        if inflight is not None and inflight.ready():
            # the device finished while the host was away: stamp it so
            # the device wall is measured, not inferred from the collect
            self.overlap_ledger.note_ready()
        progressed = self._admit_phase()
        if inflight is not None:
            self._inflight = None
            if inflight.ready():
                self.overlap_ledger.note_ready()
            toks, blamed = self._collect_with_blame(inflight)
            self.overlap_ledger.note_collect()
            self._finish_step(inflight.active, inflight.t0, inflight.mints0,
                              toks, blamed)
            progressed = True
        active = self._mask_phase()
        if not active.any():
            return progressed
        t0 = time.monotonic()
        mints0 = self._led_total()
        self.overlap_ledger.note_dispatch()
        inflight = self._dispatch(active, t0, mints0)
        with self._lock:
            if self._stopped:
                # stop() ran between the mask and the dispatch: the
                # step's requests already failed typed; drop it
                self.overlap_ledger.discard()
            else:
                self._inflight = inflight
        return True

    def _dispatch(self, active, t0, mints0) -> _Inflight:
        """Issue the device step for ``active`` without waiting on it
        (``step_async`` where the stepper has it; otherwise the call runs
        here and its result — or exception — rides the handle to this
        iteration's collect)."""
        inf = _Inflight(active, t0, mints0)
        st = self.stepper
        try:
            if hasattr(st, "step_async"):
                inf.handle = st.step_async(active)
            else:
                inf.result = self._device_step(active)
        except Exception as e:  # noqa: BLE001 — device crash boundary
            inf.exc = e
        return inf

    def _collect_with_blame(self, inf: _Inflight):
        """The overlapped loop's sync point: the in-flight step's tokens,
        or its deferred failure followed by blame exactly as in
        ``_step_with_blame`` (a failed call advanced nothing, so the
        synchronous probes retry from the state the dispatch saw).
        Returns ``(toks, blamed)``."""
        try:
            if inf.exc is not None:
                raise inf.exc
            if inf.handle is not None:
                return np.asarray(inf.handle.collect()).reshape(-1), []
            return inf.result, []
        except Exception:  # noqa: BLE001 — device crash boundary
            with self._lock:
                self.counters["step_failures"] += 1
        return self._assign_blame(inf.active)

    def _admit_phase(self) -> bool:
        """Host work at the top of an iteration: quarantine recycle,
        admission of queued requests into free (not quarantined) slots,
        the chunked-prefill budget."""
        now = time.monotonic()
        admitted = []
        with self._lock:
            self._sched_iters += 1
            for s, until in list(self._quarantined.items()):
                if self._sched_iters >= until:
                    del self._quarantined[s]  # probation served
            free = [
                i for i, slot in enumerate(self._slots)
                if slot is None and i not in self._quarantined
            ]
            for i in free:
                req = self._pop_live(now)
                if req is None:
                    break
                self._slots[i] = req
                req.started = now
                self._admit_seq += 1
                self._admit_order[i] = self._admit_seq
                admitted.append((i, req))
        # device work outside the lock: submit() never blocks on a step
        began = []
        for i, req in admitted:
            try:
                n0, ta = self._led_total(), time.monotonic()
                began.append((i, req, self.stepper.begin_admit(
                    i, req.prompt, sampling=req.sampling
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
        return self._spend_prefill_budget() or bool(admitted)

    def _mask_phase(self) -> np.ndarray:
        """Deadline-sweep slots mid-prefill (they emit nothing, so the
        post-step check never sees them) and return the decode mask. Runs
        right before dispatch in both loop modes."""
        now = time.monotonic()
        with self._lock:
            for i in list(self._prefill_left):
                req = self._slots[i]
                if req is not None and req._expired(now):
                    self._evict(i, req, DeadlineExceededError(
                        "deadline passed during prefill"
                    ))
            return np.array(
                [
                    s is not None and i not in self._prefill_left
                    for i, s in enumerate(self._slots)
                ],
                bool,
            )

    def _finish_step(self, active, step_t0, mints0, toks, blamed) -> bool:
        """Emission and eviction for one collected device step: mint
        attribution, blame eviction + quarantine, then per-token budget,
        EOS and deadline checks, stream pushes before any eviction."""
        now = time.monotonic()
        if self._led_total() > mints0:
            # a mint landed inside the decode phase: every traced active
            # request was stalled by it
            for i, r in enumerate(self._slots):
                if r is not None and active[i]:
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
            emitted = 0
            blamed_set = set(blamed)
            for i, req in enumerate(self._slots):
                if req is None or not active[i] or i in blamed_set:
                    continue
                tok = int(toks[i])
                req.iterations += 1
                req.tokens.append(tok)
                if req.first_token is None:
                    req.first_token = now
                self.counters["tokens_generated"] += 1
                emitted += 1
                if req.stream:
                    # pushed before the eviction below: the terminal
                    # sentinel must never overtake the last tokens
                    self.counters["streamed_chunks"] += 1
                    req._push_chunk([tok])
                if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_id is not None and tok == req.eos_id
                ):
                    self._evict(i, req, None)
                elif req._expired(now):
                    self._evict(i, req, DeadlineExceededError(
                        f"deadline passed after {len(req.tokens)} tokens"
                    ))
        if self.recorder is not None:
            # one line per WORKING iteration (idle loops record nothing)
            self.recorder.record(
                "scheduler.iteration", iter=self._sched_iters,
                active=int(active.sum()), emitted=emitted,
                blamed=blamed if blamed else None,
            )
        return True

    # -- blame assignment ----------------------------------------------------

    def _device_step(self, active) -> np.ndarray:
        """One synchronous device advance: the (B,) tokens."""
        return np.asarray(self.stepper.step(active)).reshape(-1)

    def _step_with_blame(self, active):
        """Advance the active slots one token, surviving a poison request:
        when the device step raises, ``_assign_blame`` finds the culprit.
        Every non-blamed slot advances exactly one token (failed calls
        advance nothing — the seams fire before device work, and the
        stepper advances its host state only at collect), so surviving
        streams stay token-identical to their solo decode. Returns
        ``(toks, blamed)``; ``toks`` is None when nothing advanced."""
        try:
            return self._device_step(active), []
        except Exception:  # noqa: BLE001 — device crash boundary
            with self._lock:
                self.counters["step_failures"] += 1
        return self._assign_blame(active)

    def _assign_blame(self, active):
        """The probe cascade after a failed step (shared by both loop
        shapes): retry with the newest admission masked out (established
        streams were stepping fine before it arrived); if that fails too,
        bisect the active set down to the culpable slots. A slot alone in
        the batch is culpable by elimination. Every probe failing blames
        every active slot — the supervisor's restart budget is the
        backstop for a stepper that is dead, not poisoned."""
        idxs = [int(i) for i in np.flatnonzero(active)]
        if len(idxs) == 1:
            return None, idxs
        with self._lock:
            suspect = max(idxs, key=lambda i: self._admit_order[i])
        retry = active.copy()
        retry[suspect] = False
        try:
            with self._lock:
                self.counters["blame_probes"] += 1
            return self._device_step(retry), [suspect]
        except Exception:  # noqa: BLE001
            pass
        # the newest admission alone is not the story: bisect the whole
        # active set (nothing has advanced yet — all probes so far failed)
        got: dict[int, int] = {}
        blamed: list[int] = []

        def probe(group):
            mask = np.zeros_like(active)
            mask[group] = True
            try:
                with self._lock:
                    self.counters["blame_probes"] += 1
                t = self._device_step(mask)
            except Exception:  # noqa: BLE001
                if len(group) == 1:
                    blamed.append(group[0])
                    return
                half = len(group) // 2
                probe(group[:half])
                probe(group[half:])
                return
            for i in group:
                got[i] = int(t[i])

        probe(idxs)
        if not got:
            return None, blamed
        toks = np.zeros(len(active), np.int64)
        for i, tok in got.items():
            toks[i] = tok
        return toks, blamed

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
        request: an injected seam re-raises one instance)."""
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
                req._finish(DeadlineExceededError("deadline expired in queue"))
                continue
            return req
        return None

    def _evict(self, slot_idx, req, error):
        """Free a slot and complete its request. Caller holds the lock."""
        self._slots[slot_idx] = None
        self._drop_prefill(slot_idx)
        self.stepper.release(slot_idx)
        if error is None:
            self.counters["completed"] += 1
        elif isinstance(error, InternalError):
            self.counters["internal_errors"] += 1
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
                self._queue.popleft()._finish(type(proto)(*proto.args))
            self._prefill_left.clear()
            self._prefill_fifo.clear()
            for i, req in enumerate(self._slots):
                if req is not None:
                    self._slots[i] = None
                    self.stepper.release(i)
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
                "preemptions": 0,
                "prompt_len": int(req.prompt.size),
                "max_new_tokens": req.max_new_tokens,
                "tokens_emitted": len(req.tokens),
                "trace_id": (
                    None if req.trace is None else req.trace.trace_id
                ),
            }

        with self._lock:
            out = [row(r, "queued") for r in self._queue]
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
            }

    def stats(self) -> dict:
        out = self.load()
        with self._lock:
            out.update(self.counters)
            out["quarantined_slots"] = len(self._quarantined)
            out["prefill_chunk"] = self.prefill_chunk
            out["draining"] = self._draining
        steps = out["steps"]
        out["mean_batch_occupancy"] = (
            out["occupancy_sum"] / steps if steps else 0.0
        )
        out["overlap"] = {
            "enabled": self.overlap,
            **self.overlap_ledger.snapshot(),
        }
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
