"""Request scheduling for the serving runtime — pure host logic (PyTorch
port of the subset of ``distkeras_tpu.serving.scheduler`` the serving
slice runs).

- ``ContinuousBatcher``: iteration-level batching for autoregressive
  decode over a fixed bank of ``num_slots`` sequence slots. Each
  scheduler step admits queued requests into free slots, spends at most
  ``prefill_chunk`` prompt tokens on slots mid-prefill (oldest admission
  first), advances every decoding slot one token, and evicts finished
  sequences. FIFO queue with bounded-queue backpressure, per-request
  deadlines, drain / hard stop. This is the JAX package's sequential
  loop (``overlap=False``), which is token-identical to its overlapped
  default.
- ``WindowedBatcher``: size/timeout-windowed batching for batch scoring.

Not ported yet: QoS and preemption, speculative windows, streaming,
completion groups (n > 1), prefill export, blame assignment on a failed
device step (here a failed step reaches the engine's crash boundary,
which fails every pending request typed).

The device face is an injected stepper (``engine.DecodeStepper``) with
``num_slots``, ``max_len``, ``begin_admit(slot, prompt, sampling) -> left``,
``prefill_chunk(slot, budget) -> left``, ``release(slot)`` and
``step(active) -> (num_slots,) tokens``.
"""

from __future__ import annotations

import collections
import copy
import threading
import time

import numpy as np


class ServingError(RuntimeError):
    """Base class for request-level serving failures; ``code`` is the
    stable error string."""

    code = "error"


class OverloadedError(ServingError):
    """Admission queue full — retry later (explicit backpressure)."""

    code = "overloaded"


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
    ``ServingError``. ``sampling``: an optional ``SamplingParams``."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 sampling=None):
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
        self.sampling = sampling
        self.tokens: list[int] = []
        self.error: ServingError | None = None
        self._done = threading.Event()

    def _finish(self, error: ServingError | None = None):
        self.error = error
        self._done.set()

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


class ContinuousBatcher:
    """Slot-bank continuous batching around an injected device stepper.
    Thread-safe ``submit``; ``step()`` is driven by exactly one loop (the
    engine thread). Slots go ``queued -> prefilling -> decoding ->
    evicted``; admission is incremental (chunked prefill under the
    per-iteration ``prefill_chunk`` budget; None = whole prompt at once)
    and slots mid-prefill sit out the decode step."""

    def __init__(self, stepper, queue_capacity=64, prefill_chunk=None):
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
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._slots: list[ServeRequest | None] = [None] * stepper.num_slots
        # slot -> prefill positions remaining; membership IS the
        # "prefilling" state, FIFO order = admission order
        self._prefill_left: dict[int, int] = {}
        self._prefill_fifo: collections.deque[int] = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Event()  # signals the engine loop
        self._draining = False
        self._stopped = False
        self.counters = dict.fromkeys(
            (
                "submitted", "rejected_overloaded", "completed",
                "deadline_exceeded", "steps", "occupancy_sum",
                "tokens_generated", "prefill_chunks", "prefill_tokens",
                "prefill_failures", "internal_errors", "sampled_requests",
            ),
            0,
        )

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

    # -- scheduler iteration ------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: admit, spend the prefill budget,
        advance every decoding slot one token, evict finished sequences.
        Returns True when any slot made progress."""
        progressed = self._admit_phase()
        active = self._mask_phase()
        if not active.any():
            return progressed
        toks = np.asarray(self.stepper.step(active)).reshape(-1)
        self._finish_step(active, toks)
        return True

    def _admit_phase(self) -> bool:
        now = time.monotonic()
        admitted = []
        with self._lock:
            free = [i for i, s in enumerate(self._slots) if s is None]
            for i in free:
                req = self._pop_live(now)
                if req is None:
                    break
                self._slots[i] = req
                admitted.append((i, req))
        # device work outside the lock: submit() never blocks on a step
        began = []
        for i, req in admitted:
            try:
                began.append((i, req, self.stepper.begin_admit(
                    i, req.prompt, sampling=req.sampling
                )))
            except Exception as e:  # noqa: BLE001 — admission boundary
                self._fail_admission(i, req, e)
        with self._lock:
            for i, req, left in began:
                if self._slots[i] is req and left > 0:
                    self._prefill_left[i] = left
                    self._prefill_fifo.append(i)
        return self._spend_prefill_budget() or bool(admitted)

    def _mask_phase(self) -> np.ndarray:
        """Deadline-sweep slots mid-prefill (they emit nothing, so the
        post-step check never sees them) and return the decode mask."""
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

    def _finish_step(self, active, toks) -> None:
        """Emission and eviction for one device step: per-token budget,
        EOS and deadline checks."""
        now = time.monotonic()
        with self._lock:
            self.counters["steps"] += 1
            self.counters["occupancy_sum"] += int(active.sum())
            for i, req in enumerate(self._slots):
                if req is None or not active[i]:
                    continue
                tok = int(toks[i])
                req.tokens.append(tok)
                self.counters["tokens_generated"] += 1
                if len(req.tokens) >= req.max_new_tokens or (
                    req.eos_id is not None and tok == req.eos_id
                ):
                    self._evict(i, req, None)
                elif req._expired(now):
                    self._evict(i, req, DeadlineExceededError(
                        f"deadline passed after {len(req.tokens)} tokens"
                    ))

    def _fail_admission(self, i, req, exc):
        """A begin_admit/prefill_chunk crash fails only its own
        (attributable) request, typed, and frees the slot."""
        err = (
            copy.copy(exc)
            if isinstance(exc, ServingError)
            else InternalError(f"prefill failed for this request: {exc!r}")
        )
        with self._lock:
            self.counters["prefill_failures"] += 1
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
            try:
                new_left = self.stepper.prefill_chunk(i, give)
            except Exception as e:  # noqa: BLE001 — admission boundary
                self._fail_admission(i, req, e)
                progressed = True
                continue
            with self._lock:
                if self._slots[i] is not req:
                    continue  # stopped/evicted underneath us
                consumed = left - new_left
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
        ``error`` (default ``EngineStoppedError``), one instance each."""
        proto = error if error is not None else EngineStoppedError(
            "engine stopped"
        )
        with self._lock:
            self._draining = self._stopped = True
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
            return not self._queue and all(s is None for s in self._slots)

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
            out["prefill_chunk"] = self.prefill_chunk
            out["draining"] = self._draining
        steps = out["steps"]
        out["mean_batch_occupancy"] = (
            out["occupancy_sum"] / steps if steps else 0.0
        )
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
