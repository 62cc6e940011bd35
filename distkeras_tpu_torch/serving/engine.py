"""The serving runtime's device face (PyTorch port of the dense-bank parts
of ``distkeras_tpu.serving.engine``).

- ``DecodeStepper``: a bank of ``num_slots`` sequence slots over a causal
  LM. Per slot: one row of the (B, T) token buffer and one row of each
  block's (B, T, H, Dh) K/V caches, plus a host-side length. Admission
  prefills positions ``0..len-2`` (whole prompt, or chunk by chunk under
  the scheduler's budget); ``step(active)`` embeds each slot's last token
  at its OWN position, attends one row against the caches and appends the
  greedy or sampled token — inactive slots freeze. ``step_async`` enqueues
  the same step and hands back a handle whose ``collect()`` is the one
  host sync. Greedy slot output is the solo ``CachedSequenceGenerator``
  decode, token for token. The caches and the token buffer are updated in
  place. The ``stepper.step``/``stepper.prefill`` fault seams fire before
  any work, and a failed call advances nothing.
- ``ServingEngine``: continuous-batching generate plus windowed batch
  scoring (``predict``), driven by a scheduler thread (the overlapped loop
  by default) and watched by a supervisor thread that restarts a dead or
  wedged scheduler with a rebuilt stepper, with the JAX engine's books: a
  metrics ``registry`` (the batcher's counters, occupancy gauges, per-phase
  latency histograms, the overlap ledger), a ``compile_ledger``, a flight
  ``recorder``, a metrics ``history`` ring, optional ``slos``, a
  ``trace_collector`` and a JSONL ``metrics_path``; ``metrics_snapshot``/
  ``timeseries``/``postmortem`` answer the server's verbs. ``from_bundle``
  boots from a quantized serving bundle.

Every LayerNorm on these paths goes through ``LayerNorm.forward``, so with
``attach_fused_layernorm`` the CUDA LayerNorm kernel runs on every
prefill, chunk and decode step (2 per block + the final one). A model
carrying an attention hook (``attach_flash_attention``) is refused by the
cached generator, and the engine then serves ``predict`` only — JAX's
behaviour, kept.

Not ported yet (and absent from the signatures, so passing one fails
loudly): paged pools, prefix cache, speculative decode, QoS (``tenant``
and ``priority`` only label metrics), meshes, disaggregation roles and
their ``prefill``/``resume`` faces and the KV epoch, load shedding, CUDA
graphs around the decode step, bf16 K/V caches (``kv_dtype``).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.kernels.build import (
    add_build_observer,
    remove_build_observer,
)
from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.obs import (
    FAST_WINDOW,
    CompileLedger,
    FlightRecorder,
    MetricsHistory,
    MetricsRegistry,
    SloEvaluator,
    TraceCollector,
    dump_postmortem,
    latest_postmortem,
)
from distkeras_tpu_torch.ops.quantization import qmatmul
from distkeras_tpu_torch.predictors import (
    CachedSequenceGenerator,
    ModelPredictor,
)
from distkeras_tpu_torch.serving import sampling as _sp
from distkeras_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    EngineStoppedError,
    InternalError,
    ServeRequest,
    WindowedBatcher,
)
from distkeras_tpu_torch.utils.device import check_model_device


#: distinct tenant labels on the latency histograms before the rest fold
#: into ``OTHER_TENANTS`` (the JAX package's bound)
MAX_TENANT_LABELS = 64
OTHER_TENANTS = "__other__"


def _bucket_pow2(n: int, cap: int) -> int:
    """Round ``n`` up to a power of two, clamped to ``cap`` — the JAX
    package's program-key bucket, which the compile ledger's keys use. n
    <= 0 stays 0: a one-token prompt has nothing to prefill."""
    if n <= 0:
        return 0
    return min(1 << (n - 1).bit_length(), cap)


class _WarmScope(threading.local):
    """Per-thread "inside a stepper warmup" depth: a kernel build that a
    warmup triggers is recorded with ``trigger="warmup"``."""

    depth = 0


_WARM_SCOPE = _WarmScope()


def in_warmup() -> bool:
    """True on a thread that is inside ``DecodeStepper.warmup`` or
    ``warm_prefill_buckets``."""
    return _WARM_SCOPE.depth > 0


class _InflightStep:
    """One enqueued-but-uncollected decode step: the stepper, the active
    mask it was issued with, and its (B,) token vector. On the card the
    vector is copied into a pinned host buffer behind the step on the
    current stream, and an event is recorded after the copy: ``ready()``
    is ``event.query()`` and ``collect()`` is ``event.synchronize()`` and
    a read of the buffer. On CPU tensors the step already ran, so
    ``ready()`` is True. ``collect()`` also applies the host bookkeeping
    a successful step implies (the ``_lens``/``_spos`` advance), so
    nothing advances until the step is known good. Single consumer,
    collect once (the scheduler thread)."""

    __slots__ = ("_stepper", "active", "_host", "_event")

    def __init__(self, stepper, active, toks):
        self._stepper = stepper
        self.active = active
        self._event = None
        if toks.is_cuda:
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = toks

    def ready(self) -> bool:
        """True when ``collect`` would not block."""
        if self._event is None or self._host is None:
            return True
        return self._event.query()

    def collect(self) -> np.ndarray:
        """The step's tokens (THE host sync point), then the host
        bookkeeping. Whatever the device deferred raises here, and then
        nothing has advanced — the "a failed call advanced nothing"
        contract the blame probes rely on."""
        if self._host is None:
            raise RuntimeError("decode step already collected")
        if self._event is not None:
            self._event.synchronize()
        toks = self._host.numpy().copy()
        self._host = self._event = None
        st, active = self._stepper, self.active
        st._lens[active] = np.minimum(st._lens[active] + 1, st.max_len)
        # the RNG counter mirrors the length discipline: replay through
        # blame probes is this line
        st._spos[active] += 1
        return toks


class DecodeStepper:
    """Dense slot-bank decode over a ``zoo.transformer_lm``-shaped model.

    ``compile_ledger``: an ``obs.CompileLedger`` (the engine's, shared by
    every stepper generation) on which the first call of each program of
    this stepper is recorded as a mint: ``ctx_row``, ``admit[pb]``,
    ``chunk[cb]`` and ``step[plain]``, the JAX package's keys and pow2
    buckets. ``on_compile``: called right before such a first call (the
    engine's watchdog extends its wedge grace through it)."""

    def __init__(self, model, num_slots=8, temperature=0.0, seed=0,
                 top_k=None, top_p=None, device=None, compile_ledger=None):
        # the generator's model-family validation, block parsing and
        # per-stage bodies, reused wholesale
        self._gen = CachedSequenceGenerator(
            model, temperature=temperature, seed=seed, top_k=top_k,
            top_p=top_p, device=device,
        )
        self.device = self._gen.device
        self.model = model
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1; got {num_slots}")
        self.max_len = int(model.input_shape[0])
        b, t = self.num_slots, self.max_len
        self._nh, self._hd = self._gen.num_heads, self._gen.head_dim
        self._ctx = torch.zeros((b, t), dtype=torch.int64, device=self.device)
        self._caches = self._gen.new_caches(b, t)
        self._lens = np.ones((b,), np.int64)  # host mirror; >= 1 always
        self._rows = torch.arange(b, device=self.device)
        self._t_idx = torch.arange(t, device=self.device)
        # per-slot sampler state, passed to every step as data; the
        # emitted-position counter is what the counter RNG keys on
        self.default_sampling = _sp.SamplingParams(
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        self._temps = np.zeros((b,), np.float32)
        self._topk = np.zeros((b,), np.int64)  # 0 = disabled
        self._topp = np.ones((b,), np.float32)  # 1.0 = disabled
        self._seeds = np.zeros((b,), np.int64)
        self._spos = np.zeros((b,), np.int64)
        for i in range(b):
            self.set_sampling(i, None)
        # in-progress admissions: slot -> pending prompt / next position
        self._pending: dict[int, np.ndarray] = {}
        self._prefill_pos: dict[int, int] = {}
        self.ledger = compile_ledger
        self.on_compile = None
        self._warming = False  # True inside warmup(): mints off-path
        self._called: set[str] = set()  # program keys run on this bank

    # -- host inputs and program mints --------------------------------------

    def _to_dev(self, arr) -> torch.Tensor:
        """A host array on the stepper's device. On the card it goes
        through pinned memory with ``non_blocking=True``: a copy from
        pageable memory synchronizes the stream, which would make every
        admission wait for the decode step in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self, key, fn, *args):
        """Run one stepper program. Its first call on this stepper is a
        mint: the ``on_compile`` hook fires before it, and the call is
        timed to the end of its device work and recorded on the ledger."""
        if key in self._called:
            return fn(*args)
        hook = self.on_compile
        if hook is not None:
            hook()
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._called.add(key)
        led = self.ledger
        if led is not None:
            try:
                led.record_mint(key, time.perf_counter() - t0,
                                warming=self._warming)
            except Exception:  # noqa: BLE001 — observability boundary
                pass
        return out

    def _warm(self, fn):
        """Run ``fn`` with this stepper's mints (and, on this thread, any
        kernel build) recorded as ``trigger="warmup"``."""
        self._warming = True
        _WARM_SCOPE.depth += 1
        try:
            fn()
        finally:
            _WARM_SCOPE.depth -= 1
            self._warming = False

    # -- per-slot sampler state ---------------------------------------------

    def set_sampling(self, slot, params):
        """Bind ``params`` (None = the engine default) to ``slot`` and
        reset its emitted-position counter (admission is the replay
        boundary)."""
        p = params if params is not None else self.default_sampling
        self._temps[slot] = p.temperature
        self._topk[slot] = 0 if p.top_k is None else p.top_k
        self._topp[slot] = 1.0 if p.top_p is None else p.top_p
        self._seeds[slot] = p.seed
        self._spos[slot] = 0

    # -- admission ----------------------------------------------------------

    def admit(self, slot: int, prompt, sampling=None) -> None:
        """One-shot admission: ``begin_admit`` plus the whole prefill."""
        left = self.begin_admit(slot, prompt, sampling=sampling)
        while left > 0:
            left = self.prefill_chunk(slot, left)

    @torch.no_grad()
    def begin_admit(self, slot: int, prompt, sampling=None) -> int:
        """Start admitting ``prompt`` into ``slot``: bind its sampling,
        write its context row, and return the prefill positions still to
        compute (0 = ready to decode). The ``stepper.prefill`` seam fires
        first, before anything changes."""
        faults.fire("stepper.prefill", slot=slot)
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = prompt.size
        if not 1 <= plen <= self.max_len:
            raise ValueError(
                f"prompt length {plen} outside [1, {self.max_len}]"
            )
        self.set_sampling(slot, sampling)
        row = np.zeros((self.max_len,), np.int64)
        row[:plen] = prompt
        self._run("ctx_row", self._write_row, slot, row)
        self._pending[slot] = prompt
        self._prefill_pos[slot] = 0
        self._lens[slot] = plen
        target = plen - 1  # prefill covers positions 0..plen-2
        if target <= 0:
            self._finish_admit(slot)
            return 0
        return target

    def _write_row(self, slot, row):
        self._ctx[slot] = self._to_dev(row)

    @torch.no_grad()
    def prefill_chunk(self, slot: int, budget: int) -> int:
        """Prefill up to ``budget`` more positions of ``slot``'s prompt;
        returns positions remaining (0 = ready to decode). A chunk that
        covers the whole prefix from 0 runs the full-prefill body (dense
        causal attention over the prefix, key ``admit[pb]``); a mid-prompt
        chunk runs the generator's ``_stage_chunk`` against the slot's
        cache rows (key ``chunk[cb]``). As in the JAX package, a chunk
        whose pow2 bucket would run past the cache shrinks to the largest
        pow2 that fits. The ``stepper.prefill`` seam fires first."""
        faults.fire("stepper.prefill", slot=slot)
        prompt = self._pending.get(slot)
        if prompt is None:
            return 0  # released underneath us
        target = prompt.size - 1
        pos = self._prefill_pos[slot]
        n = min(int(budget), target - pos)
        if n > 0:
            if pos == 0 and n == target:
                pb = _bucket_pow2(target, self.max_len - 1)
                self._run(f"admit[{pb}]", self._prefill_full, slot, prompt)
            else:
                cb = _bucket_pow2(n, self.max_len)
                room = self.max_len - pos
                if cb > room:
                    cb = 1 << (room.bit_length() - 1)  # largest pow2 <= room
                    n = min(n, cb)
                self._run(f"chunk[{cb}]", self._prefill_mid, slot, prompt,
                          pos, n)
            pos += n
            self._prefill_pos[slot] = pos
        if pos >= target:
            self._finish_admit(slot)
            return 0
        return target - pos

    def _slot_caches(self, slot):
        """(1, T, H, Dh) views of one slot's cache rows: writes through
        them land in the bank."""
        return [
            (ck[slot : slot + 1], cv[slot : slot + 1])
            for ck, cv in self._caches
        ]

    def _prefill_full(self, slot, prompt):
        pp = prompt.size - 1
        toks = self._to_dev(prompt[None, :pp])
        x = self._gen.embed(toks, torch.arange(pp, device=self.device))
        self._gen._prefill(self._slot_caches(slot), x)

    def _prefill_mid(self, slot, prompt, pos, n):
        toks = self._to_dev(prompt[None, pos : pos + n])
        positions = torch.arange(pos, pos + n, device=self.device)
        x = self._gen.embed(toks, positions)
        qmask = self._t_idx[None, :] <= positions[:, None]  # (n, T)
        for blk, (ck, cv) in zip(self._gen._blocks, self._slot_caches(slot)):
            x = self._gen._stage_chunk(blk, x, ck, cv, pos, qmask)

    def _finish_admit(self, slot):
        self._pending.pop(slot, None)
        self._prefill_pos.pop(slot, None)

    def release(self, slot: int) -> None:
        self._lens[slot] = 1  # keep pos = lens-1 in range while parked
        self._pending.pop(slot, None)
        self._prefill_pos.pop(slot, None)
        self.set_sampling(slot, None)

    def warmup(self) -> None:
        """One all-inactive step off the serving path: builds the kernels
        the step runs (their first use) and pays the step's first-call
        costs without touching the slot bank — every write is masked and
        no host bookkeeping advances. It does not go through ``step``, so
        it never fires an armed ``stepper.step`` seam. Mints record
        ``trigger="warmup"``; declaring the warm set complete
        (``compile_ledger.mark_warmed()``) is the harness's call."""
        active = np.zeros(self.num_slots, bool)
        self._warm(lambda: self._run(
            "step[plain]", self._step_dev, active, self._lens.copy(),
        ))

    def warm_prefill_buckets(self) -> None:
        """Run every pow2 ``chunk[cb]`` and ``admit[pb]`` bucket (and
        ``ctx_row``) once off the serving path, through slot 0's rows.
        Only safe on an IDLE bank: slot 0's cache rows and context row are
        overwritten by the next admission before anything attends them."""

        def warm():
            zeros = np.zeros(self.max_len, np.int64)
            self._run("ctx_row", self._write_row, 0, zeros)
            cb = 1
            while True:
                n = min(cb, self.max_len)
                self._run(f"chunk[{n}]", self._prefill_mid, 0, zeros, 0, n)
                if cb >= self.max_len:
                    break
                cb <<= 1
            pb, buckets = 1, set()
            while True:
                buckets.add(min(pb, self.max_len - 1))
                if pb >= self.max_len - 1:
                    break
                pb <<= 1
            for pb in sorted(b for b in buckets if b >= 1):
                self._run(f"admit[{pb}]", self._prefill_full, 0,
                          zeros[: pb + 1])

        self._warm(warm)

    # -- decode -------------------------------------------------------------

    def step(self, active) -> np.ndarray:
        """Advance every active slot one token; returns the (B,) tokens
        appended (entries for inactive slots are meaningless). Dispatch
        plus immediate collect of :meth:`step_async`, so the sequential
        loop and the overlapped one run the same code in the same order."""
        return self.step_async(active).collect()

    def step_async(self, active) -> _InflightStep:
        """Enqueue one decode step without waiting for it. The host inputs
        are snapshot (``self._lens.copy()`` and the sampler arrays) and
        copied through pinned memory, the step is enqueued on the CURRENT
        stream, and the token vector rides the returned handle; the
        ``_lens``/``_spos`` advance waits for its ``collect()``.

        Every stepper call stays on the current stream, and that is what
        keeps the overlapped loop correct: the step rewrites every slot's
        cache rows and context entry at the slot's own position (inactive
        slots with their old values), so an admission or prefill of
        another slot enqueued while the step is in flight is right only
        because the stream orders it behind the step.

        The ``stepper.step`` seam fires first, before any device work or
        host bookkeeping, so a failed call leaves the bank as it was."""
        active = np.asarray(active, bool)
        faults.fire("stepper.step", active=active)
        toks = self._run("step[plain]", self._step_dev, active,
                         self._lens.copy())
        return _InflightStep(self, active, toks)

    @torch.no_grad()
    def _step_dev(self, active, lens) -> torch.Tensor:
        """The decode step over host snapshots ``active``/``lens``;
        returns the (B,) token vector on the device."""
        gen, dev = self._gen, self.device
        b, t = self.num_slots, self.max_len
        nh, hd = self._nh, self._hd
        rows = self._rows
        sampled = bool((self._temps > 0.0).any())
        ints = self._to_dev(np.stack([
            active.astype(np.int64), lens, self._topk, self._seeds,
            self._spos,
        ]))
        act = ints[0].bool()
        pos = torch.clamp(ints[1] - 1, 0, t - 1)  # (B,) per-slot position
        x = gen.embed(self._ctx[rows, pos], pos)
        keep = act[:, None, None]
        t_mask = (self._t_idx[None, :] <= pos[:, None])[:, None, :]  # (B,1,T)
        for blk, (ck, cv) in zip(gen._blocks, self._caches):
            mh = blk.mhsa
            h_ = blk.ln1(x)
            q = qmatmul(h_, mh.wq).reshape(b, nh, hd)
            k_new = qmatmul(h_, mh.wk).reshape(b, nh, hd)
            v_new = qmatmul(h_, mh.wv).reshape(b, nh, hd)
            ck[rows, pos] = torch.where(keep, k_new, ck[rows, pos])
            cv[rows, pos] = torch.where(keep, v_new, cv[rows, pos])
            scores = torch.einsum("bhd,bthd->bht", q, ck) / math.sqrt(hd)
            scores = scores.masked_fill(~t_mask, float("-inf"))
            w = torch.softmax(scores, dim=-1)
            o = torch.einsum("bht,bthd->bhd", w, cv)
            o = qmatmul(o.reshape(b, nh * hd), mh.wo)
            if mh.use_bias:
                o = o + mh.bo
            x = x + o
            x = x + blk.fc2(blk.fc1(blk.ln2(x)))
        logit = gen._head(gen._final_ln(x))  # (B, V)
        if sampled:
            floats = self._to_dev(np.stack([self._temps, self._topp]))
            nxt = _sp.sample_tokens(
                logit, floats[0], ints[2], floats[1], ints[3], ints[4],
                filtered=bool((self._topk > 0).any()
                              or (self._topp < 1.0).any()),
            )
        else:
            nxt = torch.argmax(logit, dim=-1)
        wpos = torch.clamp(pos + 1, 0, t - 1)
        write = act & (pos + 1 <= t - 1)
        self._ctx[rows, wpos] = torch.where(write, nxt, self._ctx[rows, wpos])
        return nxt


class ServingEngine:
    """The in-process serving runtime: continuous-batching decode plus
    windowed batch scoring over one model, driven by a dedicated scheduler
    thread and watched by a supervisor thread.

    ``generate`` is synchronous (submit + wait); ``submit`` returns the
    ``ServeRequest`` handle. ``stop(drain=True)`` refuses new work and
    completes everything already admitted or queued before returning.
    ``prefill_chunk``: per-iteration prefill token budget — "auto" picks
    ``max(16, seq_len // 8)``, an int sets it, None disables chunking.
    ``device=None`` means CUDA; the model must already live there.

    Self-healing knobs, with the JAX engine's defaults and meanings:
    ``quarantine_steps`` (iterations a blamed slot sits out),
    ``overlap`` (True: the overlapped loop; False: dispatch and wait),
    ``watchdog_interval`` (seconds without a scheduler heartbeat before
    the supervisor declares it wedged, fails its in-flight requests typed
    and restarts it with a rebuilt stepper), ``watchdog_grace`` (seconds
    after each scheduler launch, and after each program mint or kernel
    build, during which wedge detection stays disarmed; default
    ``max(2, watchdog_interval)``; dead-thread detection is never
    graced), ``max_restarts`` (the lifetime restart budget: exhausted =
    the engine stays ``degraded`` and ``submit`` raises ``InternalError``)
    and ``restart_backoff`` (the base of the full-jitter delay between
    restarts, ``networking.RetryPolicy``'s schedule).

    The watchdog covers HOST wedges: a stuck lock, a pathological sleep,
    the fault seams' ``delay``. A scheduler hung inside a CUDA call is not
    cured by abandoning its thread — the device and its stream are shared
    with the next generation — so that case ends in ``degraded`` once the
    budget is spent, and nothing here tries more.

    Books, as in the JAX engine at its defaults: a flight recorder of
    events (armed fault-seam firings, blame, quarantine, watchdog trips,
    restarts, program mints), a span ring, a metrics history a snapshot a
    second, ten minutes deep, for the ``timeseries`` verb (``history=
    False`` turns it off), and a ``compile_ledger`` shared by every
    stepper generation. ``postmortem_dir`` is where a trip's bundle is
    written (None keeps it in memory for the ``postmortem`` verb);
    ``slos`` (a list of ``obs.SloSpec``) grade this registry, their
    verdicts ride ``health``; ``metrics_path`` adds a JSONL sink
    (``serving_submit``/``serving_complete`` events and drained trace
    spans).
    """

    def __init__(self, model, num_slots=8, queue_capacity=64,
                 temperature=0.0, seed=0, top_k=None, top_p=None,
                 predict_batch=64, predict_window=0.005,
                 prefill_chunk="auto", quarantine_steps=64,
                 watchdog_interval=10.0, watchdog_grace=None,
                 max_restarts=3, restart_backoff=0.05, metrics_path=None,
                 postmortem_dir=None, slos=None, history=True,
                 overlap=True, device=None):
        self.model = model
        self.device = check_model_device(model, device)
        # the engine-owned books (per engine, so in-process fleets keep
        # per-replica registries and span rings)
        self.registry = MetricsRegistry()
        self.trace_collector = TraceCollector(on_drop=self._on_trace_drop)
        self.registry.gauge(
            "serving_trace_collector_dropped",
            fn=lambda: self.trace_collector.dropped_total,
        )
        self.recorder = FlightRecorder()
        self.recorder.register_gauges(self.registry, "serving")
        # the compile ledger outlives stepper generations: a rebuilt
        # stepper's first calls are attributed as rewarms
        self.compile_ledger = CompileLedger(
            registry=self.registry, recorder=self.recorder,
            prefix="serving", inflight_fn=self._inflight_estimate,
        )
        self.history = (
            MetricsHistory(self.metrics_snapshot) if history else None
        )
        self.postmortem_dir = postmortem_dir
        self.last_postmortem = None
        self.last_postmortem_path = None
        self._stepper = None
        self._decode_err = None
        # everything a supervisor restart needs to rebuild the device face
        self._stepper_cfg = dict(
            num_slots=num_slots, temperature=temperature, seed=seed,
            top_k=top_k, top_p=top_p, device=self.device,
            compile_ledger=self.compile_ledger,
        )
        try:
            self._stepper = DecodeStepper(model, **self._stepper_cfg)
            self._stepper.on_compile = self._extend_grace
        except ValueError as e:
            # non-LM models (and hooked ones) still serve predict;
            # generate replies with this error
            self._decode_err = e
        if self._stepper is not None and prefill_chunk == "auto":
            prefill_chunk = max(16, self._stepper.max_len // 8)
        self._batcher_cfg = dict(
            queue_capacity=queue_capacity, prefill_chunk=prefill_chunk,
            quarantine_steps=quarantine_steps, registry=self.registry,
            recorder=self.recorder, overlap=overlap,
        )
        self.batcher = (
            None
            if self._stepper is None
            else ContinuousBatcher(self._stepper, **self._batcher_cfg)
        )
        self._predictor = ModelPredictor(
            model, batch_size=int(predict_batch), device=self.device
        )
        self._predict_batcher = WindowedBatcher(
            self._run_predict_batch, max_batch=int(predict_batch),
            max_wait=float(predict_window),
        )
        self.metrics = None
        if metrics_path is not None:
            from distkeras_tpu_torch.utils.profiling import MetricsLogger

            self.metrics = MetricsLogger(metrics_path)
        self._thread = None
        self._stop_evt = threading.Event()
        self._started = False
        # supervisor state: the scheduler loop stamps _heartbeat every
        # iteration; the supervisor watches it and the thread's liveness
        self.watchdog_interval = float(watchdog_interval)
        self.watchdog_grace = (
            max(2.0, self.watchdog_interval)
            if watchdog_grace is None
            else float(watchdog_grace)
        )
        self._grace_until = 0.0
        self.max_restarts = int(max_restarts)
        self._restart_delays = RetryPolicy(
            max_attempts=self.max_restarts + 1,
            base_delay=float(restart_backoff), max_delay=2.0, seed=seed,
        )
        self._supervisor = None
        self._crash_evt = threading.Event()  # crash boundary -> supervisor
        self._heartbeat = time.monotonic()
        self._restarts = 0
        self._watchdog_trips = 0
        self._failed = False  # permanently degraded (see _failed_reason)
        self._failed_reason = None
        self._last_crash = None
        #: wall seconds of the last restart: backoff, rebuild, warmup
        self.last_restart = None
        reg = self.registry
        reg.gauge("serving_engine_restarts", fn=lambda: self._restarts)
        reg.gauge("serving_engine_watchdog_trips",
                  fn=lambda: self._watchdog_trips)
        reg.gauge("serving_engine_degraded", fn=lambda: self._failed)
        reg.gauge(
            "serving_engine_heartbeat_age_seconds",
            fn=lambda: (
                time.monotonic() - self._heartbeat
                if self._started and self.batcher is not None else None
            ),
        )
        # per-phase request latency histograms, observed in ``wait``
        self._lat_hists = {
            phase: reg.histogram(f"serving_request_{phase}_seconds")
            for phase in ("queue_wait", "prefill", "decode", "ttft", "total")
        }
        self._tenant_lat_hists: dict[tuple, object] = {}
        self._tenants_seen: set[str] = set()
        self.slo = None
        if slos:
            self.slo = SloEvaluator(
                slos, self.metrics_snapshot, registry=reg,
                recorder=self.recorder, prefix="serving",
            )

    @classmethod
    def from_bundle(cls, path: str, **kwargs) -> "ServingEngine":
        """Boot from a quantized serving bundle on disk
        (``utils.serialization.load_serving_bundle`` validates structure,
        shapes and dtypes first); the model is loaded onto ``device``."""
        from distkeras_tpu_torch.utils.serialization import (
            load_serving_bundle,
        )

        model = load_serving_bundle(path, device=kwargs.get("device"))
        return cls(model, **kwargs)

    def _on_trace_drop(self):
        self.recorder.record(
            "trace.drops", capacity=self.trace_collector.capacity
        )

    def _inflight_estimate(self):
        """Requests queued or slotted, for the compile ledger's per-mint
        stamp (unlocked reads: a torn read is fine for a blast radius)."""
        batcher = self.batcher
        if batcher is None:
            return None
        return len(batcher._queue) + sum(
            s is not None for s in batcher._slots
        )

    def start(self) -> "ServingEngine":
        if self._started:
            return self
        self._started = True
        faults.add_observer(self.recorder.fault_observer)
        add_build_observer(self._on_build)
        self._predict_batcher.start()
        if self.batcher is not None:
            self._launch_scheduler(self.batcher)
            self._supervisor = threading.Thread(
                target=self._supervise, name="serving-supervisor",
                daemon=True,
            )
            self._supervisor.start()
        return self

    def _on_build(self, names, seconds):
        """Kernel build observer: a first-use ``nvcc`` build stalls the
        thread that needs the kernel, so the wedge detector's grace is
        pushed out before it starts, and the finished build is a
        ``build[<kernels>]`` mint on the compile ledger."""
        self._extend_grace()
        if seconds is not None:
            self.compile_ledger.record_mint(
                f"build[{','.join(names)}]", seconds, warming=in_warmup()
            )

    def _extend_grace(self):
        """A program is about to mint (stepper ``on_compile``, a kernel
        build, each scheduler launch): push the wedge detector's grace
        window out so the mint is never read as a wedged scheduler.
        Dead-thread detection is unaffected."""
        self._grace_until = max(
            self._grace_until, time.monotonic() + self.watchdog_grace
        )

    def _launch_scheduler(self, batcher):
        self._heartbeat = time.monotonic()
        self._grace_until = self._heartbeat + self.watchdog_grace
        self._thread = threading.Thread(
            target=self._loop, args=(batcher,), name="serving-engine",
            daemon=True,
        )
        self._thread.start()

    def _loop(self, batcher):
        """The scheduler thread: admit/step/evict until stopped; in drain
        mode, exit once everything in flight completed. A crash that
        escapes the batcher's blame machinery wakes the supervisor, which
        dumps the post-mortem while the in-flight table still holds the
        crash-time state, fails every pending request TYPED
        (``InternalError``) and restarts the loop with a rebuilt stepper.
        ``batcher`` is bound at thread start: a superseded
        (restart-replaced) loop notices and exits instead of driving the
        new generation's state."""
        try:
            while True:
                if self.batcher is not batcher:
                    return  # superseded by a supervisor restart
                self._heartbeat = time.monotonic()
                faults.fire("scheduler.loop", busy=not batcher.idle)
                progressed = batcher.step()
                if self._stop_evt.is_set() and batcher.idle:
                    return
                if not progressed:
                    if self._stop_evt.is_set():
                        return
                    batcher.wait_for_work()
        except Exception as e:  # noqa: BLE001 — scheduler crash boundary
            self._last_crash = repr(e)
            self.recorder.record("engine.crash", error=repr(e)[:200])
            if self.metrics is not None:
                self.metrics.log(event="serving_engine_crash", error=repr(e))
            self._crash_evt.set()  # wake the supervisor immediately

    # -- supervisor ---------------------------------------------------------

    def _supervise(self):
        """Watchdog: a dead scheduler thread (crash boundary fired) or a
        wedged one (no heartbeat for ``watchdog_interval`` outside the
        grace window) trips a restart. A wedged thread cannot be killed:
        it is ABANDONED — its batcher is stopped (in-flight requests fail
        typed) and replaced, and the zombie exits at its next iteration
        through the superseded check. The history ring's cadence rides
        this poll loop, so the time series keeps ticking through a
        wedge."""
        poll = max(0.01, min(0.05, self.watchdog_interval / 4))
        while not self._stop_evt.is_set():
            self._crash_evt.wait(timeout=poll)
            self._crash_evt.clear()
            if self._stop_evt.is_set():
                return
            if self.history is not None:
                self.history.maybe_snap()  # cadence-guarded
            th = self._thread
            if th is None or self._failed:
                continue
            now = time.monotonic()
            dead = not th.is_alive()
            wedged = (
                now - self._heartbeat > self.watchdog_interval
                and now > self._grace_until  # mints are not wedges
            )
            if not dead and not wedged:
                continue
            self._watchdog_trips += 1
            self.recorder.record(
                "engine.watchdog_trip", dead=dead, wedged=wedged,
                restarts=self._restarts,
                heartbeat_age=round(now - self._heartbeat, 3),
                last_crash=self._last_crash,
            )
            if self.metrics is not None:
                self.metrics.log(event="serving_watchdog_trip", dead=dead,
                                 wedged=wedged, restarts=self._restarts)
            # dump BEFORE the restart tears the old batcher down: the
            # bundle's in-flight table is the state at trip time
            self._safe_dump("watchdog_trip", {
                "dead": dead, "wedged": wedged,
                "last_crash": self._last_crash,
            })
            self._restart(dead)

    def _degrade(self, reason):
        self._failed = True
        self._failed_reason = reason
        self.recorder.record("engine.degraded", reason=reason)
        self._safe_dump("degraded", {"reason": reason})

    def _restart(self, dead):
        """Fail everything the old scheduler generation held (typed),
        then rebuild the stepper, warm it HERE on the supervisor thread
        (so the first live iteration serves rather than mints), and swap
        it in under the restart budget with full-jitter backoff. An
        exhausted budget degrades the engine for good (its bundle dumped
        before the requests fail)."""
        t0 = time.monotonic()
        exhausted = self._restarts >= self.max_restarts
        if exhausted:
            self._degrade(
                f"scheduler restart budget exhausted "
                f"({self._restarts}/{self.max_restarts})"
            )
        self.batcher.stop(error=InternalError(
            "scheduler " + ("crashed" if dead else "wedged")
            + "; in-flight request aborted by the supervisor"
        ))
        if exhausted:
            if self.metrics is not None:
                self.metrics.log(event="serving_restart_budget_exhausted",
                                 restarts=self._restarts)
            return
        if self._stop_evt.wait(self._restart_delays.delay(self._restarts)):
            return  # shutdown arrived during the backoff
        try:
            stepper = DecodeStepper(self.model, **self._stepper_cfg)
            stepper.on_compile = self._extend_grace
            t_warm = time.monotonic()
            stepper.warmup()
            warm_s = time.monotonic() - t_warm
        except Exception as e:  # noqa: BLE001 — rebuild is last-resort
            self._last_crash = repr(e)
            self._degrade(f"stepper rebuild failed: {e!r}")
            return
        # published before the restart count, which readers poll
        self.last_restart = {"seconds": time.monotonic() - t0,
                             "warmup_seconds": warm_s}
        self._restarts += 1
        self._stepper = stepper
        batcher = ContinuousBatcher(stepper, **self._batcher_cfg)
        self.batcher = batcher
        self._launch_scheduler(batcher)
        self.recorder.record("engine.restarted", restarts=self._restarts)
        if self.metrics is not None:
            self.metrics.log(event="serving_engine_restarted",
                             restarts=self._restarts)

    def stop(self, drain=True):
        """Shutdown. ``drain=True``: stop admissions, finish queued and
        in-flight requests, then stop; ``drain=False``: fail them."""
        self._stop_evt.set()
        self._crash_evt.set()  # wake the supervisor so it can exit
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
            self._supervisor = None
        batcher = self.batcher
        if batcher is not None:
            if drain:
                batcher.drain()
            else:
                batcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if batcher is not None and (not drain or not batcher.idle):
            # fail anything the loop left behind (hard stop, or a drain
            # whose scheduler thread was already dead)
            batcher.stop()
        self._predict_batcher.close()
        remove_build_observer(self._on_build)
        faults.remove_observer(self.recorder.fault_observer)
        self.drain_traces()  # the tail of the span ring is not lost

    # -- generate -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None, deadline=None,
               trace=None, sampling=None, tenant=None, priority=0,
               stream=False) -> ServeRequest:
        """Queue one generate request; ``sampling`` is a
        ``SamplingParams`` or its wire dict (None = the engine default).
        ``trace``: an ``obs.TraceContext`` (the scheduler then keeps the
        request's event ledger). ``tenant``/``priority`` label metrics
        only. ``stream``: the scheduler pushes each iteration's tokens
        into the request's chunk FIFO (``req.next_chunk``)."""
        batcher = self.batcher
        if batcher is None:
            raise EngineStoppedError(
                f"model does not support generate: {self._decode_err}"
            )
        if not self._started:
            raise EngineStoppedError("engine not started")
        if self._failed:
            raise InternalError(f"engine is degraded: {self._failed_reason}")
        req = ServeRequest(
            prompt, max_new_tokens, eos_id=eos_id, deadline=deadline,
            trace=trace, sampling=_sp.SamplingParams.from_wire(sampling),
            tenant=tenant, priority=priority, stream=stream,
        )
        try:
            return batcher.submit(req)
        finally:
            if self.metrics is not None:
                load = batcher.load()
                self.metrics.log(
                    event="serving_submit", request_id=req.id,
                    prompt_len=int(req.prompt.size),
                    max_new_tokens=req.max_new_tokens,
                    queue_depth=load["queue_depth"],
                    active_slots=load["active_slots"],
                )

    def generate(self, prompt, max_new_tokens, eos_id=None, deadline=None,
                 timeout=None, trace=None, sampling=None, tenant=None,
                 priority=0) -> np.ndarray:
        """The full sequence (prompt + generated, eos-trimmed)."""
        req = self.submit(prompt, max_new_tokens, eos_id=eos_id,
                          deadline=deadline, trace=trace, sampling=sampling,
                          tenant=tenant, priority=priority)
        return self.wait(req, timeout)

    def wait(self, req: ServeRequest, timeout=None) -> np.ndarray:
        """Block on a submitted request, then run its completion
        bookkeeping: the latency histograms (tenant-labeled twins of
        ``ttft``/``total`` for a named tenant), the ``serving_complete``
        JSONL record and, for a traced request, the span drain."""
        try:
            return req.result(timeout)
        finally:
            if req.done:
                self._complete(req)

    def _complete(self, req):
        lat = req.latency()
        for phase, hist in self._lat_hists.items():
            if lat[phase] is not None:
                hist.observe(lat[phase])
        if req.tenant != "default":
            # the tenant is a client-chosen wire string: past
            # MAX_TENANT_LABELS distinct names the rest share one label
            tenant = req.tenant
            if tenant not in self._tenants_seen:
                if len(self._tenants_seen) < MAX_TENANT_LABELS:
                    self._tenants_seen.add(tenant)
                else:
                    tenant = OTHER_TENANTS
            for phase in ("ttft", "total"):
                if lat[phase] is None:
                    continue
                key = (tenant, phase)
                h = self._tenant_lat_hists.get(key)
                if h is None:
                    h = self._tenant_lat_hists[key] = self.registry.histogram(
                        f"serving_request_{phase}_seconds",
                        labels={"tenant": tenant},
                    )
                h.observe(lat[phase])
        if self.metrics is not None:
            self.metrics.log(
                event="serving_complete", request_id=req.id,
                tokens=len(req.tokens),
                error=None if req.error is None else req.error.code,
                **{k: v for k, v in lat.items() if v is not None},
            )
            if req.trace is not None:
                self.drain_traces()

    # -- predict ------------------------------------------------------------

    def _run_predict_batch(self, x):
        return self._predictor.predict(Dataset({"features": x}))["prediction"]

    def predict(self, x, timeout=None) -> np.ndarray:
        """Batch scoring: rows accumulate into the current window and run
        as one ``ModelPredictor`` forward."""
        if not self._started:
            raise EngineStoppedError("engine not started")
        return self._predict_batcher.submit(x).result(timeout)

    # -- observability ------------------------------------------------------

    def drain_traces(self) -> int:
        """Flush the trace collector into the ``MetricsLogger`` (one
        ``trace_span`` line per span); no-op without ``metrics_path``."""
        if self.metrics is None:
            return 0
        return self.trace_collector.drain_to(self.metrics)

    def metrics_snapshot(self) -> list:
        """JSON-able samples of every registered metric — the payload of
        the server's ``metrics`` verb."""
        return self.registry.snapshot()

    def timeseries(self, window=None, names=None, points=30) -> dict:
        """The ``timeseries`` verb's payload: windowed digests of every
        series plus the burn-rate verdict when SLOs are configured.
        Raises ``ValueError`` with ``history=False``."""
        if self.history is None:
            raise ValueError(
                "metrics history disabled (ServingEngine(history="
                "False)); the timeseries verb has nothing to serve"
            )
        self.history.maybe_snap()  # a query is its own cadence
        out = self.history.digest(
            window=FAST_WINDOW if window is None else float(window),
            names=names, points=int(points),
        )
        out["ok"] = True
        out["burn"] = self.burn_verdict()
        return out

    def burn_verdict(self) -> dict | None:
        """Multi-window burn-rate verdict over the SLO specs (None
        without both ``slos`` and ``history``)."""
        if self.history is None or self.slo is None:
            return None
        self.history.maybe_snap()
        return self.history.burn(self.slo.specs)

    def _safe_dump(self, reason, detail):
        try:
            self.dump_postmortem(reason, detail=detail)
        except Exception as e:  # noqa: BLE001 — observability boundary
            if self.metrics is not None:
                self.metrics.log(event="postmortem_dump_failed",
                                 reason=reason, error=repr(e))

    def dump_postmortem(self, reason: str, detail=None):
        """Dump this engine's post-mortem bundle (the ``obs`` schema):
        recorder ring, metrics, the in-flight request table with trace
        ids and their spans, the config, armed fault seams, the SLO
        verdict. Kept for the ``postmortem`` verb; written to
        ``postmortem_dir`` when set. Returns ``(bundle, path)``."""
        batcher = self.batcher
        in_flight = [] if batcher is None else batcher.inflight_snapshot()
        trace_spans = []
        for row in in_flight:
            if row["trace_id"] is not None:
                trace_spans.extend(
                    self.trace_collector.spans_for(row["trace_id"])
                )
        cfg = dict(self._batcher_cfg)
        cfg.pop("registry", None)
        cfg.pop("recorder", None)
        cfg.update(
            model=type(self.model).__name__,
            num_slots=(
                None if self._stepper is None else self._stepper.num_slots
            ),
            device=str(self.device),
            watchdog_interval=self.watchdog_interval,
            watchdog_grace=self.watchdog_grace,
            max_restarts=self.max_restarts,
        )
        bundle, path = dump_postmortem(
            self.postmortem_dir, "serving_engine", reason,
            recorder=self.recorder, metrics=self.metrics_snapshot(),
            in_flight=in_flight, config=cfg,
            trace_spans=trace_spans,
            slo=None if self.slo is None else self.slo.evaluate(),
            detail=detail,
        )
        self.last_postmortem = bundle
        self.last_postmortem_path = path
        if self.metrics is not None:
            self.metrics.log(event="postmortem_dumped", reason=reason,
                             path=path)
        return bundle, path

    def postmortem(self):
        """Latest bundle for the ``postmortem`` verb: the in-memory last
        dump, else the newest file in ``postmortem_dir``;
        ``(bundle_or_None, path_or_None)``."""
        if self.last_postmortem is not None:
            return self.last_postmortem, self.last_postmortem_path
        if self.postmortem_dir is not None:
            return latest_postmortem(self.postmortem_dir)
        return None, None

    def health(self) -> dict:
        """Liveness summary: ``status`` is ``serving`` (scheduler
        heartbeating), ``degraded`` (scheduler dead or restarting, or the
        restart budget exhausted) or ``draining``; plus occupancy, the
        heartbeat age, the quarantined-slot count, the restart ledger,
        the overlap ledger and, with SLOs, their verdict."""
        batcher = self.batcher
        if self._stop_evt.is_set():
            status = "draining"
        elif batcher is None:
            status = "serving"  # predict-only engines have no scheduler
        else:
            th = self._thread
            now = time.monotonic()
            healthy = (
                self._started
                and not self._failed
                and th is not None
                and th.is_alive()
                and (
                    now - self._heartbeat <= self.watchdog_interval
                    # a stale heartbeat inside the mint/launch grace is
                    # the supervisor's definition of fine
                    or now <= self._grace_until
                )
            )
            status = "serving" if healthy else "degraded"
        out = {
            "status": status,
            "device": str(self.device),
            "generate_enabled": batcher is not None,
            "restarts": self._restarts,
            "max_restarts": self.max_restarts,
            "restart_budget_exhausted": self._failed,
            "watchdog_trips": self._watchdog_trips,
            "quarantined_slots": (
                0 if batcher is None else len(batcher._quarantined)
            ),
        }
        if batcher is not None:
            out.update(batcher.load())
            out["overlap"] = {
                "enabled": batcher.overlap,
                **batcher.overlap_ledger.snapshot(),
            }
        out["heartbeat_age"] = (
            None if batcher is None or not self._started
            else time.monotonic() - self._heartbeat
        )
        if self.slo is not None:
            verdict = self.slo.maybe_evaluate()
            out["slo"] = verdict["slo"]
            out["slo_violations"] = verdict["violations"]
            if self.history is not None:
                b = self.burn_verdict()
                out["burn"] = b["burn"]
                out["burn_violations"] = b["violations"]
        if self._last_crash is not None:
            out["last_crash"] = self._last_crash
        return out

    def stats(self) -> dict:
        out = {
            "model": type(self.model).__name__,
            "num_params": int(self.model.num_params()),
            "generate_enabled": self.batcher is not None,
        }
        if self.batcher is not None:
            out.update(self.batcher.stats())
        out["restarts"] = self._restarts
        out["watchdog_trips"] = self._watchdog_trips
        out["status"] = self.health()["status"]
        # every runtime mint with its trigger, seconds and the storm count
        out["compiles"] = self.compile_ledger.snapshot()
        return out
