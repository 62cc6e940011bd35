"""The serving runtime's device face (PyTorch port of the dense-bank parts
of ``distkeras_tpu.serving.engine``).

- ``DecodeStepper``: a bank of ``num_slots`` sequence slots over a causal
  LM. Per slot: one row of the (B, T) token buffer and one row of each
  block's (B, T, H, Dh) K/V caches, plus a host-side length. Admission
  prefills positions ``0..len-2`` (whole prompt, or chunk by chunk under
  the scheduler's budget); ``step(active)`` embeds each slot's last token
  at its OWN position, attends one row against the caches and appends the
  greedy or sampled token — inactive slots freeze. Greedy slot output is
  the solo ``CachedSequenceGenerator`` decode, token for token. The caches
  and the token buffer are updated in place.
- ``ServingEngine``: continuous-batching generate plus windowed batch
  scoring (``predict``), driven by a scheduler thread, with the JAX
  engine's books: a metrics ``registry`` (the batcher's counters,
  occupancy gauges, per-phase latency histograms), a flight ``recorder``,
  a metrics ``history`` ring, optional ``slos``, a ``trace_collector``
  and a JSONL ``metrics_path``; ``metrics_snapshot``/``timeseries``/
  ``postmortem`` answer the server's verbs. ``from_bundle`` boots from a
  quantized serving bundle.

Every LayerNorm on these paths goes through ``LayerNorm.forward``, so with
``attach_fused_layernorm`` the CUDA LayerNorm kernel runs on every
prefill, chunk and decode step (2 per block + the final one). A model
carrying an attention hook (``attach_flash_attention``) is refused by the
cached generator, and the engine then serves ``predict`` only — JAX's
behaviour, kept.

Not ported yet (and absent from the signatures, so passing one fails
loudly): paged pools, prefix cache, speculative decode, QoS (``tenant``
and ``priority`` only label metrics), meshes, disaggregation roles and
their ``prefill``/``resume`` faces, load shedding, the overlapped loop,
the watchdog and supervisor (a scheduler crash leaves the engine
degraded and dumps a post-mortem), the compile and overlap ledgers, bf16
K/V caches (``kv_dtype``).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.obs import (
    FAST_WINDOW,
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


class DecodeStepper:
    """Dense slot-bank decode over a ``zoo.transformer_lm``-shaped model."""

    def __init__(self, model, num_slots=8, temperature=0.0, seed=0,
                 top_k=None, top_p=None, device=None):
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
        compute (0 = ready to decode)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = prompt.size
        if not 1 <= plen <= self.max_len:
            raise ValueError(
                f"prompt length {plen} outside [1, {self.max_len}]"
            )
        self.set_sampling(slot, sampling)
        self._ctx[slot].zero_()
        self._ctx[slot, :plen] = torch.as_tensor(prompt, device=self.device)
        self._pending[slot] = prompt
        self._prefill_pos[slot] = 0
        self._lens[slot] = plen
        target = plen - 1  # prefill covers positions 0..plen-2
        if target <= 0:
            self._finish_admit(slot)
            return 0
        return target

    @torch.no_grad()
    def prefill_chunk(self, slot: int, budget: int) -> int:
        """Prefill up to ``budget`` more positions of ``slot``'s prompt;
        returns positions remaining (0 = ready to decode). A chunk that
        covers the whole prefix from 0 runs the full-prefill body (dense
        causal attention over the prefix); a mid-prompt chunk runs the
        generator's ``_stage_chunk`` against the slot's cache rows."""
        prompt = self._pending.get(slot)
        if prompt is None:
            return 0  # released underneath us
        target = prompt.size - 1
        pos = self._prefill_pos[slot]
        n = min(int(budget), target - pos)
        if n > 0:
            if pos == 0 and n == target:
                self._prefill_full(slot, prompt)
            else:
                self._prefill_mid(slot, prompt, pos, n)
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
        toks = torch.as_tensor(prompt[None, :pp], device=self.device)
        x = self._gen.embed(toks, torch.arange(pp, device=self.device))
        self._gen._prefill(self._slot_caches(slot), x)

    def _prefill_mid(self, slot, prompt, pos, n):
        toks = torch.as_tensor(prompt[None, pos : pos + n], device=self.device)
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
        """One all-inactive step: builds the kernels the step runs (their
        first use) without touching the slot bank — every write is
        masked and no host bookkeeping advances."""
        self._step(np.zeros(self.num_slots, bool))

    # -- decode -------------------------------------------------------------

    def step(self, active) -> np.ndarray:
        """Advance every active slot one token; returns the (B,) tokens
        appended (entries for inactive slots are meaningless)."""
        active = np.asarray(active, bool)
        toks = self._step(active)
        self._lens[active] = np.minimum(self._lens[active] + 1, self.max_len)
        self._spos[active] += 1
        return toks

    @torch.no_grad()
    def _step(self, active) -> np.ndarray:
        gen, dev = self._gen, self.device
        b, t = self.num_slots, self.max_len
        nh, hd = self._nh, self._hd
        rows = self._rows
        act = torch.as_tensor(active, device=dev)
        pos = torch.clamp(
            torch.as_tensor(self._lens, device=dev) - 1, 0, t - 1
        )  # (B,) per-slot position
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
        if (self._temps > 0.0).any():
            nxt = _sp.sample_tokens(
                logit,
                torch.as_tensor(self._temps, device=dev),
                torch.as_tensor(self._topk, device=dev),
                torch.as_tensor(self._topp, device=dev),
                torch.as_tensor(self._seeds, device=dev),
                torch.as_tensor(self._spos, device=dev),
            )
        else:
            nxt = torch.argmax(logit, dim=-1)
        wpos = torch.clamp(pos + 1, 0, t - 1)
        write = act & (pos + 1 <= t - 1)
        self._ctx[rows, wpos] = torch.where(write, nxt, self._ctx[rows, wpos])
        return nxt.cpu().numpy()


class ServingEngine:
    """The in-process serving runtime: continuous-batching decode plus
    windowed batch scoring over one model, driven by a dedicated scheduler
    thread.

    ``generate`` is synchronous (submit + wait); ``submit`` returns the
    ``ServeRequest`` handle. ``stop(drain=True)`` refuses new work and
    completes everything already admitted or queued before returning.
    ``prefill_chunk``: per-iteration prefill token budget — "auto" picks
    ``max(16, seq_len // 8)``, an int sets it, None disables chunking.
    ``device=None`` means CUDA; the model must already live there.

    Books, as in the JAX engine at its defaults: a flight recorder of
    events (armed fault-seam firings, the crash), a span ring, and a
    metrics history a snapshot a second, ten minutes deep, for the
    ``timeseries`` verb (``history=False`` turns it off).
    ``postmortem_dir`` is where a crash bundle is written (None keeps it
    in memory for the ``postmortem`` verb); ``slos`` (a list of
    ``obs.SloSpec``) grade this registry, their verdicts ride ``health``;
    ``metrics_path`` adds a JSONL sink (``serving_submit``/
    ``serving_complete`` events and drained trace spans).
    """

    def __init__(self, model, num_slots=8, queue_capacity=64,
                 temperature=0.0, seed=0, top_k=None, top_p=None,
                 predict_batch=64, predict_window=0.005,
                 prefill_chunk="auto", metrics_path=None,
                 postmortem_dir=None, slos=None, history=True, device=None):
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
        self.history = (
            MetricsHistory(self.metrics_snapshot) if history else None
        )
        self.postmortem_dir = postmortem_dir
        self.last_postmortem = None
        self.last_postmortem_path = None
        self._stepper = None
        self._decode_err = None
        try:
            self._stepper = DecodeStepper(
                model, num_slots=num_slots, temperature=temperature,
                seed=seed, top_k=top_k, top_p=top_p, device=self.device,
            )
        except ValueError as e:
            # non-LM models (and hooked ones) still serve predict;
            # generate replies with this error
            self._decode_err = e
        if self._stepper is not None and prefill_chunk == "auto":
            prefill_chunk = max(16, self._stepper.max_len // 8)
        self.batcher = (
            None
            if self._stepper is None
            else ContinuousBatcher(
                self._stepper, queue_capacity=queue_capacity,
                prefill_chunk=prefill_chunk, registry=self.registry,
            )
        )
        self._config = dict(
            model=type(model).__name__,
            num_slots=None if self._stepper is None else self._stepper.num_slots,
            queue_capacity=queue_capacity, prefill_chunk=prefill_chunk,
            device=str(self.device),
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
        self._heartbeat = time.monotonic()
        self._last_crash = None
        reg = self.registry
        reg.gauge("serving_engine_degraded",
                  fn=lambda: self._last_crash is not None)
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

    def start(self) -> "ServingEngine":
        if self._started:
            return self
        self._started = True
        faults.add_observer(self.recorder.fault_observer)
        self._predict_batcher.start()
        if self.batcher is not None:
            self._thread = threading.Thread(
                target=self._loop, name="serving-engine", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self):
        """The scheduler thread: admit/step/evict until stopped; in drain
        mode, exit once everything in flight completed. A crash fails
        every pending request TYPED (``InternalError``) and leaves the
        engine degraded (no supervisor restart in this port yet)."""
        batcher = self.batcher
        history = self.history
        try:
            while True:
                self._heartbeat = time.monotonic()
                if history is not None:
                    history.maybe_snap()  # cadence-guarded
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
            self.recorder.record("engine.degraded", reason=repr(e))
            # dump before the requests fail: the in-flight table is the
            # state at the crash
            self._safe_dump("degraded", {"last_crash": self._last_crash})
            batcher.stop(error=InternalError(
                f"scheduler crashed; request aborted: {e!r}"
            ))
            if self.metrics is not None:
                self.metrics.log(event="serving_engine_crash", error=repr(e))

    def stop(self, drain=True):
        """Shutdown. ``drain=True``: stop admissions, finish queued and
        in-flight requests, then stop; ``drain=False``: fail them."""
        self._stop_evt.set()
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
            batcher.stop()
        self._predict_batcher.close()
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
        if self._last_crash is not None:
            raise InternalError(
                f"engine is degraded (last crash: {self._last_crash})"
            )
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
        bundle, path = dump_postmortem(
            self.postmortem_dir, "serving_engine", reason,
            recorder=self.recorder, metrics=self.metrics_snapshot(),
            in_flight=in_flight, config=dict(self._config),
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
        """Liveness summary: ``serving``, ``degraded`` (scheduler dead) or
        ``draining``, plus occupancy and the device."""
        batcher = self.batcher
        if self._stop_evt.is_set():
            status = "draining"
        elif batcher is None:
            status = "serving"  # predict-only engines have no scheduler
        else:
            th = self._thread
            alive = self._started and th is not None and th.is_alive()
            status = "serving" if alive else "degraded"
        out = {
            "status": status,
            "device": str(self.device),
            "generate_enabled": batcher is not None,
            "heartbeat_age": (
                None if batcher is None or not self._started
                else time.monotonic() - self._heartbeat
            ),
        }
        if batcher is not None:
            out.update(batcher.load())
        if self._last_crash is not None:
            out["last_crash"] = self._last_crash
        if self.slo is not None:
            verdict = self.slo.maybe_evaluate()
            out["slo"] = verdict["slo"]
            out["slo_violations"] = verdict["violations"]
            if self.history is not None:
                b = self.burn_verdict()
                out["burn"] = b["burn"]
                out["burn_violations"] = b["violations"]
        return out

    def stats(self) -> dict:
        out = {
            "model": type(self.model).__name__,
            "num_params": int(self.model.num_params()),
            "generate_enabled": self.batcher is not None,
        }
        if self.batcher is not None:
            out.update(self.batcher.stats())
        out["status"] = self.health()["status"]
        return out
