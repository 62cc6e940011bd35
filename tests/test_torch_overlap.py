"""The port's overlap and compile ledgers and its overlapped decode loop,
against the JAX package.

- ``OverlapLedger``: the same stamp sequence under an injected clock gives
  JAX's snapshot and bubble-histogram buckets.
- The overlapped loop on fake steppers (JAX's cases): tokens emit one call
  later and equal the sequential loop's, streamed chunk order is kept, a
  stop with a step in the air fails nothing silently, a raise at dispatch
  or at collect surfaces at its own collect, and blame isolates a poison
  slot among survivors. On the real LM both loop shapes decode JAX's
  tokens.
- ``CompileLedger``: the same ``record_mint`` sequence gives JAX's
  snapshot; the engine mints JAX's program keys for the same admissions;
  storms after ``mark_warmed``; the kernel build hook.

The JAX package is imported inside the fixtures and helpers, so the
``gpu``-marked test also runs on a machine without JAX (``python -m pytest
--noconftest tests/test_torch_overlap.py -m gpu``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import obs as pobs
from distkeras_tpu_torch.kernels import build
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.serving import engine as engine_mod
from distkeras_tpu_torch.serving.engine import _InflightStep
from distkeras_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    InternalError,
    ServeRequest,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


def _jobs():
    from distkeras_tpu import obs

    return obs


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm, JCached(jlm)


# ------------------------------------------------------- OverlapLedger


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: (stamp, clock-after) programs from JAX's ledger tests: the two-iteration
#: arithmetic, the gauge's first iteration, the first ready observation
#: winning, collect without dispatch and a discarded step
STAMPS = {
    "bubble_and_efficiency": [
        ("dispatch", 3.0), ("ready", 5.0), ("collect", 6.0),
        ("dispatch", 9.0), ("collect", 9.0),
    ],
    "zero_bubble_first_iteration": [
        ("dispatch", 2.0), ("ready", 2.0), ("collect", 2.0),
    ],
    "first_ready_wins": [
        ("dispatch", 1.0), ("ready", 4.0), ("ready", 4.0), ("collect", 4.0),
    ],
    "idle_pass_and_discard": [
        ("ready", 0.0), ("collect", 0.0), ("dispatch", 7.0), ("discard", 7.0),
        ("collect", 7.0),
    ],
    "microsecond_bubbles": [
        ("dispatch", 1e-4), ("collect", 1.3e-4), ("dispatch", 1.35e-4),
        ("ready", 2e-4), ("collect", 2.4e-4), ("dispatch", 2.5e-4),
        ("collect", 9.0),
    ],
}


def _run_stamps(pkg, program):
    reg, clock = pkg.MetricsRegistry(), FakeClock()
    led = pkg.OverlapLedger(reg, clock=clock)
    for stamp, t in program:
        getattr(led, "note_" + stamp if stamp != "discard" else stamp)()
        clock.t = t
    hist = next(s for s in reg.snapshot()
                if s["name"] == "serving_step_bubble_seconds")
    gauge = next(s for s in reg.snapshot()
                 if s["name"] == "serving_overlap_efficiency")
    return led.snapshot(), hist, gauge["value"], led.bubble_fraction


@pytest.mark.parametrize("program", sorted(STAMPS))
def test_overlap_ledger_matches_jax(program):
    """The same stamps under an injected clock: equal snapshots, bubble
    histogram buckets and efficiency gauge."""
    assert _run_stamps(pobs, STAMPS[program]) == _run_stamps(
        _jobs(), STAMPS[program])
    snap, hist, gauge, _ = _run_stamps(pobs, STAMPS[program])
    if program == "bubble_and_efficiency":
        assert snap["iterations"] == 2 and hist["count"] == 2
        assert hist["sum"] == pytest.approx(3.0)  # bubbles 2 + 1
        assert gauge == pytest.approx(6.0 / 9.0)
    if program == "idle_pass_and_discard":
        assert snap["iterations"] == 0 and gauge is None


# ------------------------------------------------ the overlapped loop


class FakeStepper:
    """Slot ``i`` emits ``1000 + i*100 + n`` for its n-th token (JAX's
    test fake, taking the port's ``sampling`` keyword)."""

    def __init__(self, num_slots=2, max_len=32):
        self.num_slots, self.max_len = num_slots, max_len
        self._n = np.zeros(num_slots, int)
        self._left = np.zeros(num_slots, int)

    def begin_admit(self, slot, prompt, sampling=None):
        self._n[slot] = 0
        self._left[slot] = max(0, len(np.asarray(prompt)) - 1)
        return int(self._left[slot])

    def prefill_chunk(self, slot, budget):
        n = min(int(budget), int(self._left[slot]))
        self._left[slot] -= n
        return int(self._left[slot])

    def release(self, slot):
        pass

    def step(self, active):
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            self._n[i] += 1
            toks[i] = 1000 + i * 100 + self._n[i]
        return toks


class AsyncFakeStepper(FakeStepper):
    """The ``step_async`` face: the result rides a handle that reports
    not-ready for ``delay_polls`` polls and hands the tokens out at
    collect."""

    def __init__(self, *a, delay_polls=1, **kw):
        super().__init__(*a, **kw)
        self.delay_polls = delay_polls
        self.collected = 0

    def step_async(self, active):
        toks = super().step(active)
        stepper = self

        class Handle:
            def __init__(self):
                self.polls = 0

            def ready(self):
                self.polls += 1
                return self.polls > stepper.delay_polls

            def collect(self):
                stepper.collected += 1
                return toks

        return Handle()


def _req(plen=3, max_new=4, **kw):
    return ServeRequest(np.arange(1, plen + 1), max_new, **kw)


def _drain(b, n=50):
    for _ in range(n):
        if b.idle:
            return
        b.step()
    raise AssertionError("batcher did not drain")


def test_overlap_tokens_emit_on_the_next_call_and_match_sequential():
    seq_b = ContinuousBatcher(FakeStepper(num_slots=2))
    seq_reqs = [seq_b.submit(_req(max_new=3)) for _ in range(3)]
    while not seq_b.idle:
        seq_b.step()
    st = AsyncFakeStepper(num_slots=2)
    b = ContinuousBatcher(st, overlap=True)
    reqs = [b.submit(_req(max_new=3)) for _ in range(3)]
    b.step()  # admit + dispatch: tokens still in the air
    assert not any(r.done for r in reqs)
    assert not b.idle  # an in-flight step is live work
    _drain(b)
    assert st.collected > 0
    for r, sr in zip(reqs, seq_reqs):
        assert r.result().tolist() == sr.result().tolist()
    assert b.counters["tokens_generated"] == 9
    assert b.overlap_ledger.iterations >= 3
    assert b.stats()["overlap"]["enabled"] is True


def test_overlap_streamed_chunk_order_matches_sequential():
    def run(overlap):
        b = ContinuousBatcher(AsyncFakeStepper(num_slots=2),
                              overlap=overlap)
        r = b.submit(_req(max_new=5, stream=True))
        while not b.idle:
            b.step()
        chunks = []
        while True:
            c = r.next_chunk(timeout=0.1)
            if c is None:
                break
            chunks.append(list(c))
        return chunks, r.result().tolist()

    seq_chunks, seq_final = run(False)
    ov_chunks, ov_final = run(True)
    assert ov_final == seq_final
    assert ov_chunks == seq_chunks == [[t] for t in seq_final[3:]]


def test_overlap_stop_with_step_in_the_air():
    b = ContinuousBatcher(AsyncFakeStepper(num_slots=1), overlap=True)
    r = b.submit(_req(max_new=5))
    b.step()  # dispatched, uncollected
    assert not b.idle
    b.stop()
    assert b.idle and r.done  # the handle was dropped with the request
    with pytest.raises(Exception, match="engine stopped"):
        r.result()
    assert b.overlap_ledger.iterations == 0  # the entry was discarded


def test_dispatch_raise_surfaces_at_its_own_collect():
    class BoomStepper(FakeStepper):
        def step(self, active):
            raise RuntimeError("injected step crash")

    b = ContinuousBatcher(BoomStepper(num_slots=1), overlap=True,
                          quarantine_steps=2)
    r = b.submit(_req(max_new=4))
    b.step()  # dispatch: the failure is stashed on the handle
    assert not r.done and b.counters["step_failures"] == 0
    b.step()  # collect of its own iteration: blame by elimination
    assert r.done
    with pytest.raises(InternalError, match="blamed"):
        r.result()
    assert b.counters["step_failures"] == 1
    assert b.counters["quarantines"] == 1


def test_deferred_collect_raise_surfaces_at_its_own_collect():
    class DeferredBoomStepper(AsyncFakeStepper):
        def step_async(self, active):
            class Handle:
                @staticmethod
                def ready():
                    return True

                @staticmethod
                def collect():
                    raise RuntimeError("deferred device failure")

            return Handle()

    b = ContinuousBatcher(DeferredBoomStepper(num_slots=1), overlap=True,
                          quarantine_steps=2)
    r = b.submit(_req(max_new=4))
    b.step()
    assert not r.done
    b.step()
    assert r.done
    with pytest.raises(InternalError, match="blamed"):
        r.result()
    assert b.counters["step_failures"] == 1


def test_overlap_blame_isolates_poison_slot_among_survivors():
    class PoisonStepper(AsyncFakeStepper):
        poison = 1

        def step(self, active):
            if np.asarray(active, bool)[self.poison]:
                raise RuntimeError("poison slot in batch")
            return super().step(active)

        def step_async(self, active):
            # fail at the HANDLE, after a successful dispatch
            try:
                out = self.step(active)
            except RuntimeError as e:
                out = e

            class Handle:
                @staticmethod
                def ready():
                    return True

                @staticmethod
                def collect():
                    if isinstance(out, Exception):
                        raise out
                    return out

            return Handle()

    b = ContinuousBatcher(PoisonStepper(num_slots=2), overlap=True,
                          quarantine_steps=100)
    good = b.submit(_req(max_new=2))
    bad = b.submit(_req(plen=4, max_new=2))  # admitted second -> slot 1
    _drain(b)
    with pytest.raises(InternalError, match="blamed"):
        bad.result()
    assert good.result().tolist() == [1, 2, 3, 1001, 1002]
    assert b.counters["step_failures"] >= 1
    assert b.counters["blame_probes"] >= 1


def test_overlap_concurrent_submits_and_stop_lose_nothing():
    """More submitting threads than cores against the overlapped loop,
    with a hard stop racing the last submits: every accepted request ends
    (tokens or a typed stop), and the counters add up — a lost update
    under the batcher lock, or a request stranded with a step in the
    air, would break them."""
    import sys
    import threading

    from distkeras_tpu_torch.serving.scheduler import EngineStoppedError

    b = ContinuousBatcher(AsyncFakeStepper(num_slots=4), overlap=True,
                          queue_capacity=10_000, prefill_chunk=4)
    done = threading.Event()

    def loop():
        while not done.is_set():
            if not b.step():
                b.wait_for_work(0.001)

    reqs, lock = [], threading.Lock()

    def client(k):
        for j in range(40):
            try:
                r = b.submit(ServeRequest(np.full(3 + (j % 5), k + 1), 2))
            except EngineStoppedError:
                return
            with lock:
                reqs.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stepper = threading.Thread(target=loop)
    clients = [threading.Thread(target=client, args=(k,)) for k in range(16)]
    try:
        stepper.start()
        for t in clients:
            t.start()
        for t in clients[:8]:
            t.join(timeout=60)
        b.stop()  # races the other 8 clients and the step in the air
        for t in clients[8:]:
            t.join(timeout=60)
    finally:
        done.set()
        stepper.join(timeout=10)
        sys.setswitchinterval(old)
    assert not stepper.is_alive()
    assert not any(t.is_alive() for t in clients)
    assert all(r.done for r in reqs)
    ok = [r for r in reqs if r.error is None]
    assert all(isinstance(r.error, EngineStoppedError)
               for r in reqs if r.error is not None)
    assert all(len(r.tokens) == 2 for r in ok)
    stats = b.stats()
    assert stats["submitted"] == len(reqs)
    assert stats["completed"] == len(ok)
    assert stats["tokens_generated"] >= 2 * len(ok)
    assert b.idle


def test_sequential_mode_one_call_emits():
    b = ContinuousBatcher(FakeStepper(num_slots=1))
    assert not b.overlap
    r = b.submit(_req(max_new=1))
    b.step()
    assert r.done and r.result().tolist() == [1, 2, 3, 1001]
    assert b.overlap_ledger.iterations == 1  # the control stamps it too


@pytest.mark.parametrize("overlap", [False, True])
def test_both_loops_decode_jax_tokens_on_the_lm(lms, overlap):
    """The overlapped and the sequential loop on the real LM: every reply
    equals JAX's solo decode, greedy or sampled (the sampled replay is the
    port's own engine: counter RNG keyed on (seed, position))."""
    _, lm, ref = lms
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 61, n).astype(np.int32)
               for n in (3, 9, 20, 5, 14)]
    eng = ServingEngine(lm, num_slots=2, overlap=overlap,
                        device="cpu").start()
    try:
        reqs = [eng.submit(p, 6) for p in prompts]
        outs = [eng.wait(r, timeout=60) for r in reqs]
        sampling = {"temperature": 0.8, "seed": 11}
        s1 = eng.generate(prompts[0], 6, sampling=sampling, timeout=60)
        stats = eng.stats()
    finally:
        eng.stop()
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, ref.generate(p[None], steps=6)[0])
    other = ServingEngine(lm, num_slots=2, overlap=not overlap,
                          device="cpu").start()
    try:
        s2 = other.generate(prompts[0], 6, sampling=sampling, timeout=60)
    finally:
        other.stop()
    np.testing.assert_array_equal(s1, s2)
    assert stats["overlap"]["enabled"] is overlap
    assert stats["overlap"]["iterations"] == stats["steps"]


def test_inflight_step_on_cpu_is_ready_and_collects_once(lms):
    _, lm, ref = lms
    eng = ServingEngine(lm, num_slots=2, device="cpu")
    st = eng._stepper
    prompt = np.arange(1, 6)
    st.admit(0, prompt)
    lens0 = st._lens.copy()
    h = st.step_async(np.array([True, False]))
    assert isinstance(h, _InflightStep) and h.ready()
    assert (st._lens == lens0).all()  # nothing advances before collect
    tok = h.collect()[0]
    assert st._lens[0] == lens0[0] + 1 and st._spos[0] == 1
    assert tok == ref.generate(prompt[None], steps=1)[0][-1]
    with pytest.raises(RuntimeError, match="already collected"):
        h.collect()


# ------------------------------------------------------- CompileLedger


MINTS = [
    ("admit[16]", 0.25, (), True),
    ("step[plain]", 0.5, (), True),
    ("chunk[4]", 0.125, (), False),
    ("build[layernorm_fwd]", 6.5, (), False),
    ("step[plain]", 0.0625, (), False),  # a restart's rewarm
]


@pytest.mark.parametrize("mark_after", [None, 0, 2, 4])
def test_compile_ledger_matches_jax(mark_after):
    """The same ``record_mint`` sequence (warmup boundary at
    ``mark_after``) gives JAX's snapshot; the records differ only in
    their wall-clock stamps."""

    def run(pkg):
        reg, rec = pkg.MetricsRegistry(), pkg.FlightRecorder()
        led = pkg.CompileLedger(registry=reg, recorder=rec,
                                inflight_fn=lambda: 3)
        for i, (key, secs, sig, warming) in enumerate(MINTS):
            if mark_after == i:
                led.mark_warmed()
            led.record_mint(key, secs, signature=sig, warming=warming)
        samples = {s["name"]: s["value"] for s in reg.snapshot()}
        events = [{k: v for k, v in e.items() if k != "ts"}
                  for e in rec.snapshot()]
        mints = [{k: v for k, v in r.items() if k != "t"}
                 for r in led.mints()]
        return led.snapshot(), samples, events, mints, led.tail(2)[-1]["key"]

    got, want = run(pobs), run(_jobs())
    assert got == want
    if mark_after == 2:
        assert got[0]["storms"] == 2  # chunk[4] and the build: never seen


def test_engine_mints_jax_program_keys(lms):
    """The same admissions through both engines mint the same program
    keys (the port adds only ``build[...]`` keys, on the card)."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm, _ = lms
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 61, n).astype(np.int32)
               for n in (3, 9, 20, 32 - 4)]
    keys = []
    for eng in (JEngine(jlm, num_slots=2, prefix_cache=False),
                ServingEngine(lm, num_slots=2, device="cpu")):
        eng.start()
        try:
            for p in prompts:
                eng.generate(p, 4, timeout=120)
        finally:
            eng.stop()
        snap = eng.compile_ledger.snapshot()
        assert snap["warmup"] == 0 and snap["storms"] == 0
        keys.append({r["key"] for r in eng.compile_ledger.mints()
                     if not r["key"].startswith("build[")})
    assert keys[1] == keys[0]
    assert {"ctx_row", "step[plain]"} < keys[1]


def test_traced_request_carries_its_mints_like_jax(lms):
    """The first traced request on a fresh engine stalls on every program
    its admission and decode mint: both packages attribute the same keys
    to its ``xla.compile`` events, and the port's ``request_spans`` renders
    them as spans."""
    from distkeras_tpu.obs import TraceContext as JTrace
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm, _ = lms
    prompt = np.arange(1, 21, dtype=np.int32)
    keys = []
    for eng, ctx in ((JEngine(jlm, num_slots=2, prefix_cache=False),
                      JTrace.new()),
                     (ServingEngine(lm, num_slots=2, device="cpu"),
                      pobs.TraceContext.new())):
        eng.start()
        try:
            req = eng.submit(prompt, 3, trace=ctx)
            eng.wait(req, timeout=120)
        finally:
            eng.stop()
        evs = [ev for ev in req.events if ev["name"] == "xla.compile"]
        keys.append(sorted(k for ev in evs for k in ev["keys"]))
    assert keys[1] == keys[0] and "step[plain]" in keys[1]
    spans = pobs.request_spans(req, ctx)
    assert sum(sp["name"] == "xla.compile" for sp in spans) == len(evs)


def test_storms_after_mark_warmed_and_rewarm_after_restart(lms):
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, device="cpu").start()
    led = eng.compile_ledger
    try:
        st = eng._stepper
        st.warmup()
        eng.generate(np.arange(1, 4, dtype=np.int32), 2, timeout=60)
        led.mark_warmed()
        eng.generate(np.arange(1, 4, dtype=np.int32), 2, timeout=60)
        assert led.snapshot()["storms"] == 0  # every key seen before
        eng.generate(np.arange(1, 12, dtype=np.int32), 2, timeout=60)
        snap = led.snapshot()
        assert snap["storms"] == 1  # admit[16]: a bucket never warmed
        assert [r["key"] for r in led.mints() if r["storm"]] == ["admit[16]"]
        st.warm_prefill_buckets()
        before = led.snapshot()["total"]
        eng.generate(np.arange(1, 30, dtype=np.int32), 2, timeout=60)
        assert led.snapshot()["total"] == before  # all warmed: no mint
        assert led.snapshot()["storms"] == 1
        # a rebuilt generation's warmup re-runs a known program: rewarm
        fresh = type(st)(lm, num_slots=2, device="cpu",
                         compile_ledger=led)
        fresh.warmup()
        rec = led.mints()[-1]
        assert (rec["key"], rec["trigger"], rec["rewarm"], rec["storm"]) \
            == ("step[plain]", "warmup", True, False)
    finally:
        eng.stop()


def test_kernel_build_reports_to_observers(monkeypatch):
    """``build`` tells its observers before a build starts and, after the
    compile and the load, which kernels it built and the wall seconds;
    the engine turns that into a ``build[...]`` mint and a grace
    extension."""

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "_observers", [])
    monkeypatch.setattr(build, "_compile_all", lambda names: None)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    heard = []
    build.add_build_observer(lambda names, secs: heard.append((names, secs)))
    build.build(["layernorm_fwd"])
    build.build(["layernorm_fwd"])  # loaded: no build, no report
    assert [n for n, _ in heard] == [["layernorm_fwd"], ["layernorm_fwd"]]
    assert heard[0][1] is None and heard[1][1] >= 0.0


def test_engine_records_build_mints_and_extends_grace(lms):
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, watchdog_interval=0.5,
                        device="cpu").start()
    try:
        eng._grace_until = 0.0
        eng._on_build(["layernorm_fwd"], None)
        assert eng._grace_until > 0.0  # graced before the build runs
        # a build on a thread that does not work for this engine (a
        # sibling replica's) graces it but is not its mint
        n0 = len(eng.compile_ledger.mints())
        eng._on_build(["layernorm_fwd"], 5.5)
        assert len(eng.compile_ledger.mints()) == n0
        # a build on the engine's own thread is (the scheduler loop and
        # the predict window claim their threads the same way)
        engine_mod._WARM_SCOPE.ledger = eng.compile_ledger
        try:
            eng._on_build(["layernorm_fwd"], 5.5)
        finally:
            engine_mod._WARM_SCOPE.ledger = None
        rec = eng.compile_ledger.mints()[-1]
        assert (rec["key"], rec["seconds"], rec["trigger"]) == (
            "build[layernorm_fwd]", 5.5, "serving")
        assert eng.stats()["compiles"]["seconds"] >= 5.5
    finally:
        eng.stop()


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_inflight_step_on_card_waits_on_its_event():
    """On the card the step's handle answers ``ready()`` from its CUDA
    event, ``collect()`` syncs on that event, and both loop shapes decode
    the solo generator's tokens through the LayerNorm kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    lm = zoo.transformer_lm(**LM)
    assert attach_fused_layernorm(lm) == 5
    eng = ServingEngine(lm, num_slots=2)
    st = eng._stepper
    st.warmup()
    prompt = np.arange(1, 9)
    st.admit(0, prompt)
    h = st.step_async(np.array([True, False]))
    assert isinstance(h._event, torch.cuda.Event)
    torch.cuda._sleep(50_000_000)  # keep the stream busy past the query
    h2 = st.step_async(np.array([False, False]))
    assert not h2.ready()  # the event has not fired behind the sleep
    h.collect()
    h2.collect()
    assert h2.ready()
    want = CachedSequenceGenerator(lm).generate(prompt[None], 4)[0]
    for overlap in (False, True):
        eng = ServingEngine(lm, num_slots=2, overlap=overlap).start()
        try:
            kernels.reset_launch_counts()
            out = eng.generate(prompt, 4, timeout=120)
            counts = kernels.launch_counts()
        finally:
            eng.stop()
        np.testing.assert_array_equal(out, want)
        assert counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0


@pytest.mark.gpu
def test_host_phases_never_sync_the_stream():
    """With every program warmed, an admission, its prefill chunks and
    the decode dispatches of the overlapped loop run with a step in
    flight and never synchronize the stream (PyTorch's sync debug mode
    raises on any synchronizing call); only ``collect`` waits, on its
    event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.sampling import SamplingParams

    lm = zoo.transformer_lm(**LM)
    attach_fused_layernorm(lm)
    eng = ServingEngine(lm, num_slots=2)
    st = eng._stepper
    st.warmup()
    st.warm_prefill_buckets()
    st.admit(0, np.arange(1, 6))
    sampled = SamplingParams(temperature=0.8, top_k=5, seed=3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = st.step_async(np.array([True, False]))
        left = st.begin_admit(1, np.arange(1, 20), sampling=sampled)
        while left:
            left = st.prefill_chunk(1, 4)
        h2 = st.step_async(np.array([True, True]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h.collect()
    h2.collect()
