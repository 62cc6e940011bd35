"""The port's self-healing serving tier against the JAX package: blame and
quarantine in the scheduler, the watchdog and supervisor in the engine,
and the self-healing books on the engine and the wire.

Fake-stepper cases run one seeded scenario through both packages'
``ContinuousBatcher`` and hold their outcomes equal. The real-LM cases use
JAX's chaos fixture LM (d32/L2, vocab 61), its weights carried into the
port, and hold the survivors to JAX's solo ``CachedSequenceGenerator``
decode. Timing cases keep a margin of at least 5x between an injected
stall and the watchdog interval, and wait on conditions with bounded
waits.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu.serving import scheduler as jsched
from distkeras_tpu_torch import faults
from distkeras_tpu_torch.faults import FaultPlan
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import TraceContext, request_spans
from distkeras_tpu_torch.serving import (
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
)
from distkeras_tpu_torch.serving import scheduler as psched
from distkeras_tpu_torch.serving.scheduler import InternalError
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults._ACTIVE
    if leaked is not None:
        leaked.deactivate()
        pytest.fail("test leaked an active FaultPlan")


@pytest.fixture(scope="module")
def lms():
    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm, JCached(jlm)


def _wait(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


# -------------------------------------------- blame parity on fake steppers


class PoisonStepper:
    """Pure-Python stepper (JAX's test fake, with a poison switch): slot
    ``i`` emits ``1000 + i*100 + n`` for its n-th token; a step whose
    active mask holds ``poison_slot`` raises; ``bad_prompt`` raises at
    admission; ``bad_left`` raises in the prefill chunk that starts with
    that many positions left. Every call is logged."""

    def __init__(self, num_slots=2, max_len=32, poison_slot=None,
                 bad_prompt=None, bad_left=None):
        self.num_slots, self.max_len = num_slots, max_len
        self.poison_slot = poison_slot
        self.bad_prompt, self.bad_left = bad_prompt, bad_left
        self.log = []
        self._n = np.zeros(num_slots, int)
        self._left = np.zeros(num_slots, int)

    def begin_admit(self, slot, prompt, sampling=None):
        prompt = [int(t) for t in np.asarray(prompt)]
        self.log.append(("admit", slot, prompt))
        if prompt == self.bad_prompt:
            raise RuntimeError("poison prompt")
        self._n[slot] = 0
        self._left[slot] = max(0, len(prompt) - 1)
        return int(self._left[slot])

    def prefill_chunk(self, slot, budget):
        if self._left[slot] == self.bad_left:
            raise RuntimeError("chunk crash")
        n = min(int(budget), int(self._left[slot]))
        self.log.append(("chunk", slot, n))
        self._left[slot] -= n
        return int(self._left[slot])

    def release(self, slot):
        self.log.append(("release", slot))

    def step(self, active):
        self.log.append(("step", [int(i) for i in np.flatnonzero(active)]))
        if self.poison_slot is not None and active[self.poison_slot]:
            raise RuntimeError("poisoned step")
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            self._n[i] += 1
            toks[i] = 1000 + i * 100 + self._n[i]
        return toks


def _drain(b, reqs, limit=200):
    steps = 0
    while not all(r.done for r in reqs):
        b.step()
        steps += 1
        assert steps < limit, "scheduler made no progress"


def _case_newest_masked(S, mk):
    st = PoisonStepper(num_slots=3)
    b = S.ContinuousBatcher(st, queue_capacity=8, **mk)
    good = [b.submit(S.ServeRequest([1, 2], 6)) for _ in range(2)]
    b.step()
    b.step()  # both loop shapes: the goods are decoding
    st.poison_slot = 2
    bad = b.submit(S.ServeRequest([9, 9, 9], 6))
    _drain(b, good + [bad])
    return st, b, good + [bad]


def _case_bisect(S, mk):
    st = PoisonStepper(num_slots=3, poison_slot=0)
    b = S.ContinuousBatcher(st, queue_capacity=8, **mk)
    reqs = [b.submit(S.ServeRequest([9, 9], 6))]  # slot 0 = oldest
    reqs += [b.submit(S.ServeRequest([1, 2], 6)) for _ in range(2)]
    _drain(b, reqs)
    return st, b, reqs


def _case_solo(S, mk):
    st = PoisonStepper(num_slots=2, poison_slot=0)
    b = S.ContinuousBatcher(st, queue_capacity=4, **mk)
    reqs = [b.submit(S.ServeRequest([5], 4))]
    _drain(b, reqs)
    return st, b, reqs


def _case_quarantine(S, mk):
    st = PoisonStepper(num_slots=1, poison_slot=0)
    b = S.ContinuousBatcher(st, queue_capacity=8, quarantine_steps=5, **mk)
    bad = b.submit(S.ServeRequest([7, 7], 4))
    _drain(b, [bad])
    assert b.stats()["quarantined_slots"] == 1
    st.poison_slot = None
    nxt = b.submit(S.ServeRequest([1, 2], 2))
    for _ in range(3):  # probation: the only slot stays out of the pool
        b.step()
    admits = [e for e in st.log if e[0] == "admit"]
    assert not nxt.done and admits[-1][2] == [7, 7]
    _drain(b, [nxt])  # probation expires, the slot recycles
    assert b.stats()["quarantined_slots"] == 0
    return st, b, [bad, nxt]


def _case_prefill_failure(S, mk):
    st = PoisonStepper(num_slots=2, bad_prompt=[6, 6, 6])
    b = S.ContinuousBatcher(st, queue_capacity=8, **mk)
    reqs = [b.submit(S.ServeRequest([1, 2], 3)),
            b.submit(S.ServeRequest([6, 6, 6], 3))]
    _drain(b, reqs)
    return st, b, reqs


def _case_chunk_failure(S, mk):
    # the long prompt's third chunk call crashes (the shared budget walks
    # it 10 -> 7 -> 3 remaining); the short prompt never reaches 3
    st = PoisonStepper(num_slots=2, max_len=64, bad_left=3)
    b = S.ContinuousBatcher(st, queue_capacity=8, prefill_chunk=4, **mk)
    reqs = [b.submit(S.ServeRequest([1, 2], 3)),
            b.submit(S.ServeRequest(np.arange(1, 12), 3))]
    _drain(b, reqs)
    return st, b, reqs


BLAME_CASES = {
    "newest_admission_masked_first": _case_newest_masked,
    "bisect_when_suspect_is_innocent": _case_bisect,
    "solo_slot_by_elimination": _case_solo,
    "quarantined_slot_sits_out_then_recycles": _case_quarantine,
    "prefill_failure": _case_prefill_failure,
    "mid_prefill_chunk_failure": _case_chunk_failure,
}

BLAME_COUNTERS = ("step_failures", "blame_probes", "quarantines",
                  "prefill_failures", "internal_errors", "completed",
                  "tokens_generated", "quarantined_slots")


def _outcome(S, st, b, reqs):
    rows = []
    for r in reqs:
        if isinstance(r.error, S.InternalError):
            kind = ("blamed" if "blamed" in str(r.error)
                    else "prefill" if "prefill failed" in str(r.error)
                    else str(r.error))
        else:
            kind = None if r.error is None else type(r.error).__name__
        rows.append((kind, list(r.tokens)))
    stats = b.stats()
    return {"requests": rows, "log": st.log,
            "counters": {k: stats[k] for k in BLAME_COUNTERS}}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("case", sorted(BLAME_CASES))
def test_blame_parity_with_jax(case, overlap):
    """One seeded scenario through JAX's batcher and the port's: the same
    requests fail the same way, the survivors emit the same tokens, the
    stepper sees the same call sequence and the counters agree."""
    mk = {"overlap": overlap}
    want = _outcome(jsched, *BLAME_CASES[case](jsched, mk))
    got = _outcome(psched, *BLAME_CASES[case](psched, mk))
    assert got == want
    kinds = [k for k, _ in got["requests"]]
    if case.endswith("failure"):
        assert kinds.count("prefill") == 1
        assert got["counters"]["prefill_failures"] == 1
    else:
        assert kinds.count("blamed") == 1
        assert got["counters"]["quarantines"] == 1
    if case == "newest_admission_masked_first":
        assert got["counters"]["blame_probes"] == 1  # one masked retry
    if case == "solo_slot_by_elimination":
        assert got["counters"]["blame_probes"] == 0


# ----------------------------------------------------- poison, real LM


@pytest.mark.parametrize("overlap", [False, True])
def test_poison_generate_fails_alone_streams_equal_jax(lms, overlap):
    """A poison request fails alone with ``InternalError`` while the
    concurrent streams equal JAX's solo decode token for token; the engine
    never leaves ``serving``."""
    _, lm, ref = lms
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (4, 7)]
    want = [ref.generate(p[None], steps=20)[0] for p in prompts]
    eng = ServingEngine(lm, num_slots=3, watchdog_interval=30.0,
                        overlap=overlap, device="cpu").start()
    # the first matching seam fires: a step with the poison's slot (2)
    # active raises; every other step is slowed to 30 ms, so the good
    # streams are still decoding when the poison arrives
    plan = (
        FaultPlan()
        .arm("stepper.step", times=None,
             when=lambda ctx: bool(ctx["active"][2]))
        .arm("stepper.step", action="delay", delay=0.03, times=None)
    )
    try:
        with plan:
            goods = [eng.submit(p, 20) for p in prompts]  # slots 0 and 1
            _wait(lambda: all(len(g.tokens) >= 1 for g in goods),
                  msg="good streams decoding")
            ctx = TraceContext.new()
            bad = eng.submit(rng.integers(0, 61, 5).astype(np.int32), 10,
                             trace=ctx)
            with pytest.raises(InternalError, match="blamed"):
                bad.result(timeout=60)
            for req, w in zip(goods, want):
                np.testing.assert_array_equal(req.result(timeout=60), w)
        assert plan.fired("stepper.step") >= 1
        st = eng.stats()
        assert st["internal_errors"] == 1 and st["quarantines"] == 1
        assert st["step_failures"] >= 1 and st["blame_probes"] >= 1
        assert st["status"] == "serving"
        assert st["overlap"]["enabled"] is overlap
        # the blame window rides the culprit's own trace
        (blame,) = [sp for sp in request_spans(bad, ctx)
                    if sp["name"] == "scheduler.blame"]
        assert blame["status"] == "internal"
        assert blame["attrs"]["slot"] == 2
    finally:
        eng.stop()


def test_prefill_seam_fails_its_admission_alone(lms):
    _, lm, ref = lms
    prompt = np.arange(1, 9, dtype=np.int32)
    want = ref.generate(prompt[None], steps=4)[0]
    eng = ServingEngine(lm, num_slots=2, device="cpu").start()
    plan = FaultPlan().arm("stepper.prefill", times=1)
    try:
        with plan:
            bad = eng.submit(prompt, 4)
            with pytest.raises(InternalError, match="prefill failed"):
                bad.result(timeout=60)
        np.testing.assert_array_equal(eng.generate(prompt, 4, timeout=60),
                                      want)
        st = eng.stats()
        assert st["prefill_failures"] == 1 and st["quarantines"] == 0
        assert eng.health()["status"] == "serving"
    finally:
        eng.stop()


# ------------------------------------------------------------- watchdog


def test_watchdog_restarts_dead_scheduler(lms):
    """A killed scheduler thread is restarted; the request in flight fails
    TYPED and the rebuilt stepper decodes JAX's tokens."""
    _, lm, ref = lms
    prompt = np.arange(1, 6, dtype=np.int32)
    want = ref.generate(prompt[None], steps=6)[0]
    eng = ServingEngine(
        lm, num_slots=2, watchdog_interval=1.0, watchdog_grace=30.0,
        max_restarts=3, restart_backoff=0.01, device="cpu",
    ).start()
    plan = (
        FaultPlan()
        .arm("stepper.step", action="delay", delay=0.02, times=None)
        .arm("scheduler.loop", times=1, after=5,
             when=lambda ctx: ctx["busy"])
    )
    try:
        with plan:
            inflight = eng.submit(prompt, 20)
            with pytest.raises(InternalError, match="scheduler crashed"):
                inflight.result(timeout=30)
            assert 0 < len(inflight.tokens) < 20  # it WAS mid-decode
            _wait(lambda: eng.health()["status"] == "serving"
                  and eng.health()["restarts"] == 1,
                  msg="supervisor restart")
            h = eng.health()
            assert h["watchdog_trips"] == 1 and h["restarts"] == 1
            np.testing.assert_array_equal(
                eng.generate(prompt, 6, timeout=60), want)
        assert eng.last_restart["warmup_seconds"] >= 0.0
        # the new generation's first calls re-run known programs
        assert eng.compile_ledger.snapshot()["rewarms"] >= 1
        warm = [r for r in eng.compile_ledger.mints()
                if r["trigger"] == "warmup"]
        assert [r["key"] for r in warm] == ["step[plain]"]
        assert warm[0]["rewarm"]  # the restarted generation's warmup
    finally:
        eng.stop()


def test_watchdog_detects_wedged_scheduler(lms):
    """A scheduler stuck in a 3 s stall (6x the 0.5 s interval) trips the
    heartbeat watchdog: the request fails typed, a fresh generation takes
    over, and the abandoned zombie exits once it wakes."""
    _, lm, ref = lms
    prompt = np.arange(2, 7, dtype=np.int32)
    want = ref.generate(prompt[None], steps=5)[0]
    eng = ServingEngine(
        lm, num_slots=2, watchdog_interval=0.5, watchdog_grace=30.0,
        max_restarts=2, restart_backoff=0.01, device="cpu",
    ).start()
    try:
        np.testing.assert_array_equal(eng.generate(prompt, 5, timeout=60),
                                      want)
        eng._grace_until = 0.0  # warm: arm the wedge detector
        plan = (
            FaultPlan()
            .arm("stepper.step", action="delay", delay=0.02, times=None)
            .arm("scheduler.loop", action="delay", delay=3.0, times=1,
                 after=3, when=lambda ctx: ctx["busy"])
        )
        with plan:
            inflight = eng.submit(prompt, 20)
            with pytest.raises(InternalError, match="wedged"):
                inflight.result(timeout=30)
            assert 0 < len(inflight.tokens) < 20
            _wait(lambda: eng.health()["status"] == "serving"
                  and eng.health()["restarts"] == 1, msg="wedge recovery")
            np.testing.assert_array_equal(
                eng.generate(prompt, 5, timeout=60), want)
        _wait(lambda: sum(t.name == "serving-engine"
                          for t in threading.enumerate()) == 1,
              msg="the zombie scheduler exits")
    finally:
        eng.stop()


def test_restart_budget_exhausts_to_degraded(lms):
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, watchdog_interval=0.2,
                        max_restarts=1, restart_backoff=0.01,
                        device="cpu").start()
    plan = FaultPlan().arm("scheduler.loop", times=None)  # crash forever
    try:
        with plan:
            _wait(lambda: eng.health()["restart_budget_exhausted"],
                  msg="budget exhaustion")
        h = eng.health()
        assert h["status"] == "degraded" and h["restarts"] == 1
        assert h["watchdog_trips"] == 2
        with pytest.raises(InternalError, match="budget exhausted"):
            eng.submit(np.arange(1, 4), 4)
        assert eng.stats()["status"] == "degraded"
    finally:
        eng.stop()


# ------------------------------------------------------------------ wire


def _client(srv):
    return ServingClient(srv.host, srv.port, timeout=60, connect_timeout=2)


def test_wire_stream_on_wedged_scheduler_ends_typed(lms):
    """A streamed wire request on a wedged scheduler ends with a typed
    ``internal`` frame a few watchdog intervals after the wedge, long
    before the 6 s stall would have ended on its own."""
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, watchdog_interval=0.5,
                        watchdog_grace=30.0, restart_backoff=0.01,
                        device="cpu")
    srv = ServingServer(eng).start()
    plan = FaultPlan().arm("scheduler.loop", action="delay", delay=6.0,
                           times=1, after=3, when=lambda ctx: ctx["busy"])
    try:
        with _client(srv) as c:
            c.generate(np.arange(1, 6, dtype=np.int32), 3)  # warm
            eng._grace_until = 0.0
            with plan:
                t0 = time.monotonic()
                with pytest.raises(ServingError) as ei:
                    for _ in c.generate_stream(
                            np.arange(1, 6, dtype=np.int32), 20):
                        pass
                took = time.monotonic() - t0
            assert ei.value.code == "internal"
            assert "wedged" in str(ei.value)
            assert took < 5.0, took
            _wait(lambda: c.health()["restarts"] == 1, msg="restart")
    finally:
        srv.shutdown()


def test_health_verb_reports_self_healing_fields(lms):
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, device="cpu")
    srv = ServingServer(eng).start()
    try:
        with _client(srv) as c:
            c.generate(np.arange(1, 5, dtype=np.int32), 2)
            h = c.health()
            assert h["status"] == "serving"
            assert h["restarts"] == 0 and h["watchdog_trips"] == 0
            assert h["max_restarts"] == 3
            assert h["restart_budget_exhausted"] is False
            assert h["quarantined_slots"] == 0
            assert h["heartbeat_age"] is not None
            assert h["overlap"]["enabled"] is True
            assert h["overlap"]["iterations"] >= 1
            st = c.stats()
            for key in ("step_failures", "blame_probes", "internal_errors",
                        "prefill_failures", "quarantines",
                        "quarantined_slots", "restarts", "watchdog_trips"):
                assert st[key] == 0, key
            assert st["compiles"]["total"] >= 1
    finally:
        srv.shutdown()


def test_postmortem_verb_names_blamed_slot_and_both_seams(lms, tmp_path):
    """An armed ``stepper.step`` seam blames a slot, then an armed
    ``scheduler.loop`` seam kills the scheduler; the trip's bundle, served
    by the ``postmortem`` verb, names the blamed slot and both seams."""
    _, lm, _ = lms
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=4,
                        watchdog_interval=0.5, watchdog_grace=30.0,
                        max_restarts=5, restart_backoff=0.01,
                        postmortem_dir=str(tmp_path), device="cpu")
    srv = ServingServer(eng).start()
    try:
        with _client(srv) as c:
            assert c.postmortem() is None  # nothing terminal yet
            c.generate(np.arange(1, 10, dtype=np.int32), 4)
            plan = (
                FaultPlan(seed=0)
                .arm("stepper.step", times=1)
                .arm("scheduler.loop", times=1, after=4)
            )
            with plan:
                with pytest.raises(ServingError) as ei:
                    c.generate(np.arange(1, 8, dtype=np.int32), 4)
                assert ei.value.code == "internal"
                _wait(lambda: eng.last_postmortem is not None,
                      msg="trip bundle")
            assert plan.fired("stepper.step") == 1
            assert plan.fired("scheduler.loop") == 1
            pm = c.postmortem()
        assert pm["reason"] == "watchdog_trip"
        assert pm["component"] == "serving_engine"
        sites = [e["site"] for e in pm["events"] if e["kind"] == "fault.fired"]
        assert "stepper.step" in sites and "scheduler.loop" in sites
        (blame,) = [e for e in pm["events"] if e["kind"] == "scheduler.blame"]
        (quar,) = [e for e in pm["events"]
                   if e["kind"] == "scheduler.quarantine"]
        assert blame["slot"] == quar["slot"]
        assert isinstance(blame["request_id"], int)
        assert any(e["kind"] == "scheduler.iteration" for e in pm["events"])
        cfg = pm["config"]
        assert (cfg["watchdog_interval"], cfg["watchdog_grace"],
                cfg["max_restarts"]) == (0.5, 30.0, 5)
        assert any(m["name"] == "serving_engine_watchdog_trips"
                   and m["value"] == 1 for m in pm["metrics"])
    finally:
        srv.shutdown()


# ------------------------------------------------------------ key parity

HEALTH_KEYS = {"restarts", "max_restarts", "restart_budget_exhausted",
               "watchdog_trips", "quarantined_slots", "heartbeat_age",
               "overlap", "status"}
STATS_KEYS = {"step_failures", "blame_probes", "internal_errors",
              "prefill_failures", "quarantines", "quarantined_slots",
              "restarts", "watchdog_trips", "compiles", "overlap"}
CONFIG_KEYS = {"quarantine_steps", "overlap", "watchdog_interval",
               "watchdog_grace", "max_restarts", "queue_capacity",
               "prefill_chunk", "num_slots", "model"}
METRICS = {"serving_engine_restarts", "serving_engine_watchdog_trips",
           "serving_engine_degraded", "serving_scheduler_quarantined_slots",
           "serving_scheduler_step_failures", "serving_scheduler_blame_probes",
           "serving_scheduler_quarantines", "serving_step_bubble_seconds",
           "serving_overlap_efficiency", "serving_compiles",
           "serving_compile_seconds", "serving_compile_storms"}


@pytest.mark.parametrize("knobs", [
    {},
    {"quarantine_steps": 9, "watchdog_interval": 4.0, "max_restarts": 2,
     "overlap": False},
    {"watchdog_interval": 1.0, "watchdog_grace": 7.0, "restart_backoff": 0.2},
])
def test_self_healing_keys_match_jax(lms, knobs):
    """``health``/``stats`` carry the JAX engine's self-healing keys with
    the same values for the same knobs, and so do the post-mortem config
    and the registry."""
    jlm, lm, _ = lms
    jeng = JEngine(jlm, num_slots=2, prefix_cache=False, **knobs).start()
    peng = ServingEngine(lm, num_slots=2, device="cpu", **knobs).start()
    try:
        jh, ph = jeng.health(), peng.health()
        js, ps = jeng.stats(), peng.stats()
        jcfg = jeng.dump_postmortem("keys")[0]["config"]
        pcfg = peng.dump_postmortem("keys")[0]["config"]
    finally:
        jeng.stop()
        peng.stop()
    for k in HEALTH_KEYS - {"heartbeat_age"}:
        assert ph[k] == jh[k], k
    assert "heartbeat_age" in ph
    for k in STATS_KEYS - {"compiles", "overlap"}:
        assert ps[k] == js[k], k
    assert ps["compiles"].keys() == js["compiles"].keys()
    assert ps["overlap"] == js["overlap"]
    for k in CONFIG_KEYS - {"model"}:
        assert pcfg[k] == jcfg[k], k
    names = {m["name"] for m in peng.metrics_snapshot()}
    assert METRICS <= names
    assert METRICS <= {m["name"] for m in jeng.metrics_snapshot()}
