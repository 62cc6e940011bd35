"""Load shedding and the server half of ``serving.resilience`` in the port,
against the JAX package.

The JAX counterparts: ``tests/test_resilience.py``'s circuit-breaker and
admission-controller units, the shed-gate coercions and the batcher's
shed door (``:117-357``). Here the port's ``CircuitBreaker`` and
``AdmissionController`` are first driven through seeded random traces of
calls under fake clocks beside JAX's, every answer and every state dict
compared; then the same units run against the port alone; then the
engine's ``shed=`` knob (``health()["shed"]`` beside JAX's, typed
``overloaded`` sheds in process and over the wire, rung-2 clamps, the
gate surviving a restart) and its ring knobs (``flight_recorder``,
``recorder_capacity``, ``trace_ring``, ``history_interval``/
``history_capacity``, ``slo_interval``) on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    AdmissionController,
    CircuitBreaker,
    ContinuousBatcher,
    ServeRequest,
    ServingClient,
    ServingEngine,
    ServingServer,
    ShedError,
)
from distkeras_tpu_torch.serving import resilience as pres
from distkeras_tpu_torch.serving.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    as_breaker_config,
    as_shed_gate,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
TRACES_PER_CASE = 10


class Tick:
    """Injected monotonic clock: advances only when told to."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _jres():
    from distkeras_tpu.serving import resilience

    return resilience


# ---------------------------------------------- seeded traces beside JAX


def _gate_trace(rng):
    """One random call sequence for an ``AdmissionController``: sojourns
    around the target, clock steps within and past the interval, burn
    verdicts switching (and raising), admissions of every class."""
    verdicts = ["ok", "burning", "spiking", "breach", None, "weird",
                {"burn": "burning"}, {"burn": "ok"}, "raise"]
    ops = []
    for _ in range(int(rng.integers(20, 60))):
        kind = rng.choice(["note", "tick", "admit", "admit", "burn",
                           "rung", "retry", "poll", "state"])
        if kind == "note":
            ops.append(("note", float(rng.choice([0.001, 0.03, 0.049, 0.05,
                                                 0.051, 0.2, 1.5]))))
        elif kind == "tick":
            ops.append(("tick", float(rng.choice([0.0, 0.1, 0.3, 0.5, 0.6,
                                                 1.1, 2.5]))))
        elif kind == "admit":
            ops.append(("admit", int(rng.integers(0, 4)),
                        int(rng.integers(1, 200))))
        elif kind == "burn":
            ops.append(("burn", verdicts[int(rng.integers(len(verdicts)))]))
        else:
            ops.append((kind,))
    kw = {
        "target_ms": float(rng.choice([10.0, 50.0, 100.0])),
        "interval_ms": float(rng.choice([100.0, 500.0])),
        "shed_priority_max": int(rng.integers(0, 2)),
        "clamp_frac": float(rng.choice([0.1, 0.25, 1.0])),
        "burn_interval": float(rng.choice([0.0, 0.2, 1.0])),
    }
    return kw, ops


def _run_gate(mod, kw, ops):
    clk = Tick()
    verdict = {"v": "ok"}

    def burn():
        if verdict["v"] == "raise":
            raise RuntimeError("burn_fn down")
        return verdict["v"]

    g = mod.AdmissionController(clock=clk, burn_fn=burn, **kw)
    out = []
    for op in ops:
        if op[0] == "note":
            g.note_delay(op[1])
        elif op[0] == "tick":
            clk.advance(op[1])
        elif op[0] == "admit":
            out.append(("admit", g.admit(op[1], op[2])))
        elif op[0] == "burn":
            verdict["v"] = op[1]
        elif op[0] == "rung":
            out.append(("rung", g.rung()))
        elif op[0] == "retry":
            out.append(("retry", g.retry_after_ms()))
        elif op[0] == "poll":
            out.append(("poll", g.poll_transition()))
        out.append(("state", g.state()))
    return out


@pytest.mark.parametrize("case", range(10))
def test_admission_controller_traces_match_jax(case):
    """Seeded traces (10 per case): every ``admit`` answer ``(action,
    retry_after_ms, clamp)``, rung, hint, transition and ``state()`` dict
    equals JAX's under the same fake clock and burn verdicts."""
    jres = _jres()
    rng = np.random.default_rng(1600 + case)
    for _ in range(TRACES_PER_CASE):
        kw, ops = _gate_trace(rng)
        assert _run_gate(pres, kw, ops) == _run_gate(jres, kw, ops)


def _breaker_trace(rng):
    ops = []
    for _ in range(int(rng.integers(20, 60))):
        kind = rng.choice(["ok", "fail", "fail", "lat", "tick", "due",
                           "probe", "result", "snap"])
        if kind == "lat":
            ops.append(("lat", bool(rng.integers(0, 2))))
        elif kind == "tick":
            ops.append(("tick", float(rng.choice([0.1, 1.0, 2.0, 5.1,
                                                 12.0]))))
        elif kind == "probe":
            ops.append(("probe", bool(rng.integers(0, 4) == 0)))
        elif kind == "result":
            ops.append(("result", bool(rng.integers(0, 2))))
        else:
            ops.append((kind,))
    kw = {
        "window": float(rng.choice([3.0, 10.0])),
        "min_requests": int(rng.integers(1, 6)),
        "failure_threshold": float(rng.choice([0.3, 0.5, 0.9])),
        "open_secs": float(rng.choice([1.0, 5.0])),
        "outlier_trips": int(rng.integers(1, 4)),
    }
    return kw, ops


def _run_breaker(mod, kw, ops):
    clk = Tick()
    br = mod.CircuitBreaker(clock=clk, **kw)
    out = []
    for op in ops:
        if op[0] == "ok":
            out.append(br.record_success())
        elif op[0] == "fail":
            out.append(br.record_failure())
        elif op[0] == "lat":
            out.append(br.note_latency(op[1]))
        elif op[0] == "tick":
            clk.advance(op[1])
        elif op[0] == "due":
            out.append(br.probe_due())
        elif op[0] == "probe":
            out.append(br.try_probe(force=op[1]))
        elif op[0] == "result":
            out.append(br.record_probe(op[1]))
        out.append((br.state, br.opened_at, br.open_cause, br.snapshot()))
    return out


@pytest.mark.parametrize("case", range(10))
def test_circuit_breaker_traces_match_jax(case):
    """Seeded traces (10 per case): every transition, probe grant,
    ``state``/``opened_at``/``open_cause`` and ``snapshot()`` equals
    JAX's under the same fake clock."""
    jres = _jres()
    rng = np.random.default_rng(1700 + case)
    for _ in range(TRACES_PER_CASE):
        kw, ops = _breaker_trace(rng)
        assert _run_breaker(pres, kw, ops) == _run_breaker(jres, kw, ops)


def test_constants_match_jax():
    jres = _jres()
    for name in ("CLOSED", "OPEN", "HALF_OPEN", "RUNG_OK", "RUNG_SHED",
                 "RUNG_CLAMP", "RUNG_REFUSE", "BURN_RUNGS"):
        assert getattr(pres, name) == getattr(jres, name), name


@pytest.mark.parametrize("spec", [None, False, 0, True, {"target_ms": 10.0},
                                  {"target_ms": 5.0, "burn_fn": len},
                                  7, "yes", {"target_ms": -1.0},
                                  {"clamp_frac": 0.0}, {"nope": 1}],
                         ids=lambda s: repr(s)[:20])
def test_shed_gate_coercion_matches_jax(spec):
    """``as_shed_gate`` builds, passes through or refuses (the same
    exception type) as JAX's; a built gate keeps the engine's burn_fn
    unless the spec carries one."""
    jres = _jres()

    def build(mod):
        try:
            g = mod.as_shed_gate(spec, burn_fn=abs)
        except Exception as e:  # noqa: BLE001 — the type is compared
            return type(e).__name__
        if g is None:
            return None
        return (g.target, g.interval, g.clamp_frac, g.burn_fn, g.state())

    assert build(pres) == build(jres)


@pytest.mark.parametrize("spec", [None, False, True, {"window": 3.0}, 7,
                                  "x"], ids=lambda s: repr(s))
def test_breaker_config_coercion_matches_jax(spec):
    jres = _jres()

    def build(mod):
        try:
            return mod.as_breaker_config(spec)
        except Exception as e:  # noqa: BLE001 — the type is compared
            return type(e).__name__

    assert build(pres) == build(jres)


# ------------------------------------- the port alone (JAX's unit tests)


def test_breaker_error_rate_trip_probe_and_close():
    clk = Tick()
    br = CircuitBreaker(window=10.0, min_requests=4, failure_threshold=0.5,
                        open_secs=5.0, clock=clk)
    assert br.record_failure() is None
    assert br.record_failure() is None
    assert br.state == CLOSED
    br.record_success()
    assert br.record_failure() == (CLOSED, OPEN)  # 3/4 failed
    assert br.open_cause == "error_rate"
    assert not br.probe_due()
    assert br.try_probe() == (False, None)
    clk.advance(5.1)
    assert br.probe_due()
    assert br.try_probe() == (True, (OPEN, HALF_OPEN))
    assert not br.probe_due()
    assert br.try_probe() == (False, None)
    assert br.record_probe(ok=True) == (HALF_OPEN, CLOSED)
    assert br.open_cause is None
    assert br.snapshot()["window_outcomes"] == 0


def test_breaker_probe_failure_reopens_and_outlier_streak():
    clk = Tick()
    br = CircuitBreaker(window=10.0, min_requests=2, failure_threshold=0.5,
                        open_secs=5.0, clock=clk)
    br.record_failure()
    assert br.record_failure() == (CLOSED, OPEN)
    clk.advance(5.1)
    assert br.try_probe()[0]
    assert br.record_probe(ok=False) == (HALF_OPEN, OPEN)
    assert br.open_cause == "probe_failed" and not br.probe_due()
    clk.advance(5.1)
    assert br.probe_due()
    lat = CircuitBreaker(outlier_trips=3, open_secs=5.0, clock=clk)
    assert lat.note_latency(True) is None
    assert lat.note_latency(True) is None
    assert lat.note_latency(False) is None  # streak reset
    lat.note_latency(True)
    lat.note_latency(True)
    assert lat.note_latency(True) == (CLOSED, OPEN)
    assert lat.open_cause == "latency_outlier"
    assert as_breaker_config(True) == {}
    with pytest.raises(TypeError):
        as_breaker_config(7)


def test_admission_codel_latch_and_stale_evidence():
    clk = Tick()
    g = AdmissionController(target_ms=50.0, interval_ms=500.0, clock=clk)
    g.note_delay(0.2)
    assert g.rung() == 0  # one spike does not latch
    clk.advance(0.3)
    g.note_delay(0.2)
    assert g.rung() == 0
    clk.advance(0.3)
    g.note_delay(0.2)
    assert g.rung() == 1
    assert g.admit(0, 64)[0] == "shed"
    assert g.admit(1, 64)[0] == "admit"  # a higher class rides through
    g.note_delay(0.01)  # one below-target sojourn releases the latch
    assert g.rung() == 0
    clk.advance(0.6)
    g.note_delay(0.2)
    clk.advance(0.6)
    g.note_delay(0.2)
    assert g.rung() == 1
    clk.advance(1.1)  # no admissions for two intervals: stale
    assert g.rung() == 0


def test_admission_burn_ladder_clamp_and_refuse():
    clk = Tick()
    verdict = {"burn": "ok"}
    g = AdmissionController(target_ms=50.0, interval_ms=500.0,
                            burn_fn=lambda: verdict, burn_interval=0.0,
                            clamp_frac=0.25, clock=clk)
    assert g.admit(0, 64) == ("admit", None, None)
    verdict = {"burn": "burning"}
    act, hint, clamp = g.admit(0, 64)
    assert act == "shed" and hint >= 25.0 and clamp is None
    assert g.poll_transition() == (0, 1)
    assert g.poll_transition() is None
    verdict = {"burn": "spiking"}
    assert g.admit(3, 64) == ("admit", None, 16)
    verdict = {"burn": "breach"}
    act, hint, _ = g.admit(9, 64)
    assert act == "refuse" and hint >= 25.0
    st = g.state()
    assert st["rung"] == 3 and st["burn_rung"] == 3
    g2 = AdmissionController(burn_fn=lambda: 1 / 0, burn_interval=0.0,
                             clock=clk)
    assert g2.admit(0, 64)[0] == "admit"  # a crashing burn_fn is neutral
    assert as_shed_gate(None) is None and as_shed_gate(False) is None
    assert isinstance(as_shed_gate(True), AdmissionController)
    inst = AdmissionController()
    assert as_shed_gate(inst) is inst


class FakeStepper:
    """Slot ``i`` emits ``1000 + i*100 + n`` for its n-th token."""

    def __init__(self, num_slots=2, max_len=32):
        self.num_slots, self.max_len = num_slots, max_len
        self._n = np.zeros(num_slots, int)

    def begin_admit(self, slot, prompt, **kw):
        self._n[slot] = 0
        return 0

    def prefill_chunk(self, slot, budget):
        return 0

    def release(self, slot):
        pass

    def step(self, active):
        out = np.zeros(self.num_slots, np.int64)
        for i in np.flatnonzero(active):
            out[i] = 1000 + i * 100 + self._n[i]
            self._n[i] += 1
        return out


def _req(max_new=4, **kw):
    return ServeRequest(np.arange(1, 4), max_new, **kw)


def test_batcher_shed_gate_refuses_typed_and_clamps():
    """JAX's scripted drive on the port's batcher: the door sheds typed
    ``overloaded`` with the gate's hint, lets a higher class through,
    clamps at rung 2, refuses all at rung 3, and counts each; the rung
    changes land one ``scheduler.shed_rung`` event each."""
    from distkeras_tpu_torch.obs import FlightRecorder

    clk = Tick()
    verdict = {"burn": "ok"}
    gate = AdmissionController(target_ms=50.0, burn_fn=lambda: verdict,
                               burn_interval=0.0, clamp_frac=0.25,
                               clock=clk)
    rec = FlightRecorder()
    b = ContinuousBatcher(FakeStepper(num_slots=2), queue_capacity=8,
                          shed_gate=gate, recorder=rec)
    b.submit(_req(max_new=2))
    verdict = {"burn": "burning"}
    with pytest.raises(ShedError) as ei:
        b.submit(_req(max_new=2, priority=0))
    assert ei.value.code == "overloaded"
    assert ei.value.retry_after_ms == gate.retry_after_ms() >= 25.0
    assert b.submit(_req(max_new=8, priority=2)).max_new_tokens == 8
    verdict = {"burn": "spiking"}
    assert b.submit(_req(max_new=8, priority=2)).max_new_tokens == 2
    verdict = {"burn": "breach"}
    with pytest.raises(ShedError):
        b.submit(_req(max_new=2, priority=9))
    s = b.stats()
    assert s["shed_overloaded"] == 2 and s["shed_clamped"] == 1
    rungs = [(e["old"], e["new"]) for e in rec.snapshot()
             if e["kind"] == "scheduler.shed_rung"]
    assert rungs == [(0, 1), (1, 2), (2, 3)]


def test_batcher_shed_gate_sees_queue_sojourn():
    clk = Tick()
    gate = AdmissionController(target_ms=50.0, clock=clk)
    b = ContinuousBatcher(FakeStepper(num_slots=1), queue_capacity=8,
                          shed_gate=gate)
    b.submit(_req(max_new=2))
    b.step()  # admits: a sojourn ~0, below target, no latch
    assert gate.state()["sojourn_ms"] is not None
    assert not gate.state()["shedding"]


# -------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _engine(lm, **kw):
    return ServingEngine(lm, num_slots=2, prefix_cache=False, device="cpu",
                         **kw).start()


def test_engine_shed_health_and_gauge_match_jax(lms):
    """``health()["shed"]`` carries JAX's keys and values, the
    ``serving_shed_rung`` gauge appears with the gate and only with it, and
    the postmortem config names the gate's state."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm = lms
    books = {}
    for side, make in (("torch", lambda **k: _engine(lm, **k)),
                       ("jax", lambda **k: JEngine(
                           jlm, num_slots=2, prefix_cache=False, **k
                       ).start())):
        eng, plain = make(shed=True), make()
        try:
            h = eng.health()
            names = {m["name"] for m in eng.metrics_snapshot()}
            plain_names = {m["name"] for m in plain.metrics_snapshot()}
            books[side] = (h["shed"], "shed" in plain.health(),
                           "serving_shed_rung" in names,
                           "serving_shed_rung" in plain_names,
                           eng.dump_postmortem("probe")[0]["config"]["shed"])
        finally:
            eng.stop()
            plain.stop()
    assert books["torch"] == books["jax"]
    assert books["torch"][2] and not books["torch"][1]


def test_engine_sheds_typed_and_clamps_to_a_prefix(lms):
    """A declared brownout on the engine's gate: priority 0 is shed typed
    ``overloaded`` with the gate's ``retry_after_ms`` in [25, 5000],
    priority 2 rides through with the unshed reply, a rung-2 clamp gives
    an exact prefix of it, and the live rung returns to 0 when the burn
    clears; ``health()["shed"]`` and the gauge agree throughout."""
    _, lm = lms
    p = np.arange(3, 11)
    ref_eng = _engine(lm)
    try:
        ref = ref_eng.generate(p, 12, timeout=60)
    finally:
        ref_eng.stop()
    eng = _engine(lm, shed=dict(burn_interval=0.0))
    gate = eng.shed_gate
    gauge = lambda: next(m["value"] for m in eng.metrics_snapshot()  # noqa: E731
                         if m["name"] == "serving_shed_rung")
    try:
        assert eng.generate(p, 12, priority=0, timeout=60).tolist() \
            == ref.tolist()
        gate.burn_fn = lambda: "burning"
        with pytest.raises(ShedError) as ei:
            eng.generate(p, 12, priority=0, timeout=60)
        assert ei.value.code == "overloaded"
        assert 25.0 <= ei.value.retry_after_ms <= 5000.0
        hi = eng.generate(p, 12, priority=2, timeout=60)
        assert hi.tolist() == ref.tolist()
        assert eng.health()["shed"]["rung"] == gauge() == 1
        gate.burn_fn = lambda: "spiking"
        clamped = eng.generate(p, 12, priority=2, timeout=60)
        assert len(clamped) == p.size + 3  # 12 * 0.25
        assert clamped.tolist() == ref[: clamped.size].tolist()
        assert eng.health()["shed"]["rung"] == gauge() == 2
        gate.burn_fn = lambda: "ok"
        assert gate.rung() == 0
        assert eng.generate(p, 12, priority=0, timeout=60).tolist() \
            == ref.tolist()
        st = eng.stats()
        assert st["shed_overloaded"] == 1 and st["shed_clamped"] == 1
        assert eng.health()["shed"]["rung"] == gauge() == 0
    finally:
        eng.stop()


def test_engine_shed_over_the_wire(lms):
    """A shed over TCP arrives as ``overloaded`` with the gate's own
    ``retry_after_ms`` (not the server's default hint)."""
    _, lm = lms
    eng = _engine(lm, shed=dict(burn_interval=0.0))
    srv = ServingServer(eng, retry_after_ms=7.0).start()
    cli = ServingClient(srv.host, srv.port, retry=False, connect_timeout=5)
    try:
        p = np.arange(3, 9)
        ok = cli.generate(p, 4)
        eng.shed_gate.burn_fn = lambda: "burning"
        with pytest.raises(Exception) as ei:
            cli.generate(p, 4, priority=0)
        assert ei.value.code == "overloaded"
        assert ei.value.retry_after * 1e3 == pytest.approx(
            eng.shed_gate.retry_after_ms())
        assert ei.value.retry_after * 1e3 >= 25.0
        assert cli.generate(p, 4, priority=1).tolist() == ok.tolist()
    finally:
        cli.close()
        srv.shutdown()
        eng.stop()


def test_shed_gate_survives_a_restart(lms):
    """A crashed scheduler's rebuilt batcher keeps the engine's gate (its
    history is evidence about the host, not one batcher)."""
    _, lm = lms
    eng = _engine(lm, shed=True, restart_backoff=0.0)
    gate = eng.shed_gate
    try:
        with faults.FaultPlan().arm("scheduler.loop", times=1):
            deadline = 200
            while eng.health()["restarts"] < 1 and deadline:
                eng.batcher._work.set()
                import time

                time.sleep(0.05)
                deadline -= 1
        assert eng.health()["restarts"] == 1
        assert eng.batcher.shed_gate is gate and eng.shed_gate is gate
        assert eng.generate(np.arange(2, 7), 3, timeout=60).size == 8
    finally:
        eng.stop()


def test_ring_knobs_keep_the_newest_events(lms):
    """``recorder_capacity`` bounds the flight recorder to the newest N
    events (JAX's ring: same events, same order), ``trace_ring`` the span
    ring, ``history_interval``/``history_capacity`` the history,
    ``slo_interval`` the SLO evaluator; ``flight_recorder=False`` serves
    without a recorder."""
    from distkeras_tpu.obs import FlightRecorder as JRecorder

    from distkeras_tpu_torch.obs import SloSpec

    _, lm = lms
    slo = [SloSpec("ttft", "serving_request_ttft_seconds", 1.0, agg="p99")]
    eng = _engine(lm, recorder_capacity=16, trace_ring=32,
                  history_interval=0.25, history_capacity=40, slos=slo,
                  slo_interval=0.5)
    jrec = JRecorder(capacity=16)
    try:
        for i in range(50):
            eng.recorder.record("probe.event", i=i)
            jrec.record("probe.event", i=i)
        got = [(e["kind"], e.get("i")) for e in eng.recorder.snapshot()]
        want = [(e["kind"], e.get("i")) for e in jrec.snapshot()]
        assert got == want and len(got) == 16 and got[-1] == ("probe.event",
                                                                49)
        assert eng.trace_collector.capacity == 32
        assert eng.history.interval == 0.25
        assert eng.history.capacity == 40
        assert eng.slo.interval == 0.5
    finally:
        eng.stop()
    quiet = _engine(lm, flight_recorder=False)
    try:
        assert quiet.recorder is None
        assert quiet.generate(np.arange(2, 7), 3, timeout=60).size == 8
        assert quiet.dump_postmortem("probe")[0]["events"] == []
    finally:
        quiet.stop()
