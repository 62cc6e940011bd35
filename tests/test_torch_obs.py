"""The port's ``obs`` books (copies of the JAX package's ``obs.metrics``,
``obs.recorder``, ``obs.slo`` and ``obs.timeseries``) against the JAX
package on the CPU: the same operations on both packages' objects give
equal snapshots, equal Prometheus text, equal time-series digests under
an injected clock, equal flight-recorder rings and equal post-mortem
bundles (the wall clock pinned where a timestamp is recorded). All
comparisons are exact: both sides do the same pure-Python arithmetic."""

import itertools
import json

import pytest

from distkeras_tpu import faults as jfaults
from distkeras_tpu import obs as jobs
from distkeras_tpu_torch import faults, obs


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


@pytest.fixture
def pinned_time(monkeypatch):
    """``time.time`` as a counter; calling the fixture's value restarts
    it, so both packages' recorders stamp the same values."""
    ticks = [itertools.count(1)]

    def restart():
        ticks[0] = itertools.count(1)

    monkeypatch.setattr("time.time", lambda: 1.7e9 + next(ticks[0]) * 0.25)
    return restart


def _drive(mod, step):
    """One registry, mutated by ``step`` operations: counters, a group,
    labeled and unlabeled histograms, set and callback gauges."""
    reg = mod.MetricsRegistry()
    grp = reg.group("training_ps", ("pulls", "commits"))
    hist = reg.histogram("training_ps_commit_interval_seconds", start=1e-3)
    lab = reg.histogram("training_ps_commit_interval_seconds",
                        labels={"worker": "1"}, start=1e-3)
    gauge = reg.gauge("training_ps_replicas")
    state = {"n": 0}
    reg.gauge("training_ps_updates", fn=lambda: state["n"])
    reg.gauge("training_ps_straggler", fn=lambda: None)
    esc = reg.counter("odd_total", labels={"path": 'a"b\\c\nd'})
    for i in range(step):
        grp.inc("pulls")
        if i % 3:
            grp["commits"] += 2
        hist.observe(0.0005 * (i + 1) ** 2)
        if i % 2:
            lab.observe(0.01 * i)
        gauge.set(i % 4)
        state["n"] = i
        esc.inc()
    return reg


@pytest.mark.parametrize("steps", [0, 1, 37])
def test_registry_snapshot_and_prometheus_text_equal_jax(steps):
    port, jax_reg = _drive(obs, steps), _drive(jobs, steps)
    snap, jsnap = port.snapshot(), jax_reg.snapshot()
    assert snap == jsnap
    text = obs.render_prometheus(snap)
    assert text == jobs.render_prometheus(jsnap)
    # a gauge without a value renders NaN: compare the parses by repr
    assert (repr(obs.parse_prometheus(text))
            == repr(jobs.parse_prometheus(text)))
    names = {name for name, _, _ in obs.parse_prometheus(text)}
    assert "training_ps_pulls_total" in names
    assert any(n.endswith("_bucket") for n in names)


def test_counter_group_and_registration_rules():
    reg = obs.MetricsRegistry(namespace="ns")
    g = reg.group("x", ("a", "b"))
    g["a"] += 3
    g.inc("b")
    assert dict(g) == {"a": 3, "b": 1}
    assert reg.counter("x_a") is g.counter("a")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_a")
    fresh = reg.group("x", ("a",))
    assert fresh["a"] == 0 and g["a"] == 3
    with pytest.raises(KeyError):
        g["missing"] += 1
    assert [s["name"] for s in reg.snapshot()] == ["ns_x_a", "ns_x_b"]
    labeled = obs.label_samples(reg.snapshot(), replica="h:1")
    assert labeled == jobs.label_samples(reg.snapshot(), replica="h:1")


def _history(mod, clock):
    reg = _drive(mod, 0)
    grp = mod.CounterGroup({"commits": reg.counter("training_ps_commits")})
    hist = reg.histogram("training_ps_commit_interval_seconds", start=1e-3)
    h = mod.MetricsHistory(reg.snapshot, interval=1.0, capacity=64,
                           clock=clock)
    return reg, grp, hist, h


def test_history_digest_equal_jax_under_an_injected_clock():
    """60 ticks of commits, a counter reset and interval observations:
    every windowed query and the digest (rates, quantiles, trend, points)
    equal JAX's exactly."""
    ca, cb = FakeClock(), FakeClock()
    _, ga, ha, hist_a = _history(obs, ca)
    _, gb, hb, hist_b = _history(jobs, cb)
    for i in range(60):
        for g, h in ((ga, ha), (gb, hb)):
            g.inc("commits", 1 + i % 5)
            h.observe(0.002 * (1 + i % 7))
        if i == 40:  # a restarted component's counter starts at zero
            ga.counter("commits").value = 0
            gb.counter("commits").value = 0
        assert hist_a.maybe_snap() == hist_b.maybe_snap()
        ca.tick(1.0)
        cb.tick(1.0)
    for window in (10.0, 30.0, 600.0):
        for fn, args in (("rate", ("training_ps_commits",)),
                         ("increase", ("training_ps_commits",)),
                         ("trend", ("training_ps_commits",)),
                         ("ewma", ("training_ps_commits",)),
                         ("quantile_over",
                          ("training_ps_commit_interval_seconds",))):
            extra = (0.99,) if fn == "quantile_over" else ()
            a = getattr(hist_a, fn)(*args, window, *extra)
            b = getattr(hist_b, fn)(*args, window, *extra)
            assert a == b, (fn, window)
        da = hist_a.digest(window=window, points=12)
        db = hist_b.digest(window=window, points=12)
        assert da == db
        assert json.loads(json.dumps(da)) == da
    assert hist_a.rate("training_ps_commits", 30.0) > 0
    specs = obs.default_training_slos(straggler_ratio=2.0,
                                      commit_interval_p99_s=0.01,
                                      gate_refusal_rate=0.1, min_count=4)
    jspecs = jobs.default_training_slos(straggler_ratio=2.0,
                                        commit_interval_p99_s=0.01,
                                        gate_refusal_rate=0.1, min_count=4)
    assert hist_a.burn(specs) == hist_b.burn(jspecs)


def test_slo_evaluation_equal_jax():
    port, jax_reg = _drive(obs, 25), _drive(jobs, 25)
    for kw in ({"straggler_ratio": 1.5},
               {"commit_interval_p99_s": 0.05, "min_count": 2},
               {"commit_interval_p99_s": 0.5, "min_count": 2},
               {"gate_refusal_rate": 0.5, "min_count": 2}):
        a = obs.evaluate_slos(port.snapshot(),
                              obs.default_training_slos(**kw))
        b = jobs.evaluate_slos(jax_reg.snapshot(),
                               jobs.default_training_slos(**kw))
        assert a == b
    spec = obs.SloSpec("p99", "training_ps_commit_interval_seconds", 0.05,
                       agg="p99", warn=0.01, min_count=2)
    jspec = jobs.SloSpec("p99", "training_ps_commit_interval_seconds", 0.05,
                         agg="p99", warn=0.01, min_count=2)
    assert spec.describe() == jspec.describe()
    assert (obs.evaluate_slos(port.snapshot(), [spec])
            == jobs.evaluate_slos(jax_reg.snapshot(), [jspec]))


def _recorder(mod, fl):
    rec = mod.FlightRecorder(capacity=8)
    reg = mod.MetricsRegistry()
    rec.register_gauges(reg, "training")
    fl.add_observer(rec.fault_observer)
    plan = fl.FaultPlan(seed=3).arm("ps.commit", times=2, after=9)
    try:
        with plan:
            for i in range(12):
                rec.record("ps.commit", position=i, commit_id=[0, i],
                           via="client")
                try:
                    fl.fire("ps.commit", commit_id=(0, i), tag=None,
                            mask=[True, False] * 50)
                except fl.InjectedFault:
                    rec.record("ps.rejected", position=i)
            bundle = mod.build_postmortem(
                "parameter_server", "promotion", recorder=rec,
                metrics=reg.snapshot(), in_flight=[{"worker_id": 0}],
                config={"role": "primary"}, detail={"reason": "test"},
            )
    finally:
        fl.remove_observer(rec.fault_observer)
    return rec, reg, bundle


def test_flight_recorder_ring_and_bundle_equal_jax(pinned_time):
    rec, reg, bundle = _recorder(obs, faults)
    pinned_time()
    jrec, jreg, jbundle = _recorder(jobs, jfaults)
    assert rec.snapshot() == jrec.snapshot()
    assert len(rec.snapshot()) == 8
    assert rec.overwrites == jrec.overwrites == rec.events_recorded - 8
    assert reg.snapshot() == jreg.snapshot()
    assert [e["position"] for e in rec.events("ps.rejected")] == [9, 10]
    assert len(rec.events("fault.fired")) == 2
    assert bundle == jbundle
    assert bundle["schema"] == obs.POSTMORTEM_SCHEMA
    assert [s["site"] for s in bundle["fault_seams"]] == ["ps.commit"]


def test_dump_postmortem_writes_and_finds_the_newest(tmp_path, pinned_time):
    rec = obs.FlightRecorder(capacity=4)
    rec.record("ps.promoted", reason="primary-lost", position=7)
    first, p1 = obs.dump_postmortem(str(tmp_path), "parameter_server",
                                    "promotion", recorder=rec)
    second, p2 = obs.dump_postmortem(str(tmp_path), "parameter_server",
                                     "stand_down", recorder=rec)
    assert p1 != p2 and p2.endswith(".json")
    latest, path = obs.latest_postmortem(str(tmp_path))
    assert path == p2 and latest["reason"] == "stand_down"
    assert latest == json.loads(json.dumps(second))
    # the JAX reader reads the port's bundles
    jlatest, jpath = jobs.latest_postmortem(str(tmp_path))
    assert jpath == p2 and jlatest == latest
    mem, none = obs.dump_postmortem(None, "parameter_server", "promotion")
    assert none is None and mem["events"] == []
    assert obs.latest_postmortem(str(tmp_path / "nowhere")) == (None, None)
