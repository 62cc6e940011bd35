"""The port's autoscaler and deploy loop, against the JAX package.

The JAX counterparts: ``tests/test_autoscale.py:86-506,632-651`` (the pure
policy under a fake clock, the ``Autoscaler``'s tick order with a
duck-typed controller, ``BundlePublisher``/``ContinuousDeployer`` down to
the atomic rename, the autoscaler thread's lifecycle). Here: the port's
``AutoscalePolicy`` and JAX's are fed the same fake-clock signal sequences
and must decide alike, tick for tick; the autoscaler, publisher and
deployer cases run on the port's own books and parameter server; a
bundle the port's publisher writes loads in JAX's ``load_serving_bundle``;
and a real-LM fleet scales up (warmed before it joins, 0 storms), scales
down (0 failed requests) and has a killed replica reaped and replaced in
one tick.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs.metrics import MetricsRegistry
from distkeras_tpu_torch.obs.recorder import FlightRecorder
from distkeras_tpu_torch.obs.timeseries import (
    BURN_BREACH,
    BURN_BURNING,
    BURN_OK,
)
from distkeras_tpu_torch.serving import (
    AutoscalePolicy,
    Autoscaler,
    BundlePublisher,
    ContinuousDeployer,
    FleetController,
    ReplicaSignals,
    signals_from_router,
)
from distkeras_tpu_torch.serving import autoscale
from distkeras_tpu_torch.serving.autoscale import HOLD, SCALE_DOWN, SCALE_UP

torch.set_num_threads(2)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def sig(ep=0, state="active", util=0.0, cls=ReplicaSignals, **kw):
    """A replica signal whose utilization is exactly ``util`` (queue fill
    drives it; slots and pool left neutral)."""
    return cls(endpoint=("127.0.0.1", 9000 + ep), state=state,
               queue_depth=int(round(util * 100)), queue_capacity=100, **kw)


def policy(clock, cls=AutoscalePolicy, **kw):
    base = dict(min_replicas=1, max_replicas=4, up_threshold=0.75,
                down_threshold=0.25, up_ticks=2, down_ticks=2,
                up_cooldown=10.0, down_cooldown=30.0, clock=clock)
    base.update(kw)
    return cls(**base)


# ------------------------------------ the policy, tick for tick against JAX


def _random_walk(seed, ticks=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        n = int(rng.integers(1, 6))
        fleet = []
        for i in range(n):
            kw = {"util": float(rng.choice([0.0, 0.1, 0.3, 0.5, 0.8, 0.95]))}
            if rng.random() < 0.1:
                kw["state"] = str(rng.choice(["draining", "ejected",
                                              "joining"]))
            if rng.random() < 0.15:
                kw["burn"] = str(rng.choice(["ok", "burning", "spiking",
                                             "breach"]))
            if rng.random() < 0.1:
                kw["pool_exhausted_rate"] = float(rng.random())
            if rng.random() < 0.1:
                kw["queue_depth_trend"] = float(rng.normal())
            if rng.random() < 0.1:
                kw["kv_page_util"] = float(rng.random())
            fleet.append((i, kw))
        out.append((float(rng.choice([0.5, 1.0, 5.0, 20.0])), fleet))
    return out


def _steady(fleet, ticks, dt=1.0):
    return [(dt, fleet)] * ticks


# name -> (policy kwargs, [(clock advance, [(endpoint, signal kwargs)])])
SCENARIOS = {
    "breach_immediate": ({}, [(0.0, [(0, {"util": 0.1, "burn": BURN_BREACH})])]),
    "up_cooldown_gates_breach": ({}, [
        (0.0, [(0, {"burn": BURN_BREACH})]),
        (5.0, [(0, {"burn": BURN_BREACH}), (1, {"burn": BURN_BREACH})]),
        (5.0, [(0, {"burn": BURN_BREACH}), (1, {"burn": BURN_BREACH})])]),
    "pressure_streak": ({"up_ticks": 3},
                        _steady([(0, {"util": 0.9})], 3)),
    "hysteresis_band": ({"up_ticks": 1, "down_ticks": 1,
                         "down_cooldown": 0.0},
                        _steady([(0, {"util": 0.5}), (1, {"util": 0.5})],
                                20, dt=5.0)),
    "oscillation": ({}, [(1.0, [(0, {"util": 0.9 if i % 2 == 0 else 0.5})])
                         for i in range(10)]),
    "below_min": ({"min_replicas": 2, "up_cooldown": 1e9}, [
        (0.0, [(0, {"burn": BURN_BREACH})]), (0.0, [(0, {})])]),
    "above_max": ({"max_replicas": 2}, [(0.0, [
        (0, {"util": 0.3}), (1, {"util": 0.1}), (2, {"util": 0.9})])]),
    "at_max_breach": ({"max_replicas": 2}, [(0.0, [
        (0, {"burn": BURN_BREACH}), (1, {"burn": BURN_BREACH})])]),
    "min_equals_max": ({"min_replicas": 2, "max_replicas": 2, "up_ticks": 1},
                       [(0.0, [(0, {})]),
                        (0.0, [(0, {"util": 0.99}), (1, {"util": 0.99})])]),
    "least_loaded_down": ({"down_ticks": 1, "down_cooldown": 0.0}, [(0.0, [
        (0, {"util": 0.2}), (1, {"util": 0.0}), (2, {"util": 0.1})])]),
    "down_cooldown_after_up": ({"up_ticks": 1, "down_ticks": 1,
                                "down_cooldown": 30.0, "up_cooldown": 0.0}, [
        (0.0, [(0, {"util": 0.9})]),
        (10.0, [(0, {"util": 0.0}), (1, {"util": 0.0})]),
        (30.0, [(0, {"util": 0.0}), (1, {"util": 0.0})])]),
    "rising_trend_blocks_down": ({"down_ticks": 1, "down_cooldown": 0.0}, [
        (0.0, [(0, {"util": 0.0, "queue_depth_trend": 2.5}),
               (1, {"util": 0.0})])]),
    "pool_exhaustion": ({"up_ticks": 1}, [
        (0.0, [(0, {"util": 0.0, "pool_exhausted_rate": 0.5})])]),
    "non_ok_burn": ({"up_ticks": 1}, [
        (0.0, [(0, {"util": 0.0, "burn": BURN_BURNING})])]),
    "draining_not_counted": ({"min_replicas": 2}, [
        (0.0, [(0, {}), (1, {"state": "draining"})])]),
    "at_min_idle": ({"down_ticks": 1, "down_cooldown": 0.0},
                    [(0.0, [(0, {"util": 0.0})])]),
    "kv_pool_pressure": ({"up_ticks": 2, "up_cooldown": 3.0},
                         _steady([(0, {"kv_page_util": 0.8}),
                                  (1, {"util": 0.7})], 8)),
    "walk_0": ({"max_replicas": 5, "down_ticks": 1, "down_cooldown": 5.0},
               _random_walk(0)),
    "walk_1": ({"max_replicas": 3, "up_ticks": 1, "down_ticks": 3,
                "down_cooldown": 10.0}, _random_walk(1)),
    "walk_2": ({"min_replicas": 2, "exhaustion_rate": 0.3,
                "trend_slope": 0.5}, _random_walk(2)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_policy_decides_like_jax(name):
    from distkeras_tpu.serving.autoscale import AutoscalePolicy as JPolicy
    from distkeras_tpu.serving.autoscale import ReplicaSignals as JSignals

    kw, steps = SCENARIOS[name]
    runs = {}
    for pkg, pcls, scls in (("port", AutoscalePolicy, ReplicaSignals),
                            ("jax", JPolicy, JSignals)):
        clk = FakeClock()
        p = policy(clk, cls=pcls, **kw)
        out = []
        for dt, fleet in steps:
            clk.advance(dt)
            d = p.decide([sig(i, cls=scls, **s) for i, s in fleet])
            out.append((d.action, d.reason, d.replicas, d.utilization,
                        d.burn, d.target))
        runs[pkg] = out
    assert runs["port"] == runs["jax"]
    if name.startswith("walk"):  # the walks reach every row's action
        assert {a for a, *_ in runs["port"]} == {SCALE_UP, SCALE_DOWN, HOLD}


def test_policy_reasons_pinned():
    """The decision table's rows, read off the shared scenarios."""
    def last(name):
        kw, steps = SCENARIOS[name]
        clk = FakeClock()
        p = policy(clk, **kw)
        d = None
        for dt, fleet in steps:
            clk.advance(dt)
            d = p.decide([sig(i, **s) for i, s in fleet])
        return d

    assert (last("breach_immediate").action,
            last("breach_immediate").reason) == (SCALE_UP, "slo_breach")
    assert last("pressure_streak").reason == "pressure:utilization"
    assert (last("below_min").action, last("below_min").reason) == (
        SCALE_UP, "below_min")
    d = last("above_max")
    assert (d.action, d.reason, d.target) == (
        SCALE_DOWN, "above_max", ("127.0.0.1", 9001))
    assert last("at_max_breach").reason == "at_max"
    assert last("least_loaded_down").target == ("127.0.0.1", 9001)
    assert last("down_cooldown_after_up").action == SCALE_DOWN
    assert last("rising_trend_blocks_down").action == HOLD
    assert last("pool_exhaustion").reason == "pressure:pool_exhausted"
    assert last("non_ok_burn").reason == "pressure:burn_burning"
    assert last("draining_not_counted").reason == "below_min"
    assert last("at_min_idle").reason == "at_min"


def test_constructor_validates_bounds_and_gap():
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscalePolicy(up_threshold=0.3, down_threshold=0.5)


def test_utilization_and_signals_from_router_like_jax():
    from distkeras_tpu.serving.autoscale import (
        signals_from_router as j_signals,
    )

    s = ReplicaSignals(endpoint=("h", 1), in_flight=1, capacity=4,
                       queue_depth=1, queue_capacity=100, kv_page_util=0.9)
    assert s.utilization() == 0.9

    class R:
        def replicas(self):
            return [{"endpoint": ["127.0.0.1", 9100], "state": "active",
                     "in_flight": 2, "capacity": 4, "queue_depth": 3,
                     "queue_capacity": 8, "kv_page_util": 0.5,
                     "pool_exhausted_rate": 0.0, "queue_depth_trend": 1.5,
                     "burn": BURN_OK}]

    (p,), (j,) = signals_from_router(R()), j_signals(R())
    assert p.endpoint == j.endpoint == ("127.0.0.1", 9100)
    assert p.utilization() == j.utilization() == 0.5
    assert vars(p) == vars(j)


# ------------------------------------------------------- the autoscaler


class FakeReplica:
    def __init__(self, endpoint):
        self.endpoint = endpoint


class FakeRouter:
    def __init__(self, controller):
        self.registry = MetricsRegistry()
        self.recorder = FlightRecorder()
        self._ctl = controller

    def replicas(self):
        return [{"endpoint": list(r.endpoint), "state": "active",
                 "queue_depth": 0, "queue_capacity": 100}
                for r in self._ctl.replicas]


class FakeController:
    """Duck-typed FleetController: the books the autoscaler reads, the call
    order it must keep, the failures it must absorb."""

    def __init__(self, n=2, dead=()):
        self.replicas = [FakeReplica(("127.0.0.1", 9200 + i))
                         for i in range(n)]
        self._dead = set(dead)
        self.calls = []
        self.router = FakeRouter(self)
        self.fail_scale_up = False
        self._next = 9200 + n

    def reap_dead(self):
        self.calls.append("reap_dead")
        reaped = [r for r in self.replicas if r.endpoint[1] in self._dead]
        self.replicas = [r for r in self.replicas
                         if r.endpoint[1] not in self._dead]
        self._dead.clear()
        return reaped

    def scale_up(self, n=1):
        self.calls.append("scale_up")
        if self.fail_scale_up:
            raise RuntimeError("boot failed")
        added = [FakeReplica(("127.0.0.1", self._next))]
        self._next += 1
        self.replicas.extend(added)
        return added

    def scale_down(self, endpoint=None):
        self.calls.append(("scale_down", endpoint))
        self.replicas = [r for r in self.replicas
                         if r.endpoint != tuple(endpoint)]


def test_reap_and_replace_in_the_same_tick():
    clk = FakeClock()
    ctl = FakeController(n=2, dead={9201})
    sc = Autoscaler(ctl, policy(clk, min_replicas=2, max_replicas=2),
                    interval=1.0, clock=clk)
    d = sc.tick()
    assert (d.action, d.reason) == (SCALE_UP, "below_min")
    assert ctl.calls == ["reap_dead", "scale_up"]
    assert len(ctl.replicas) == 2
    assert sc._counters["reaps"] == 1 and sc._counters["scale_ups"] == 1
    kinds = [e["kind"] for e in ctl.router.recorder.snapshot()]
    assert kinds.index("autoscale.reap") < kinds.index("autoscale.scale_up")


def test_deploys_run_on_hold_ticks_only():
    clk = FakeClock()
    pending = [{"version": 1, "path": "/x", "ledger": {"replaced": [1, 2]}}]

    class D:
        calls = 0

        def maybe_deploy(self):
            D.calls += 1
            return pending.pop() if pending else None

    ctl = FakeController(n=1)
    sc = Autoscaler(ctl, policy(clk, min_replicas=2), interval=1.0,
                    deployer=D(), clock=clk)
    assert sc.tick().action == SCALE_UP
    assert D.calls == 0 and sc.last_deploy is None
    assert sc.tick().action == HOLD
    assert D.calls == 1 and sc.last_deploy["version"] == 1
    assert sc._counters["deploys"] == 1
    assert "autoscale.deploy" in [e["kind"]
                                  for e in ctl.router.recorder.snapshot()]


def test_actuation_failure_counted_never_raised():
    clk = FakeClock()
    ctl = FakeController(n=1)
    ctl.fail_scale_up = True
    sc = Autoscaler(ctl, policy(clk, min_replicas=2), interval=1.0,
                    clock=clk)
    assert sc.tick().action == SCALE_UP
    assert sc._counters["errors"] == 1 and sc._counters["scale_ups"] == 0
    assert any(e["kind"] == "autoscale.error"
               for e in ctl.router.recorder.snapshot())


def test_maybe_tick_is_cadence_guarded():
    clk = FakeClock()
    sc = Autoscaler(FakeController(n=1), policy(clk), interval=10.0,
                    clock=clk)
    assert sc.maybe_tick() is not None
    clk.advance(5.0)
    assert sc.maybe_tick() is None
    clk.advance(5.0)
    assert sc.maybe_tick() is not None
    assert sc.ticks == 2


def test_tick_before_controller_start_raises():
    class Stopped:
        router = None

    with pytest.raises(RuntimeError):
        Autoscaler(Stopped(), policy(FakeClock())).tick()


def test_autoscaler_thread_start_shutdown_idempotent():
    clk = FakeClock()
    sc = Autoscaler(FakeController(n=1), policy(clk), interval=0.01)
    done = threading.Event()
    orig = sc.tick

    def tick():
        try:
            return orig()
        finally:
            done.set()

    sc.tick = tick
    with sc:
        assert sc.start() is sc
        assert done.wait(5.0)
    assert sc._thread is None
    sc.shutdown()


# --------------------------------------- publisher / deployer (the CD leg)


class FakePS:
    def __init__(self):
        self.listener = None
        self.every = None

    def add_snapshot_listener(self, cb, every=1):
        self.listener, self.every = cb, every

    def remove_snapshot_listener(self, cb):
        if self.listener == cb:
            self.listener = None


def test_publisher_atomic_rename_and_monotonic_versions(tmp_path):
    ps = FakePS()

    def build(center, meta, path):
        with open(path, "w") as f:
            f.write(f"v{meta['n']}")

    pub = BundlePublisher(ps, build, str(tmp_path), every=2)
    assert ps.every == 2 and pub.latest() is None
    ps.listener(2, {"w": 1}, {"n": 2}, {})
    ps.listener(4, {"w": 2}, {"n": 4}, {})
    latest = pub.latest()
    assert latest["version"] == 4
    assert latest["path"].endswith("bundle_v00000004.dkt")
    assert pub.published == 2 and pub.publish_errors == 0
    assert sorted(os.listdir(tmp_path)) == ["bundle_v00000002.dkt",
                                            "bundle_v00000004.dkt"]
    pub.close()
    assert ps.listener is None


def test_publisher_failing_build_counted_and_leaves_no_partial(tmp_path):
    ps = FakePS()

    def build(center, meta, path):
        with open(path, "w") as f:
            f.write("partial")
        raise RuntimeError("quantize blew up")

    pub = BundlePublisher(ps, build, str(tmp_path))
    ps.listener(1, {}, {}, {})
    assert pub.publish_errors == 1 and pub.published == 0
    assert pub.latest() is None
    assert os.listdir(tmp_path) == []


def test_publisher_rides_port_ps_commit_cadence_and_detaches(tmp_path):
    """On the port's parameter server: version N is the N-update center,
    and ``close`` really detaches (the PS matches a bound method by
    equality: each attribute access makes a new one)."""
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer

    ps = DeltaParameterServer({"w": np.zeros((3,), np.float32)})
    seen = []

    def build(center, meta, path):
        seen.append(float(np.asarray(center["w"]).sum()))
        with open(path, "wb") as f:
            f.write(b"x")

    pub = BundlePublisher(ps, build, str(tmp_path), every=2)
    delta = {"w": np.ones((3,), np.float32)}
    for _ in range(4):
        ps.commit(delta)
    assert pub.published == 2 and pub.latest()["version"] == 4
    assert seen == [6.0, 12.0]
    pub.close()
    for _ in range(2):
        ps.commit(delta)
    assert pub.published == 2 and seen == [6.0, 12.0]


class FakePublisher:
    def __init__(self, latest=None):
        self._latest = latest

    def latest(self):
        return None if self._latest is None else dict(self._latest)

    def publish(self, version):
        self._latest = {"version": version, "path": f"/b/v{version}"}


def test_deployer_deploys_only_new_versions():
    rolls = []

    class Ctl:
        def rollover(self, bundle=None, timeout=None):
            rolls.append(bundle)
            return {"replaced": [("h", 1), ("h", 2)]}

    pub = FakePublisher()
    dep = ContinuousDeployer(Ctl(), pub, timeout=5.0)
    assert dep.maybe_deploy() is None
    pub.publish(1)
    out = dep.maybe_deploy()
    assert out["version"] == 1 and len(out["ledger"]["replaced"]) == 2
    assert dep.maybe_deploy() is None
    assert rolls == ["/b/v1"] and dep.deploys == 1


def test_deployer_attach_time_version_is_the_baseline():
    class Ctl:
        def rollover(self, **kw):
            raise AssertionError("must not roll the boot bundle")

    dep = ContinuousDeployer(Ctl(), FakePublisher({"version": 5,
                                                   "path": "/b/v5"}))
    assert dep.maybe_deploy() is None


# ------------------------------------------- real engines on the CPU

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


@pytest.fixture(scope="module")
def lm():
    torch.manual_seed(0)
    return zoo.transformer_lm(**LM, device="cpu")


def _center_builder(lm):
    """A publisher ``build``: the PS center into a copy of ``lm``,
    quantized, written as a serving bundle."""
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.utils.serialization import save_serving_bundle

    def build(center, meta, path):
        m = lm.copy()
        own = dict(m.named_parameters())
        with torch.no_grad():
            for name, a in center.items():
                own[name].copy_(torch.from_numpy(np.asarray(a)))
        save_serving_bundle(path, quantize_model(m))

    return build


def test_published_bundle_deploys_and_loads_in_jax(lm, tmp_path):
    """Two PS commits publish a bundle; a ``ContinuousDeployer`` rolls a
    port fleet to it on a hold tick; replies after the roll equal a solo
    engine booted from that bundle; and JAX's ``load_serving_bundle``
    reads the same file."""
    from distkeras_tpu.utils.serialization import (
        load_serving_bundle as j_load,
    )

    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.serving import ServingEngine

    center = {n: p.detach().numpy().copy() for n, p in lm.named_parameters()}
    ps = DeltaParameterServer(center)
    pub = BundlePublisher(ps, _center_builder(lm), str(tmp_path), every=2)
    ctl = FleetController(lm, replicas=2, num_slots=2, prefix_cache=False,
                          device="cpu",
                          router_kw=dict(health_interval=0.05)).start()
    try:
        dep = ContinuousDeployer(ctl, pub, timeout=30.0)
        sc = Autoscaler(ctl, AutoscalePolicy(min_replicas=1, max_replicas=3,
                                             down_ticks=100),
                        deployer=dep)
        rng = np.random.default_rng(4)
        delta = {n: (0.01 * rng.standard_normal(a.shape)).astype(np.float32)
                 for n, a in center.items()}
        for _ in range(2):
            ps.commit(delta)
        latest = pub.latest()
        assert latest["version"] == 2
        old = {r.endpoint for r in ctl.replicas}
        d = sc.tick()
        assert d.action == HOLD and sc.last_deploy["version"] == 2
        assert {r.endpoint for r in ctl.replicas}.isdisjoint(old)
        solo = ServingEngine.from_bundle(latest["path"], num_slots=2,
                                         prefix_cache=False,
                                         device="cpu").start()
        try:
            p = rng.integers(0, 61, 9).astype(np.int32)
            with ctl.client(connect_timeout=2.0) as c:
                np.testing.assert_array_equal(c.generate(p, 6),
                                              solo.generate(p, 6))
        finally:
            solo.stop()
        jm = j_load(latest["path"])
        assert jm.get_config() == lm.get_config()
    finally:
        pub.close()
        ctl.stop()


def test_real_fleet_scale_up_down_and_reap(lm, monkeypatch):
    """A real-LM fleet under the ``Autoscaler``: a burn breach scales it
    up and the new replica joins warmed (0 storms on its ledger, 0 on the
    old replica's from the join), sustained idleness scales it down with
    0 failed requests, and a killed replica is reaped and replaced in one
    tick."""
    from distkeras_tpu_torch.kernels import build as kbuild

    ctl = FleetController(lm, replicas=1, num_slots=2, prefix_cache=False,
                          device="cpu",
                          router_kw=dict(health_interval=0.05)).start()
    clk = FakeClock()
    sc = Autoscaler(ctl, AutoscalePolicy(min_replicas=1, max_replicas=3,
                                         up_ticks=1, down_ticks=2,
                                         up_cooldown=0.0, down_cooldown=0.0,
                                         clock=clk), clock=clk)
    stop = threading.Event()
    bad = []
    served = [0]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 61, 9).astype(np.int32) for _ in range(4)]

    def traffic():
        with ctl.client(connect_timeout=2.0) as c:
            k = 0
            while not stop.is_set():
                try:
                    c.generate(prompts[k % 4], 4)
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — counted
                    bad.append(repr(e))
                k += 1

    try:
        first = ctl.replicas[0]
        first.warm()
        # a kernel build on a warming replica's thread is its own warmup
        # mint, never a sibling's
        n0 = len(first.engine.compile_ledger.mints())
        th = threading.Thread(target=traffic)
        th.start()
        def breach(router):  # the replica's books, burning its SLO
            out = signals_from_router(router)
            out[0].burn = BURN_BREACH
            return out

        with monkeypatch.context() as m:
            m.setattr(autoscale, "signals_from_router", breach)
            d = sc.tick()
        assert (d.action, d.reason) == (SCALE_UP, "slo_breach")
        assert len(ctl.replicas) == 2
        new = ctl.replicas[-1]
        assert new.engine.compile_ledger.warmed
        new.engine._stepper._warm(lambda: kbuild._notify(
            list(kbuild._observers), ["layernorm_fwd"], 0.5))
        time.sleep(0.3)  # live traffic reaches both replicas
        for rep in ctl.replicas:
            assert rep.engine.compile_ledger.storms == 0
        assert len(first.engine.compile_ledger.mints()) == n0
        assert new.engine.compile_ledger.mints()[-1]["key"] == (
            "build[layernorm_fwd]")

        # idle: the traffic stops, two idle ticks drain one replica
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        decisions = [sc.tick() for _ in range(2)]
        assert decisions[-1].action == SCALE_DOWN
        assert len(ctl.replicas) == 1
        assert bad == [] and served[0] > 0

        # kill the survivor: reaped and replaced inside one tick
        victim = ctl.replicas[0]
        victim.stop(drain=False)
        d = sc.tick()
        assert (d.action, d.reason) == (SCALE_UP, "below_min")
        assert victim not in ctl.replicas and len(ctl.replicas) == 1
        assert sc._counters["reaps"] == 1
        with ctl.client(connect_timeout=2.0) as c:
            assert c.generate(prompts[0], 3).size == 12
    finally:
        stop.set()
        ctl.stop()
