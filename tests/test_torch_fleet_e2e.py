"""The port's serving fleet over real engines, against the JAX package.

The JAX counterparts: ``tests/test_fleet.py:759`` (a 2-replica fleet of
real engines, token-identical to solo decode before and after a live
rollover), the router cases of ``tests/test_qos.py:736`` (tenant quotas),
``tests/test_resilience.py:534`` (the gray-failure breaker),
``tests/test_timeseries.py:543,586`` (the fleet ``timeseries`` verb),
``tests/test_obs.py:489`` (a routed trace and the aggregated metrics) and
``tests/test_postmortem.py:480,662`` (SLO ejection, the router's
post-mortem). Here the weights are JAX's (bridged with
``params_from_jax``) and every reply is held against JAX's solo
``CachedSequenceGenerator``; mixed fleets put one JAX and one port
replica behind either package's router. Besides: the engine's fleet
signals (``pool_exhausted``, ``pool_exhausted_rate``,
``queue_depth_trend``, ``kv_shard_bytes``, ``mesh``) equal JAX's under
the same injected pool exhaustion, and one ``gpu`` test serves a
2-replica fleet on the card.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import (
    default_serving_slos,
    parse_prometheus,
    timeline_complete,
)
from distkeras_tpu_torch.serving import (
    FleetController,
    FleetRouter,
    PoolExhaustedError,
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
BUNDLE_KEYS = {
    "schema", "component", "reason", "ts", "events", "metrics",
    "in_flight", "config", "fault_seams", "trace_spans", "slo", "detail",
}


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


@pytest.fixture(scope="module")
def solo(lms):
    """JAX's solo decode: the reference of every routed reply."""
    from distkeras_tpu.predictors import CachedSequenceGenerator

    gen = CachedSequenceGenerator(lms[0])
    return lambda p, n: np.asarray(gen.generate(p[None], steps=n)[0])


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults._ACTIVE
    if leaked is not None:
        leaked.deactivate()
        pytest.fail("test leaked an active FaultPlan")


def _header_prompts(seed=0):
    rng = np.random.default_rng(seed)
    header = rng.integers(0, 61, 16).astype(np.int32)
    return [np.concatenate([header, rng.integers(0, 61, k).astype(np.int32)])
            for k in (1, 2, 3, 4)] + [rng.integers(0, 61, 5).astype(np.int32)]


def _concurrent(fn, n):
    """Run ``fn(i)`` for i < n on threads; every thread must finish."""
    errs = []

    def one(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    ths = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths), "a client hung"
    assert not errs, errs


def _fleet(lm, n=2, **kw):
    kw.setdefault("router_kw", dict(health_interval=0.1,
                                    connect_timeout=2.0))
    return FleetController(lm, replicas=n, num_slots=2, queue_capacity=16,
                           device="cpu", **kw).start()


# ------------------------------------------------------------ identity


def test_fleet_end_to_end_identity_affinity_and_live_rollover(lms, solo):
    """A 2-replica port fleet serves concurrent shared-header traffic
    token-identical to JAX's solo decode, one header lands on one replica
    (the ``served_by`` stamp), and a rollover made WHILE clients send
    replaces both replicas with zero failed requests."""
    prompts = _header_prompts()
    refs = [solo(p, 6) for p in prompts]
    ctl = _fleet(lms[1], prefix_cache=True)
    try:
        results, served = [None] * len(prompts), [None] * len(prompts)

        def worker(i):
            with ctl.client(connect_timeout=2.0) as c:
                results[i] = c.generate(prompts[i], 6)
                served[i] = c.last_served_by

        _concurrent(worker, len(prompts))
        for i, (got, want) in enumerate(zip(results, refs)):
            np.testing.assert_array_equal(got, want, err_msg=f"req {i}")
        homes = {served[i] for i in range(4)}
        assert len(homes) == 1
        assert homes.pop() in {r.endpoint for r in ctl.replicas}

        old_eps = {r.endpoint for r in ctl.replicas}
        stop = threading.Event()
        live = {"ok": 0, "bad": []}

        def traffic():
            with ctl.client(connect_timeout=2.0) as c:
                k = 0
                while not stop.is_set():
                    i = k % len(prompts)
                    try:
                        out = c.generate(prompts[i], 6)
                        if np.array_equal(out, refs[i]):
                            live["ok"] += 1
                        else:
                            live["bad"].append(("diverged", i))
                    except Exception as e:  # noqa: BLE001 — counted
                        live["bad"].append(repr(e))
                    k += 1

        th = threading.Thread(target=traffic)
        th.start()
        try:
            time.sleep(0.2)
            ledger = ctl.rollover()
            time.sleep(0.2)
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive()
        assert live["bad"] == [] and live["ok"] > 0
        assert len(ledger["replaced"]) == 2
        assert {r.endpoint for r in ctl.replicas}.isdisjoint(old_eps)
        _concurrent(worker, len(prompts))
        for i, (got, want) in enumerate(zip(results, refs)):
            np.testing.assert_array_equal(got, want, err_msg=f"post {i}")
    finally:
        ctl.stop()


@pytest.mark.parametrize("router_pkg", ["port", "jax"])
def test_mixed_fleet_behind_either_router(lms, solo, router_pkg):
    """One JAX replica and one port replica behind a router of either
    package: every reply equals JAX's solo decode, and both replicas
    serve (prompts are chosen by their rendezvous home)."""
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving import ServingServer as JServer
    from distkeras_tpu.serving.fleet import FleetRouter as JRouter

    from distkeras_tpu_torch.serving.fleet import _rendezvous, affinity_key

    jsrv = JServer(JEngine(lms[0], num_slots=2, prefix_cache=False)).start()
    psrv = ServingServer(ServingEngine(lms[1], num_slots=2,
                                       prefix_cache=False,
                                       device="cpu")).start()
    eps = [(jsrv.host, jsrv.port), (psrv.host, psrv.port)]
    cls = FleetRouter if router_pkg == "port" else JRouter
    router = cls(endpoints=eps, health_interval=0.1).start()
    try:
        for ep in eps:
            assert router.wait_in_rotation(ep, timeout=20)
        rng = np.random.default_rng(7)
        prompts, homes = [], set()
        while len(homes) < 2 or len(prompts) < 6:
            p = rng.integers(0, 61, 9).astype(np.int32)
            home = max(eps, key=lambda e: _rendezvous(affinity_key(p), e))
            prompts.append(p)
            homes.add(home)
        served = []
        with ServingClient(router.host, router.port, retry=False,
                           connect_timeout=2.0) as c:
            for p in prompts:
                np.testing.assert_array_equal(c.generate(p, 6), solo(p, 6))
                served.append(c.last_served_by)
            st = c.generate_stream(prompts[0], 6)
            for _ in st:
                pass
            np.testing.assert_array_equal(st.sequence, solo(prompts[0], 6))
        assert set(served) == set(eps)
    finally:
        router.shutdown()
        jsrv.shutdown()
        psrv.shutdown()


# ------------------------------------------------- the engine's fleet signals


def _exhaust(eng, plan_cls, exc_cls, prompts, n_exhausted):
    """Fail ``n_exhausted`` admissions typed through the ``kv.alloc`` seam,
    then serve the rest; the history ring is snapped around the burst."""
    eng.health()
    time.sleep(0.03)
    plan = plan_cls().arm("kv.alloc", exc=exc_cls("injected"),
                          times=n_exhausted)
    codes = []
    with plan:
        for p in prompts:
            try:
                eng.generate(p, 3)
                codes.append("ok")
            except Exception as e:  # noqa: BLE001 — the code is compared
                codes.append(getattr(e, "code", type(e).__name__))
    time.sleep(0.03)
    return codes


def test_pool_exhausted_counts_and_health_signals_equal_jax(lms):
    """Fault (a): an admission failed typed ``overloaded`` by pool
    exhaustion is counted in ``pool_exhausted`` as JAX counts it. Fault
    (b): ``health()`` carries JAX's keys for the same knobs, with
    ``mesh`` None, ``kv_shard_bytes == kv_bytes_total()``, and positive
    ``pool_exhausted_rate``/``queue_depth_trend`` after a burst."""
    from distkeras_tpu import faults as jfaults
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving.scheduler import (
        PoolExhaustedError as JPoolExhausted,
    )

    knobs = dict(num_slots=1, paged=True, page_size=4, prefix_cache=False,
                 queue_capacity=32, history_interval=0.01)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 61, 6).astype(np.int32) for _ in range(5)]
    jeng = JEngine(lms[0], **knobs).start()
    peng = ServingEngine(lms[1], device="cpu", **knobs).start()
    try:
        jcodes = _exhaust(jeng, jfaults.FaultPlan, JPoolExhausted, prompts, 3)
        pcodes = _exhaust(peng, faults.FaultPlan, PoolExhaustedError,
                          prompts, 3)
        assert pcodes == jcodes == ["overloaded"] * 3 + ["ok"] * 2
        assert peng.stats()["pool_exhausted"] == (
            jeng.stats()["pool_exhausted"]) == 3

        def counter(eng):
            (s,) = [s for s in eng.registry.snapshot()
                    if s["name"] == "serving_scheduler_pool_exhausted"]
            return s["value"]

        assert counter(peng) == counter(jeng) == 3
        jh, ph = jeng.health(), peng.health()
        assert set(jh) <= set(ph), set(jh) - set(ph)
        assert ph["mesh"] is None
        assert ph["kv_shard_bytes"] == peng._stepper.kv_bytes_total() > 0
        assert ph["pool_exhausted_rate"] > 0
        assert jh["pool_exhausted_rate"] > 0

        # the queue burst: slow every decode step so arrivals pile up,
        # with a health poll (a history snap) between arrivals
        plan = faults.FaultPlan().arm("stepper.step", action="delay",
                                      delay=0.02, times=None)
        with plan:
            reqs = []
            for i in range(8):
                reqs.append(peng.submit(prompts[i % 5], 12))
                time.sleep(0.015)
                peng.health()
            h = peng.health()
            for r in reqs:
                peng.wait(r)
        assert h["queue_depth_trend"] > 0, h["queue_depth_trend"]
        assert h["pool_exhausted_rate"] > 0
    finally:
        jeng.stop()
        peng.stop()


# ---------------------------------------------------- router features e2e


def test_router_tenant_quota_e2e_over_tcp(lms):
    srv = ServingServer(ServingEngine(lms[1], num_slots=2, prefix_cache=False,
                                      watchdog_interval=30.0,
                                      device="cpu")).start()
    router = FleetRouter(endpoints=[(srv.host, srv.port)],
                         health_interval=0.1,
                         tenant_quotas={"noisy": {"rate": 0.001,
                                                  "burst": 2}}).start()
    try:
        assert router.wait_in_rotation((srv.host, srv.port))
        prompt = np.arange(1, 6, dtype=np.int32)
        with ServingClient("127.0.0.1", router.port, retry=False,
                           connect_timeout=2.0) as c:
            c.generate(prompt, 3, tenant="noisy")
            c.generate(prompt, 3, tenant="noisy")
            with pytest.raises(ServingError) as ei:
                c.generate(prompt, 3, tenant="noisy")
            assert ei.value.code == "quota_exhausted"
            assert ei.value.retry_after > 0
            assert c.generate(prompt, 3, tenant="quiet").size == 8
        assert router.stats()["quota_rejections"] == 1
        labeled = {(s["name"], s["labels"].get("tenant")): s["value"]
                   for s in router.registry.snapshot()
                   if s["kind"] == "counter"}
        assert labeled[("serving_quota_rejections", "noisy")] == 1
        kinds = [e["kind"] for e in router.recorder.snapshot()]
        assert "qos.quota_reject" in kinds
    finally:
        router.shutdown()
        srv.shutdown()


@pytest.mark.chaos
def test_gray_failure_breaker_opens_recovers_and_closes(lms):
    """One replica slowed through the ``net.delay`` seam stays
    health-green; the router's breaker opens on the latency outlier,
    steers traffic off it, and closes after the seam disarms."""
    servers = []
    router = None
    plan = faults.FaultPlan()
    try:
        for _ in range(2):
            servers.append(ServingServer(ServingEngine(
                lms[1], num_slots=2, queue_capacity=16,
                device="cpu")).start())
        slow_port = int(servers[0].port)
        plan.arm("net.delay", action="delay", delay=0.35, times=None,
                 when=lambda ctx: ctx.get("port") == slow_port).activate()
        router = FleetRouter(
            endpoints=[(s.host, s.port) for s in servers],
            health_interval=0.1, affinity=False,
            breaker=dict(open_secs=1.0, outlier_trips=2,
                         outlier_factor=3.0, min_latency=0.050),
        ).start()
        slow_ep = (servers[0].host, slow_port)

        def breaker_state():
            for r in router.replicas():
                if tuple(r["endpoint"]) == slow_ep:
                    return r["breaker"]["state"], r["state"]
            return None, None

        prompt = np.arange(6, dtype=np.int32) % 11

        def burst(base):
            def one(i):
                with ServingClient("127.0.0.1", router.port, retry=False,
                                   connect_timeout=2.0) as c:
                    c.generate((prompt + base + i) % 11, 3)

            _concurrent(one, 4)

        with ServingClient("127.0.0.1", router.port, retry=False,
                           connect_timeout=2.0) as cli:
            deadline = time.monotonic() + 40.0
            opened = False
            while time.monotonic() < deadline:
                burst(int(time.monotonic() * 10) % 40)
                bstate, rstate = breaker_state()
                assert rstate == "active"  # health-green while slow
                if bstate == "open":
                    opened = True
                    break
            assert opened, "breaker never opened on the slow replica"
            lats = []
            for i in range(6):
                t0 = time.monotonic()
                cli.generate((prompt + 50 + i) % 11, 3)
                lats.append(time.monotonic() - t0)
            assert max(lats) < 0.3, lats
            plan.deactivate()
            deadline = time.monotonic() + 20.0
            closed = False
            while time.monotonic() < deadline:
                for i in range(3):
                    cli.generate((prompt + 100 + i) % 11, 3)
                if breaker_state()[0] == "closed":
                    closed = True
                    break
                time.sleep(0.1)
            assert closed, "breaker never closed after disarm"
            assert router.counters["breaker_closes"] >= 1
            assert router.counters["breaker_probes"] >= 1
        assert router.counters["breaker_bypass_forwards"] == 0
    finally:
        plan.deactivate()
        if router is not None:
            router.shutdown()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("history", [True, False], ids=["on", "off"])
def test_router_timeseries_aggregates_endpoint_labeled(lms, history):
    """The fleet ``timeseries`` verb: the router's own windowed rows and
    the replica's, labeled; a replica built with ``history=False`` is
    named under ``no_history``, never ``unreachable``."""
    kw = dict(history_interval=0.05) if history else dict(history=False)
    srv = ServingServer(ServingEngine(lms[1], num_slots=2, device="cpu",
                                      **kw)).start()
    router = FleetRouter(endpoints=[(srv.host, srv.port)],
                         health_interval=0.05).start()
    label = f"{srv.host}:{srv.port}"
    cli = ServingClient("127.0.0.1", router.port, connect_timeout=2.0)
    try:
        cli.generate(np.arange(1, 6, dtype=np.int32), 3)
        time.sleep(0.3)
        for _ in range(2):
            reply = cli.timeseries(window=60)
            assert reply["ok"] is True
            assert reply["unreachable"] == []
            rows = {}
            for r in reply["series"]:
                rows.setdefault((r.get("labels") or {}).get("replica"),
                                set()).add(r["name"])
            assert "fleet_router_forwards" in rows["router"]
            if history:
                assert "serving_scheduler_completed" in rows[label]
            else:
                assert reply["no_history"] == [label]
                assert set(rows) == {"router"}
    finally:
        cli.close()
        router.shutdown()
        srv.shutdown()


def _check_sample_schema(samples):
    assert samples
    for s in samples:
        assert set(s) >= {"name", "kind", "labels"}, s
        assert s["kind"] in ("counter", "gauge", "histogram"), s
        assert s["name"].replace("_", "a").isalnum(), s["name"]
        assert s["name"].split("_", 1)[0] in (
            "serving", "fleet", "training"), s["name"]
        if s["kind"] == "histogram":
            assert {"count", "sum", "buckets"} <= set(s), s
            assert s["buckets"][-1][0] == "+Inf", s
        else:
            assert "value" in s, s
        json.dumps(s)


def test_fleet_routed_trace_and_metrics_aggregate(lms):
    ctl = _fleet(lms[1])
    try:
        with ctl.client(connect_timeout=2.0) as c:
            prompt = np.arange(1, 14, dtype=np.int32)
            out = c.generate(prompt, 5, trace=True)
            assert out.size == prompt.size + 5
            spans = c.last_trace["spans"]
            names = [s["name"] for s in spans]
            assert {"client.request", "router.route", "server.generate",
                    "serving.queue", "serving.decode"} <= set(names), names
            assert timeline_complete(spans)
            (route,) = [s for s in spans if s["name"] == "router.route"]
            assert route["attrs"]["how"] in ("affinity", "spill",
                                             "least_loaded")
            assert route["attrs"]["replica"].startswith("127.0.0.1:")
            assert route["attrs"]["failovers"] == 0
            by_name = {s["name"]: s for s in spans}
            assert by_name["server.generate"]["parent_id"] == (
                route["span_id"])
            assert route["parent_id"] == by_name["client.request"]["span_id"]
            samples = c.metrics()
            _check_sample_schema(samples)
            labels = {s["labels"].get("replica") for s in samples}
            assert "router" in labels and len(labels) == 3
            names = {s["name"] for s in samples}
            assert {"fleet_router_forwards",
                    "fleet_router_forward_seconds"} <= names
            parse_prometheus(c.metrics(prometheus=True))
    finally:
        ctl.stop()


def test_fleet_sweep_ejects_on_sustained_slo_breach(lms):
    ctl = _fleet(lms[1], slos=default_serving_slos(latency_p99_s=1e-9,
                                                   min_count=1),
                 slo_interval=0.0,
                 router_kw=dict(health_interval=0.05, eject_on_slo_breach=2))
    try:
        with ctl.client(connect_timeout=2.0) as c:
            c.generate(np.arange(1, 10, dtype=np.int32), 4)
            deadline = time.monotonic() + 20
            ejected = None
            while time.monotonic() < deadline and ejected is None:
                for r in ctl.router.replicas():
                    if r["state"] == "ejected":
                        ejected = r
                time.sleep(0.02)
            assert ejected is not None, ctl.router.replicas()
            assert ejected["consecutive_slo_breaches"] >= 2
            pm, _ = ctl.router.postmortem()
            assert pm["reason"] == "replica_ejected"
            (ej,) = [e for e in pm["events"] if e["kind"] == "router.eject"]
            assert ej["cause"] == "slo_breach"
            time.sleep(0.3)
            states = {tuple(r["endpoint"]): r["state"]
                      for r in ctl.router.replicas()}
            assert states[tuple(ejected["endpoint"])] == "ejected"
            assert c.generate(np.arange(1, 6, dtype=np.int32), 3).size == 8
    finally:
        ctl.stop()


def test_router_postmortem_verb_empty_then_populated(lms):
    ctl = _fleet(lms[1], router_kw=dict(health_interval=0.05, eject_after=2))
    try:
        with ctl.client(connect_timeout=2.0) as c:
            assert c.postmortem() is None
            ctl.replicas[0].stop(drain=False)
            deadline = time.monotonic() + 20
            while (time.monotonic() < deadline
                   and ctl.router.last_postmortem is None):
                time.sleep(0.02)
            pm = c.postmortem()
            assert set(pm) == BUNDLE_KEYS
            assert pm["component"] == "fleet_router"
            assert pm["reason"] == "replica_ejected"
            assert any(e["kind"] == "router.eject" for e in pm["events"])
            assert all("endpoint" in row for row in pm["in_flight"])
    finally:
        ctl.stop()


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_two_replica_fleet_on_card_equals_solo_decode():
    """On CUDA: a 2-replica fleet serves concurrent traffic token-identical
    to a solo CUDA engine of the same layout, before and after a
    rollover."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lm = zoo.transformer_lm(**LM, device="cuda")
    common = dict(num_slots=2, queue_capacity=16, prefix_cache=False,
                  device="cuda")
    prompts = _header_prompts(1)
    ref = ServingEngine(lm, **common).start()
    try:
        refs = [ref.generate(p, 6) for p in prompts]
    finally:
        ref.stop()
    ctl = FleetController(lm, replicas=2,
                          router_kw=dict(health_interval=0.1),
                          **common).start()
    try:
        outs = [None] * len(prompts)

        def worker(i):
            with ctl.client(connect_timeout=2.0) as c:
                outs[i] = c.generate(prompts[i], 6)

        for _ in range(2):
            _concurrent(worker, len(prompts))
            for got, want in zip(outs, refs):
                np.testing.assert_array_equal(got, want)
            ctl.rollover()
    finally:
        ctl.stop()
