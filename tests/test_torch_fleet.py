"""The port's fleet router and controller against fake replicas, and its
books against the JAX package's router.

The JAX counterparts: ``tests/test_fleet.py:332-757`` (affinity keys,
rendezvous, the router over fake DKT1 replicas, the controller over fake
replicas) and the router cases of ``tests/test_resilience.py:477-531``
(the fleet retry budget, hedging). The fake replica is the JAX suite's
own (``test_fleet.FakeReplica``: real DKT1 over real sockets, no
engine), so the port's ``FleetRouter`` and ``FleetController`` are held
to the same scripted replicas. Here, besides: the affinity keys and
rendezvous scores equal JAX's for int32 and the port's int64 rows, and
the router's ``stats()``/``replicas()``/``health`` books carry JAX's keys
and counts on the same fake fleet.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.faults import FaultPlan
from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.serving import (
    FleetController,
    FleetRouter,
    ServingClient,
    affinity_key,
)
from distkeras_tpu_torch.serving.fleet import (
    ACTIVE,
    DRAINING,
    EJECTED,
    _rendezvous,
)
from distkeras_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    OverloadedError,
    ServingError,
)
from test_fleet import FakeReplica, _fake_pair, _prompt_for, _state_of, _wait


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults._ACTIVE
    if leaked is not None:
        leaked.deactivate()
        pytest.fail("test leaked an active FaultPlan")


def _router(*fakes, **kw):
    kw.setdefault("health_interval", 0.05)
    kw.setdefault("health_timeout", 1.0)
    kw.setdefault("connect_timeout", 1.0)
    kw.setdefault("request_timeout", 10.0)
    return FleetRouter(endpoints=[f.endpoint for f in fakes], **kw).start()


def _client(router, **kw):
    kw.setdefault("retry", False)
    return ServingClient(router.host, router.port, timeout=15.0,
                         connect_timeout=2.0, **kw)


@pytest.fixture
def pair():
    a, b = _fake_pair()
    yield a, b
    a.kill()
    b.kill()


# ------------------------------------------------------------- pure units


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_affinity_keys_and_scores_equal_jax(dtype):
    from distkeras_tpu.serving.fleet import _rendezvous as j_rendezvous
    from distkeras_tpu.serving.fleet import affinity_key as j_affinity_key

    rng = np.random.default_rng(18)
    eps = [("127.0.0.1", 9000 + i) for i in range(3)]
    for n in (3, 7, 8, 9, 16, 31, 33, 100):
        p = rng.integers(0, 8192, n).astype(dtype)
        for min_len in (4, 8):
            key = affinity_key(p, min_len=min_len)
            # JAX keys its int32 rows; the port's int64 rows key the same
            assert key == j_affinity_key(p.astype(np.int32), min_len=min_len)
            if key is None:
                continue
            assert [_rendezvous(key, e) for e in eps] == [
                j_rendezvous(key, e) for e in eps]


def test_affinity_key_is_pow2_ladder_granular():
    header = np.arange(100, 116)  # 16-token header, int64 as the port's rows
    for sfx in ([7], [8, 9], [1, 2, 3]):
        prompt = np.concatenate([header, np.asarray(sfx)])
        assert affinity_key(prompt) == affinity_key(header)
    assert affinity_key(np.concatenate([header, np.arange(16)])) != (
        affinity_key(header))
    assert affinity_key(np.arange(7)) is None
    assert affinity_key(np.arange(8)) is not None


def test_rendezvous_is_deterministic_and_spreads():
    eps = [("127.0.0.1", 9000 + i) for i in range(4)]
    key = affinity_key(np.arange(32))
    assert _rendezvous(key, eps[0]) == _rendezvous(key, eps[0])
    winners = set()
    for s in range(64):
        k = affinity_key(np.arange(s, s + 16))
        winners.add(max(eps, key=lambda e: _rendezvous(k, e)))
    assert len(winners) == len(eps)


# ---------------------------------------------------------- router: routing


def test_router_affinity_placement_and_served_by_stamp(pair):
    a, b = pair
    router = _router(a, b)
    try:
        pa = _prompt_for((a, b), a)
        pb = _prompt_for((a, b), b)
        with _client(router) as c:
            assert list(c.generate(pa, 4)[-4:]) == [a.tag] * 4
            assert c.last_served_by == tuple(a.endpoint)
            assert c.connected_endpoint == (router.host, router.port)
            assert list(c.generate(pb, 4)[-4:]) == [b.tag] * 4
            assert c.last_served_by == tuple(b.endpoint)
            out = c.generate(np.concatenate([pa, [3, 1]]), 4)
            assert list(out[-4:]) == [a.tag] * 4
        st = router.stats()
        assert st["affinity_enabled"]
        assert st["affinity_routed"] == 3
        assert st["failovers"] == 0
    finally:
        router.shutdown()


def test_router_without_affinity_routes_least_loaded(pair):
    a, b = pair
    router = _router(a, b, affinity=False)
    try:
        gate = threading.Event()
        a.block = b.block = gate
        with _client(router) as c0, _client(router) as c1:
            outs = [None, None]
            ths = [threading.Thread(target=lambda i=i, c=c: outs.__setitem__(
                i, c.generate(np.arange(16), 3))) for i, c in enumerate((c0, c1))]
            for t in ths:
                t.start()
            _wait(lambda: sorted(r["in_flight"] for r in router.replicas())
                  == [1, 1], timeout=10, msg="one in-flight per replica")
            gate.set()
            for t in ths:
                t.join(timeout=15)
        assert {int(o[-1]) for o in outs} == {a.tag, b.tag}
        assert router.stats()["least_loaded_routed"] == 2
    finally:
        router.shutdown()


def test_router_health_gate_ejects_degraded_and_rejoins(pair):
    a, b = pair
    router = _router(a, b)
    try:
        pa = _prompt_for((a, b), a)
        a.status = "degraded"
        _wait(lambda: _state_of(router, a.endpoint) == EJECTED, timeout=10,
              msg="degraded replica ejected")
        with _client(router) as c:
            assert list(c.generate(pa, 4)[-4:]) == [b.tag] * 4
        a.status = "serving"
        _wait(lambda: _state_of(router, a.endpoint) == ACTIVE, timeout=10,
              msg="clean poll rejoins")
        with _client(router) as c:
            assert list(c.generate(pa, 4)[-4:]) == [a.tag] * 4
        st = router.stats()
        assert st["ejections"] >= 1 and st["rejoins"] >= 1
    finally:
        router.shutdown()


def test_router_fails_over_mid_request_and_ejects_victim(pair):
    a, b = pair
    router = _router(a, b)
    try:
        pa = _prompt_for((a, b), a)
        a.die_next = 1
        with _client(router) as c:
            out = c.generate(pa, 4)
        assert list(out[-4:]) == [b.tag] * 4
        assert c.last_served_by == tuple(b.endpoint)
        assert router.stats()["failovers"] == 1
        _wait(lambda: _state_of(router, a.endpoint) == ACTIVE, timeout=10,
              msg="victim rejoins after clean polls")
    finally:
        router.shutdown()


def test_router_unavailable_when_every_replica_is_dead(pair):
    a, b = pair
    router = _router(a, b)
    a.kill()
    b.kill()
    try:
        with _client(router) as c:
            t0 = time.monotonic()
            with pytest.raises(ServingError) as ei:
                c.generate(np.arange(16), 4)
            assert time.monotonic() - t0 < 10.0
        assert ei.value.code == "unavailable"
        assert router.stats()["unavailable"] == 1
    finally:
        router.shutdown()


# ------------------------------------------------- router: overload shed


def test_replica_overloaded_spills_before_fleet_sheds(pair):
    a, b = pair
    router = _router(a, b)
    try:
        pa = _prompt_for((a, b), a)
        a.overload_next = 1
        with _client(router) as c:
            assert list(c.generate(pa, 4)[-4:]) == [b.tag] * 4
            a.overload_next = b.overload_next = 5
            with pytest.raises(OverloadedError) as ei:
                c.generate(pa, 4)
        assert ei.value.retry_after == pytest.approx(0.025)
        assert router.stats()["fleet_overloaded"] == 1
    finally:
        router.shutdown()


def test_router_accounts_in_flight_and_sheds_at_capacity():
    a, b = _fake_pair(num_slots=1, queue_capacity=0)
    router = _router(a, b)
    try:
        gate = threading.Event()
        a.block = b.block = gate
        outs = [None, None]
        clis = [_client(router) for _ in range(2)]
        ths = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, clis[i].generate(np.arange(i * 40, i * 40 + 16), 3)))
            for i in range(2)]

        def gen_calls():
            with a._lock, b._lock:
                return sum(v == "generate" for v in a.calls + b.calls)

        for t in ths:
            t.start()
        _wait(lambda: sum(r["in_flight"] for r in router.replicas()) == 2
              and gen_calls() == 2, timeout=10, msg="both busy, delivered")
        before = gen_calls()
        with _client(router) as c:
            with pytest.raises(OverloadedError):
                c.generate(np.arange(16), 3)
        assert gen_calls() == before  # shed router-side
        gate.set()
        for t in ths:
            t.join(timeout=15)
        for cli in clis:
            cli.close()
        assert all(o is not None for o in outs)
    finally:
        router.shutdown()
        a.kill()
        b.kill()


# ------------------------------------------------------- router: drain


def test_drain_excludes_from_rotation_and_wait_drained(pair):
    a, b = pair
    router = _router(a, b)
    try:
        pa = _prompt_for((a, b), a)
        a.block = gate = threading.Event()
        out = [None]
        with _client(router) as c0:
            th = threading.Thread(target=lambda: out.__setitem__(
                0, c0.generate(pa, 3)))
            th.start()
            _wait(lambda: any(r["in_flight"] == 1 for r in router.replicas()),
                  timeout=10, msg="request in flight on its home")
            router.drain_replica(a.endpoint)
            assert _state_of(router, a.endpoint) == DRAINING
            assert not router.wait_drained(a.endpoint, timeout=0.2)
            with _client(router) as c1:
                assert list(c1.generate(pa, 3)[-3:]) == [b.tag] * 3
            gate.set()
            assert router.wait_drained(a.endpoint, timeout=10)
            th.join(timeout=10)
        assert list(out[0][-3:]) == [a.tag] * 3
        time.sleep(0.2)
        assert _state_of(router, a.endpoint) == DRAINING
        router.remove_replica(a.endpoint)
        assert _state_of(router, a.endpoint) is None
    finally:
        router.shutdown()


# ------------------------------------------------------- router: seams


@pytest.mark.chaos
def test_router_dispatch_seam_rides_typed_reply_path(pair):
    router = _router(*pair)
    try:
        plan = FaultPlan().arm("router.dispatch",
                               exc=DeadlineExceededError("injected"))
        with _client(router) as c, plan:
            with pytest.raises(DeadlineExceededError):
                c.generate(np.arange(16), 3)
            assert c.generate(np.arange(16), 3) is not None
        assert plan.fired("router.dispatch") == 1
        plan2 = FaultPlan().arm("router.dispatch")
        with _client(router) as c, plan2:
            with pytest.raises(ServingError) as ei:
                c.generate(np.arange(16), 3)
            assert ei.value.code == "internal"
    finally:
        router.shutdown()


@pytest.mark.chaos
def test_router_health_seam_ejects_until_clean_poll(pair):
    a, b = pair
    router = _router(a, b, eject_after=2)
    try:
        target = tuple(a.endpoint)
        plan = FaultPlan().arm("router.health", times=None, when=lambda ctx:
                               tuple(ctx["endpoint"]) == target)
        with plan:
            _wait(lambda: _state_of(router, a.endpoint) == EJECTED,
                  timeout=10, msg="failed polls eject the replica")
            pa = _prompt_for((a, b), a)
            with _client(router) as c:
                assert list(c.generate(pa, 3)[-3:]) == [b.tag] * 3
        assert plan.fired("router.health") >= 2
        _wait(lambda: _state_of(router, a.endpoint) == ACTIVE, timeout=10,
              msg="clean poll rejoins after the seam disarms")
    finally:
        router.shutdown()


# --------------------------------------- router: retry budget and hedging


def test_router_retry_budget_refuses_marked_retries():
    f = FakeReplica(1)
    router = None
    try:
        f.overload_next = 100
        router = _router(f, retry_budget={"ratio": 0.0, "burst": 1.0})
        with _client(router, retry=RetryPolicy(
                max_attempts=6, base_delay=0.001, max_delay=0.005)) as cli:
            with pytest.raises(OverloadedError):
                cli.generate(np.arange(4), 2)
        assert f.calls.count("generate") == 2
        assert router.retry_budget_exhausted.value >= 1
    finally:
        if router is not None:
            router.shutdown()
        f.kill()


def test_router_hedge_pairing_and_first_win(pair):
    f1, f2 = pair
    router = _router(f1, f2, affinity=False, hedge_after=0.15)
    try:
        with _client(router) as cli:
            cli.generate(np.arange(4), 2)
            f1.block = threading.Event()
            t0 = time.monotonic()
            outs = [cli.generate(np.arange(5 + i), 2) for i in range(4)]
            dt = time.monotonic() - t0
        assert all(o[-1] in (f1.tag, f2.tag) for o in outs)
        assert dt < 4.0
        c = router.counters
        assert c["hedges_launched"] >= 1
        f1.block.set()
        _wait(lambda: c["hedges_launched"] == c["hedge_wins"]
              + c["hedge_losers"], timeout=5, msg="hedge ledger pairs")
        assert c["breaker_bypass_forwards"] == 0
    finally:
        router.shutdown()


# -------------------------------------------- the books against JAX's router


def test_router_books_equal_jax_router_books(pair):
    """The same fake fleet behind both routers, the same traffic: equal
    ``stats()`` keys and counts, equal ``replicas()`` rows (every key,
    and the values that do not depend on time), equal health keys."""
    from distkeras_tpu.serving import ServingClient as JClient
    from distkeras_tpu.serving.fleet import FleetRouter as JRouter

    a, b = pair
    pa = _prompt_for((a, b), a)
    kw = dict(health_interval=0.05, health_timeout=1.0, connect_timeout=1.0,
              request_timeout=10.0, tenant_quotas={"t": (100.0, 10)},
              breaker=True, retry_budget=True)
    books = {}
    for name, cls, client in (("port", FleetRouter, ServingClient),
                              ("jax", JRouter, JClient)):
        router = cls(endpoints=[a.endpoint, b.endpoint], **kw).start()
        try:
            for ep in (a.endpoint, b.endpoint):
                assert router.wait_in_rotation(ep, timeout=10)
            with client(router.host, router.port, retry=False) as c:
                outs = [c.generate(pa, 3, tenant="t"),
                        c.generate(np.arange(5), 2)]
                health = c.health()
            st = router.stats()
            books[name] = (outs, st, router.replicas(), health)
        finally:
            router.shutdown()
    (p_outs, p_st, p_reps, p_h), (j_outs, j_st, j_reps, j_h) = (
        books["port"], books["jax"])
    for x, y in zip(p_outs, j_outs):
        np.testing.assert_array_equal(x, y)
    assert set(p_st) == set(j_st)
    for k in ("forwards", "affinity_routed", "least_loaded_routed",
              "failovers", "quota_rejections"):
        assert p_st[k] == j_st[k], k
    assert set(p_h) == set(j_h)
    for k in ("status", "active_replicas", "roles", "disagg"):
        assert p_h[k] == j_h[k], k
    volatile = {"consecutive_poll_failures", "kv_fabric", "breaker"}
    for pr, jr in zip(sorted(p_reps, key=lambda r: r["endpoint"]),
                      sorted(j_reps, key=lambda r: r["endpoint"])):
        assert set(pr) == set(jr)
        assert {k: v for k, v in pr.items() if k not in volatile} == {
            k: v for k, v in jr.items() if k not in volatile}
        assert set(pr["breaker"]) == set(jr["breaker"])


# --------------------------------------------------------- controller


def test_controller_rollover_order_and_ledger_with_fakes():
    built = []

    def factory(bundle):
        rep = FakeReplica(8000 + len(built) + int(bundle))
        built.append(rep)
        return rep

    ctl = FleetController(0, replicas=2, factory=factory,
                          router_kw=dict(health_interval=0.05)).start()
    try:
        gen0 = list(built)
        old_eps = [r.endpoint for r in ctl.replicas]
        ledger = ctl.rollover(bundle=10)
        assert [tuple(r["old"]) for r in ledger["replaced"]] == [
            tuple(e) for e in old_eps]
        assert all(not r.alive() for r in gen0)
        assert all(r.alive() for r in ctl.replicas)
        states = {tuple(r["endpoint"]): r["state"]
                  for r in ctl.router.replicas()}
        assert set(states) == {r.endpoint for r in ctl.replicas}
        assert all(s == ACTIVE for s in states.values())
        assert ctl.rollovers == 1
        with ctl.client(retry=False) as c:
            tag = int(c.generate(np.arange(16), 2)[-1])
        assert tag in {r.tag for r in ctl.replicas}
    finally:
        ctl.stop()
        for r in built:
            r.kill()


def test_controller_reaps_killed_replicas():
    built = []

    def factory(bundle):
        rep = FakeReplica(8100 + len(built))
        built.append(rep)
        return rep

    ctl = FleetController(0, replicas=2, factory=factory,
                          router_kw=dict(health_interval=0.05)).start()
    try:
        victim = ctl.replicas[0]
        victim.kill()
        assert ctl.reap_dead() == [victim]
        assert len(ctl.replicas) == 1
        assert _state_of(ctl.router, victim.endpoint) is None
        with ctl.client(retry=False) as c:
            assert int(c.generate(np.arange(16), 2)[-1]) == (
                ctl.replicas[0].tag)
    finally:
        ctl.stop()
        for r in built:
            r.kill()


def test_controller_scale_up_down_with_fakes():
    built = []

    def factory(bundle):
        rep = FakeReplica(8200 + len(built))
        built.append(rep)
        return rep

    ctl = FleetController(0, replicas=1, factory=factory,
                          router_kw=dict(health_interval=0.05)).start()
    try:
        (new,) = ctl.scale_up()
        assert _state_of(ctl.router, new.endpoint) == ACTIVE
        assert len(ctl.replicas) == 2
        victim = ctl.scale_down(endpoint=new.endpoint)
        assert victim is new and not new.alive()
        assert _state_of(ctl.router, new.endpoint) is None
        with pytest.raises(RuntimeError):
            ctl.scale_down()  # never below one replica
    finally:
        ctl.stop()
        for r in built:
            r.kill()
