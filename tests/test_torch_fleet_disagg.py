"""Role-aware dispatch and page-aware routing through the port's router.

The JAX counterparts: ``tests/test_disagg.py:443`` (a prefill and a decode
replica behind the router: pushed and stream-relayed replies equal solo
decode, the push and relay ledgers pair) and ``:510`` (a decode worker
killed mid-transfer; the request fails over to the sibling with identical
tokens). Here the replicas are the port's engines on JAX's weights and the
replies are held against JAX's solo decode, with JAX's ledger values. The
page-aware case: a prompt whose pages a sibling holds is routed to that
sibling (``digest_routed``), and when the holder is saturated the request
spills with a peer hint and its replica fetches the prefix from the holder
(``fetch_ok``), token-identically.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    FleetRouter,
    ServingClient,
    ServingEngine,
    ServingServer,
)
from distkeras_tpu_torch.serving.fleet import _rendezvous, affinity_key
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


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
    from distkeras_tpu.predictors import CachedSequenceGenerator

    gen = CachedSequenceGenerator(lms[0])
    return lambda p, n: np.asarray(gen.generate(p[None], steps=n)[0])


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 61, n).astype(np.int32)


def _engine(lm, **kw):
    kw.setdefault("prefix_cache", False)
    return ServingEngine(lm, num_slots=2, device="cpu", **kw)


def _paired(stats, ledger):
    if ledger == "transfer":
        return stats["transfer_sends"] == (stats["transfer_ok"]
                                           + stats["transfer_typed"])
    return stats["peer_sends"] == (stats["peer_ok"] + stats["peer_typed"]
                                   + stats["peer_degraded"])


def test_router_disagg_e2e_identity_and_counters(lms, solo):
    p = _prompt(9, seed=11)
    want = solo(p, 8)
    s1 = ServingServer(_engine(lms[1], role="prefill",
                               prefill_chunk=4)).start()
    s2 = ServingServer(_engine(lms[1], role="decode")).start()
    router = FleetRouter(endpoints=[(s1.host, s1.port), (s2.host, s2.port)],
                         health_interval=0.1).start()
    try:
        for s in (s1, s2):
            assert router.wait_in_rotation((s.host, s.port))
        with ServingClient("127.0.0.1", router.port,
                           connect_timeout=2.0) as c:
            h = c.health()
            assert h["disagg"] is True
            assert h["roles"] == {"prefill": 1, "decode": 1}
            np.testing.assert_array_equal(c.generate(p, 8), want)
            st = c.generate_stream(p, 8)
            for _ in st:
                pass
            np.testing.assert_array_equal(st.sequence, want)
            assert st.served_by == (s2.host, s2.port)
            stats = c.stats()
        # JAX's ledger values: one direct push, one stream relay
        assert stats["disagg_routed"] == 2
        assert (stats["peer_sends"], stats["peer_ok"], stats["peer_typed"],
                stats["peer_degraded"]) == (1, 1, 0, 0)
        assert (stats["transfer_sends"], stats["transfer_ok"],
                stats["transfer_typed"]) == (1, 1, 0)
        assert _paired(stats, "transfer") and _paired(stats, "peer")
        roles = {tuple(r["endpoint"]): r["role"] for r in stats["replicas"]}
        assert roles[(s1.host, s1.port)] == "prefill"
        assert roles[(s2.host, s2.port)] == "decode"
        with ServingClient(s1.host, s1.port, connect_timeout=2.0) as c1:
            t = c1.health()["transfer"]
            assert t["sends"] == 2 and t["errors"] == 0
    finally:
        router.shutdown()
        s1.shutdown()
        s2.shutdown()


@pytest.mark.chaos
def test_router_disagg_mid_transfer_death_fails_over(lms, solo):
    p = _prompt(8, seed=13)
    want = solo(p, 6)
    s1 = ServingServer(_engine(lms[1], role="prefill",
                               prefill_chunk=4)).start()
    s2 = ServingServer(_engine(lms[1], role="decode")).start()
    s3 = ServingServer(_engine(lms[1], role="decode")).start()
    router = FleetRouter(endpoints=[(s.host, s.port) for s in (s1, s2, s3)],
                         health_interval=0.1).start()
    try:
        for s in (s1, s2, s3):
            assert router.wait_in_rotation((s.host, s.port))
        with ServingClient("127.0.0.1", router.port,
                           connect_timeout=2.0) as c:
            np.testing.assert_array_equal(c.generate(p, 6), want)
            s2.shutdown(drain=False)
            for _ in range(3):
                np.testing.assert_array_equal(c.generate(p, 6), want)
            st = c.generate_stream(p, 6)
            for _ in st:
                pass
            np.testing.assert_array_equal(st.sequence, want)
            assert st.served_by == (s3.host, s3.port)
            stats = c.stats()
        assert _paired(stats, "transfer") and _paired(stats, "peer")
        assert stats["transfer_typed"] == 0 and stats["peer_typed"] == 0
    finally:
        router.shutdown()
        s1.shutdown()
        s3.shutdown()


def _warm_on(srv, p, n):
    """Two touches of ``p`` on one replica: its store admits the prefix
    (the two-touch rule) and advertises it in the digest."""
    with ServingClient(srv.host, srv.port, connect_timeout=2.0) as c:
        for _ in range(2):
            c.generate(p, n)


def test_page_aware_routing_digest_and_peer_fetch(lms, solo):
    """Pages warm on the rendezvous LOSER: the router sends the prompt
    there (``digest_routed``). With the holder saturated, the request
    spills to the other replica with a peer hint and that replica fetches
    the prefix from the holder (``fetch_ok``); both replies equal JAX's
    solo decode."""
    a = ServingServer(_engine(lms[1], prefix_cache=True,
                              queue_capacity=1)).start()
    b = ServingServer(_engine(lms[1], prefix_cache=True,
                              queue_capacity=1)).start()
    eps = [(a.host, a.port), (b.host, b.port)]
    rng = np.random.default_rng(21)
    while True:  # a 16-token prompt whose rendezvous home is `a`
        p = rng.integers(0, 61, 17).astype(np.int32)
        if max(eps, key=lambda e: _rendezvous(affinity_key(p), e)) == eps[0]:
            break
    want = solo(p, 4)
    _warm_on(b, p, 4)
    assert b.engine.prefix_store.coverage(p) >= 16
    router = FleetRouter(endpoints=eps, health_interval=0.05).start()
    plan = faults.FaultPlan()
    try:
        for ep in eps:
            assert router.wait_in_rotation(ep)
        with ServingClient("127.0.0.1", router.port,
                           connect_timeout=2.0) as c:
            np.testing.assert_array_equal(c.generate(p, 4), want)
            assert c.last_served_by == eps[1]
        assert router.stats()["digest_routed"] == 1

        # saturate the holder: three generates held in its net.delay seam
        # (capacity 3 = slots + queue); kv.fetch passes undelayed
        plan.arm("net.delay", action="delay", delay=2.5, times=3,
                 when=lambda ctx: ctx["port"] == b.port
                 and ctx["verb"] == "generate").activate()
        held = []

        def hold(i):
            with ServingClient("127.0.0.1", router.port,
                               connect_timeout=2.0) as c:
                held.append(c.generate(p[: 8 + i], 2))

        ths = [threading.Thread(target=hold, args=(i,)) for i in range(3)]
        for t in ths:
            t.start()
        deadline = time.monotonic() + 10
        while plan.fired("net.delay") < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert plan.fired("net.delay") == 3
        with ServingClient("127.0.0.1", router.port,
                           connect_timeout=2.0) as c:
            np.testing.assert_array_equal(c.generate(p, 4), want)
            assert c.last_served_by == eps[0]
        for t in ths:
            t.join(timeout=30)
        assert len(held) == 3
        fab = a.engine.peer_fabric.counters
        assert fab["fetch_ok"] == 1, dict(fab)
        assert a.engine.prefix_store.coverage(p) >= 16
    finally:
        plan.deactivate()
        router.shutdown()
        a.shutdown()
        b.shutdown()
