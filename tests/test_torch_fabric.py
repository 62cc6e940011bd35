"""The fleet KV fabric in the port, against the JAX package.

The JAX counterparts: ``tests/test_fabric.py:111,193,244,324``. Here, on
the same weights (bridged with ``params_from_jax``): a cold port engine
given a ``kv_peers`` hint pulls a warm sibling's prefix rows over the wire
(``kv.fetch``), bit for bit, and decodes JAX's solo tokens, with both
ledgers agreeing on what moved; after the sibling's scheduler restarts,
its old epoch is refused typed ``stale_epoch`` on the wire, in
``serve_prefix`` and by the requester's silent degrade; the ``kv.peer``
seam on either side, a dead peer, a clean miss, a serve-side stall past
the fetch deadline and an open breaker each degrade to recompute,
token-identical; and a port engine fetches from a JAX engine and the
reverse.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    PeerError,
    ServingClient,
    ServingEngine,
    ServingServer,
    StaleEpochError,
)
from distkeras_tpu_torch.serving.prefix_cache import ladder_hashes
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.serialization import serialize_params

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
    """JAX's solo greedy decode, the identity every fetch is held to."""
    from distkeras_tpu.predictors import CachedSequenceGenerator

    gen = CachedSequenceGenerator(lms[0])
    return lambda p, n: np.asarray(gen.generate(p[None], steps=n)[0])


def _prompt(n=18, seed=3):
    return np.random.default_rng(seed).integers(0, 61, n).astype(np.int32)


def _dead_endpoint():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return ("127.0.0.1", port)


def _engine(lm, **kw):
    return ServingEngine(lm, num_slots=2, device="cpu", **kw)


def _warm(eng, p, n=6):
    """Two-touch admission inserts the pow2 ladder on the second pass."""
    for _ in range(2):
        eng.wait(eng.submit(p, n))


def _same_rows(a, b, p):
    pa, kva = a.prefix_store.peek(p)
    pb, kvb = b.prefix_store.peek(p)
    assert pa == pb
    for (k0, v0), (k1, v1) in zip(kva, kvb):
        assert k0.dtype == k1.dtype
        assert np.array_equal(k0, k1) and np.array_equal(v0, v1)
    return pa


def test_peer_fetch_over_wire_identity_and_ledger(lms, solo):
    """A sibling's hint pays: the cold requester pulls the peer's prefix
    rows over the wire, inserts them, and decodes JAX's solo tokens; both
    ledgers agree (one served == one ok, bytes in == bytes out); health
    advertises the epoch and the digest the hint was computed from."""
    lm = lms[1]
    p = _prompt(19, seed=23)
    a = _engine(lm)
    sa = ServingServer(a).start()
    b = _engine(lm).start()
    try:
        _warm(a, p)
        assert a.prefix_store.coverage(p) == 16
        with ServingClient(sa.host, sa.port) as c:
            kf = c.health()["kv_fabric"]
        assert kf["epoch"] == int(a.kv_epoch)
        assert set(kf["digest"]["h"]) >= {h for _, h in ladder_hashes(p[:16])}
        assert set(kf["peer"]) >= {"fetches", "fetch_served", "bytes_out"}

        hint = [{"endpoint": (sa.host, sa.port), "epoch": int(a.kv_epoch),
                 "len": 16}]
        assert b.prefix_store.coverage(p) == 0
        out = b.wait(b.submit(p, 6, kv_peers=hint))
        assert out.tolist() == solo(p, 6).tolist()
        assert b.prefix_store.coverage(p) == 16
        assert _same_rows(a, b, p) == 16
        fb, fa = b.peer_fabric.counters, a.peer_fabric.counters
        assert fb["fetches"] == fb["fetch_ok"] == 1
        assert fb["fetch_degraded"] == 0
        assert fa["fetch_served"] == 1 and fa["stale_refusals"] == 0
        assert fb["bytes_in"] == fa["bytes_out"] > 0
        snap = b.stats()["kv_fabric"]
        assert snap["epoch"] == int(b.kv_epoch) and snap["fetch_ok"] == 1
        assert snap["digest"]["n"] >= 2
        ages = [m["value"] for m in b.metrics_snapshot()
                if m["name"] == "serving_kv_fabric_digest_age_seconds"]
        assert len(ages) == 1 and ages[0] >= 0
        # the fetched rows now serve a local hit: no second dial
        assert b.wait(b.submit(p, 6, kv_peers=hint)).tolist() == (
            out.tolist())
        assert fb["fetches"] == 1
    finally:
        sa.shutdown()
        b.stop()


def test_stale_epoch_refusal_typed_everywhere_after_restart(lms, solo):
    """A scheduler restart re-mints the epoch; the old one is then refused
    on all three faces — typed on the wire, ``StaleEpochError`` from the
    engine, a silent degrade at the requester (identical tokens, nothing
    inserted). The host store survives, so the new epoch serves."""
    from distkeras_tpu_torch.faults import FaultPlan

    lm = lms[1]
    p = _prompt(18, seed=29)
    a = _engine(lm, watchdog_interval=1.0)
    sa = ServingServer(a).start()
    b = None
    try:
        _warm(a, p)
        old = int(a.kv_epoch)
        # the only scheduler running: the seam fires on A's loop
        with FaultPlan(seed=0).arm("scheduler.loop", times=1):
            deadline = time.monotonic() + 30
            while a.health()["restarts"] < 1:
                assert time.monotonic() < deadline, "no restart"
                time.sleep(0.02)
        assert int(a.kv_epoch) != old
        b = _engine(lm).start()
        with ServingClient(sa.host, sa.port) as c:
            reply, _ = c._roundtrip({"verb": "kv.fetch", "epoch": old},
                                    serialize_params(p[:16]),
                                    raise_on_error=False)
            assert reply["ok"] is False and reply["error"] == "stale_epoch"
            assert c.health()["kv_fabric"]["epoch"] == int(a.kv_epoch)
        assert a.peer_fabric.counters["stale_refusals"] == 1
        with pytest.raises(StaleEpochError) as ei:
            a.serve_prefix(p[:16], epoch=old)
        assert ei.value.code == "stale_epoch"
        assert isinstance(ei.value, PeerError)

        hint = [{"endpoint": (sa.host, sa.port), "epoch": old, "len": 16}]
        assert b.wait(b.submit(p, 6, kv_peers=hint)).tolist() == (
            solo(p, 6).tolist())
        assert b.peer_fabric.counters["fetch_degraded"] == 1
        assert b.prefix_store.coverage(p) == 0
        tape = [e for e in b.recorder.snapshot()
                if e["kind"] == "kv.peer.degraded"]
        assert tape and tape[-1]["error"] == "StaleEpochError"
        assert any(e["kind"] == "kv.peer.stale"
                   for e in a.recorder.snapshot())

        hint[0]["epoch"] = int(a.kv_epoch)
        assert b.wait(b.submit(p, 6, kv_peers=hint)).tolist() == (
            solo(p, 6).tolist())
        assert b.peer_fabric.counters["fetch_ok"] == 1
        assert b.prefix_store.coverage(p) == 16
    finally:
        sa.shutdown()
        if b is not None:
            b.stop()


@pytest.mark.chaos
@pytest.mark.parametrize("direction", ["fetch", "serve"])
def test_kv_peer_seam_degrades_identically(lms, solo, direction):
    """The ``kv.peer`` seam on the requester's dial and on the sibling's
    serve each degrade that request to recompute: identical tokens, the
    local store untouched, one ``fetch_degraded``."""
    from distkeras_tpu_torch.faults import FaultPlan

    lm = lms[1]
    a = _engine(lm)
    sa = ServingServer(a).start()
    b = _engine(lm).start()
    p = _prompt(17, seed=41 if direction == "fetch" else 42)
    try:
        _warm(a, p)
        hint = [{"endpoint": (sa.host, sa.port), "epoch": int(a.kv_epoch),
                 "len": 16}]
        plan = FaultPlan(seed=0).arm(
            "kv.peer", times=1,
            when=lambda ctx: ctx.get("direction") == direction)
        with plan:
            out = b.wait(b.submit(p, 6, kv_peers=hint))
        assert plan.fired("kv.peer") == 1
        assert out.tolist() == solo(p, 6).tolist()
        assert b.peer_fabric.counters["fetch_degraded"] == 1
        assert b.prefix_store.coverage(p) == 0
    finally:
        sa.shutdown()
        b.stop()


@pytest.mark.chaos
def test_degrade_to_recompute_per_failure_class(lms, solo):
    """Dead peer, clean miss, a serve-side stall past the fetch deadline,
    an open breaker (last: it poisons the endpoint; the sibling is never
    dialed), each with a fresh prompt: identical tokens, the local store
    untouched, exactly one ``fetch_degraded``, the tape naming the
    class."""
    from distkeras_tpu_torch.faults import FaultPlan

    lm = lms[1]
    a = _engine(lm)
    sa = ServingServer(a).start()
    b = _engine(lm).start()
    b.peer_fabric.fetch_timeout = 0.3  # the deadline class cuts here
    live = (sa.host, sa.port)

    def degrade(seed, endpoint, plan=None, tape_error=None):
        p = _prompt(18, seed=seed)
        hint = [{"endpoint": endpoint, "epoch": int(a.kv_epoch), "len": 16}]
        before = b.peer_fabric.counters["fetch_degraded"]
        if plan is not None:
            with plan:
                out = b.wait(b.submit(p, 6, kv_peers=hint))
        else:
            out = b.wait(b.submit(p, 6, kv_peers=hint))
        assert out.tolist() == solo(p, 6).tolist(), endpoint
        assert b.peer_fabric.counters["fetch_degraded"] == before + 1
        assert b.prefix_store.coverage(p) == 0
        tape = [e for e in b.recorder.snapshot()
                if e["kind"] == "kv.peer.degraded"]
        assert tape and tape[-1]["error"] == tape_error

    try:
        degrade(51, _dead_endpoint(), tape_error="PeerError")
        degrade(52, live, tape_error="miss")
        assert a.peer_fabric.counters["fetch_miss"] >= 1
        degrade(53, live, plan=FaultPlan(seed=0).arm(
            "kv.peer", action="delay", delay=1.0, times=2,
            when=lambda ctx: ctx.get("direction") == "serve"),
            tape_error="PeerError")
        br = b.peer_fabric.breaker(live)
        for _ in range(5):
            br.record_failure()
        answered = lambda: sum(a.peer_fabric.counters[k] for k in (  # noqa: E731
            "fetch_served", "fetch_miss", "stale_refusals"))
        answered0 = answered()
        skips0 = b.peer_fabric.counters["breaker_skips"]
        degrade(54, live, tape_error="PeerError")
        assert b.peer_fabric.counters["breaker_skips"] == skips0 + 1
        assert answered() == answered0  # never dialed
    finally:
        sa.shutdown()
        b.stop()


@pytest.mark.parametrize("direction", ["port_from_jax", "jax_from_port"])
def test_fetch_across_implementations(lms, solo, direction):
    """A port engine fetches a JAX sibling's rows over the wire, and a JAX
    engine a port sibling's: bit for bit, JAX's solo tokens, one
    ``fetch_ok``."""
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving import ServingServer as JServer

    jlm, lm = lms
    p = _prompt(20, seed=37)
    if direction == "port_from_jax":
        a, b = JEngine(jlm, num_slots=2), _engine(lm).start()
        sa = JServer(a).start()
    else:
        a, b = _engine(lm), JEngine(jlm, num_slots=2).start()
        sa = ServingServer(a).start()
    try:
        _warm(a, p)
        hint = [{"endpoint": (sa.host, sa.port), "epoch": int(a.kv_epoch),
                 "len": 16}]
        out = np.asarray(b.wait(b.submit(p, 6, kv_peers=hint)))
        assert out.tolist() == solo(p, 6).tolist()
        assert b.peer_fabric.counters["fetch_ok"] == 1
        assert a.peer_fabric.counters["fetch_served"] == 1
        assert _same_rows(a, b, p) == 16
    finally:
        sa.shutdown()
        b.stop()
