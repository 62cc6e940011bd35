"""The port's serving TCP front (``ServingServer``, ``ServingClient``,
``TokenStream``) on the CPU, against the JAX package.

The tiny LM of ``tests/test_torch_serving.py`` (vocab 61, d128, 2 heads,
depth 2) with weights bridged from JAX: wire generate (greedy and
seeded-sampled) equals JAX's solo decode token for token, wire predict
equals JAX's ``ModelPredictor`` within 1e-4, streamed chunks concatenate
to the full sequence, the typed errors, the engine's obs verbs, stop and
shutdown, and both packages' clients against both packages' servers with
the same reply header keys. Every socket binds ``127.0.0.1:0``, dial
timeouts are 2 s, every wait is bounded. The JAX package is imported
inside the fixtures and helpers, so the ``gpu``-marked test also runs on
a machine without JAX (``python -m pytest --noconftest
tests/test_torch_serving_front.py -m gpu``).
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults, networking
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import parse_prometheus, timeline_complete
from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
from distkeras_tpu_torch.serving import (
    DeadlineExceededError,
    EngineStoppedError,
    InternalError,
    OverloadedError,
    RetryBudget,
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
    serve,
)
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.serialization import (
    pack_frame,
    serialize_params,
    unpack_frame,
)

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=64, d_model=128, num_heads=2, depth=2)
SAMPLING = {"temperature": 0.8, "seed": 9}


def _jax_lm():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    return jlm, jax.tree.map(np.asarray, jlm.params)


@pytest.fixture(scope="module")
def lms():
    jlm, params = _jax_lm()
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, params)
    attach_fused_layernorm(lm)  # the generate path's hook (plain on CPU)
    return jlm, lm


@pytest.fixture(scope="module")
def served(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=8, device="cpu")
    srv = ServingServer(eng).start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jserved(lms):
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving import ServingServer as JServer

    jlm, _ = lms
    srv = JServer(JEngine(jlm, num_slots=2, prefill_chunk=8)).start()
    yield srv
    srv.shutdown()


def _client(srv, **kw):
    kw.setdefault("timeout", 60)
    kw.setdefault("connect_timeout", 2)
    return ServingClient(srv.host, srv.port, **kw)


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, n).astype(np.int32) for n in lens]


def _solo(jlm, prompt, n, sampling=None):
    """JAX's solo decode of one prompt."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    kw = {} if sampling is None else dict(temperature=sampling["temperature"],
                                          seed=sampling["seed"])
    return np.asarray(JCached(jlm, **kw).generate(prompt[None], n))[0]


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _concurrent(srv, prompts, n, make=_client, **gen_kw):
    """One client per thread, as a user fans out; returns the replies."""
    out = [None] * len(prompts)
    errs = []

    def work(i):
        try:
            with make(srv) as c:
                out[i] = c.generate(prompts[i], n, **gen_kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    return out


# --------------------------------------------------------------- parity


@pytest.mark.parametrize("sampling", [None, SAMPLING],
                         ids=["greedy", "sampled"])
def test_wire_generate_matches_jax_solo_decode(lms, served, sampling):
    """4 client threads on 2 slots with an 8-token prefill budget."""
    jlm, _ = lms
    prompts = _prompts((5, 30, 17, 3))
    outs = _concurrent(served, prompts, 10, sampling=sampling)
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _solo(jlm, p, 10, sampling))


def test_wire_predict_matches_jax_model_predictor(lms, served):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.predictors import ModelPredictor as JPredictor

    jlm, _ = lms
    x = np.random.default_rng(3).integers(0, 61, (5, 64)).astype(np.int32)
    want = JPredictor(jlm, batch_size=4).predict(
        JDataset({"features": x}))["prediction"]
    with _client(served) as c:
        got = c.predict(x)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_stream_chunks_concatenate_to_the_full_sequence(lms, served):
    jlm, _ = lms
    p = _prompts((9,), seed=4)[0]
    with _client(served) as c:
        plain = c.generate(p, 12)
        st = c.generate_stream(p, 12, trace=True)
        chunks = [chunk for chunk in st]
        spans = c.last_trace["spans"]
    np.testing.assert_array_equal(np.concatenate([p, *chunks]), plain)
    np.testing.assert_array_equal(st.sequence, plain)
    np.testing.assert_array_equal(plain, _solo(jlm, p, 12))
    assert st.ttft_s is not None and st.ttft_s > 0
    assert len(st.inter_token_s) == len(chunks) - 1
    names = [s["name"] for s in spans]
    assert names.count("serving.stream_chunk") == len(chunks) == 12
    assert timeline_complete(spans)
    assert served.engine.stats()["streamed_chunks"] >= 12


def test_traced_generate_returns_a_complete_timeline(served):
    p = _prompts((20,), seed=5)[0]
    with _client(served) as c:
        c.generate(p, 4, trace=True)
        tr = c.last_trace
    spans = tr["spans"]
    assert timeline_complete(spans)
    by = {s["name"]: s for s in spans}
    for name in ("serving.queue", "serving.prefill", "serving.decode",
                 "server.generate", "client.request"):
        assert name in by, name
    assert sum(s["name"] == "serving.prefill_chunk" for s in spans) == 3
    assert {s["trace_id"] for s in spans} == {tr["trace_id"]}
    server_span = by["server.generate"]
    for name in ("serving.queue", "serving.prefill", "serving.decode"):
        assert by[name]["parent_id"] == server_span["span_id"]
    assert by["serving.decode"]["attrs"] == {"iterations": 4, "tokens": 4}


# ---------------------------------------------------------- typed errors


def _busy_engine(lm, **kw):
    """A one-slot engine whose scheduler sleeps 50 ms per busy iteration
    while the returned plan is active: a long request holds the slot and
    a second one the one-deep queue, deterministically."""
    eng = ServingEngine(lm, num_slots=1, queue_capacity=1, device="cpu", **kw)
    plan = faults.FaultPlan().arm("scheduler.loop", action="delay",
                                  delay=0.05, times=None,
                                  when=lambda ctx: ctx["busy"])
    return eng, plan


def _fill(eng):
    a = eng.submit(np.arange(3, dtype=np.int32), 40)
    assert _wait(lambda: eng.batcher.load()["active_slots"] == 1)
    b = eng.submit(np.arange(4, dtype=np.int32), 4)
    return a, b


def test_overloaded_reply_carries_retry_after_ms(lms):
    _, lm = lms
    eng, plan = _busy_engine(lm)
    srv = ServingServer(eng, retry_after_ms=75.0).start()
    try:
        with plan:
            held = _fill(eng)
            with _client(srv, retry=False) as c:
                with pytest.raises(OverloadedError) as ei:
                    c.generate(np.arange(5, dtype=np.int32), 2)
        assert ei.value.code == "overloaded"
        assert ei.value.retry_after == pytest.approx(0.075)
        assert all(eng.wait(r, timeout=60) is not None for r in held)
        assert eng.stats()["rejected_overloaded"] == 1
    finally:
        srv.shutdown()


def test_retrying_client_backs_off_overloaded_and_succeeds(lms):
    jlm, lm = lms
    eng, plan = _busy_engine(lm)
    srv = ServingServer(eng, retry_after_ms=20.0).start()
    p = np.arange(5, dtype=np.int32)
    try:
        with plan:
            _fill(eng)
            policy = networking.RetryPolicy(max_attempts=400,
                                            base_delay=0.01, max_delay=0.05)
            with _client(srv, retry=policy) as c:
                out = c.generate(p, 3)
                retries = c.retries
        np.testing.assert_array_equal(out, _solo(jlm, p, 3))
        assert retries >= 1
    finally:
        srv.shutdown()


def test_retry_budget_exhaustion_surfaces_the_original_error(lms):
    _, lm = lms
    eng, plan = _busy_engine(lm)
    srv = ServingServer(eng).start()
    try:
        with plan:
            _fill(eng)
            budget = RetryBudget(ratio=0.0, burst=1.0)
            policy = networking.RetryPolicy(max_attempts=50,
                                            base_delay=0.001, max_delay=0.002)
            with _client(srv, retry=policy, retry_budget=budget) as c:
                with pytest.raises(OverloadedError):
                    c.generate(np.arange(5, dtype=np.int32), 2)
                assert c.retries == 1 and c.budget_refused == 1
        assert budget.snapshot() == {"tokens": 0.0, "attempts": 1,
                                     "grants": 1, "exhausted": 1}
    finally:
        srv.shutdown()


def test_deadline_exceeded_is_typed(served):
    with _client(served, retry=False) as c:
        with pytest.raises(DeadlineExceededError) as ei:
            c.generate(np.arange(1, 4, dtype=np.int32), 8, deadline_ms=0,
                       trace=True)
    assert ei.value.code == "deadline_exceeded"
    assert ei.value.trace_id == c.last_trace["trace_id"]
    assert timeline_complete(c.last_trace["spans"])


def test_stopping_is_typed_while_the_engine_drains(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng).start()
    try:
        eng.stop(drain=True)
        with _client(srv, retry=False) as c:
            with pytest.raises(EngineStoppedError) as ei:
                c.generate(np.arange(4, dtype=np.int32), 2)
            assert ei.value.code == "stopping"
            assert c.health()["status"] == "draining"
    finally:
        srv.shutdown()


def test_frame_too_large_is_salvaged_and_health_carries_the_limit(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng, max_frame_bytes=1 << 16).start()
    try:
        with _client(srv) as c:
            assert c.health()["max_frame_bytes"] == 1 << 16
            assert c.max_frame_bytes == 1 << 16
            big = np.zeros((300, 128), np.float32)  # ~150 KiB > 64 KiB
            with pytest.raises(ServingError) as ei:
                c.predict(big)
            assert ei.value.code == "frame_too_large"
            assert c._last_fatal.startswith("frame_too_large")
            # the client redials transparently afterwards
            assert c.health()["status"] == "serving"
    finally:
        srv.shutdown()


def test_oversized_declared_frame_is_refused_before_buffering(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng, max_frame_bytes=1 << 16).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as s:
            s.sendall(struct.pack(">Q", 1 << 40) + b"xx")
            header, _ = unpack_frame(networking.recv_data(s))
            assert header["error"] == "frame_too_large"
            assert header["fatal"] is True
            assert header["max_frame_bytes"] == 1 << 16
            try:
                assert s.recv(1) == b""
            except ConnectionResetError:
                pass
    finally:
        srv.shutdown()


@pytest.mark.parametrize("verb", ["prefill", "kv.transfer", "kv.fetch"])
def test_disaggregation_verbs_are_bad_request_on_an_open_connection(
        served, verb):
    """Not ported: typed ``bad_request`` (unknown verb), and the same
    connection keeps serving."""
    header = {"verb": verb, "max_new_tokens": 2}
    if verb == "kv.transfer":
        header["stream"] = True
    with _client(served, retry=False) as c:
        sock = c._sock
        with pytest.raises(ServingError) as ei:
            c._call(header, serialize_params(np.arange(4, dtype=np.int32)))
        assert ei.value.code == "bad_request"
        assert "unknown verb" in str(ei.value)
        assert c.health()["status"] == "serving"
        assert c._sock is sock


def test_unknown_verb_error_is_stamped_with_the_trace_id(served):
    with _client(served, retry=False) as c:
        reply, _ = c._roundtrip({"verb": "nope", "trace": {"id": "abc"}},
                                b"", raise_on_error=False)
    assert reply["error"] == "bad_request"
    assert reply["trace"] == {"id": "abc"}


# ------------------------------------------------------- fault seams


def test_server_fault_seams(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng).start()
    plan = (faults.FaultPlan()
            .arm("server.dispatch", when=lambda ctx: ctx["verb"] == "stats")
            .arm("net.delay", action="delay", delay=0.01, times=None,
                 when=lambda ctx: ctx["port"] == srv.port)
            .arm("server.reply", action="drop", after=2))
    try:
        with plan, _client(srv, retry=False) as c:
            with pytest.raises(ServingError) as ei:
                c.stats()
            assert ei.value.code == "bad_request"
            assert "injected fault at server.dispatch" in str(ei.value)
            c.health()
            with pytest.raises(ConnectionError):
                c.predict(np.zeros((1, 64), np.int32))  # reply dropped
        assert plan.fired("server.reply") == 1
        assert plan.fired("net.delay") == 1  # data verbs only
        with _client(srv) as c:
            assert c.stats()["open_connections"] == 1
    finally:
        srv.shutdown()


def test_dropped_reply_is_a_connection_error_then_a_redial(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng).start()
    plan = faults.FaultPlan().arm("server.reply", action="drop")
    try:
        with plan, _client(srv, retry=False) as c:
            with pytest.raises(ConnectionError):
                c.health()
            assert c.health()["status"] == "serving"
    finally:
        srv.shutdown()


def test_hedged_generate_ledger_balances(lms, served):
    jlm, _ = lms
    p = _prompts((6,), seed=8)[0]
    with _client(served, hedge_after=0.0) as c:
        out = c.generate(p, 5)
        assert _wait(lambda: c.hedges_launched
                     == c.hedge_wins + c.hedge_losers)
        assert c.hedges_launched == 1
    np.testing.assert_array_equal(out, _solo(jlm, p, 5))


# ----------------------------------------------------- the obs verbs


def test_metrics_timeseries_health_and_stats_verbs(served):
    with _client(served) as c:
        c.generate(np.arange(6, dtype=np.int32), 3)
        samples = c.metrics()
        text = c.metrics(prometheus=True)
        ts = c.timeseries(window=60)
        health = c.health()
        stats = c.stats()
        pm = c.postmortem()
    names = {s["name"] for s in samples}
    for name in ("serving_scheduler_completed",
                 "serving_scheduler_tokens_generated",
                 "serving_scheduler_queue_depth",
                 "serving_request_total_seconds",
                 "serving_server_open_connections",
                 "serving_trace_collector_dropped",
                 "serving_recorder_events"):
        assert name in names, name
    parsed = {n for n, _, _ in parse_prometheus(text)}
    assert "serving_scheduler_completed_total" in parsed
    assert ts["ok"] and ts["burn"] is None
    assert any(r["name"] == "serving_scheduler_completed"
               for r in ts["series"])
    assert health["status"] == "serving"
    assert health["endpoint"] == [served.host, served.port]
    assert health["protocol"] == 1
    assert stats["open_connections"] >= 1 and stats["completed"] >= 1
    assert pm is None


def test_timeseries_refused_without_history(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, history=False, device="cpu")
    srv = ServingServer(eng).start()
    try:
        with _client(srv, retry=False) as c:
            with pytest.raises(ServingError) as ei:
                c.timeseries()
            assert ei.value.code == "bad_request"
    finally:
        srv.shutdown()


def test_scheduler_crash_fails_typed_and_serves_a_postmortem(lms, tmp_path):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu",
                        postmortem_dir=str(tmp_path))
    srv = ServingServer(eng).start()
    plan = faults.FaultPlan().arm("scheduler.loop",
                                  when=lambda ctx: ctx["busy"])
    try:
        with plan, _client(srv, retry=False) as c:
            with pytest.raises(InternalError):
                c.generate(np.arange(4, dtype=np.int32), 3, trace=True)
            bundle = c.postmortem()
            assert c.last_postmortem_path is not None
            assert c.health()["status"] == "degraded"
        assert bundle["component"] == "serving_engine"
        assert bundle["reason"] == "degraded"
        assert [r["state"] for r in bundle["in_flight"]] == ["queued"]
        assert bundle["in_flight"][0]["trace_id"] is not None
        kinds = [e["kind"] for e in bundle["events"]]
        assert "fault.fired" in kinds and "engine.degraded" in kinds
    finally:
        srv.shutdown()


def test_metrics_path_logs_submit_complete_and_spans(lms, tmp_path):
    _, lm = lms
    path = tmp_path / "serving.jsonl"
    eng = ServingEngine(lm, num_slots=1, metrics_path=str(path),
                        device="cpu")
    srv = ServingServer(eng).start()
    try:
        with _client(srv) as c:
            c.generate(np.arange(4, dtype=np.int32), 2, trace=True)
    finally:
        srv.shutdown()
    events = [json.loads(line)["event"] for line in path.read_text().split("\n")
              if line]
    assert events.count("serving_submit") == 1
    assert events.count("serving_complete") == 1
    assert events.count("trace_span") >= 5


# ------------------------------------------------- stop and shutdown


def test_stop_verb_drains_in_flight_and_races_shutdown(lms):
    jlm, lm = lms
    eng = ServingEngine(lm, num_slots=2, queue_capacity=8, device="cpu")
    srv = serve(eng)
    prompt = np.arange(1, 5, dtype=np.int32)
    result = [None]

    def worker():
        with _client(srv) as c:
            result[0] = c.generate(prompt, 10)

    th = threading.Thread(target=worker)
    th.start()
    assert _wait(lambda: eng.stats()["active_slots"]
                 + eng.stats()["queue_depth"] >= 1)
    with _client(srv) as c:
        assert c.stop()["stopping"]
    srv.shutdown()  # races the verb's side thread; waits for it
    with pytest.raises(EngineStoppedError):
        eng.generate(prompt, 2)
    assert not any(t.is_alive() for t in srv._conn_threads)
    th.join(timeout=60)
    assert not th.is_alive()
    np.testing.assert_array_equal(result[0], _solo(jlm, prompt, 10))


def test_shutdown_not_stalled_by_an_idle_connection(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu")
    srv = ServingServer(eng).start()
    idle = _client(srv)  # holds a connection, sends nothing
    try:
        t0 = time.monotonic()
        srv.shutdown()
        assert time.monotonic() - t0 < 15
        assert not any(t.is_alive() for t in srv._conn_threads)
    finally:
        idle.close()


# ----------------------------------------------- across the packages


def _jclient(srv, **kw):
    from distkeras_tpu.serving import ServingClient as JClient

    return JClient(srv.host, srv.port, timeout=60, connect_timeout=2, **kw)


@pytest.mark.parametrize("sampling", [None, SAMPLING],
                         ids=["greedy", "sampled"])
def test_jax_client_against_the_port_server(lms, served, sampling):
    jlm, _ = lms
    prompts = _prompts((7, 22), seed=11)
    outs = _concurrent(served, prompts, 8, make=_jclient, sampling=sampling)
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _solo(jlm, p, 8, sampling))
    with _jclient(served) as c:
        st = c.generate_stream(prompts[0], 8, sampling=sampling)
        np.testing.assert_array_equal(np.concatenate([prompts[0], *st]),
                                      outs[0])


@pytest.mark.parametrize("sampling", [None, SAMPLING],
                         ids=["greedy", "sampled"])
def test_port_client_against_the_jax_server(lms, served, jserved, sampling):
    jlm, _ = lms
    prompts = _prompts((7, 22), seed=12)
    outs = _concurrent(jserved, prompts, 8, sampling=sampling)
    port = _concurrent(served, prompts, 8, sampling=sampling)
    for p, o, q in zip(prompts, outs, port):
        np.testing.assert_array_equal(o, _solo(jlm, p, 8, sampling))
        np.testing.assert_array_equal(o, q)
    with _client(jserved) as c:
        st = c.generate_stream(prompts[1], 8, sampling=sampling)
        np.testing.assert_array_equal(np.concatenate([prompts[1], *st]),
                                      outs[1])
        x = np.random.default_rng(2).integers(0, 61, (2, 64)).astype(np.int32)
        np.testing.assert_allclose(c.predict(x), _client(served).predict(x),
                                   atol=1e-4, rtol=0)


def _raw(srv, header, payload=b""):
    """Every frame one request brings back (a stream's chunks, then its
    terminal frame), as headers."""
    with socket.create_connection((srv.host, srv.port), timeout=60) as s:
        networking.send_data(s, pack_frame(header, payload))
        out = []
        while True:
            reply, _ = unpack_frame(networking.recv_data(s))
            out.append(reply)
            if reply.get("stream") != "chunk":
                return out


def _keys(reply):
    """Header keys without timing values; span records by name."""
    out = {"keys": sorted(reply)}
    if isinstance(reply.get("trace"), dict):
        tl = reply["trace"].get("timeline") or []
        out["trace"] = sorted(reply["trace"])
        out["spans"] = sorted(
            (s["name"], tuple(sorted(s)), tuple(sorted(s.get("attrs", {}))))
            for s in tl if s["name"] != "xla.compile"
        )
    return out


REQUESTS = {
    "generate": ({"verb": "generate", "max_new_tokens": 4}, True),
    "traced": ({"verb": "generate", "max_new_tokens": 4,
                "trace": {"id": "t1", "span": "s1", "return": True}}, True),
    "stream": ({"verb": "generate", "max_new_tokens": 4, "stream": True},
               True),
    "deadline": ({"verb": "generate", "max_new_tokens": 4,
                  "deadline_ms": 0}, True),
    "predict": ({"verb": "predict"}, False),
    "unknown": ({"verb": "nope"}, False),
    "prometheus": ({"verb": "metrics", "format": "prometheus"},
                          False),
}


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_reply_headers_have_the_same_keys_on_both_servers(served, jserved,
                                                          kind):
    header, is_generate = REQUESTS[kind]
    prompt = np.arange(1, 7, dtype=np.int32)
    payload = serialize_params(prompt if is_generate
                               else np.zeros((1, 64), np.int32))
    # warm the JAX engine's programs for this prompt so no compile span
    # lands in the traced timeline
    _raw(jserved, {"verb": "generate", "max_new_tokens": 4}, payload)
    ours = _raw(served, dict(header), payload)
    theirs = _raw(jserved, dict(header), payload)
    assert [_keys(r) for r in ours] == [_keys(r) for r in theirs]


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_wire_generate_launches_the_layernorm_kernel_on_card():
    """The tiny LM (seeded weights) on the card behind a server: one wire
    generate launches B7 exactly as often as its prefill chunks and decode
    steps need, and decodes what the solo generator does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    lm = zoo.transformer_lm(**LM)
    assert attach_fused_layernorm(lm) == 5
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=8)
    srv = ServingServer(eng).start()
    p = _prompts((12,), seed=13)[0]
    try:
        eng._stepper.warmup()
        kernels.reset_launch_counts()
        with _client(srv) as c:
            out = c.generate(p, 6)
        counts = kernels.launch_counts()
    finally:
        srv.shutdown()
    # 2 per block in each prefill chunk (two chunks: 8 and 3 positions),
    # and 2 per block plus the final norm in each of the 6 decode steps
    assert counts["layernorm_fwd"] == 4 * 2 + 5 * 6
    assert counts["flash_fwd"] == 0
    want = CachedSequenceGenerator(lm).generate(p[None], 6)[0]
    np.testing.assert_array_equal(out, want)


def test_tenant_labels_are_bounded(lms):
    """``tenant`` is a client-chosen wire string: it labels the latency
    histograms up to ``MAX_TENANT_LABELS`` names, the rest share one."""
    from distkeras_tpu_torch.serving.engine import (
        MAX_TENANT_LABELS,
        OTHER_TENANTS,
    )

    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, device="cpu").start()
    try:
        for i in range(MAX_TENANT_LABELS + 3):
            eng.generate(np.arange(3, dtype=np.int32), 1, tenant=f"t{i}",
                         timeout=60)
    finally:
        eng.stop()
    tenants = [s.get("labels", {}).get("tenant")
               for s in eng.metrics_snapshot()
               if s["name"] == "serving_request_total_seconds"]
    assert len(tenants) == MAX_TENANT_LABELS + 2  # + unlabeled + folded
    assert None in tenants and OTHER_TENANTS in tenants
