"""The port's ``obs.tracing``, the client half of ``serving.resilience``
and the scheduler's request ledger, against the JAX package on the same
inputs: trace contexts cross both wires, span records and timelines have
one schema, retry budgets, latency windows and hedge delays give JAX's
answers, the typed errors keep JAX's codes and subclassing, and streamed
chunks never lose the last token to the eviction."""

import numpy as np
import pytest

from distkeras_tpu.obs import tracing as jt
from distkeras_tpu.serving import resilience as jr
from distkeras_tpu.serving import scheduler as js
from distkeras_tpu.utils.profiling import MetricsLogger as JLogger
from distkeras_tpu_torch.obs import tracing as tt
from distkeras_tpu_torch.serving import resilience as tr
from distkeras_tpu_torch.serving import scheduler as ts
from distkeras_tpu_torch.utils.profiling import MetricsLogger, read_metrics

# ------------------------------------------------------------- tracing


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("timeline", [False, True])
def test_trace_context_wire_round_trips_across_packages(direction, timeline):
    src, dst = (tt, jt) if direction == "port->jax" else (jt, tt)
    ctx = src.TraceContext.new(want_timeline=timeline).child()
    got = dst.TraceContext.from_wire(ctx.to_wire())
    assert (got.trace_id, got.span_id, got.parent_id, got.want_timeline) == (
        ctx.trace_id, ctx.span_id, ctx.parent_id, timeline)
    assert got.to_wire() == ctx.to_wire()
    child = got.child()
    assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id


@pytest.mark.parametrize("field", [None, "x", {}, {"id": ""}, {"span": "s"},
                                   {"id": "t", "parent": ""}])
def test_malformed_trace_fields_parse_alike(field):
    a, b = tt.TraceContext.from_wire(field), jt.TraceContext.from_wire(field)
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.trace_id, a.parent_id, a.want_timeline) == (
            b.trace_id, b.parent_id, b.want_timeline)


def test_span_records_and_error_stamps_match_jax():
    args = ("serving.decode", "t", "s", "p", 12.3456789, 0.0123456)
    kw = dict(status="ok", terminal=True, iterations=4, tokens=4)
    assert tt.span_record(*args, **kw) == jt.span_record(*args, **kw)
    assert tt.span_record(*args) == jt.span_record(*args)
    for req_header in ({}, {"trace": {"id": "abc"}}, {"trace": "junk"}):
        for exc in (ValueError("x"), type("E", (Exception,), {})()):
            a, b = {}, {}
            tt.stamp_error_trace(a, req_header, exc)
            jt.stamp_error_trace(b, req_header, exc)
            assert a == b
    exc = ValueError("x")
    exc.trace = {"id": "full", "timeline": []}
    a, b = {}, {}
    tt.stamp_error_trace(a, {"trace": {"id": "abc"}}, exc)
    jt.stamp_error_trace(b, {"trace": {"id": "abc"}}, exc)
    assert a == b == {"trace": {"id": "full", "timeline": []}}
    spans = [{"terminal": True}, {}]
    assert tt.timeline_complete(spans) == jt.timeline_complete(spans) is True
    assert tt.timeline_complete(spans * 2) == jt.timeline_complete(
        spans * 2) is False


def test_span_end_is_idempotent_and_recorded():
    col = tt.TraceCollector(capacity=4)
    ctx = tt.TraceContext.new()
    span = tt.start_span("client.request", ctx, collector=col, verb="g")
    rec = span.end(status="ok", terminal=True, attempts=1)
    assert span.end(status="other") is rec
    assert rec["attrs"] == {"verb": "g", "attempts": 1}
    assert col.spans_for(ctx.trace_id) == [rec]


def test_collector_ring_drops_and_drain_match_jax(tmp_path):
    fired = {"port": 0, "jax": 0}
    cols = {
        "port": tt.TraceCollector(capacity=3, on_drop=lambda: fired.update(
            port=fired["port"] + 1)),
        "jax": jt.TraceCollector(capacity=3, on_drop=lambda: fired.update(
            jax=fired["jax"] + 1)),
    }
    recs = [tt.span_record(f"s{i}", "t", f"id{i}", None, i, 0.001)
            for i in range(5)]
    for col in cols.values():
        for r in recs:
            col.record(dict(r))
    assert fired == {"port": 1, "jax": 1}
    ours = MetricsLogger(str(tmp_path / "port.jsonl"))
    theirs = JLogger(str(tmp_path / "jax.jsonl"))
    assert cols["port"].drain_to(ours) == cols["jax"].drain_to(theirs) == 3
    assert cols["port"].dropped == cols["jax"].dropped == 0
    assert cols["port"].dropped_total == cols["jax"].dropped_total == 2

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "ts"} for r in rows]

    assert strip(read_metrics(str(tmp_path / "port.jsonl"))) == strip(
        read_metrics(str(tmp_path / "jax.jsonl")))
    with pytest.raises(ValueError):
        tt.TraceCollector(capacity=0)


class _Req:
    """The fields ``request_spans`` reads, stamped as the scheduler
    stamps them."""

    def __init__(self, stream_chunks=0):
        self.created, self.started = 100.0, 100.5
        self.prefill_finished, self.finished = 101.0, 103.0
        self.prefill_chunks, self.iterations = 2, 4
        self.tokens = [1, 2, 3, 4]
        self.events = [
            {"name": "serving.prefill_chunk", "t0": 100.5, "t1": 100.7,
             "tokens": 8, "slot": 0},
            {"name": "serving.prefill_chunk", "t0": 100.7, "t1": 101.0,
             "tokens": 3, "slot": 0},
        ] + [
            {"name": "serving.stream_chunk", "t0": 101 + i * 0.5,
             "t1": 101.1 + i * 0.5, "tokens": 1}
            for i in range(stream_chunks)
        ]


@pytest.mark.parametrize("stream_chunks", [0, 4])
def test_request_spans_match_jax_structure(stream_chunks):
    ctx = tt.TraceContext.new(want_timeline=True)
    jctx = jt.TraceContext(ctx.trace_id, ctx.span_id, None, True)
    ours = tt.request_spans(_Req(stream_chunks), ctx, collector=None)
    theirs = jt.request_spans(_Req(stream_chunks), jctx, collector=None)

    def shape(spans):
        ids = {s["span_id"]: s["name"] for s in spans}
        return [(s["name"], ids.get(s["parent_id"], s["parent_id"]),
                 s["duration_ms"], s.get("attrs")) for s in spans]

    assert shape(ours) == shape(theirs)
    assert [s["name"] for s in ours].count("serving.prefill_chunk") == 2
    assert [s["name"] for s in ours].count("serving.stream_chunk") == \
        stream_chunks


# ----------------------------------------------------------- resilience


def _budget_trace(mod):
    b = mod.RetryBudget(ratio=0.5, burst=2.0)
    seq = []
    for step in range(12):
        if step % 3 == 0:
            b.note_attempt(2 if step % 2 else 1)
        seq.append(b.acquire())
    seq.append(b.acquire(0.25))
    return seq, b.snapshot(), b.tokens


def test_retry_budget_matches_jax():
    assert _budget_trace(tr) == _budget_trace(jr)
    for mod in (tr, jr):
        with pytest.raises(ValueError):
            mod.RetryBudget(ratio=-1)
        with pytest.raises(ValueError):
            mod.RetryBudget(burst=0.5)


@pytest.mark.parametrize("spec", [None, False, True, 0, {"ratio": 0.2,
                                                         "burst": 3.0}])
def test_as_retry_budget_coerces_like_jax(spec):
    a, b = tr.as_retry_budget(spec), jr.as_retry_budget(spec)
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.ratio, a.burst, a.snapshot()) == (b.ratio, b.burst,
                                                    b.snapshot())
    shared = tr.RetryBudget()
    assert tr.as_retry_budget(shared) is shared
    with pytest.raises(TypeError):
        tr.as_retry_budget("lots")


def test_latency_tracker_matches_jax():
    xs = np.random.default_rng(0).exponential(0.05, 300)
    a = tr.LatencyTracker(capacity=64, min_samples=8)
    b = jr.LatencyTracker(capacity=64, min_samples=8)
    for i, x in enumerate(xs):
        a.note(x)
        b.note(x)
        if i in (3, 7, 50, 299):
            for q in (0.0, 0.5, 0.95, 0.99, 1.0):
                assert a.quantile(q) == b.quantile(q)
    assert len(a) == len(b) == 64


@pytest.mark.parametrize("spec", [None, 0, 0.25, 2, "p95", "p50", "p99.9"])
def test_resolve_hedge_delay_matches_jax(spec):
    a, b = tr.LatencyTracker(min_samples=4), jr.LatencyTracker(min_samples=4)
    assert tr.resolve_hedge_delay(spec, a) == jr.resolve_hedge_delay(spec, b)
    for x in (0.1, 0.3, 0.2, 0.4, 0.9):
        a.note(x)
        b.note(x)
    assert tr.resolve_hedge_delay(spec, a) == jr.resolve_hedge_delay(spec, b)
    assert tr.resolve_hedge_delay(spec, None) == jr.resolve_hedge_delay(
        spec, None)


@pytest.mark.parametrize("spec", ["95p", "p0", "p100", -1.0])
def test_bad_hedge_specs_are_refused_like_jax(spec):
    with pytest.raises(ValueError):
        tr.resolve_hedge_delay(spec, None)
    with pytest.raises(ValueError):
        jr.resolve_hedge_delay(spec, None)


# ------------------------------------------------------------ scheduler


ERRORS = ["ServingError", "OverloadedError", "PoolExhaustedError",
          "ShedError", "QuotaExhaustedError", "WrongRoleError", "PeerError",
          "StaleEpochError", "DeadlineExceededError", "EngineStoppedError",
          "InternalError"]


@pytest.mark.parametrize("name", ERRORS)
def test_typed_errors_keep_jax_codes_and_subclassing(name):
    ours, theirs = getattr(ts, name), getattr(js, name)
    assert ours.code == theirs.code
    for other in ERRORS:
        assert issubclass(ours, getattr(ts, other)) == issubclass(
            theirs, getattr(js, other)), other
    if hasattr(theirs("m"), "retry_after_ms"):
        e, f = ours("m", retry_after_ms=120.0), theirs("m",
                                                       retry_after_ms=120.0)
        assert (e.retry_after_ms, e.retry_after) == (f.retry_after_ms,
                                                     f.retry_after)


class _Stepper:
    """A host-only stepper: each slot emits its own admission id."""

    num_slots, max_len = 2, 32

    def __init__(self):
        self.tok = {}

    def begin_admit(self, slot, prompt, sampling=None):
        self.tok[slot] = int(prompt[0])
        return max(0, len(prompt) - 1)

    def prefill_chunk(self, slot, budget):
        return 0

    def release(self, slot):
        self.tok.pop(slot, None)

    def step(self, active):
        return np.array([self.tok.get(i, -1) for i in range(self.num_slots)])


def _drive(batcher, reqs, limit=200):
    for _ in range(limit):
        batcher.step()
        if all(r.done for r in reqs):
            return
    raise AssertionError("requests did not finish")


def test_stream_pushes_every_token_before_the_eviction():
    b = ts.ContinuousBatcher(_Stepper(), prefill_chunk=4)
    reqs = [ts.ServeRequest([7, 1, 1], 5, stream=True),
            ts.ServeRequest([9, 1], 3, eos_id=9, stream=True),
            ts.ServeRequest([5], 2)]
    for r in reqs:
        b.submit(r)
    _drive(b, reqs)
    for r in reqs[:2]:
        chunks = []
        while (c := r.next_chunk(timeout=1)) is not None:
            chunks.append(c)
        assert sum(chunks, []) == r.tokens
        assert r.result(0).tolist() == r.prompt.tolist() + r.tokens
    assert reqs[1].tokens == [9]  # eos on the first token: one chunk
    assert b.stats()["streamed_chunks"] == 6
    with pytest.raises(TimeoutError):
        reqs[0].next_chunk(timeout=0.01)


def test_requests_carry_timestamps_and_the_trace_ledger():
    b = ts.ContinuousBatcher(_Stepper(), prefill_chunk=4)
    traced = ts.ServeRequest([3] * 10, 2, trace=tt.TraceContext.new(),
                             tenant="a", priority=2)
    plain = ts.ServeRequest([4] * 10, 2)
    b.submit(traced)
    b.submit(plain)
    _drive(b, [traced, plain])
    for r in (traced, plain):
        assert r.created <= r.started <= r.prefill_finished <= r.finished
        assert r.first_token is not None and r.iterations == 2
        assert r.prefill_chunks == 1
        lat = r.latency()
        assert all(lat[k] is not None for k in lat)
    assert [e["name"] for e in traced.events] == ["serving.prefill_chunk"]
    assert plain.events == []
    assert (traced.tenant, traced.priority) == ("a", 2)
    assert plain.tenant == "default"


def test_inflight_snapshot_names_queued_and_slotted_requests():
    b = ts.ContinuousBatcher(_Stepper(), prefill_chunk=None)
    ctx = tt.TraceContext.new()
    reqs = [ts.ServeRequest([1, 2], 4, trace=ctx if i == 0 else None)
            for i in range(3)]
    for r in reqs:
        b.submit(r)
    assert [row["state"] for row in b.inflight_snapshot()] == ["queued"] * 3
    b.step()
    rows = b.inflight_snapshot()
    assert [(r["state"], r["slot"]) for r in rows] == [
        ("queued", None), ("decoding", 0), ("decoding", 1)]
    assert rows[1]["trace_id"] == ctx.trace_id and rows[2]["trace_id"] is None
    assert rows[1]["tokens_emitted"] == 1
    assert set(rows[0]) == {"request_id", "state", "slot", "tenant",
                            "priority", "preemptions", "prompt_len",
                            "max_new_tokens", "tokens_emitted", "trace_id"}


def test_a_stopped_stream_ends_with_a_typed_sentinel():
    b = ts.ContinuousBatcher(_Stepper())
    r = b.submit(ts.ServeRequest([1], 5, stream=True))
    b.step()
    b.stop(error=ts.InternalError("scheduler crashed"))
    chunks = []
    while (c := r.next_chunk(timeout=1)) is not None:
        chunks.append(c)
    assert sum(chunks, []) == r.tokens
    assert isinstance(r.error, ts.InternalError)
