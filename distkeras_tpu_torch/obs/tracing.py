"""End-to-end request tracing across the serving front (PyTorch port: a
copy of ``distkeras_tpu.obs.tracing``, pure Python, so trace contexts and
span records are the same on both packages' wires).

- :class:`TraceContext` — ``(trace_id, span_id, parent_id)`` plus a
  ``want_timeline`` flag, carried in an optional ``trace`` field of the
  DKT1 frame header (:meth:`TraceContext.to_wire` /
  :meth:`TraceContext.from_wire`). Requests without the field cost one
  dict lookup.
- :class:`Span` — one timed operation; ``end()`` freezes it into a
  JSON-able record and hands it to the collector. A span marked
  ``terminal=True`` states the request's final outcome; a complete
  trace has exactly one (:func:`timeline_complete`).
- :class:`TraceCollector` — a bounded ring of finished span records;
  ``drain_to(MetricsLogger)`` flushes them to the JSONL sink.
- :func:`request_spans` — the server-side timeline of one
  ``ServeRequest`` (queue wait, prefill with per-chunk child spans,
  decode with per-chunk stream spans) from the timestamps and event
  ledger the scheduler keeps.
- :func:`stamp_error_trace` — trace identity on a typed error reply.

Span hierarchy of a generate::

    client.request                       (client; terminal)
      server.generate                    (server dispatch -> reply)
        serving.queue                    (submit -> slot admission)
        serving.prefill                  (admission -> decodable)
          serving.prefill_chunk ...      (one per chunk)
        serving.decode                   (decodable -> finished)
          serving.stream_chunk ...       (streamed requests)

The ``scheduler.blame`` and ``xla.compile`` event names are read as in
the JAX package; nothing in the port records them yet.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque


def new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """Propagated identity of one request's trace. ``child()`` derives
    the context a downstream hop records its spans under (fresh
    span_id, parent = this hop's span)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "want_timeline")

    def __init__(self, trace_id=None, span_id=None, parent_id=None,
                 want_timeline=False):
        self.trace_id = trace_id or new_id()
        self.span_id = span_id or new_id()
        self.parent_id = parent_id
        self.want_timeline = bool(want_timeline)

    @classmethod
    def new(cls, want_timeline=False) -> "TraceContext":
        return cls(want_timeline=want_timeline)

    def child(self) -> "TraceContext":
        return TraceContext(
            self.trace_id, new_id(), self.span_id, self.want_timeline
        )

    # -- wire ---------------------------------------------------------------

    def to_wire(self) -> dict:
        """The optional DKT1 header field (``header["trace"]``)."""
        d = {"id": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.want_timeline:
            d["return"] = True
        return d

    @classmethod
    def from_wire(cls, field) -> "TraceContext | None":
        """Parse ``header.get("trace")``; None (absent/malformed) means
        the request is untraced — a garbled field must never fail a
        request over an observability frill."""
        if not isinstance(field, dict) or not field.get("id"):
            return None
        return cls(
            trace_id=str(field["id"]),
            span_id=str(field.get("span") or new_id()),
            parent_id=(
                str(field["parent"]) if field.get("parent") else None
            ),
            want_timeline=bool(field.get("return")),
        )


class Span:
    """One timed operation under a trace. Created open via
    :func:`start_span`; ``end()`` freezes and records it. The record
    is a flat JSON-able dict (what rides replies and the JSONL sink).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "attrs", "_collector", "record")

    def __init__(self, name, ctx: TraceContext, collector, **attrs):
        self.name = name
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_id = ctx.parent_id
        self.start = time.time()
        self.attrs = attrs
        self._collector = collector
        self.record = None

    def end(self, status: str = "ok", terminal: bool = False,
            **attrs) -> dict:
        if self.record is not None:
            return self.record  # idempotent: a span ends once
        self.attrs.update(attrs)
        self.record = span_record(
            self.name, self.trace_id, self.span_id, self.parent_id,
            self.start, time.time() - self.start, status=status,
            terminal=terminal, **self.attrs,
        )
        if self._collector is not None:
            self._collector.record(self.record)
        return self.record


def span_record(name, trace_id, span_id, parent_id, start, duration_s,
                status="ok", terminal=False, **attrs) -> dict:
    """A finished span as a flat dict — the one schema every producer
    (live spans, the scheduler's event ledger, reconstructed request
    timelines) emits."""
    rec = {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "start": round(float(start), 6),
        "duration_ms": round(max(0.0, float(duration_s)) * 1e3, 3),
        "status": status,
    }
    if terminal:
        rec["terminal"] = True
    if attrs:
        rec["attrs"] = attrs
    return rec


class TraceCollector:
    """Bounded, thread-safe ring of finished span records. Keeps the
    most recent ``capacity`` spans; ``dropped`` counts what the bound
    discarded (never silently — the JSONL drain records it).

    ``on_drop``: optional zero-arg callback fired ONCE, on the ring's
    first-ever drop (the 0 -> nonzero transition of
    ``dropped_total``). The engine wires it to a ``trace.drops``
    flight-recorder event so silent span loss under load is on the
    incident tape, not only a gauge nobody watches; called outside
    the collector lock (the recorder takes its own)."""

    def __init__(self, capacity: int = 8192, on_drop=None):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(
                f"capacity must be >= 1; got {capacity}"
            )
        self._spans: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.on_drop = on_drop
        self.dropped = 0
        # lifetime total: ``dropped`` is read-and-reset by the JSONL
        # drain, so a scrape-time gauge over it would zero whenever the
        # sink flushed — this one only grows
        self.dropped_total = 0

    def record(self, span: dict) -> None:
        first_drop = False
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                self.dropped_total += 1
                first_drop = self.dropped_total == 1
            self._spans.append(span)
        if first_drop and self.on_drop is not None:
            try:
                self.on_drop()
            except Exception:  # noqa: BLE001 — observability boundary
                pass

    def drain(self) -> list[dict]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def spans_for(self, trace_id: str) -> list[dict]:
        with self._lock:
            return [s for s in self._spans if s["trace_id"] == trace_id]

    def drain_to(self, metrics_logger) -> int:
        """Flush everything into a ``utils.profiling.MetricsLogger``
        (one ``trace_span`` JSONL event per span); returns the number
        of spans written. The drop counter is read-and-reset UNDER the
        lock with the spans, so a drop landing mid-drain is reported
        by the next flush instead of silently zeroed."""
        with self._lock:
            spans = list(self._spans)
            self._spans.clear()
            dropped, self.dropped = self.dropped, 0
        for s in spans:
            metrics_logger.log(event="trace_span", **s)
        if dropped:
            metrics_logger.log(
                event="trace_spans_dropped", dropped=dropped
            )
        return len(spans)


#: process-wide default collector — servers/routers/schedulers record
#: here; ``ServingEngine`` drains it to its MetricsLogger when one is
#: configured, and tools read it in-process.
COLLECTOR = TraceCollector()


def start_span(name, ctx: TraceContext, collector=COLLECTOR,
               **attrs) -> Span:
    return Span(name, ctx, collector, **attrs)


def stamp_error_trace(reply_header: dict, request_header: dict,
                      exc) -> None:
    """Stamp trace identity onto a typed ERROR reply so client-side
    failures join server-side spans: prefer the full trace a traced
    ``generate`` attached to the exception (``exc.trace`` — id plus
    any timeline), else echo the request header's trace id. Untraced
    requests leave the reply untouched."""
    tr = getattr(exc, "trace", None)
    if tr is None:
        field = request_header.get("trace")
        if isinstance(field, dict) and field.get("id"):
            tr = {"id": str(field["id"])}
    if tr is not None:
        reply_header["trace"] = tr


def timeline_complete(spans) -> bool:
    """A trace is COMPLETE when exactly one span states the final
    outcome — what the soaks assert for every attempt (completed,
    typed-error, or failed-over alike)."""
    return sum(1 for s in spans if s.get("terminal")) == 1


def request_spans(req, ctx: TraceContext, collector=COLLECTOR) -> list[dict]:
    """The server-side phase timeline of one finished ``ServeRequest``,
    reconstructed from the timestamps and per-request event ledger the
    scheduler records (monotonic clocks converted to wall time): queue
    wait, prefill (+ one child span per prefill chunk), decode
    (iterations aggregated), plus a ``scheduler.blame`` span when a
    device failure was blamed on this request. Spans are parented
    under ``ctx`` (the server's own span) and also pushed to the
    collector."""
    # map the request's monotonic stamps onto the wall clock
    off = time.time() - time.monotonic()
    out = []

    def phase(name, t0, t1, **attrs):
        rec = span_record(
            name, ctx.trace_id, new_id(), ctx.span_id,
            off + t0, t1 - t0, **attrs,
        )
        out.append(rec)
        if collector is not None:
            collector.record(rec)
        return rec

    if req.started is not None:
        phase("serving.queue", req.created, req.started)
    if req.started is not None and req.prefill_finished is not None:
        pf = phase("serving.prefill", req.started, req.prefill_finished,
                   chunks=int(req.prefill_chunks))
        for ev in req.events:
            if ev["name"] != "serving.prefill_chunk":
                continue
            rec = span_record(
                ev["name"], ctx.trace_id, new_id(), pf["span_id"],
                off + ev["t0"], ev["t1"] - ev["t0"],
                **{k: v for k, v in ev.items()
                   if k not in ("name", "t0", "t1")},
            )
            out.append(rec)
            if collector is not None:
                collector.record(rec)
    if req.prefill_finished is not None and req.finished is not None:
        dec = phase(
            "serving.decode", req.prefill_finished, req.finished,
            iterations=int(req.iterations), tokens=len(req.tokens),
        )
        for ev in req.events:
            # streaming delivery: one child span per chunk frame the
            # server flushed (the per-chunk trace of the streaming
            # generate verb), parented under the decode phase
            if ev["name"] != "serving.stream_chunk":
                continue
            rec = span_record(
                ev["name"], ctx.trace_id, new_id(), dec["span_id"],
                off + ev["t0"], ev["t1"] - ev["t0"],
                **{k: v for k, v in ev.items()
                   if k not in ("name", "t0", "t1")},
            )
            out.append(rec)
            if collector is not None:
                collector.record(rec)
    for ev in req.events:
        if ev["name"] == "scheduler.blame":
            phase(
                "scheduler.blame", ev["t0"], ev["t1"],
                status="internal", slot=ev.get("slot"),
            )
        elif ev["name"] == "xla.compile":
            # a program build landed inside this traced request's
            # lifetime (compile-ledger attribution in the scheduler):
            # the stall is visible in the client-assembled timeline
            phase(
                "xla.compile", ev["t0"], ev["t1"],
                **{k: v for k, v in ev.items()
                   if k not in ("name", "t0", "t1")},
            )
    return out
