"""TCP front of the serving engine (PyTorch port of
``distkeras_tpu.serving.server``; the same frames, so a client of either
package talks to a server of either).

The wire is ``networking.send_data``/``recv_data`` (8-byte length prefix,
Nagle off) carrying ``serialization.pack_frame`` frames: a JSON header and
an npz payload, no pickle (the port accepts bytes from untrusted
clients). One frame per request and one per reply; each connection gets
a thread, so a slow client never blocks the scheduler.

Verbs (header ``{"verb": ...}``):

- ``generate``: payload = 1-D int prompt; header ``max_new_tokens``,
  optional ``eos_id``, ``deadline_ms`` (budget from arrival),
  ``sampling`` (a ``SamplingParams`` wire dict), ``tenant``/``priority``
  (metric labels), ``trace``. Reply payload = the full sequence.
  Failures reply ``{"ok": false, "error": code}``; ``overloaded``
  carries ``retry_after_ms``.
- ``generate`` with ``stream: true``: ``{"stream": "chunk", "tokens":
  [...]}`` frames as the scheduler emits them, then a terminal
  ``{"stream": "end"}`` frame with the full sequence (or a typed error
  frame). ``ServeRequest.first_sent`` is stamped when the first chunk
  has been sent.
- ``predict``: payload = (N, ...) rows; reply payload = the outputs
  (windowed-batched server-side).
- ``prefill`` (disaggregation): payload = the prompt, header as
  ``generate``'s; the engine prefills it and the reply payload is the
  slot's ``kv_transfer`` frame (header ``transfer``: its length and
  bytes). With ``push_to: [host, port]`` the frame is pushed to that
  decode worker over the engine's peer fabric and its final reply comes
  back with ``pushed: true``; any push failure hands the frame back
  (``pushed: false``, ``push_error``), so the prefill is never wasted.
- ``kv.transfer``: payload = a ``kv_transfer`` frame, header
  ``max_new_tokens`` and the optional ``generate`` fields; the engine
  resumes the slot and the reply is ``generate``'s. With ``stream: true``
  it streams like ``generate``.
- ``kv.fetch``: payload = 1-D tokens, optional header ``epoch``; the
  reply payload is the longest cached prefix as a frame (``hit: true``,
  ``len``, ``epoch``) or nothing (``hit: false``); a stale epoch is
  refused typed ``stale_epoch``.
- ``health`` (engine liveness plus ``max_frame_bytes`` and the bound
  ``endpoint``), ``stats`` (scheduler counters plus
  ``open_connections``), ``metrics`` (registry samples; ``format:
  "prometheus"`` for the text dump), ``timeseries`` (windowed digests
  and the burn verdict), ``postmortem`` (the latest crash bundle) and
  ``stop`` (acked, then a graceful drain and close).

A frame longer than ``max_frame_bytes`` is refused before it is
buffered: the server flushes a ``fatal`` ``frame_too_large`` reply and
closes. Typed error replies are stamped with the request's trace id. The
``net.delay`` fault seam fires on the data verbs (``generate``,
``predict``, ``prefill``, ``kv.transfer``, ``kv.fetch``) only.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.networking import recv_data, send_data
from distkeras_tpu_torch.obs import (
    COLLECTOR,
    TraceContext,
    render_prometheus,
    request_spans,
    start_span,
)
from distkeras_tpu_torch.obs import stamp_error_trace as _stamp_trace
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.serving.scheduler import ServingError
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    pack_frame,
    serialize_params,
    unpack_frame,
)

_PROTOCOL = 1


class ServingServer:
    """Serve one ``ServingEngine`` over TCP. ``port=0`` binds an
    ephemeral port (read it back from ``.port``)."""

    def __init__(self, engine, host="127.0.0.1", port=0, backlog=64,
                 max_frame_bytes=64 << 20, retry_after_ms=50.0):
        """``max_frame_bytes``: per-request frame cap enforced before
        buffering (the port accepts untrusted bytes; an unchecked
        length prefix is a one-client memory DoS). 64 MiB comfortably
        covers prompts and predict feature batches. It also rides the
        ``health`` reply so well-behaved clients can self-limit before
        sending. ``retry_after_ms``: the Retry-After-style hint stamped
        on ``overloaded`` replies — clients with a ``RetryPolicy`` back
        off by it instead of guessing."""
        self.engine = engine
        self.max_frame_bytes = int(max_frame_bytes)
        self.retry_after_ms = float(retry_after_ms)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(int(backlog))
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = None
        self._conn_threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._shutdown_done = threading.Event()
        reg = getattr(engine, "registry", None)
        if reg is not None:  # server-level gauge rides the engine book
            reg.gauge(
                "serving_server_open_connections",
                fn=lambda: len(self._conns),
            )

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServingServer":
        self.engine.start()
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="serving-accept",
                daemon=True,
            )
            self._accept_thread.start()
        return self

    def shutdown(self, drain=True):
        """Close the listener and stop the engine. ``drain=True`` lets
        queued and in-flight requests finish first (their connection
        threads stay alive until the replies are flushed).

        Idempotent AND awaitable: the ``stop`` verb runs shutdown on a
        side thread, so a second caller (the owner's ``shutdown()``, a
        ``with`` block's ``__exit__``) must not return while the first
        is still draining — it waits for completion instead of racing
        the teardown."""
        with self._lock:
            first = not self._stopping.is_set()
            self._stopping.set()
        if not first:
            self._shutdown_done.wait(timeout=90)
            return
        try:
            # shutdown BEFORE close: a bare close does not wake a
            # thread blocked in accept(), which would leak it and
            # stall the accept-thread join below for its full timeout
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self.engine.stop(drain=drain)
            with self._lock:
                threads = list(self._conn_threads)
            # short grace for threads flushing their last reply, then
            # force-close the sockets of the rest — an idle persistent
            # connection sits in recv_data forever and would otherwise
            # stall shutdown and leak its thread
            deadline = time.monotonic() + 5
            for th in threads:
                th.join(timeout=max(0.0, deadline - time.monotonic()))
            with self._lock:
                lingering = list(self._conns)
            for conn in lingering:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            for th in threads:
                th.join(timeout=5)
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=5)
        finally:
            self._shutdown_done.set()  # waiters must never hang on a crash

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # -- connection handling ------------------------------------------------

    def _accept_loop(self):
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            th = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="serving-conn", daemon=True,
            )
            with self._lock:
                self._conn_threads = [
                    t for t in self._conn_threads if t.is_alive()
                ]
                self._conn_threads.append(th)
                self._conns.add(conn)
                # started under the lock: a shutdown that copies the
                # list never joins a thread that has not started yet
                th.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            self._serve_frames(conn)
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_frames(self, conn: socket.socket):
        while True:
            try:
                frame = recv_data(conn, max_len=self.max_frame_bytes)
            except ValueError:
                # oversized declared frame: the stream position is
                # unrecoverable (bytes keep coming) — reply (marked
                # ``fatal`` so the client knows the close that follows
                # was deliberate and why) and close
                try:
                    send_data(conn, pack_frame(
                        {"ok": False, "error": "frame_too_large",
                         "fatal": True,
                         "max_frame_bytes": self.max_frame_bytes,
                         "detail": f"limit {self.max_frame_bytes} bytes"}
                    ))
                except (ConnectionError, OSError):
                    pass
                return
            except (ConnectionError, OSError):
                return
            header = {}
            try:
                header, payload = unpack_frame(frame)
                if header.get("stream") and header.get("verb") in (
                    "generate", "kv.transfer"
                ):
                    # the streaming path sends its own frames (chunks
                    # + terminal); everything else stays one-reply
                    if not self._serve_stream(conn, header, payload):
                        return
                    if self._stopping.is_set():
                        return
                    continue
                reply = self._dispatch(header, payload)
            except ServingError as e:
                h = {"ok": False, "error": e.code, "detail": str(e)}
                # Retry-After semantics: tell the client how long to
                # back off instead of letting the fleet guess — and
                # prefer the error's OWN hint (quota waits, shed-gate
                # sojourn estimates) over the server-wide constant
                if getattr(e, "retry_after", None) is not None:
                    h["retry_after_ms"] = e.retry_after * 1e3
                elif e.code == "overloaded":
                    h["retry_after_ms"] = self.retry_after_ms
                _stamp_trace(h, header, e)
                reply = pack_frame(h)
            except Exception as e:  # noqa: BLE001 — wire boundary
                h = {"ok": False, "error": "bad_request",
                     "detail": repr(e)}
                _stamp_trace(h, header, e)
                reply = pack_frame(h)
            act = faults.fire("server.reply", nbytes=len(reply))
            if act == "drop":
                return  # injected: vanish without replying (conn closes)
            try:
                send_data(conn, reply)
            except (ConnectionError, OSError):
                return
            if self._stopping.is_set():
                return

    # -- verbs --------------------------------------------------------------

    def _dispatch(self, header: dict, payload: bytes) -> bytes:
        verb = header.get("verb")
        faults.fire("server.dispatch", verb=verb)
        if verb in ("generate", "predict", "prefill", "kv.transfer",
                    "kv.fetch"):
            # the gray-failure seam: a delay armed here (filtered by
            # port) slows this replica's DATA path while its health
            # polls stay green
            faults.fire("net.delay", verb=verb, port=int(self.port))
        if verb == "generate":
            return self._generate(header, payload)
        if verb == "prefill":
            return self._prefill(header, payload)
        if verb == "kv.transfer":
            return self._transfer(header, payload)
        if verb == "kv.fetch":
            return self._kv_fetch(header, payload)
        if verb == "predict":
            return self._predict(payload)
        if verb == "metrics":
            # the typed-registry snapshot (scheduler/engine/prefix-
            # cache counters, gauges, latency histograms); format=
            # "prometheus" ships the text exposition dump instead
            samples = self.engine.metrics_snapshot()
            if header.get("format") == "prometheus":
                return pack_frame(
                    {"ok": True, "format": "prometheus",
                     "text": render_prometheus(samples)}
                )
            return pack_frame({"ok": True, "metrics": samples})
        if verb == "timeseries":
            # windowed rate/quantile/trend digests over the engine's
            # metrics-history ring + the burn-rate SLO verdict; header
            # knobs: window (seconds), names (series filter), points
            # (sparkline resolution). history=False engines refuse
            # with bad_request (a ValueError at this boundary).
            return pack_frame(self.engine.timeseries(
                window=header.get("window"),
                names=header.get("names"),
                points=int(header.get("points") or 30),
            ))
        if verb == "postmortem":
            # the latest crash bundle (watchdog trip / degradation),
            # retrievable remotely so soak triage never needs shell
            # access to the serving host; None when nothing has died
            bundle, path = self.engine.postmortem()
            return pack_frame(
                {"ok": True, "postmortem": bundle, "path": path}
            )
        if verb == "health":
            # engine liveness (serving|degraded|draining, heartbeat age,
            # quarantine + restart ledger) plus the server's own limits,
            # so clients can self-limit frame sizes before sending
            h = {
                "ok": True,
                "protocol": _PROTOCOL,
                "max_frame_bytes": self.max_frame_bytes,
                # the server's canonical bound address: a fleet router
                # keys its rotation on this, and a health reply that
                # names its endpoint is self-describing in logs
                "endpoint": [self.host, int(self.port)],
            }
            h.update(self.engine.health())
            if self._stopping.is_set():
                h["status"] = "draining"
            return pack_frame(h)
        if verb == "stats":
            stats = self.engine.stats()
            # server-level observability rides the same verb: scheduler
            # counters, slot lifecycle (prefilling vs decoding), prefix-
            # cache hit/miss/eviction state, and live connection count
            with self._lock:
                stats["open_connections"] = len(self._conns)
            return pack_frame({"ok": True, "stats": stats})
        if verb == "stop":
            # reply first, then drain on a side thread so the client
            # gets its ack before the listener goes away
            threading.Thread(
                target=self.shutdown, kwargs={"drain": True}, daemon=True
            ).start()
            return pack_frame({"ok": True, "stopping": True})
        raise ValueError(f"unknown verb {verb!r}")

    def _generate(self, header: dict, payload: bytes) -> bytes:
        prompt = np.asarray(deserialize_params(payload))
        deadline = self._deadline_of(header)
        # per-request sampling params ride an optional header field
        # (absent = the greedy no-params path, one dict lookup); a
        # malformed spec is a submit-boundary ValueError -> bad_request
        sampling = SamplingParams.from_wire(header.get("sampling"))
        # opt-in tracing: absent field = one dict lookup and nothing
        # else; present = a server.generate span plus the scheduler's
        # per-request phase timeline, returned on the reply when the
        # client asked for it (``return`` in the wire field)
        ctx = TraceContext.from_wire(header.get("trace"))
        span = None
        col = None
        if ctx is not None:
            # this engine's own span ring (drained to ITS MetricsLogger)
            col = getattr(self.engine, "trace_collector", None) or COLLECTOR
            attrs = {}
            if sampling is not None:
                # sampler params on the span: a sampled request's trace
                # names what it asked for (replayable from the trace)
                attrs["sampling"] = sampling.to_wire()
            span = start_span(
                "server.generate", ctx, collector=col,
                prompt_len=int(prompt.size),
                max_new_tokens=int(header["max_new_tokens"]),
                **attrs,
            )
        req = None

        def assemble_trace(status):
            """End the server span with ``status`` and build the reply's
            ``trace`` dict (timeline included when the client asked):
            the one assembly every exit path — ok, typed, untyped —
            shares, so they cannot drift apart."""
            spans = (
                []
                if req is None
                else request_spans(req, ctx, collector=col)
            )
            spans.append(span.end(status=status))
            tr = {"id": ctx.trace_id}
            if ctx.want_timeline:
                tr["timeline"] = spans
            return tr

        try:
            req = self.engine.submit(
                prompt,
                int(header["max_new_tokens"]),
                eos_id=header.get("eos_id"),
                deadline=deadline,
                trace=ctx,
                sampling=sampling,
                # QoS identity rides two optional header fields (absent
                # = default tenant, priority 0)
                tenant=header.get("tenant"),
                priority=int(header.get("priority") or 0),
                kv_peers=header.get("kv_peers"),
            )
            seq = self.engine.wait(req)
        except ServingError as e:
            if ctx is not None:
                e.trace = assemble_trace(e.code)
            raise
        except Exception as e:  # noqa: BLE001 — the wire boundary
            # replies generic bad_request for non-typed failures; the
            # span must still end (and hit the collector/JSONL sink)
            # or exactly the untyped failure class vanishes from traces
            if ctx is not None:
                tr = assemble_trace("bad_request")
                try:
                    e.trace = tr
                except AttributeError:
                    pass  # exotic exception refusing attributes
            raise
        if isinstance(seq, list):
            # n parallel completions: the payload is the list of sequences
            # (the tree codec carries ragged lengths)
            reply = {
                "ok": True,
                "n": len(seq),
                "tokens": int(sum(s.size - prompt.size for s in seq)),
            }
            if ctx is not None:
                reply["trace"] = assemble_trace("ok")
            return pack_frame(
                reply, serialize_params([np.asarray(s) for s in seq])
            )
        reply = {"ok": True, "tokens": int(seq.size - prompt.size)}
        if ctx is not None:
            reply["trace"] = assemble_trace("ok")
        return pack_frame(reply, serialize_params(np.asarray(seq)))

    @staticmethod
    def _deadline_of(header: dict):
        if header.get("deadline_ms") is None:
            return None
        return time.monotonic() + float(header["deadline_ms"]) / 1e3

    def _prefill(self, header: dict, payload: bytes) -> bytes:
        """Disaggregated prefill: the finished slot's ``kv_transfer`` frame
        as the reply payload, or, with ``push_to``, pushed to that decode
        worker (``_push``). Typed failures ride the normal error path:
        ``wrong_role`` on a decode engine, ``overloaded`` under pressure,
        ``kv_transfer`` if encoding failed."""
        t0 = time.monotonic()
        prompt = np.asarray(deserialize_params(payload))
        blob, meta = self.engine.prefill(
            prompt, int(header["max_new_tokens"]),
            eos_id=header.get("eos_id"),
            deadline=self._deadline_of(header),
            sampling=header.get("sampling"),
            tenant=header.get("tenant"),
            priority=int(header.get("priority") or 0),
        )
        push_to = header.get("push_to")
        if push_to:
            return self._push(header, blob, meta, push_to, t0)
        return pack_frame({"ok": True, "transfer": meta}, blob)

    def _push(self, header: dict, blob: bytes, meta: dict, push_to,
              t0: float) -> bytes:
        """The direct-push leg of a prefill: a ``kv.transfer`` to
        ``push_to`` over the peer fabric, its final reply relayed with
        ``pushed: true``. Fail-soft: a wire death, an open breaker or a
        typed decode refusal hands the frame back (``pushed: false``, the
        frame as payload) for the caller's relay."""

        def degrade(code, detail):
            return pack_frame(
                {"ok": True, "pushed": False, "transfer": meta,
                 "push_error": code, "push_detail": str(detail)[:200]},
                blob,
            )

        theader = {"verb": "kv.transfer",
                   "max_new_tokens": int(header["max_new_tokens"])}
        for k in ("eos_id", "tenant", "priority", "request_id"):
            if header.get(k) is not None:
                theader[k] = header[k]
        if header.get("deadline_ms") is not None:
            # the decode hop gets what the prefill left of the budget; a
            # spent budget degrades rather than decode past it
            left = float(header["deadline_ms"]) - (
                (time.monotonic() - t0) * 1e3)
            if left <= 0:
                return degrade("deadline_exceeded",
                               "deadline spent during prefill")
            theader["deadline_ms"] = left
        try:
            reply, body = self.engine.peer_fabric.push(tuple(push_to),
                                                       theader, blob)
        except Exception as e:  # noqa: BLE001 — fail-soft boundary
            return degrade(getattr(e, "code", "kv_peer"), e)
        if not reply.get("ok"):
            # a typed decode refusal: the caller's relay owns the retries
            return degrade(reply.get("error", "kv_peer"),
                           reply.get("detail", ""))
        out = dict(reply)
        out["pushed"] = True
        out["transfer"] = meta
        return pack_frame(out, body or b"")

    def _kv_fetch(self, header: dict, payload: bytes) -> bytes:
        """The fabric's serving half (``ServingEngine.serve_prefix``): a
        hit's frame as the payload; a miss is ``ok`` with ``hit: false``;
        a stale epoch or a store-less engine fail typed."""
        tokens = np.asarray(deserialize_params(payload))
        blob, reply = self.engine.serve_prefix(tokens,
                                               epoch=header.get("epoch"))
        if blob is None:
            return pack_frame(reply)
        return pack_frame(reply, blob)

    def _transfer(self, header: dict, payload: bytes) -> bytes:
        """Disaggregated decode, one reply: resume the transferred slot and
        decode it to completion; the reply is ``generate``'s."""
        req = self.engine.resume(
            payload, int(header["max_new_tokens"]),
            eos_id=header.get("eos_id"),
            deadline=self._deadline_of(header),
            tenant=header.get("tenant"),
            priority=int(header.get("priority") or 0),
        )
        seq = self.engine.wait(req)
        return pack_frame(
            {"ok": True,
             "tokens": int(np.asarray(seq).size - req.prompt.size)},
            serialize_params(np.asarray(seq)),
        )

    def _serve_stream(self, conn: socket.socket, header: dict,
                      payload: bytes) -> bool:
        """Streaming ``generate`` / ``kv.transfer``: submit (or resume)
        with a chunk FIFO, then drain
        it to the connection — one ``stream: "chunk"`` frame per
        scheduler iteration that advanced the slot, then the terminal ``stream: "end"`` frame
        with the full sequence payload (identity stays assertable
        downstream) or a typed error frame. Returns False when the
        connection is no longer usable (died mid-stream / injected
        drop). The first chunk's flush stamps ``req.first_sent`` —
        the delivery-time TTFT ``latency()`` reports."""
        verb = header.get("verb")
        faults.fire("server.dispatch", verb=verb)
        faults.fire("net.delay", verb=verb, port=int(self.port))
        ctx = TraceContext.from_wire(header.get("trace"))
        span = col = None
        if ctx is not None:
            col = getattr(self.engine, "trace_collector", None) or COLLECTOR
            span = start_span(
                "server.generate", ctx, collector=col, stream=True,
                max_new_tokens=int(header["max_new_tokens"]),
            )
        req = None

        def send_error(e, code=None):
            h = {"ok": False, "error": code or getattr(e, "code", "bad_request"),
                 "detail": repr(e) if code == "bad_request" else str(e)}
            if getattr(e, "retry_after", None) is not None:
                h["retry_after_ms"] = e.retry_after * 1e3
            elif h["error"] == "overloaded":
                h["retry_after_ms"] = self.retry_after_ms
            if span is not None:
                spans = (
                    [] if req is None
                    else request_spans(req, ctx, collector=col)
                )
                spans.append(span.end(status=h["error"]))
                h["trace"] = {"id": ctx.trace_id}
                if ctx.want_timeline:
                    h["trace"]["timeline"] = spans
            else:
                _stamp_trace(h, header, e)
            try:
                send_data(conn, pack_frame(h))
                return True
            except (ConnectionError, OSError):
                return False

        try:
            if verb == "generate":
                prompt = np.asarray(deserialize_params(payload))
                req = self.engine.submit(
                    prompt, int(header["max_new_tokens"]),
                    eos_id=header.get("eos_id"),
                    deadline=self._deadline_of(header),
                    trace=ctx,
                    sampling=SamplingParams.from_wire(
                        header.get("sampling")),
                    tenant=header.get("tenant"),
                    priority=int(header.get("priority") or 0),
                    stream=True,
                    kv_peers=header.get("kv_peers"),
                )
            else:
                req = self.engine.resume(
                    payload, int(header["max_new_tokens"]),
                    eos_id=header.get("eos_id"),
                    deadline=self._deadline_of(header),
                    trace=ctx,
                    tenant=header.get("tenant"),
                    priority=int(header.get("priority") or 0),
                    stream=True,
                )
        except ServingError as e:
            return send_error(e)
        except Exception as e:  # noqa: BLE001 — wire boundary
            return send_error(e, code="bad_request")
        while True:
            t0 = time.monotonic()
            try:
                # generous bound: the engine watchdog fails a wedged
                # scheduler's requests typed long before this fires —
                # the timeout is the belt to that suspender
                chunk = req.next_chunk(timeout=600.0)
            except TimeoutError as e:
                send_error(e, code="internal")
                return False
            if chunk is None:
                break
            frame = pack_frame(
                {"ok": True, "stream": "chunk",
                 "tokens": [int(t) for t in chunk]}
            )
            act = faults.fire("server.reply", nbytes=len(frame))
            if act == "drop":
                return False  # injected: vanish mid-stream
            try:
                send_data(conn, frame)
            except (ConnectionError, OSError):
                return False  # client went away; decode completes idle
            now = time.monotonic()
            if req.first_sent is None:
                req.first_sent = now  # DELIVERY-time TTFT stamp
            if ctx is not None:
                # per-chunk trace span (rides the request ledger; the
                # timeline's serving.stream_chunk children)
                req.events.append({
                    "name": "serving.stream_chunk", "t0": t0,
                    "t1": now, "tokens": len(chunk),
                })
        try:
            seq = self.engine.wait(req)  # completion bookkeeping
        except ServingError as e:
            return send_error(e)
        reply = {"ok": True, "stream": "end", "tokens": len(req.tokens)}
        if span is not None:
            spans = request_spans(req, ctx, collector=col)
            spans.append(span.end(status="ok"))
            reply["trace"] = {"id": ctx.trace_id}
            if ctx.want_timeline:
                reply["trace"]["timeline"] = spans
        frame = pack_frame(reply, serialize_params(np.asarray(seq)))
        act = faults.fire("server.reply", nbytes=len(frame))
        if act == "drop":
            return False
        try:
            send_data(conn, frame)
        except (ConnectionError, OSError):
            return False
        return True

    def _predict(self, payload: bytes) -> bytes:
        x = np.asarray(deserialize_params(payload))
        y = self.engine.predict(x)
        return pack_frame({"ok": True}, serialize_params(np.asarray(y)))


def serve(engine, host="127.0.0.1", port=0) -> ServingServer:
    """Convenience: construct + start in one call."""
    return ServingServer(engine, host=host, port=port).start()
