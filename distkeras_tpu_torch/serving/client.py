"""Client for ``ServingServer`` (PyTorch port of
``distkeras_tpu.serving.client``; the same frames, so it talks to a
server of either package): one persistent TCP connection, one
request/reply frame pair per call (open one client per concurrent
stream).

Server-side failures come back typed: ``overloaded`` raises
``OverloadedError``, ``quota_exhausted`` ``QuotaExhaustedError``,
``deadline_exceeded`` ``DeadlineExceededError``, ``stopping``
``EngineStoppedError``, ``internal`` ``InternalError``; anything else
raises plain ``ServingError`` with the wire code on ``.code``.

Resilience (the default; ``retry=False`` shows raw failures): a
``networking.RetryPolicy`` retries ``overloaded`` replies (honoring the
server's ``retry_after_ms`` hint) and, for idempotent verbs, reconnects
and resends after a connection reset — ``generate``/``predict``/
``health``/``stats`` are idempotent by construction; ``stop`` is never
retried. When a send dies mid-frame the client salvages the server's
parting typed reply off the socket (the server flushes ``fatal``
replies — ``frame_too_large`` — before closing), and remembers the last
fatal reply for a later bare reset. ``retry_budget`` caps retries as a
fraction of attempts, ``hedge_after`` sends a duplicate of a slow
``generate``/``predict`` on a fresh connection (first reply wins).

Every reply is stamped ``served_by`` with the ``(host, port)`` that
answered it (mirrored on ``client.last_served_by``);
``client.connected_endpoint`` is the live socket's peer.
``generate_stream`` returns a :class:`TokenStream`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from distkeras_tpu_torch.networking import (
    RetryPolicy,
    connect,
    recv_data,
    send_data,
)
from distkeras_tpu_torch.obs import TraceContext, start_span
from distkeras_tpu_torch.serving.resilience import (
    LatencyTracker,
    as_retry_budget,
    resolve_hedge_delay,
)
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    EngineStoppedError,
    InternalError,
    OverloadedError,
    QuotaExhaustedError,
    ServingError,
)
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    pack_frame,
    serialize_params,
    unpack_frame,
)

_ERRORS = {
    OverloadedError.code: OverloadedError,
    # per-tenant admission refusal (router token bucket): retriable
    # like overloaded (it subclasses it), with the bucket's honest
    # refill time riding retry_after_ms
    QuotaExhaustedError.code: QuotaExhaustedError,
    DeadlineExceededError.code: DeadlineExceededError,
    EngineStoppedError.code: EngineStoppedError,
    InternalError.code: InternalError,
}

#: verbs a hedge sibling may duplicate: deterministic in (input,
#: params), so a duplicated attempt costs compute, never correctness
_HEDGEABLE = ("generate", "predict")


def _reply_error(reply: dict) -> ServingError:
    """Build the typed error for an error reply WITHOUT touching any
    client state — the hedge sibling's error path (a losing hedge must
    never drop the primary's connection or poison its fatal ledger)."""
    code = reply.get("error", "error")
    err = _ERRORS.get(code, ServingError)(reply.get("detail", code))
    err.code = code  # wire code survives even for unmapped errors
    if reply.get("trace") is not None:
        err.trace = reply["trace"]
        err.trace_id = reply["trace"].get("id")
    if reply.get("retry_after_ms") is not None:
        # RetryPolicy reads this attribute as its backoff hint
        err.retry_after = float(reply["retry_after_ms"]) / 1e3
    return err


class _HedgeAbandoned(Exception):
    """Raised inside an abandoned primary attempt after its hedge
    sibling already won — never surfaces to callers (the winner's
    reply was already returned) and never retried."""


class ServingClient:
    def __init__(self, host, port, timeout=120.0, retry=True,
                 connect_timeout=None, retry_budget=None, hedge_after=None):
        """``retry``: True (default) builds a ``RetryPolicy()``; a
        ``RetryPolicy`` instance is used as-is; False/None disables all
        retrying and reconnecting (every failure surfaces raw).
        ``connect_timeout``: dial budget per connection attempt (default
        ``timeout``) — the fleet router dials with a short one so a
        silently dead replica fails over in seconds, while the operation
        timeout stays long enough for a full generate.

        ``retry_budget``: a ``resilience.RetryBudget`` (True = defaults,
        a dict = kwargs, an instance = as-is and SHAREABLE across
        clients — the budget caps the fleet's retry amplification, not
        one socket's). When the budget is exhausted a retriable failure
        surfaces as its ORIGINAL typed error immediately instead of
        retrying; retries that do go out are wire-marked (``retry``
        header field) so the router can enforce its own budget on top.
        Budgeted verbs are ``generate``/``predict`` — control-plane
        retries (health, stats) never spend data-plane tokens.

        ``hedge_after``: tail-latency hedging for idempotent
        non-streaming ``generate``/``predict``: seconds, or ``"p95"``
        style (resolved against this client's own completed-call
        latency window — no hedging until it has samples). When the
        primary attempt is still in flight after the delay, a sibling
        attempt launches on a FRESH connection and the first usable
        reply wins; the loser's connection is discarded, never pooled.
        Safe because served decode is deterministic in (prompt,
        params) — a hedged winner is token-identical to the solo
        reply. Hedges spend the retry budget when one is set (no
        tokens = no hedge: a hedge is a retry that didn't wait)."""
        self._host, self._port = host, int(port)
        self._timeout = timeout
        self._connect_timeout = (
            timeout if connect_timeout is None else float(connect_timeout)
        )
        if retry is True:
            retry = RetryPolicy()
        elif not retry:
            retry = None
        self._retry = retry
        self._retry_budget = as_retry_budget(retry_budget)
        self.hedge_after = hedge_after
        if isinstance(hedge_after, (str, int, float)):
            # validate the spec now (a typo'd "95p" must fail at
            # construction, not on the thousandth request)
            resolve_hedge_delay(hedge_after, None)
        self._lat = LatencyTracker()
        # resilience ledgers (the bench's pairing invariants read
        # these): retries that went out, retries refused by the
        # budget, and the hedge triple (launched == wins + losers at
        # quiescence — every launched sibling resolves exactly once)
        self._tally_lock = threading.Lock()
        self.retries = 0
        self.budget_refused = 0
        self.hedges_launched = 0
        self.hedge_wins = 0
        self.hedge_losers = 0
        self._last_fatal = None  # last fatal typed reply on this client
        self._sock = self._dial()
        self.max_frame_bytes = None  # learned from health(), if called
        # (host, port) that answered the most recent call — the fleet
        # router forwards the replica's stamp, so through a router this
        # is the REPLICA that served, not the router itself
        self.last_served_by = None
        # assembled timeline of the most recent ``generate(trace=True)``
        # call: {"trace_id", "spans"} — server/router spans off the
        # reply plus this client's own terminal ``client.request`` span
        # (also set on typed failures, so errors stay joinable)
        self.last_trace = None
        self.last_attempts = 0  # roundtrips the last traced call took
        # replicas the router could not scrape on the last metrics()
        # call (empty for a lone server / a fully reachable fleet)
        self.last_metrics_unreachable = []
        # where the last postmortem() bundle was persisted (None when
        # it was memory-only or nothing terminal has happened)
        self.last_postmortem_path = None

    def _dial(self):
        sock = connect(
            self._host, self._port, timeout=self._connect_timeout
        )
        sock.settimeout(self._timeout)
        return sock

    @property
    def connected_endpoint(self):
        """``(host, port)`` of the live socket's peer, or None when the
        client is between connections. This is the direct peer — for a
        fleet client that is the ROUTER; the serving replica's identity
        arrives via the ``served_by`` reply stamp instead."""
        sock = self._sock
        if sock is None:
            return None
        try:
            peer = sock.getpeername()
        except OSError:
            return None
        return (peer[0], int(peer[1]))

    def close(self):
        self._drop()

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- round trip ---------------------------------------------------------

    def _roundtrip(self, header: dict, payload: bytes,
                   raise_on_error=True):
        """One request/reply frame pair. ``raise_on_error=False`` returns
        error replies as ``(reply, body)`` instead of raising — the
        fleet router's forwarding face, which must relay a replica's
        typed reply verbatim rather than re-interpret it (fatal-reply
        bookkeeping still runs, so a poisoned pooled connection is still
        dropped)."""
        if self._sock is None:  # reconnect after a reset / fatal close
            self._sock = self._dial()
        try:
            send_data(self._sock, pack_frame(header, payload))
            raw = recv_data(self._sock)
        except (ConnectionError, OSError) as e:
            salvaged = self._salvage_reply()
            self._drop()
            if salvaged is not None:
                raise salvaged from e
            if self._last_fatal is not None:
                raise ConnectionError(
                    f"connection closed by server; its last fatal reply "
                    f"on this client was: {self._last_fatal}"
                ) from e
            raise
        reply, body = unpack_frame(raw)
        # stamp the endpoint that answered. setdefault, not overwrite:
        # a reply forwarded BY the router already carries the replica's
        # stamp (the router's own internal client wrote it), and that is
        # the placement truth fleet tests assert on
        ep = self.connected_endpoint
        if ep is not None:
            reply.setdefault("served_by", [ep[0], ep[1]])
        if reply.get("served_by") is not None:
            self.last_served_by = (
                reply["served_by"][0], int(reply["served_by"][1])
            )
        if not reply.get("ok"):
            err = self._typed_error(reply)
            if raise_on_error:
                raise err
        return reply, body

    def _typed_error(self, reply: dict) -> ServingError:
        # typed failures stay joinable to server-side spans: the
        # reply's trace stamp (id + any timeline) rides the error
        err = _reply_error(reply)
        code = err.code
        if reply.get("fatal"):
            # the server closes this connection right after a fatal
            # reply (e.g. frame_too_large: the stream is unrecoverable);
            # drop our side now and remember why, so a later bare reset
            # on this client still names the cause
            self._last_fatal = f"{code}: {reply.get('detail', '')}"
            if reply.get("max_frame_bytes") is not None:
                self.max_frame_bytes = int(reply["max_frame_bytes"])
            self._drop()
        return err

    def _salvage_reply(self) -> ServingError | None:
        """After a send/recv failure, try to read the server's parting
        typed reply off the half-closed socket (the server flushes
        ``frame_too_large`` before closing even when it stopped reading
        our oversized frame mid-send) — a typed reason beats a bare
        ``ConnectionError``. Best-effort: any failure here just means
        there was nothing to salvage."""
        sock = self._sock
        if sock is None:
            return None
        try:
            sock.settimeout(0.25)
            reply, _ = unpack_frame(recv_data(sock))
            if not reply.get("ok"):
                return self._typed_error(reply)
        except Exception:  # noqa: BLE001 — salvage is best-effort
            pass
        return None

    def _call(self, header: dict, payload: bytes = b"", idempotent=True,
              trace_ctx=None):
        """``trace_ctx``: when set, every attempt (retries and resends
        included) carries a FRESH child context on the wire, so each
        server-side span gets its own id under the same trace; the
        attempt count lands on ``last_attempts``."""
        cancel = threading.Event()  # set when a hedge sibling won

        if trace_ctx is None:
            def roundtrip():
                if cancel.is_set():
                    raise _HedgeAbandoned()
                return self._roundtrip(header, payload)
        else:
            self.last_attempts = 0

            def roundtrip():
                if cancel.is_set():
                    raise _HedgeAbandoned()
                self.last_attempts += 1
                header["trace"] = trace_ctx.child().to_wire()
                return self._roundtrip(header, payload)

        verb = header.get("verb")
        data_verb = verb in _HEDGEABLE and not header.get("stream")
        budget = self._retry_budget if data_verb else None
        if budget is not None:
            budget.note_attempt()  # the original attempt's deposit
        if self._retry is None:
            runner = roundtrip
        else:
            retry_on = (OverloadedError,)
            if idempotent:
                retry_on = retry_on + (ConnectionError, OSError)

            def on_retry(e, attempt, d):
                if cancel.is_set():
                    raise e  # abandoned primary: stop, spend nothing
                if budget is not None and not budget.acquire():
                    # budget exhausted: surface the ORIGINAL typed
                    # error immediately — a budget never amplifies
                    with self._tally_lock:
                        self.budget_refused += 1
                    raise e
                with self._tally_lock:
                    self.retries += 1
                # wire-mark the resend so the router can enforce its
                # own fleet-wide budget on top of this client's
                header["retry"] = attempt

            def runner():
                return self._retry.call(
                    roundtrip, retry_on=retry_on, on_retry=on_retry
                )

        hedge_wanted = (
            self.hedge_after is not None and idempotent and data_verb
        )
        if not hedge_wanted:
            if not data_verb:
                return runner()
            t0 = time.monotonic()
            out = runner()
            self._lat.note(time.monotonic() - t0)
            return out
        return self._hedged(runner, header, payload, cancel)

    def _hedged(self, primary_fn, header, payload, cancel):
        """Run ``primary_fn`` with a hedge sibling: if the primary is
        still in flight after the resolved hedge delay (and the retry
        budget grants a token), a one-shot duplicate goes out on a
        FRESH connection; the first usable (ok) reply wins. The
        loser's connection is discarded, never pooled — a hedge-beaten
        primary's socket still has a reply in flight on it."""
        delay = resolve_hedge_delay(self.hedge_after, self._lat)
        budget = self._retry_budget
        if delay is None:  # not enough latency evidence yet
            t0 = time.monotonic()
            out = primary_fn()
            self._lat.note(time.monotonic() - t0)
            return out
        t0 = time.monotonic()
        cv = threading.Condition()
        state = {"primary": None, "hedge": None, "winner": None}

        def finish(kind, result=None, exc=None):
            """Record a side's outcome; returns True when this side
            became the winner (first usable reply)."""
            with cv:
                state[kind] = (result, exc)
                won = exc is None and state["winner"] is None
                if won:
                    state["winner"] = kind
                cv.notify_all()
                return won

        def run_primary():
            try:
                finish("primary", result=primary_fn())
            except BaseException as e:  # noqa: BLE001 — relayed below
                finish("primary", exc=e)

        hedged = False

        def run_hedge():
            try:
                won = finish(
                    "hedge", result=self._hedge_roundtrip(header, payload)
                )
            except BaseException as e:  # noqa: BLE001 — relayed below
                finish("hedge", exc=e)
                won = False
            if not won:
                with self._tally_lock:
                    self.hedge_losers += 1

        threading.Thread(target=run_primary, daemon=True).start()
        with cv:
            cv.wait_for(
                lambda: state["primary"] is not None, timeout=delay
            )
            primary_done = state["primary"] is not None
        if not primary_done and (budget is None or budget.acquire()):
            hedged = True
            with self._tally_lock:
                self.hedges_launched += 1
            threading.Thread(target=run_hedge, daemon=True).start()
        with cv:
            cv.wait_for(
                lambda: state["winner"] is not None
                or (
                    state["primary"] is not None
                    and (not hedged or state["hedge"] is not None)
                )
            )
            winner = state["winner"]
        if winner == "hedge":
            # abandon the primary: its socket has a stale reply in
            # flight — drop it (never pool it) and stop its retry loop
            cancel.set()
            self._drop()
            with self._tally_lock:
                self.hedge_wins += 1
            reply, body = state["hedge"][0]
            if reply.get("served_by") is not None:
                self.last_served_by = (
                    reply["served_by"][0], int(reply["served_by"][1])
                )
            self._lat.note(time.monotonic() - t0)
            return reply, body
        if winner == "primary":
            self._lat.note(time.monotonic() - t0)
            return state["primary"][0]
        # both sides failed: surface the PRIMARY's error (it carries
        # this client's fatal bookkeeping and retry history)
        raise state["primary"][1]

    def _hedge_roundtrip(self, header, payload):
        """The hedge sibling's one-shot attempt: fresh dial, one
        request/reply, socket ALWAYS closed (a loser's connection must
        never rejoin the pool), no retries (the hedge IS the retry),
        and no shared-state side effects — a losing hedge must not
        drop the primary's connection or poison its fatal ledger."""
        sock = self._dial()
        try:
            hdr = dict(header)
            hdr["hedge"] = True  # observability: mark the duplicate
            send_data(sock, pack_frame(hdr, payload))
            reply, body = unpack_frame(recv_data(sock))
        finally:
            try:
                sock.close()
            except OSError:
                pass
        # a routed reply already carries the replica's stamp; a direct
        # server reply gets this client's target endpoint
        reply.setdefault("served_by", [self._host, self._port])
        if not reply.get("ok"):
            raise _reply_error(reply)
        return reply, body

    # -- verbs --------------------------------------------------------------

    def generate(self, prompt, max_new_tokens, eos_id=None,
                 deadline_ms=None, trace=False, sampling=None,
                 tenant=None, priority=None):
        """Continue ``prompt`` (1-D int tokens) by up to
        ``max_new_tokens``; returns the full sequence (prompt +
        generated, trimmed after the first generated ``eos_id``).

        ``sampling``: per-request ``sampling.SamplingParams`` (or its
        wire dict) — temperature / top_k / top_p / seed / n / grammar.
        Omitted = greedy, byte-for-byte the pre-sampling wire format.
        With ``n > 1`` the server decodes n parallel completions (CoW
        slot forks) and this call returns the LIST of n sequences.
        Sampled generates stay idempotent: the RNG keys on (seed,
        position), so a retried/resent request reproduces the same
        tokens — which is also why routing through the fleet router
        needs no sampling awareness at all.

        ``tenant``/``priority``: the request's QoS identity, riding
        two optional header fields client → router → server →
        scheduler (absent = the pre-QoS wire: default tenant,
        priority 0). The router's per-tenant token bucket may refuse
        with typed retriable ``quota_exhausted`` (``retry_after_ms``
        = the honest refill time); a QoS-scheduled engine uses them
        for WFQ shares and priority-class admission/preemption.

        ``trace=True`` propagates a trace context end to end (client →
        router → server → scheduler) and assembles the per-request
        timeline on ``self.last_trace`` — the client's own terminal
        ``client.request`` span plus every span the reply returned.
        The timeline is assembled for typed failures too (the error
        carries the server's trace stamp), so "which hop failed it"
        is answerable from the client alone."""
        header = {
            "verb": "generate",
            "max_new_tokens": int(max_new_tokens),
        }
        if eos_id is not None:
            header["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            header["deadline_ms"] = float(deadline_ms)
        sampling = SamplingParams.from_wire(sampling)
        if sampling is not None:
            header["sampling"] = sampling.to_wire()
        if tenant is not None:
            header["tenant"] = str(tenant)
        if priority is not None:
            header["priority"] = int(priority)
        ctx = span = None
        if trace:
            ctx = TraceContext.new(want_timeline=True)
            span = start_span(
                "client.request", ctx, verb="generate",
                endpoint=f"{self._host}:{self._port}",
            )
        try:
            reply, body = self._call(
                header, serialize_params(np.asarray(prompt, np.int32)),
                trace_ctx=ctx,
            )
        except ServingError as e:
            if span is not None:
                rec = span.end(
                    status=getattr(e, "code", "error"), terminal=True,
                    attempts=self.last_attempts,
                )
                self._assemble_trace(ctx, getattr(e, "trace", None), rec)
            raise
        except Exception:
            if span is not None:
                # an untyped wire death still ends the trace: exactly
                # one terminal span per attempt is the soak's bar
                rec = span.end(
                    status="connection_error", terminal=True,
                    attempts=self.last_attempts,
                )
                self._assemble_trace(ctx, None, rec)
            raise
        if span is not None:
            rec = span.end(
                status="ok", terminal=True, attempts=self.last_attempts
            )
            self._assemble_trace(ctx, reply.get("trace"), rec)
        out = deserialize_params(body)
        if reply.get("n") is not None:
            return [np.asarray(s) for s in out]  # n parallel completions
        return np.asarray(out)

    def generate_stream(self, prompt, max_new_tokens, eos_id=None,
                        deadline_ms=None, sampling=None, tenant=None,
                        priority=None, trace=False) -> "TokenStream":
        """Streaming generate: returns a :class:`TokenStream` iterator
        yielding each scheduler iteration's newly emitted tokens as
        they arrive over the wire. After exhaustion, ``.sequence``
        holds the full eos-trimmed sequence (identical to what plain
        ``generate`` returns) and ``.ttft_s`` the REAL time to first
        byte — request send to first chunk frame received.

        Resilience: greedy and seeded-sampled streams are
        deterministic, so a stream is idempotent the same way a
        generate is — on a mid-stream connection death (or a retriable
        typed refusal) the client RESENDS the whole request and SKIPS
        the tokens it already yielded, bounded by the client's
        ``RetryPolicy``. The caller's iterator never sees a duplicate
        or a gap. One stream at a time per client (it occupies the
        connection until the terminal frame)."""
        header = {
            "verb": "generate",
            "stream": True,
            "max_new_tokens": int(max_new_tokens),
        }
        if eos_id is not None:
            header["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            header["deadline_ms"] = float(deadline_ms)
        sampling = SamplingParams.from_wire(sampling)
        if sampling is not None:
            header["sampling"] = sampling.to_wire()
        if tenant is not None:
            header["tenant"] = str(tenant)
        if priority is not None:
            header["priority"] = int(priority)
        ctx = None
        if trace:
            # like generate(trace=True): a terminal client.request
            # span plus whatever timeline the terminal frame returns
            # (incl. the per-chunk serving.stream_chunk spans),
            # assembled onto client.last_trace at stream end
            ctx = TraceContext.new(want_timeline=True)
        return TokenStream(
            self, header,
            serialize_params(np.asarray(prompt, np.int32)),
            trace_ctx=ctx,
        )

    def _assemble_trace(self, ctx, wire_trace, client_record) -> dict:
        spans = list((wire_trace or {}).get("timeline") or [])
        spans.append(client_record)
        self.last_trace = {"trace_id": ctx.trace_id, "spans": spans}
        return self.last_trace

    def predict(self, x) -> np.ndarray:
        _, body = self._call(
            {"verb": "predict"}, serialize_params(np.asarray(x))
        )
        return np.asarray(deserialize_params(body))

    def health(self) -> dict:
        """Server + engine liveness: ``status`` (serving | degraded |
        draining), heartbeat age, quarantined slots, restart ledger,
        and ``max_frame_bytes`` (recorded on the client so callers can
        self-limit payloads)."""
        reply, _ = self._call({"verb": "health"})
        if reply.get("max_frame_bytes") is not None:
            self.max_frame_bytes = int(reply["max_frame_bytes"])
        return reply

    def stats(self) -> dict:
        reply, _ = self._call({"verb": "stats"})
        return reply["stats"]

    def metrics(self, prometheus=False):
        """The typed-registry snapshot of whatever answers — a lone
        server's engine book, or the router's per-replica-labeled
        fleet aggregate. ``prometheus=True`` returns the text
        exposition dump (a ``str``) instead of JSON samples.

        A fleet scrape that skipped dead replicas is NOT complete:
        the router names them and this client mirrors that on
        ``last_metrics_unreachable`` (empty for a lone server), so
        consumers like ``dkt_top`` can show the gap instead of
        rendering a silently shrunken fleet."""
        if prometheus:
            reply, _ = self._call(
                {"verb": "metrics", "format": "prometheus"}
            )
            self.last_metrics_unreachable = reply.get("unreachable") or []
            return reply["text"]
        reply, _ = self._call({"verb": "metrics"})
        self.last_metrics_unreachable = reply.get("unreachable") or []
        return reply["metrics"]

    def timeseries(self, window=None, names=None, points=30) -> dict:
        """Windowed performance time-series of whatever answers — a
        lone server's engine history, or the router's per-replica
        aggregate (every series row labeled ``replica=``, per-replica
        burn verdicts under ``burn``, skipped replicas named in
        ``unreachable`` and mirrored on ``last_metrics_unreachable``).
        ``window``: seconds of history to digest (default: the 60 s
        fast burn window); ``names``: optional series filter;
        ``points``: sparkline resampling resolution."""
        h = {"verb": "timeseries", "points": int(points)}
        if window is not None:
            h["window"] = float(window)
        if names is not None:
            h["names"] = list(names)
        reply, _ = self._call(h)
        self.last_metrics_unreachable = reply.get("unreachable") or []
        return reply

    def postmortem(self):
        """The latest post-mortem bundle of whatever answers (a lone
        server's engine, or the router's own book), or None when
        nothing terminal has happened. The bundle's ``path`` (when it
        was persisted) lands on ``last_postmortem_path``."""
        reply, _ = self._call({"verb": "postmortem"})
        self.last_postmortem_path = reply.get("path")
        return reply.get("postmortem")

    def stop(self) -> dict:
        """Ask the server to drain and shut down (acked before the
        listener closes). Not retried on connection failure: a reset
        here usually IS the shutdown taking effect."""
        reply, _ = self._call({"verb": "stop"}, idempotent=False)
        return reply


class TokenStream:
    """Client face of a streaming generate: iterate for per-iteration
    token chunks (1-D int32 arrays of NEW tokens); after exhaustion
    read ``.sequence`` (the full eos-trimmed sequence), ``.ttft_s``
    (first send -> first chunk frame received — the honest first-byte
    TTFT), ``.tokens`` (every token yielded, in order), and
    ``.inter_token_s`` (per-chunk arrival gaps after the first — the
    inter-token latency samples the disagg bench aggregates).

    Retry semantics: the stream RESENDS the whole request after a
    mid-stream connection death or a retriable typed refusal
    (``overloaded`` / ``unavailable``), then discards the tokens it
    already yielded — safe because served decode is deterministic in
    (prompt, params). Bounded by the owning client's ``RetryPolicy``
    (no policy = no resends, failures surface raw)."""

    def __init__(self, client: ServingClient, header: dict,
                 payload: bytes, trace_ctx=None):
        self._client = client
        self._header = header
        self._payload = payload
        self._ctx = trace_ctx
        if client._retry_budget is not None:
            # the stream's original send is this budget's deposit;
            # resends withdraw in _maybe_retry
            client._retry_budget.note_attempt()
        self._span = None
        self._started = False
        self._done = False
        self._skip = 0          # tokens to swallow after a resend
        self._attempt = 0       # retries consumed (the policy budget)
        self._sends = 0         # wire attempts (trace span attribute)
        self._t0 = None         # first send instant (TTFT anchor)
        self._t_start = None    # wall anchor of retry budget
        self._last_chunk_t = None
        self.tokens: list[int] = []
        self.sequence = None
        self.ttft_s = None
        self.inter_token_s: list[float] = []
        self.served_by = None

    def __iter__(self) -> "TokenStream":
        return self

    def _send(self):
        cli = self._client
        if self._ctx is not None:
            if self._span is None:
                self._span = start_span(
                    "client.request", self._ctx, verb="generate",
                    stream=True,
                    endpoint=f"{cli._host}:{cli._port}",
                )
            # a fresh child context per attempt, like generate's
            self._header["trace"] = self._ctx.child().to_wire()
        # anchor the TTFT / retry-budget clocks BEFORE the dial: a
        # refused first dial must still have a budget to reason about
        # (and connect time is part of the honest first-byte TTFT)
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._t_start = time.monotonic()
        if cli._sock is None:
            cli._sock = cli._dial()
        send_data(cli._sock, pack_frame(self._header, self._payload))
        self._started = True
        self._sends += 1

    def _end_trace(self, status, wire_trace):
        if self._span is None:
            return
        rec = self._span.end(
            status=status, terminal=True, attempts=max(1, self._sends),
        )
        self._client._assemble_trace(self._ctx, wire_trace, rec)
        self._span = None

    def _maybe_retry(self, exc) -> bool:
        """One resend decision under the client's policy: True =
        resend scheduled (skip set), False = surface ``exc``."""
        cli = self._client
        policy = cli._retry
        if policy is None:
            return False
        self._attempt += 1
        if self._attempt >= policy.max_attempts:
            return False
        d = policy.delay(
            self._attempt - 1, hint=getattr(exc, "retry_after", None)
        )
        start = (
            self._t_start if self._t_start is not None
            else time.monotonic()
        )
        if policy.budget is not None and (
            time.monotonic() - start + d > policy.budget
        ):
            return False
        if cli._retry_budget is not None:
            if not cli._retry_budget.acquire():
                # budget exhausted: surface the original typed error
                # now instead of amplifying the storm with a resend
                with cli._tally_lock:
                    cli.budget_refused += 1
                return False
            with cli._tally_lock:
                cli.retries += 1
        # wire-mark the resend for the router's fleet-wide budget
        self._header["retry"] = self._attempt
        time.sleep(d)
        self._skip = len(self.tokens)
        self._started = False
        return True

    def __next__(self) -> np.ndarray:
        cli = self._client
        while True:
            if self._done:
                raise StopIteration
            try:
                if not self._started:
                    self._send()
                raw = recv_data(cli._sock)
            except (ConnectionError, OSError) as e:
                cli._drop()
                if self._maybe_retry(e):
                    continue
                self._done = True
                self._end_trace("connection_error", None)
                raise
            reply, body = unpack_frame(raw)
            kind = reply.get("stream")
            if kind == "chunk":
                now = time.perf_counter()
                if self.ttft_s is None:
                    self.ttft_s = now - self._t0
                else:
                    self.inter_token_s.append(now - self._last_chunk_t)
                self._last_chunk_t = now
                toks = [int(t) for t in reply["tokens"]]
                if self._skip:
                    # replayed prefix of a resent stream: identical by
                    # determinism, already delivered — swallow it
                    take = toks[self._skip:]
                    self._skip = max(0, self._skip - len(toks))
                    if not take:
                        continue
                    toks = take
                self.tokens.extend(toks)
                return np.asarray(toks, np.int32)
            if kind == "end":
                self.sequence = np.asarray(deserialize_params(body))
                ep = cli.connected_endpoint
                reply.setdefault(
                    "served_by",
                    None if ep is None else [ep[0], ep[1]],
                )
                if reply.get("served_by") is not None:
                    self.served_by = (
                        reply["served_by"][0],
                        int(reply["served_by"][1]),
                    )
                    cli.last_served_by = self.served_by
                self._done = True
                self._end_trace("ok", reply.get("trace"))
                raise StopIteration
            # typed error frame (terminal for this attempt)
            err = cli._typed_error({**reply, "ok": False})
            if isinstance(err, OverloadedError) or (
                getattr(err, "code", None) == "unavailable"
            ):
                if self._maybe_retry(err):
                    continue
            self._done = True
            self._end_trace(
                getattr(err, "code", "error"), reply.get("trace")
            )
            raise err

    def result(self) -> np.ndarray:
        """Drain the rest of the stream and return the full
        sequence — the one-call face for callers that wanted
        streaming TTFT but not incremental consumption."""
        for _ in self:
            pass
        return self.sequence
