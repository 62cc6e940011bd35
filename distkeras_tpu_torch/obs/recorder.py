"""Black-box flight recorder + crash post-mortem bundles (PyTorch port:
a copy of ``distkeras_tpu.obs.recorder``, the same bundle schema).

Traces and typed metrics make the HAPPY path legible; this module is
the failure path's memory. When the system self-heals —
a watchdog trips and rebuilds the scheduler, a blamed slot is
quarantined, a standby promotes, a fleet replica is ejected — the
evidence used to evaporate with the recovery: triage meant re-running
the soak with seeds and reading four JSONL files. The flight recorder
keeps a bounded, always-on ring of structured events per component
(the airliner black box, not a log file), and on any TERMINAL event
the owning component dumps ONE self-contained JSON bundle — ring
contents, metrics snapshot, in-flight request table with trace ids,
config knobs, armed fault-seam state — that explains the failure
after the fact without a re-run.

- :class:`FlightRecorder` — bounded thread-safe ring of event dicts
  (the ``TraceCollector`` ring discipline, applied to component
  events instead of spans). ``record(kind, **fields)`` is the hot
  path: one lock, one append to a preallocated deque — cheap enough
  to run ALWAYS ON (unlike tracing, which is opt-in per request),
  because the ring is what makes the next unexplained failure
  explainable. Overwrites (ring-bound evictions) are counted, and
  :meth:`register_gauges` exposes the ring's fill/overwrite state in
  the owning component's metrics registry.
- :func:`dump_postmortem` — THE shared bundle writer: engine
  supervisor, ``FleetRouter``, ``SocketParameterServer``, and the
  soak harnesses all dump through it, so every bundle carries the
  same schema (``POSTMORTEM_SCHEMA`` — pinned by a golden test).
- :func:`latest_postmortem` — newest bundle in a ``postmortem_dir``
  (filenames sort by time); what the ``postmortem`` DKT1 verb and
  ``tools/dkt_postmortem.py`` read back.

Event kinds in the catalogue (see docs/ARCHITECTURE.md "Post-mortem
& SLO" for the full table): ``scheduler.iteration`` /
``scheduler.blame`` / ``scheduler.quarantine`` /
``scheduler.prefill_failure``, ``engine.watchdog_trip`` /
``engine.restarted`` / ``engine.degraded``, ``router.route`` /
``router.eject`` / ``router.rejoin`` / ``router.failover`` /
``router.drain``, ``ps.commit`` / ``ps.attach`` / ``ps.detach`` /
``ps.gate_refused`` / ``ps.sync`` / ``ps.promoted`` /
``ps.stand_down``, ``fault.fired`` (armed seam firings, via
``faults.add_observer``), ``slo.breach`` / ``slo.warn``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

#: bundle schema version — bump on any breaking key change; the golden
#: test pins the key set for the current version
POSTMORTEM_SCHEMA = 1


class FlightRecorder:
    """Bounded, thread-safe, always-on ring of component events.

    One event = one flat JSON-able dict ``{"ts", "kind", ...fields}``.
    The ring keeps the most recent ``capacity`` events; what the bound
    evicted is counted in ``overwrites`` (never silent — the bundle
    and the registry gauge both report it). ``events_recorded`` is the
    lifetime total."""

    def __init__(self, capacity: int = 2048):
        self._events: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.capacity = int(capacity)
        self.events_recorded = 0
        self.overwrites = 0

    def record(self, kind: str, **fields) -> dict:
        ev = {"ts": round(time.time(), 6), "kind": kind}
        if fields:
            ev.update(fields)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.overwrites += 1
            self._events.append(ev)
            self.events_recorded += 1
        return ev

    def snapshot(self) -> list[dict]:
        """Copy of the ring, oldest first — the bundle payload."""
        with self._lock:
            return list(self._events)

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def register_gauges(self, registry, prefix: str) -> None:
        """Expose the ring's state as scrape-time gauges in the owning
        component's registry (``<prefix>_recorder_events`` lifetime
        total, ``<prefix>_recorder_overwrites`` ring-bound evictions)
        — today drops are counted but not scrapeable anywhere else."""
        registry.gauge(
            f"{prefix}_recorder_events",
            fn=lambda: self.events_recorded,
        )
        registry.gauge(
            f"{prefix}_recorder_overwrites",
            fn=lambda: self.overwrites,
        )

    # -- fault-seam observer -------------------------------------------------

    def fault_observer(self, site: str, action: str, ctx: dict) -> None:
        """``faults.add_observer`` callback: every ARMED seam firing
        lands in the ring as a ``fault.fired`` event naming the seam —
        the post-mortem's "what was injected right before this died"
        line. Context values are summarized, not embedded (an active
        mask array must not ride a JSON bundle)."""
        summary = {}
        for k, v in ctx.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                summary[k] = v
            else:
                summary[k] = repr(v)[:80]
        self.record("fault.fired", site=site, action=action, **summary)


def build_postmortem(component: str, reason: str, recorder=None,
                     metrics=None, in_flight=None, config=None,
                     trace_spans=None, slo=None, detail=None) -> dict:
    """Assemble a post-mortem bundle dict (the one schema every dump
    shares). ``metrics`` is a ``metrics_snapshot()``-style sample
    list; ``in_flight`` the owning component's request table (with
    trace ids); ``trace_spans`` any spans recovered for those trace
    ids; ``slo`` a forced SLO verdict at dump time."""
    from distkeras_tpu_torch import faults

    return {
        "schema": POSTMORTEM_SCHEMA,
        "component": component,
        "reason": reason,
        "ts": round(time.time(), 6),
        "events": [] if recorder is None else recorder.snapshot(),
        "metrics": list(metrics or []),
        "in_flight": list(in_flight or []),
        "config": dict(config or {}),
        "fault_seams": faults.describe_active(),
        "trace_spans": list(trace_spans or []),
        "slo": slo,
        "detail": dict(detail or {}),
    }


def dump_postmortem(postmortem_dir, component: str, reason: str,
                    **kwargs):
    """Build a bundle and write it to ``postmortem_dir`` as one JSON
    file (name sorts by time, so the newest file IS the latest
    bundle). Returns ``(bundle, path)``; ``path`` is None when
    ``postmortem_dir`` is None (the bundle is still built, so the
    ``postmortem`` verb can serve it from memory). Best-effort on IO:
    a full disk must not turn a self-healing component's dump into a
    second crash — the write failure is recorded in the bundle it
    could not persist."""
    bundle = build_postmortem(component, reason, **kwargs)
    if postmortem_dir is None:
        return bundle, None
    path = os.path.join(
        postmortem_dir,
        f"postmortem_{component}_{bundle['ts']:.6f}_{os.getpid()}.json",
    )
    try:
        os.makedirs(postmortem_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=repr)
        os.replace(tmp, path)  # readers never see a half-written bundle
    except OSError as e:
        bundle["detail"]["dump_error"] = repr(e)
        return bundle, None
    return bundle, path


def _bundle_ts(name: str) -> float:
    """The dump timestamp embedded in a bundle filename
    (``postmortem_<component>_<ts>_<pid>.json``); component names may
    themselves contain underscores, so parse from the right. Unparsable
    names sort oldest."""
    try:
        return float(name[:-len(".json")].rsplit("_", 2)[1])
    except (ValueError, IndexError):
        return float("-inf")


def latest_postmortem(postmortem_dir):
    """Newest bundle in ``postmortem_dir`` as ``(bundle, path)``, or
    ``(None, None)`` when the directory holds none. Ordered by the
    timestamp IN the filename, not lexicographically — a directory
    shared by several components (engine + router) must yield the
    newest incident, not the lexicographically-last component's."""
    try:
        names = sorted(
            (
                n for n in os.listdir(postmortem_dir)
                if n.startswith("postmortem_") and n.endswith(".json")
            ),
            key=_bundle_ts,
        )
    except OSError:
        return None, None
    while names:
        path = os.path.join(postmortem_dir, names.pop())
        try:
            with open(path) as f:
                return json.load(f), path
        except (OSError, json.JSONDecodeError):
            continue  # torn/foreign file: fall back to the next-newest
    return None, None
