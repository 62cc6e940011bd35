#!/usr/bin/env python
"""Trace-driven workload generator for the PyTorch port's serving soaks.

The port's twin of ``tools/loadgen.py``: the same presets, arrival
processes, traces, JSON round trip and summaries, drawn from the same
seeded numpy streams, so one ``(spec, seed)`` gives the JAX tool's trace
event for event. It keeps its own copy of that module (it imports nothing
of the JAX side). The generator is numpy only; the CLI keeps the port's
device contract: it runs where the port runs, on the card unless
``--cpu`` is given, and without a card it exits non-zero.

What follows is the JAX tool's description, which holds unchanged.

Every serving bench so far hand-rolled its arrival schedule (one
`rng.exponential` per workload) — scenario diversity lived in one-off
bench configs. This module makes the WORKLOAD a first-class, seeded,
replayable object: a trace is a list of events ``{"t", "tenant",
"priority", "prompt", "steps"}`` drawn from

- an **arrival process** — how load arrives over time:

  * ``poisson``     — memoryless at ``rate`` req/s (the classic
    open-loop baseline);
  * ``bursty``      — an on/off modulated Poisson: ``duty`` of every
    ``period`` seconds runs at ``rate * burst_factor``, the rest at a
    trickle (the noisy-neighbour shape QoS admission exists for);
  * ``diurnal``     — sinusoidally modulated Poisson (``amplitude``
    swing over ``period`` seconds): the day/night ramp an autoscaler
    and a quota policy both have to ride;
  * ``heavy_tail``  — Pareto(``alpha``) inter-arrivals with mean
    ``1/rate``: arrivals cluster, gaps stretch (the self-similar
    traffic real serving logs show, not smooth Poisson);
  * ``ramp``        — a load RAMP from a trickle up to ``rate``
    (here the PEAK, not the mean) over ``period`` seconds, then a
    hold at peak: linear when ``ramp_steps=0``, else a staircase of
    that many flat steps. The standard autoscale stimulus — the
    bench and the soak drive the same seeded, replayable climb;
  * ``storm``       — steady at ``rate`` until ``burst_start``, a
    flat overload burst at ``rate * burst_factor`` for
    ``burst_len`` seconds, then steady again: the three-phase
    (baseline -> 5x storm -> recovery) stimulus the overload-
    defense bench and soak drive against the shed gate;

- a **tenant mix** — each tenant a dict of ``name``, ``weight``
  (traffic share), ``priority`` (QoS class), ``prompt_len`` and
  ``steps`` ranges — so one trace carries an interactive tenant's
  short urgent requests interleaved with a batch tenant's long
  low-priority ones.

Determinism is the contract: the same ``(spec, seed)`` produces the
identical trace, event for event (``numpy.default_rng(seed)`` is the
only entropy), so a bench A/B drives BOTH sides with one trace and a
failing soak replays exactly. ``trace_to_jsonable``/
``trace_from_jsonable`` round-trip a trace through JSON for archival.

Usage (summary of a trace, as JSON)::

    python tools/loadgen_torch.py --process bursty --rate 50 \
        --duration 10 --seed 0 [--cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_TENANTS = (
    {"name": "default", "weight": 1.0, "priority": 0,
     "prompt_len": (4, 64), "steps": (8, 32)},
)


def interactive_tenants(seq: int = 256) -> list[dict]:
    """The ``interactive`` preset: the traffic shape disaggregated
    prefill/decode exists for — a chat tenant's short urgent STREAMED
    turns interleaved with a document tenant's prefill-heavy long
    prompts. ``stream`` is a per-tenant probability: each event draws
    its own streaming flag, so one trace carries both delivery modes
    (the doc tenant mixes, modeling batch summarization requests that
    sometimes stream). Prompt/step ranges scale with ``seq``."""
    return [
        {"name": "chat", "weight": 0.7, "priority": 0, "stream": 1.0,
         "prompt_len": (4, max(6, seq // 10)),
         "steps": (max(4, seq // 16), max(6, seq // 6))},
        {"name": "doc", "weight": 0.3, "priority": 0, "stream": 0.5,
         "prompt_len": (seq // 2, max(seq // 2 + 2, 3 * seq // 4)),
         "steps": (max(2, seq // 32), max(4, seq // 12))},
    ]


def decode_heavy_tenants(seq: int = 256) -> list[dict]:
    """The ``decode_heavy`` preset: the traffic shape the zero-bubble
    overlap exists for — short prompts (admission/prefill is cheap)
    with LONG generations that keep every slot decoding, so the
    scheduler's per-iteration host work is the dominant non-device
    cost and the bubble is measurable at saturation. One streamed
    tenant rides along so the overlapped loop's stream-push ordering
    is exercised under the same load."""
    return [
        {"name": "gen", "weight": 0.75, "priority": 0,
         "prompt_len": (4, max(6, seq // 16)),
         "steps": (max(8, seq // 3), max(10, 2 * seq // 3))},
        {"name": "gen_stream", "weight": 0.25, "priority": 0,
         "stream": 1.0,
         "prompt_len": (4, max(6, seq // 16)),
         "steps": (max(8, seq // 3), max(10, 2 * seq // 3))},
    ]


def storm_tenants(seq: int = 256) -> list[dict]:
    """The ``storm`` preset: two QoS classes for the overload-defense
    drill — a high-priority interactive tenant whose p99 the brownout
    ladder must protect, and a low-priority bulk tenant that is the
    FIRST to shed when the gate latches. Short decodes keep per-request
    cost small so the storm is an arrival-rate problem, not a
    decode-length one."""
    return [
        {"name": "hi", "weight": 0.3, "priority": 2,
         "prompt_len": (4, max(6, seq // 16)),
         "steps": (3, max(5, seq // 32))},
        {"name": "lo", "weight": 0.7, "priority": 0,
         "prompt_len": (4, max(6, seq // 16)),
         "steps": (3, max(5, seq // 32))},
    ]


def prefix_fleet_tenants(seq: int = 256, tenants_n: int = 6,
                         header_frac: float = 0.5) -> list[dict]:
    """The ``prefix_fleet`` preset: the fleet-KV-fabric stimulus —
    ``tenants_n`` tenants, each with its OWN long shared header (a
    system prompt, drawn once per trace and prepended to every one of
    that tenant's requests) and a short random per-request tail.
    Driven against a multi-replica fleet whose per-replica prefix
    pools are budgeted BELOW the combined header working set (the
    bench pairs it with ``prefix_cache_bytes`` sized to a fraction of
    the header count), every replica can hold SOME tenants' pages but
    none can hold all — so the fleet-wide hit rate is decided by
    page-aware routing and peer fetch, not by any one store. Short
    decodes keep the trace prefill-dominated: the shared header IS
    the cost being saved."""
    hl = max(8, int(seq * header_frac))
    return [
        {"name": f"t{i}", "weight": 1.0, "priority": 0,
         "header_len": hl,
         "prompt_len": (2, max(4, seq // 16)),
         "steps": (3, max(5, seq // 32))}
        for i in range(int(tenants_n))
    ]


PRESETS = {
    "interactive": interactive_tenants,
    "decode_heavy": decode_heavy_tenants,
    "storm": storm_tenants,
    "prefix_fleet": prefix_fleet_tenants,
}


def _rate_fn(process: str, rate: float, *, burst_factor=8.0,
             period=1.0, duty=0.2, amplitude=0.8, floor_frac=0.05,
             ramp_steps=0, burst_start=None, burst_len=None):
    """The instantaneous-rate function r(t) of a modulated process
    (None for processes that do not thin a Poisson stream)."""
    if process == "poisson":
        return lambda t: rate
    if process == "ramp":
        # trickle -> peak over ``period`` seconds, then hold: ``rate``
        # is the PEAK here (an autoscaler is sized against what the
        # climb reaches, not the average of the climb). ``ramp_steps``
        # > 0 quantizes the climb into flat steps — the staircase
        # shape a step-provisioned fleet actually experiences
        lo = max(1e-9, rate * floor_frac)

        def ramp(t):
            frac = min(1.0, t / period) if period > 0 else 1.0
            if ramp_steps and frac < 1.0:
                frac = math.floor(frac * ramp_steps) / ramp_steps
            return lo + (rate - lo) * frac

        return ramp
    if process == "bursty":
        # duty * period seconds of burst at rate*burst_factor, the
        # rest at whatever off-rate keeps the MEAN near ``rate`` —
        # floored at a trickle when duty*burst_factor already exceeds
        # the budget (then the mean runs hot; the burst IS the point)
        hi = rate * burst_factor
        lo = max(rate * floor_frac,
                 rate * (1 - duty * burst_factor) / max(1e-9, 1 - duty))
        return lambda t: hi if (t % period) < duty * period else lo
    if process == "diurnal":
        return lambda t: max(
            rate * floor_frac,
            rate * (1 + amplitude * math.sin(2 * math.pi * t / period)),
        )
    if process == "storm":
        # ONE rectangular overload: ``rate`` is the STEADY baseline
        # (unlike bursty's mean-preserving duty cycle — a storm is an
        # incident, not a shape); the burst multiplies it by
        # ``burst_factor`` for ``burst_len`` seconds starting at
        # ``burst_start``. Defaults carve the timeline into thirds so
        # --process storm --duration 9 gives 3 s of each phase.
        if burst_start is None or burst_len is None:
            raise ValueError(
                "storm needs burst_start= and burst_len= (the CLI "
                "defaults both to duration/3)"
            )
        b0, b1 = float(burst_start), float(burst_start) + float(burst_len)
        return lambda t: rate * burst_factor if b0 <= t < b1 else rate
    raise ValueError(f"unknown arrival process {process!r}")


def arrivals(process: str, rate: float, *, duration=None, n=None,
             seed=0, alpha=1.5, **kw) -> np.ndarray:
    """Arrival instants (seconds from 0, ascending) for ``process`` at
    mean ``rate`` req/s — bounded by ``duration`` seconds or ``n``
    events (at least one required). Seeded and deterministic."""
    if duration is None and n is None:
        raise ValueError("need duration= or n=")
    rate = float(rate)
    if rate <= 0:
        raise ValueError(f"rate must be > 0; got {rate}")
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    if process == "heavy_tail":
        # classical Pareto inter-arrivals with mean 1/rate: gaps
        # cluster then stretch (alpha -> 1 = heavier tail; needs
        # alpha > 1 for the mean to exist)
        if alpha <= 1.0:
            raise ValueError(f"heavy_tail needs alpha > 1; got {alpha}")
        xm = (alpha - 1.0) / (alpha * rate)
        while True:
            t += xm * (1.0 + rng.pareto(alpha))
            if duration is not None and t >= duration:
                break
            out.append(t)
            if n is not None and len(out) >= n:
                break
        return np.asarray(out)
    r = _rate_fn(process, rate, **kw)
    while True:
        t += rng.exponential(1.0 / r(t))
        if duration is not None and t >= duration:
            break
        out.append(t)
        if n is not None and len(out) >= n:
            break
    return np.asarray(out)


def make_trace(*, process="poisson", rate=10.0, duration=None, n=None,
               tenants=DEFAULT_TENANTS, vocab=256, seed=0,
               **proc_kw) -> list[dict]:
    """A full workload trace: arrival instants from ``process``, each
    event assigned a tenant by weighted draw and given a prompt /
    decode budget from that tenant's ranges. Deterministic in
    ``seed`` (one rng drives arrivals, a derived one the mixes)."""
    ts = arrivals(process, rate, duration=duration, n=n, seed=seed,
                  **proc_kw)
    rng = np.random.default_rng((int(seed) << 8) + 1)
    tenants = [dict(t) for t in tenants]
    weights = np.asarray([float(t.get("weight", 1.0)) for t in tenants])
    if (weights <= 0).any():
        raise ValueError("tenant weights must be > 0")
    weights = weights / weights.sum()
    # streaming flags draw ONLY when some tenant declares a ``stream``
    # probability: traces from stream-less specs stay byte-identical
    # to what this generator produced before the field existed
    has_stream = any("stream" in t for t in tenants)
    # per-tenant SHARED headers (``header_len``): drawn once per trace
    # from a tenant-derived rng and prepended to every one of that
    # tenant's prompts — the shared-prefix traffic the fleet KV fabric
    # routes and peer-fetches. ``prompt_len`` then ranges the RANDOM
    # TAIL. Header-less specs draw exactly the streams they always did.
    headers = {}
    for ti, spec in enumerate(tenants):
        hl = int(spec.get("header_len", 0) or 0)
        if hl:
            hrng = np.random.default_rng((int(seed) << 8) + 2 + ti)
            headers[ti] = hrng.integers(0, vocab, hl).astype(np.int32)
    trace = []
    for t in ts:
        ti = int(rng.choice(len(tenants), p=weights))
        spec = tenants[ti]
        plo, phi = spec.get("prompt_len", (4, 64))
        slo_, shi = spec.get("steps", (8, 32))
        plen = int(rng.integers(plo, max(plo + 1, phi)))
        steps = int(rng.integers(slo_, max(slo_ + 1, shi)))
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        if ti in headers:
            prompt = np.concatenate([headers[ti], prompt])
        ev = {
            "t": float(t),
            "tenant": str(spec.get("name", f"tenant{ti}")),
            "priority": int(spec.get("priority", 0)),
            "prompt": prompt,
            "steps": steps,
        }
        if has_stream:
            ev["stream"] = bool(
                rng.random() < float(spec.get("stream", 0.0))
            )
        trace.append(ev)
    return trace


def trace_to_jsonable(trace) -> list[dict]:
    return [
        {**ev, "t": round(ev["t"], 6),
         "prompt": np.asarray(ev["prompt"]).tolist()}
        for ev in trace
    ]


def trace_from_jsonable(rows) -> list[dict]:
    return [
        {**row, "prompt": np.asarray(row["prompt"], np.int32)}
        for row in rows
    ]


def summarize(trace, phases: int = 0) -> dict:
    """Per-tenant counts + global arrival stats — what the CLI prints
    and a bench artifact records next to its numbers. ``phases`` > 0
    additionally splits the trace's span into that many equal windows
    and reports the arrival rate of each (``phase_rates``) — how a
    ramp trace documents its own climb; the base schema is unchanged
    when 0."""
    ts = np.asarray([ev["t"] for ev in trace])
    by_tenant: dict = {}
    for ev in trace:
        b = by_tenant.setdefault(
            ev["tenant"],
            {"requests": 0, "priority": ev["priority"],
             "prompt_tokens": 0, "decode_tokens": 0, "streamed": 0},
        )
        b["requests"] += 1
        b["prompt_tokens"] += int(np.asarray(ev["prompt"]).size)
        b["decode_tokens"] += int(ev["steps"])
        b["streamed"] += int(bool(ev.get("stream")))
    gaps = np.diff(ts) if ts.size > 1 else np.asarray([0.0])
    prompt_total = sum(b["prompt_tokens"] for b in by_tenant.values())
    decode_total = sum(b["decode_tokens"] for b in by_tenant.values())
    out = {
        "events": len(trace),
        # decode tokens per prompt token: how decode-bound the trace
        # is (the decode_heavy preset exists to push this high)
        "decode_per_prompt": round(
            decode_total / max(1, prompt_total), 3
        ),
        "span_seconds": round(float(ts[-1] - ts[0]), 4) if len(trace)
        else 0.0,
        "gap_ms": {
            "mean": round(float(gaps.mean()) * 1e3, 3),
            "p50": round(float(np.percentile(gaps, 50)) * 1e3, 3),
            "p99": round(float(np.percentile(gaps, 99)) * 1e3, 3),
            "max": round(float(gaps.max()) * 1e3, 3),
        },
        "tenants": by_tenant,
    }
    if phases > 0 and len(trace):
        span = float(ts[-1] - ts[0])
        edges = np.linspace(0.0, max(span, 1e-9), int(phases) + 1)
        rel = ts - ts[0]
        rows = []
        for i in range(int(phases)):
            lo, hi = float(edges[i]), float(edges[i + 1])
            last = i == int(phases) - 1
            mask = (rel >= lo) & ((rel <= hi) if last else (rel < hi))
            n = int(mask.sum())
            dur = hi - lo
            rows.append({
                "t0": round(lo, 4), "t1": round(hi, 4), "events": n,
                "rate": round(n / dur, 3) if dur > 0 else 0.0,
            })
        out["phase_rates"] = rows
    return out


def summarize_outcomes(outcomes) -> dict:
    """Tally a driven run's per-request OUTCOMES (the companion to
    ``summarize``'s per-trace arrival stats): each entry is one of
    ``ok`` / ``shed`` (typed overloaded with a ``retry_after_ms``
    hint) / ``budget_refused`` (a retry the budget declined to
    amplify) / ``error:<code>`` — plus ``hedged`` entries counted
    separately by callers that hedge. The soaks gate their ledgers on
    these totals balancing against the server side's counters."""
    out = {"total": 0, "ok": 0, "shed": 0, "budget_refused": 0,
           "errors": {}}
    for o in outcomes:
        out["total"] += 1
        o = str(o)
        if o in ("ok", "shed", "budget_refused"):
            out[o] += 1
        elif o.startswith("error:"):
            code = o.split(":", 1)[1]
            out["errors"][code] = out["errors"].get(code, 0) + 1
        else:
            out["errors"][o] = out["errors"].get(o, 0) + 1
    return out


def check_device(cpu: bool) -> str:
    """The port's device contract for a tool's CLI: ``"cpu"`` when
    ``cpu``, else the card, and without one a ``SystemExit`` carrying
    ``resolve_device``'s message (no fallback). Returns the ``device=``
    the tool hands the port (``None`` = the card)."""
    from distkeras_tpu_torch.parallel.backend import setup_backend

    try:
        platform = setup_backend(cpu=cpu)
    except RuntimeError as e:
        raise SystemExit(f"{os.path.basename(sys.argv[0])}: {e}") from e
    return "cpu" if platform == "cpu" else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process", default="poisson",
                    choices=("poisson", "bursty", "diurnal",
                             "heavy_tail", "ramp", "storm"))
    ap.add_argument("--rate", type=float, default=10.0,
                    help="mean arrivals per second (PEAK for ramp)")
    ap.add_argument("--period", type=float, default=None,
                    help="modulation period seconds (ramp: the climb "
                         "duration before the hold at peak)")
    ap.add_argument("--ramp-steps", type=int, default=0,
                    help="ramp only: quantize the climb into this "
                         "many flat steps (0 = linear)")
    ap.add_argument("--burst-start", type=float, default=None,
                    help="storm only: burst onset seconds "
                         "(default duration/3)")
    ap.add_argument("--burst-len", type=float, default=None,
                    help="storm only: burst length seconds "
                         "(default duration/3)")
    ap.add_argument("--burst-factor", type=float, default=None,
                    help="storm only: burst rate multiplier "
                         "(default 5.0)")
    ap.add_argument("--phases", type=int, default=0,
                    help="split the summary into this many equal "
                         "windows with per-phase arrival rates")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--tenants", default=None,
                    help="JSON list of tenant specs (name/weight/"
                         "priority/prompt_len/steps/stream)")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="named tenant-mix preset (interactive: "
                         "streamed short chat turns + prefill-heavy "
                         "long documents; decode_heavy: short prompts "
                         "with long generations — slot-saturating "
                         "decode); overrides --tenants")
    ap.add_argument("--seq", type=int, default=256,
                    help="sequence capacity the preset's prompt/step "
                         "ranges scale to")
    ap.add_argument("--dump", action="store_true",
                    help="print the full trace (JSON rows) instead of "
                         "the summary")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args(argv)
    check_device(args.cpu)
    if args.preset is not None:
        tenants = PRESETS[args.preset](args.seq)
    else:
        tenants = (
            json.loads(args.tenants) if args.tenants else DEFAULT_TENANTS
        )
    proc_kw = {}
    if args.period is not None:
        proc_kw["period"] = args.period
    if args.ramp_steps:
        proc_kw["ramp_steps"] = args.ramp_steps
    if args.process == "storm":
        third = args.duration / 3.0
        proc_kw["burst_start"] = (
            args.burst_start if args.burst_start is not None else third
        )
        proc_kw["burst_len"] = (
            args.burst_len if args.burst_len is not None else third
        )
        proc_kw["burst_factor"] = (
            args.burst_factor if args.burst_factor is not None else 5.0
        )
    trace = make_trace(
        process=args.process, rate=args.rate, duration=args.duration,
        tenants=tenants, vocab=args.vocab, seed=args.seed, **proc_kw,
    )
    out = (trace_to_jsonable(trace) if args.dump
           else summarize(trace, phases=args.phases))
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
