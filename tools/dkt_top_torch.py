#!/usr/bin/env python
"""dkt_top_torch — live terminal view over the ``metrics`` DKT1 verb
(the PyTorch port's twin of ``tools/dkt_top.py``).

It speaks through the port's ``ServingClient`` and
``RemoteParameterServerClient`` and renders the same table as the JAX
tool (the sample schema is shared). Like every port tool it runs on the
card unless ``--cpu`` is given, and without a card it exits non-zero.

Point it at a ``ServingServer`` (one engine's book) or a
``FleetRouter`` (the per-replica-labeled fleet aggregate) and it polls
the typed-metrics registry snapshot every ``--interval`` seconds,
rendering counters, gauges, and latency-histogram quantiles grouped by
replica — the "where is the fleet spending its time" answer without
grepping four logs. When the target serves the ``timeseries`` verb
(metrics history on, the default), every row also gets a sparkline of
its last ``--window`` seconds plus a trend arrow and windowed
per-second rate — "is it getting worse" at a glance::

    python tools/dkt_top_torch.py 127.0.0.1 9000
    python tools/dkt_top_torch.py 127.0.0.1 9000 --once        # one snapshot
    python tools/dkt_top_torch.py 127.0.0.1 9000 --prometheus --once  # raw dump
    python tools/dkt_top_torch.py 127.0.0.1 9000 --prometheus  # live raw dump
    python tools/dkt_top_torch.py 127.0.0.1 7000 --ps          # parameter
        # server (its b"m" scrape action; works on a standby too) —
        # commit/pull counters, per-worker commit-interval histograms,
        # and the training_ps_straggler gauge

No curses: plain ANSI clear-and-redraw, so it works in any terminal
(and in a pipe with ``--once``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sibling twins, also when this file runs through runpy
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import check_device  # noqa: E402


def _fmt_value(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:,.4g}"
    return f"{v:,}"


def _fmt_bytes(v) -> str:
    v = int(v or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return (f"{v}{unit}" if unit == "B"
                    else f"{v:.1f}{unit}")
        v /= 1024
    return f"{v}B"


_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(points) -> str:
    """Unicode sparkline over a resampled ``points`` list (the
    ``timeseries`` verb's fixed-length buckets; None = no data in the
    bucket, rendered as a gap)."""
    vals = [p for p in points or [] if p is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    out = []
    for p in points:
        if p is None:
            out.append(" ")
        elif span <= 0:
            out.append(_BLOCKS[0])
        else:
            out.append(_BLOCKS[min(7, int((p - lo) / span * 7.999))])
    return "".join(out)


def _trend_arrow(t) -> str:
    if t is None:
        return " "
    if t > 1e-9:
        return "↑"
    if t < -1e-9:
        return "↓"
    return "→"


def series_index(ts_reply) -> dict:
    """Index a ``timeseries`` verb reply for the table renderer:
    ``(replica, name, sorted-label-items) -> series row``."""
    idx = {}
    for row in (ts_reply or {}).get("series") or []:
        labels = dict(row.get("labels") or {})
        rep = labels.pop("replica", "") or "(local)"
        idx[(rep, row["name"], tuple(sorted(labels.items())))] = row
    return idx


def _hist_line(s) -> str:
    """count / mean / p50 / p99 out of the cumulative bucket samples
    (bucket-resolution quantiles: the upper bound of the bucket that
    holds the target observation)."""
    count, total = s["count"], s["sum"]
    if not count:
        return "count=0"

    def q(frac):
        target = max(1, int(frac * count))
        prev = 0
        for le, cum in s["buckets"]:
            if cum >= target and cum > prev:
                return "inf" if le == "+Inf" else f"{float(le):.4g}"
            prev = cum
        return "inf"

    return (
        f"count={count:,} mean={total / count:.4g} "
        f"p50={q(0.5)} p99={q(0.99)}"
    )


def format_table(samples, width: int = 78, series: dict | None = None
                 ) -> str:
    """Render one registry snapshot (the ``metrics`` verb payload) as
    a replica-grouped table. Pure function of the samples — the unit
    tests drive it without a socket. ``series``: an optional
    :func:`series_index` over a ``timeseries`` reply — each metric row
    then grows a sparkline + trend-arrow column (windowed per-second
    rates for counters/histograms, windowed values for gauges)."""
    groups: dict[str, list] = {}
    for s in samples:
        labels = dict(s.get("labels") or {})
        replica = labels.pop("replica", "") or "(local)"
        groups.setdefault(replica, []).append((s, labels))
    lines = []
    for replica in sorted(groups):
        # the mesh column: a replica serving over a tensor-parallel
        # mesh says so in its header (from the serving_mesh_devices
        # gauge), so a heterogeneous fleet reads at a glance
        mesh = ""
        for s, _ in groups[replica]:
            if s["name"] == "serving_mesh_devices" and s.get("value"):
                n = int(s["value"])
                mesh = f"  mesh=tp:{n}" if n > 1 else "  mesh=solo"
                break
        # the disaggregation-role column: a role-split fleet's books
        # must read at a glance which replicas prefill and which
        # decode (from the serving_engine_role_id gauge)
        role = ""
        for s, _ in groups[replica]:
            if s["name"] == "serving_engine_role_id" and (
                s.get("value") is not None
            ):
                role = "  role=" + {0: "unified", 1: "prefill",
                                    2: "decode"}.get(
                    int(s["value"]), "?"
                )
                break
        # the elastic-fleet column: the controller's fleet_replicas
        # gauge puts the CURRENT fleet size in the router group's
        # header, the autoscale counters mark how it got there
        # (↑ scale-ups / ↓ scale-downs), and — when the target serves
        # history — a sparkline of fleet_replicas draws the
        # provisioned-capacity curve next to the load that drove it
        fleet = ""
        for s, _ in groups[replica]:
            if s["name"] == "fleet_replicas" and (
                s.get("value") is not None
            ):
                fleet = f"  replicas={int(s['value'])}"
                ups = downs = 0
                for s2, _ in groups[replica]:
                    if s2["name"] == "fleet_autoscale_scale_ups":
                        ups = int(s2.get("value") or 0)
                    elif s2["name"] == "fleet_autoscale_scale_downs":
                        downs = int(s2.get("value") or 0)
                if ups or downs:
                    fleet += f" ↑{ups}↓{downs}"
                if series is not None:
                    ts = series.get((replica, "fleet_replicas", ()))
                    if ts is not None:
                        sl = _sparkline(ts.get("points"))
                        if sl:
                            fleet += f" {sl}"
                break
        # the zero-bubble column: the fraction of decode wall-clock
        # the device sat idle (1 - overlap efficiency, from the
        # overlap ledger's gauge); when the target serves history, the
        # windowed mean bubble per iteration and a sparkline of the
        # serving_step_bubble_seconds histogram's observation rate
        bubble = ""
        for s, _ in groups[replica]:
            if s["name"] == "serving_overlap_efficiency" and (
                s.get("value") is not None
            ):
                frac = 100.0 * (1.0 - float(s["value"]))
                bubble = f"  bubble={frac:.1f}%"
                if series is not None:
                    ts = series.get(
                        (replica, "serving_step_bubble_seconds", ())
                    )
                    if ts is not None:
                        if ts.get("mean") is not None:
                            bubble += f" ~{ts['mean']:.2g}s/it"
                        sl = _sparkline(ts.get("points"))
                        if sl:
                            bubble += f" {sl}"
                break
        # the overload-defense column: a breaker-enabled router says
        # how many replicas its breakers currently cut off (from the
        # fleet_router_breaker_open_replicas gauge) plus the lifetime
        # open/close ledger; a shedding engine shows its brownout rung
        # (serving_shed_rung gauge, 0=ok..3=refuse).  Both columns are
        # absent on targets that never enabled the feature.
        guard = ""
        for s, _ in groups[replica]:
            if s["name"] == "fleet_router_breaker_open_replicas" and (
                s.get("value") is not None
            ):
                n = int(s["value"])
                guard = f"  breakers={'OPEN:%d' % n if n else 'ok'}"
                opens = closes = 0
                for s2, _ in groups[replica]:
                    if s2["name"] == "fleet_router_breaker_opens":
                        opens = int(s2.get("value") or 0)
                    elif s2["name"] == "fleet_router_breaker_closes":
                        closes = int(s2.get("value") or 0)
                if opens or closes:
                    guard += f" ↑{opens}↓{closes}"
                break
        # the fleet-KV-fabric column: per-replica peer traffic (bytes
        # pulled in / served out over kv.fetch + direct push), the
        # fetch hit/degrade ledger, and how stale the advertised
        # prefix digest can be (seconds since the store last moved).
        # Absent on targets without the peer counters (old builds).
        fabric = ""
        for s, _ in groups[replica]:
            if s["name"] == "serving_kv_peer_bytes_in" and (
                s.get("value") is not None
            ):
                vals = {}
                for s2, _ in groups[replica]:
                    vals[s2["name"]] = s2.get("value")
                fabric = (
                    "  fabric="
                    f"in:{_fmt_bytes(vals.get('serving_kv_peer_bytes_in'))}"
                    f"/out:{_fmt_bytes(vals.get('serving_kv_peer_bytes_out'))}"
                    f" hit:{int(vals.get('serving_kv_peer_fetch_ok') or 0)}"
                    f" degr:{int(vals.get('serving_kv_peer_fetch_degraded') or 0)}"
                )
                age = vals.get("serving_kv_fabric_digest_age_seconds")
                if age is not None:
                    fabric += f" age:{float(age):.1f}s"
                break
        shed = ""
        for s, _ in groups[replica]:
            if s["name"] == "serving_shed_rung" and (
                s.get("value") is not None
            ):
                rung = int(s["value"])
                shed = "  shed=" + {0: "ok", 1: "shed-lo",
                                    2: "clamp", 3: "refuse"}.get(
                    rung, "?"
                )
                break
        lines.append(
            f"== {replica}{role}{mesh}{fleet}{bubble}{guard}{shed}"
            f"{fabric} ".ljust(width, "=")
        )
        rows = []
        for s, labels in sorted(
            groups[replica], key=lambda p: p[0]["name"]
        ):
            name = s["name"]
            lkey = tuple(sorted(labels.items()))
            if labels:
                name += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items())
                ) + "}"
            spark = ""
            if series is not None:
                ts = series.get((replica, s["name"], lkey))
                if ts is not None:
                    sl = _sparkline(ts.get("points"))
                    if sl:
                        rate = ts.get("rate")
                        tail = (
                            f" {rate:,.3g}/s"
                            if rate is not None else ""
                        )
                        spark = (
                            f"  {sl} {_trend_arrow(ts.get('trend'))}"
                            f"{tail}"
                        )
            if s["kind"] == "histogram":
                rows.append((name, "H", _hist_line(s) + spark))
            else:
                rows.append(
                    (name, "C" if s["kind"] == "counter" else "G",
                     _fmt_value(s["value"]) + spark)
                )
        namew = max((len(n) for n, _, _ in rows), default=0)
        for name, kind, val in rows:
            lines.append(f"  {name.ljust(namew)}  {kind}  {val}")
    return "\n".join(lines)


def _ps_loop(args) -> int:
    """The PS face: scrape the b"m" action and render the same table
    (the PS registry speaks the identical sample schema). Works on a
    standby, which refuses pull/commit but serves metrics — the
    straggler gauge and commit-interval histograms are how a DOWNPOUR
    run's lagging worker shows up here."""
    from distkeras_tpu_torch.obs import render_prometheus
    from distkeras_tpu_torch.parameter_servers import RemoteParameterServerClient

    cli = RemoteParameterServerClient(args.host, args.port)
    try:
        while True:
            m = cli.metrics()
            label = f"ps:{args.host}:{args.port} ({m.get('role')})"
            if args.prometheus:
                out = render_prometheus(m["metrics"])
            else:
                series = None
                if not args.no_series:
                    try:
                        series = series_index(
                            cli.timeseries(
                                window=args.window
                            ).get("timeseries")
                        )
                    except Exception:  # noqa: BLE001 — older PS
                        series = None
                out = format_table(
                    [dict(s) for s in m["metrics"]], series=series
                )
            if args.once:
                print(f"== {label}")
                print(out)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H")
            stamp = time.strftime("%H:%M:%S")
            print(f"dkt_top {label}  {stamp}  "
                  f"(interval {args.interval}s, ctrl-c to quit)")
            print(out)
            sys.stdout.flush()
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
    finally:
        cli.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("host")
    ap.add_argument("port", type=int)
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between polls")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen clear)")
    ap.add_argument("--prometheus", action="store_true",
                    help="print the text exposition dump instead of "
                         "the table")
    ap.add_argument("--ps", action="store_true",
                    help="the target is a parameter server (PS wire "
                         "protocol), not a serving server/router")
    ap.add_argument("--window", type=float, default=60.0,
                    help="timeseries window (seconds) behind the "
                         "sparkline/trend columns")
    ap.add_argument("--no-series", action="store_true",
                    help="skip the timeseries scrape (plain "
                         "point-in-time table; also the fallback when "
                         "the target serves no history)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args(argv)
    check_device(args.cpu)

    if args.ps:
        return _ps_loop(args)

    from distkeras_tpu_torch.serving import ServingClient

    with ServingClient(args.host, args.port, timeout=10.0) as cli:
        while True:
            if args.prometheus:
                out = cli.metrics(prometheus=True)
            else:
                samples = cli.metrics()
                series = None
                if not args.no_series:
                    try:
                        # best-effort: a history=False engine (or a
                        # pre-timeseries server) refuses the verb —
                        # render the plain table rather than fail
                        series = series_index(
                            cli.timeseries(window=args.window)
                        )
                    except Exception:  # noqa: BLE001
                        series = None
                out = format_table(samples, series=series)
            for gap in cli.last_metrics_unreachable:
                # a fleet scrape that skipped a replica is NOT complete
                # — show the hole, never a silently shrunken fleet
                ep = gap.get("endpoint", ["?", "?"])
                out += (
                    f"\n!! replica {ep[0]}:{ep[1]} UNREACHABLE for this "
                    f"scrape: {gap.get('error')}"
                )
            if args.once:
                print(out)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            stamp = time.strftime("%H:%M:%S")
            print(f"dkt_top {args.host}:{args.port}  {stamp}  "
                  f"(interval {args.interval}s, ctrl-c to quit)")
            print(out)
            sys.stdout.flush()
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0


if __name__ == "__main__":
    sys.exit(main())
