#!/usr/bin/env python
"""dkt_postmortem_torch — render a crash post-mortem bundle into a
human-readable incident timeline (the PyTorch port's twin of
``tools/dkt_postmortem.py``).

The bundle schema is the same in both packages, so this renders a
bundle either package wrote, with the same text. The live ``--host``
path speaks through the port's ``ServingClient``; like every port tool
it runs on the card unless ``--cpu`` is given, and without a card it
exits non-zero (the renderer itself touches no device).

A bundle (``obs.dump_postmortem`` schema) is what a self-healing seam
dumps on a terminal event: the component's flight-recorder ring, its
metrics snapshot, the in-flight request table with trace ids, the
config and armed fault-seam state. This tool merges the recorder
events with the in-flight requests' trace spans into ONE time-ordered
incident timeline — "what happened, in order, across every layer" —
instead of four JSONL files and a seed replay::

    python tools/dkt_postmortem_torch.py POSTMORTEM.json --cpu  # disk
    python tools/dkt_postmortem_torch.py --host H --port P      # the
        # ``postmortem`` DKT1 verb: latest bundle of a live server
        # or router, no shell access to the serving host needed

``render_bundle`` is a pure function of the bundle dict — the unit
tests drive it without a socket or a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sibling twins, also when this file runs through runpy
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import check_device  # noqa: E402


def _fmt_extra(d: dict, skip=()) -> str:
    parts = []
    for k, v in d.items():
        if k in skip or v is None:
            continue
        parts.append(f"{k}={v}")
    return " ".join(parts)


def _timeline_rows(bundle: dict) -> list[tuple[float, str, str]]:
    """(ts, tag, line) rows: recorder events merged with the trace
    spans the bundle recovered for its in-flight requests."""
    rows = []
    for ev in bundle.get("events", []):
        rows.append((
            float(ev.get("ts", 0.0)),
            "event",
            ev["kind"] + " " + _fmt_extra(ev, skip=("ts", "kind")),
        ))
    for sp in bundle.get("trace_spans", []):
        t0 = float(sp.get("start", 0.0))
        line = (
            f"span {sp['name']} [{sp.get('duration_ms', '?')} ms] "
            f"status={sp.get('status')} trace={sp.get('trace_id')}"
        )
        rows.append((t0, "trace", line))
    rows.sort(key=lambda r: r[0])
    return rows


def render_bundle(bundle: dict, width: int = 78) -> str:
    """One bundle -> the incident report: header, config, SLO verdict,
    armed seams, the merged timeline (relative timestamps), and the
    in-flight table."""
    t_crash = float(bundle.get("ts", 0.0))
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t_crash))
    lines = [
        "=" * width,
        f"POST-MORTEM  {bundle.get('component')}  "
        f"reason={bundle.get('reason')}  at {stamp}",
        "=" * width,
    ]
    if bundle.get("detail"):
        lines.append(f"detail: {_fmt_extra(bundle['detail'])}")
    if bundle.get("config"):
        lines.append(f"config: {_fmt_extra(bundle['config'])}")
    slo = bundle.get("slo")
    if slo:
        lines.append(f"slo: {slo.get('slo')}")
        for v in slo.get("violations", []):
            lines.append(
                f"  !! {v.get('name')} ({v.get('series')}): "
                f"{v.get('value')} vs {v.get('threshold')} "
                f"[{v.get('verdict')}]"
            )
    seams = bundle.get("fault_seams")
    if seams:
        lines.append("armed fault seams at dump time:")
        for s in seams:
            lines.append(
                f"  {s['site']} action={s['action']} "
                f"fired={s['fired']}"
                + (f" p={s['probability']}"
                   if s.get("probability", 1.0) < 1.0 else "")
            )
    elif seams is None:
        lines.append("armed fault seams at dump time: none")
    inflight = bundle.get("in_flight", [])
    if inflight:
        lines.append(f"in flight at dump time ({len(inflight)}):")
        for row in inflight:
            lines.append("  " + _fmt_extra(row))
    rows = _timeline_rows(bundle)
    lines.append("-" * width)
    lines.append(
        f"timeline ({len(rows)} entries; t is seconds relative to "
        "the dump, negative = before):"
    )
    for ts, tag, line in rows:
        rel = ts - t_crash
        lines.append(f"  {rel:+9.3f}s  {tag:<5}  {line}")
    lines.append("=" * width)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", nargs="?",
                    help="path to a postmortem_*.json bundle (or a "
                         "postmortem_dir — the newest bundle is used)")
    ap.add_argument("--host", help="fetch the latest bundle over the "
                                   "postmortem DKT1 verb instead")
    ap.add_argument("--port", type=int)
    ap.add_argument("--json", action="store_true",
                    help="print the raw bundle JSON instead of the "
                         "rendered timeline")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args(argv)
    check_device(args.cpu)

    if args.host is not None:
        if args.port is None:
            ap.error("--host needs --port")
        from distkeras_tpu_torch.serving import ServingClient

        with ServingClient(args.host, args.port, timeout=30.0) as cli:
            bundle = cli.postmortem()
        if bundle is None:
            print("no post-mortem bundle: nothing terminal has "
                  "happened on that server", file=sys.stderr)
            return 1
    elif args.bundle is not None:
        if os.path.isdir(args.bundle):
            from distkeras_tpu_torch.obs import latest_postmortem

            bundle, path = latest_postmortem(args.bundle)
            if bundle is None:
                print(f"no postmortem_*.json bundles in {args.bundle}",
                      file=sys.stderr)
                return 1
            print(f"# {path}", file=sys.stderr)
        else:
            with open(args.bundle) as f:
                bundle = json.load(f)
    else:
        ap.error("pass a bundle path/dir, or --host/--port")
        return 2

    if args.json:
        json.dump(bundle, sys.stdout, indent=2)
        print()
    else:
        print(render_bundle(bundle))
    return 0


if __name__ == "__main__":
    sys.exit(main())
