#!/usr/bin/env python3
"""Where a serving fleet's time goes on one NVIDIA GPU.

Phase 4's 16-request mix of ``chip_smoke.py`` (the LN-hooked d512/L8 LM,
8 slots a replica) from 8 client threads, against:

- ``single``: one engine behind its own ``ServingServer`` (phase 11's
  shape);
- ``router1``: the same engine as the one replica of a ``FleetRouter``;
- ``router2``: two replicas behind the router (phase 18a's shape);
- ``router2_sweep1s``: the same with the router's health sweep at 1 s
  instead of 0.1 s;
- ``direct2``: two replicas behind their own servers, the mix split
  between them by the clients, no router;
- ``router2_1thread``: ``router2`` with torch's intra-op threads at 1.

Each configuration runs twice, in turns (forward, then backward), on fresh
engines; every reply must equal phase 4's. Prints, per run, tokens/s and
each replica's decode steps and mean busy slots a step, with the card's
``nvidia-smi`` name and power limit.

Usage: ``python3 fleet_breakdown.py [--out FILE]`` from the repository
root (needs one CUDA card and nvcc, like ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def replica_books(engines):
    return [(e.batcher.counters["steps"], e.batcher.counters["occupancy_sum"])
            for e in engines]


def busy(before, after):
    return [{"steps": n1 - n0, "mean_occupancy": (o1 - o0) / max(1, n1 - n0)}
            for (n0, o0), (n1, o1) in zip(before, after)]


def run_config(cs, torch, np, lm, name, reqs, outs):
    from distkeras_tpu_torch.serving import FleetController, ServingServer

    servers, ctl, threads0 = [], None, torch.get_num_threads()
    try:
        if name == "router2_1thread":
            torch.set_num_threads(1)
        if name.startswith("router"):
            kw = dict(cs.ROUTER_KW)
            if name == "router2_sweep1s":
                kw["health_interval"] = 1.0
            ctl = FleetController(lm, replicas=1 if name == "router1" else 2,
                                  factory=cs.card_replicas(lm),
                                  router_kw=kw).start()
            engines = [r.engine for r in ctl.replicas]
            b0 = replica_books(engines)
            rows, secs = cs.fleet_mix(np, ctl.endpoint, reqs)
        else:
            n = 1 if name == "single" else 2
            servers = [ServingServer(cs.hooked_engine(lm)).start()
                       for _ in range(n)]
            engines = [s.engine for s in servers]
            b0 = replica_books(engines)
            parts = [[j for j in range(len(reqs)) if j % n == i]
                     for i in range(n)]
            got = [None] * n

            def drive(i):
                got[i] = cs.fleet_mix(np, (servers[i].host, servers[i].port),
                                      [reqs[j] for j in parts[i]],
                                      threads=8 // n)

            t0 = time.monotonic()
            ths = [threading.Thread(target=drive, args=(i,))
                   for i in range(n)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            secs = time.monotonic() - t0
            rows = [None] * len(reqs)
            for i in range(n):
                for j, r in zip(parts[i], got[i][0]):
                    rows[j] = r
        cs.replies(np, rows, outs, f"fleet_breakdown {name}")
        tokens = cs.mix_tokens(rows, reqs)
        return {"config": name, "tokens_per_s": tokens / secs,
                "seconds": secs, "replicas": busy(b0, replica_books(engines))}
    finally:
        torch.set_num_threads(threads0)
        if ctl is not None:
            ctl.stop()
        for s in servers:
            s.shutdown()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write results here")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fleet_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distkeras_tpu_torch.kernels import build
    from distkeras_tpu_torch.models import zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    build.build()
    lm = cs.make_lm(zoo)
    _, reqs, outs = cs.run_generate(torch, np, lm)
    names = ["single", "router1", "router2", "router2_sweep1s", "direct2",
             "router2_1thread"]
    runs = []
    for name in names + names[::-1]:
        r = run_config(cs, torch, np, lm, name, reqs, outs)
        runs.append(r)
        cs.log(f"{name}: {r['tokens_per_s']:.1f} tokens/s, replicas "
               f"{r['replicas']} on {smi}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    print(json.dumps({"nvidia_smi": smi, "tokens_per_s": {
        n: [round(r["tokens_per_s"], 1) for r in runs if r["config"] == n]
        for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
