"""Probe which ``torch.distributed`` collectives a gloo group takes CUDA
tensors for, between two processes sharing one card.

NCCL refuses two ranks on one device, so the port's multi-rank phases on
one card run gloo groups. Gloo may take a CUDA tensor itself (staging it
through the host), refuse it, or read the device pointer as host memory.
For each exchange the sequence- and tensor-parallel paths use, this script
starts a fresh pair of rank processes (a crash costs only that pair), runs
the exchange once on CUDA tensors of 4 MiB, checks the result against the
values each rank must receive, and times a second call. It prints one line
per exchange and, last, a JSON object ``{"gloo_cuda": {op: {"ok": ...,
"error": ..., "ms": ...}}}``; ``--out FILE`` writes it there too.

    python3 gloo_probe.py [--out FILE]

``parallel.mesh.HOST_STAGED`` records the outcome for the port: the
exchanges gloo does not take CUDA tensors for go through pinned host
buffers, chosen by the group's backend up front.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

OPS = ("all_reduce", "all_gather", "broadcast", "all_to_all_single",
       "batch_isend_irecv")
NUMEL = 1 << 20  # f32: 4 MiB a tensor
TIMEOUT = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(op, rank, port):
    """One rank of one pair: the exchange on CUDA tensors, checked and
    timed. Prints its result as a JSON line."""
    import datetime

    import torch
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    other = 1 - rank
    # rank r's tensor holds r + 1 everywhere, so each result is known
    mine = torch.full((NUMEL,), float(rank + 1), device=dev)

    def run():
        if op == "all_reduce":
            t = mine.clone()
            dist.all_reduce(t)
            return t, torch.full_like(t, 3.0)
        if op == "all_gather":
            outs = [torch.empty_like(mine) for _ in range(2)]
            dist.all_gather(outs, mine)
            return torch.cat(outs), torch.cat([torch.full_like(mine, 1.0),
                                               torch.full_like(mine, 2.0)])
        if op == "broadcast":
            t = mine.clone()
            dist.broadcast(t, 0)
            return t, torch.full_like(t, 1.0)
        if op == "all_to_all_single":
            # row j goes to rank j: rank r sends 10 r + j, receives 10 j + r
            send = torch.stack([torch.full((NUMEL // 2,), 10.0 * rank + j,
                                           device=dev) for j in range(2)])
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send)
            want = torch.stack([torch.full((NUMEL // 2,), 10.0 * j + rank,
                                           device=dev) for j in range(2)])
            return recv, want
        recv = torch.empty_like(mine)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, other),
                                       dist.P2POp(dist.irecv, recv, other)])
        for r in reqs:
            r.wait()
        return recv, torch.full_like(recv, float(other + 1))

    out = {"op": op, "rank": rank, "ok": False, "error": None, "ms": None}
    try:
        got, want = run()
        torch.cuda.synchronize()
        out["ok"] = bool(torch.equal(got, want))
        if out["ok"]:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t0) * 1e3
        else:
            out["error"] = "wrong values received"
    except Exception as e:  # noqa: BLE001 — the probe records the refusal
        out["error"] = f"{type(e).__name__}: {e}"[:300]
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def _pair(op):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--op", op, "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + TIMEOUT
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        texts += ["timed out"] * (2 - len(texts))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, text in zip(procs, texts):
        line = next((ln for ln in text.splitlines()[::-1]
                     if ln.startswith("{")), None)
        if line is None:
            results.append({"ok": False, "ms": None,
                            "error": f"exit {p.returncode}: {text[-300:]}"})
        else:
            results.append(json.loads(line))
    ok = all(r["ok"] for r in results)
    err = next((r["error"] for r in results if r["error"]), None)
    ms = max((r["ms"] for r in results if r["ms"] is not None), default=None)
    return {"ok": ok, "error": err, "ms": ms}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--op", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.op, args.rank, args.port)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"gloo_probe: torch {torch.__version__} cuda {torch.version.cuda}"
          f" on {smi}", flush=True)
    table = {}
    for op in OPS:
        table[op] = _pair(op)
        r = table[op]
        print(f"{op}: {'takes CUDA tensors' if r['ok'] else 'REFUSED'}"
              + (f", {r['ms']:.2f} ms for 4 MiB" if r["ms"] else "")
              + (f" ({r['error']})" if r["error"] else ""), flush=True)
    result = {"gloo_cuda": table, "nvidia_smi": smi}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
