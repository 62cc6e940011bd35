#!/usr/bin/env python
"""Chaos soak for the PyTorch port's training tier: kill the primary
parameter server mid-run under armed fault seams and prove the failover
contract (the port's twin of ``tools/soak_training.py``).

The phases, seams, budgets and bars are the JAX tool's; the port's
package runs them. The training phase's DOWNPOUR runs ``"pallas_sgd"``,
the port's B1 kernel (the same arithmetic as ``"sgd"``, which is plain
PyTorch in the port), so on the card every worker window launches it.
It runs on the card unless ``--cpu`` is given (``device="cpu"`` in the
Python API); without a card it exits non-zero. The full-scale training
phase's accuracy floor assumes each of its 4 workers on a device of its
own (the JAX tool forces 8 virtual CPU devices for it, "on ONE device ...
accuracy collapses for scheduling reasons"). The port has one device per
card, or the CPU: there the workers' windows run in lockstep, every
commit three windows stale, and the floor is missed in either package.

Two phases, each with its own acceptance bar (printed as JSON):

1. **Ledger phase** — N worker threads drive known, order-independent
   deltas (each commit adds exactly 1.0) through failover-aware clients
   while ``ps.pull`` / ``ps.commit`` / ``ps.replicate`` / ``net.*``
   seams fire and the primary is killed halfway. Asserts ZERO hung
   workers (every thread exits within its join budget) and EXACTLY-ONCE
   commit application: the promoted standby's center equals
   ``init + workers * windows`` to the bit, and its dedup table carries
   every worker's full sequence — resends across the failover were
   absorbed, none were lost. The PROMOTION — the kill's terminal
   event — must dump a post-mortem bundle whose flight-recorder
   timeline shows the standby's commit-stream position and NAMES the
   injected seams (``fault.fired`` events at the armed ``ps.*``
   sites) — asserted, not eyeballed.

2. **Training phase** — two identical DOWNPOUR runs (remote PS + warm
   standby, thread mode, seeded data/model), one unfaulted, one with
   the primary killed mid-run under the same armed seams. Asserts the
   faulted run finishes, its applied-commit ledger MATCHES the
   unfaulted run's (same ``num_updates``, same per-worker final seqs —
   the exactly-once proof on real training traffic), and its final
   accuracy clears the existing threads-mode convergence floor without
   landing materially below the unfaulted run's.

The fault mix is seeded (``FaultPlan`` draws probabilistic seams from
its own RNG) and every retry policy sleeps <= 0.2 s, so a failing soak
replays tightly::

    python tools/soak_training_torch.py --workers 4 --windows 40 --seed 0
    python tools/soak_training_torch.py --smoke --cpu   # tier-1 scale
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sibling twins, also when this file runs through runpy
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import check_device  # noqa: E402


def _make_plan(seed, fault_scale=1.0):
    """The armed seam mix. ``fault_scale`` scales every probability (the
    training phase runs a lighter mix so the client retry budgets — 8
    attempts per op — stay comfortably unspent)."""
    from distkeras_tpu_torch.faults import FaultPlan

    s = float(fault_scale)
    return (
        FaultPlan(seed=seed)
        .arm("ps.pull", times=None, probability=0.05 * s)
        .arm("ps.commit", times=None, probability=0.05 * s)
        .arm("ps.replicate", times=None, probability=0.02 * s)
        .arm("net.send", action="reset", times=None, probability=0.01 * s)
        .arm("net.send", action="truncate", times=None, probability=0.01 * s)
    )


def run_ledger_phase(workers=4, windows=40, seed=0, join_budget=60.0) -> dict:
    """Synthetic exactly-once proof: every commit adds 1.0, so the final
    center is order-independent and the soak can assert it to the bit."""
    import numpy as np

    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.parameter_servers import (
        DeltaParameterServer,
        RemoteParameterServerClient,
        SocketParameterServer,
    )

    def params(v=0.0):
        return {"w": np.full((4,), v, np.float32)}

    import tempfile

    pm_dir = tempfile.mkdtemp(prefix="soak_training_pm_")
    primary_ps = DeltaParameterServer(params(0.0))
    # durability gate on: no commit is acked without a live replica, so a
    # kill landing inside a replication-outage window cannot lose acked
    # work (the exactly-once bar below is bit-exact BECAUSE of this)
    primary_ps.require_replicas(1)
    primary = SocketParameterServer(primary_ps, host="127.0.0.1")
    primary.start()
    standby_ps = DeltaParameterServer(params(0.0))
    standby_ps.require_replicas(1)
    standby = SocketParameterServer(
        standby_ps, host="127.0.0.1",
        standby_of=("127.0.0.1", primary.port),
        postmortem_dir=pm_dir,
    )
    standby.start()
    endpoints = [("127.0.0.1", primary.port), ("127.0.0.1", standby.port)]

    total = workers * windows
    committed = [0]
    committed_lock = threading.Lock()
    kill_at = total // 2
    kill_gate = threading.Event()
    errors = []

    def worker_loop(wid):
        client = RemoteParameterServerClient(
            endpoints=endpoints,
            # 60 attempts (~6 s of jittered sleep, still inside the
            # wall-clock budget): the window a worker must outlast is
            # the standby's PROMOTION — unreachable-primary detection
            # alone costs a ~2 s dial timeout, and on a suite-loaded
            # machine the old 20-attempt (~2 s) headroom expired
            # mid-promotion, surfacing StandbyError refusals as soak
            # findings (observed in repeated full-tier-1 runs; the
            # r15 overloaded-burst budget raise is the precedent)
            retry=RetryPolicy(max_attempts=60, base_delay=0.02,
                              max_delay=0.2, budget=join_budget,
                              seed=seed * 1000 + wid),
        )
        try:
            for seq in range(windows):
                if seq % 5 == 0:
                    center, _ = client.pull(worker_id=wid)
                    assert float(center["w"][0]) <= total + 1e-3
                client.commit(params(1.0), commit_id=(wid, seq))
                with committed_lock:
                    committed[0] += 1
                    if committed[0] >= kill_at:
                        kill_gate.set()
        except Exception as e:  # noqa: BLE001 — the finding
            errors.append(f"worker {wid}: {e!r}")
        finally:
            client.close()

    plan = _make_plan(seed)
    threads = [
        threading.Thread(target=worker_loop, args=(i,), daemon=True)
        for i in range(workers)
    ]
    with plan:
        for t in threads:
            t.start()
        kill_gate.wait(timeout=join_budget)
        primary.kill()  # no drain, no goodbye — mid-epoch process death
        for t in threads:
            t.join(timeout=join_budget)
    hung = sum(t.is_alive() for t in threads)

    final = standby_ps.get_params()["w"]
    seen = dict(standby_ps._seen_seq)
    summary = {
        "workers": workers,
        "windows": windows,
        "hung": hung,
        "errors": errors,
        "promoted": standby.promoted,
        "promote_reason": standby.promote_reason,
        "reattaches": standby.reattaches,
        "replication_drops": primary_ps.replication_drops,
        "duplicates_absorbed": standby_ps.num_duplicates,
        "applied_updates": standby_ps.num_updates,
        "expected_updates": total,
        "final_center": float(final[0]),
        "expected_center": float(total),
        "exactly_once": bool(
            (final == float(total)).all()
            and standby_ps.num_updates == total
            and all(seen.get(w) == windows - 1 for w in range(workers))
        ),
        "faults_fired": plan.fired(),
        "fired_by_site": {
            s: plan.fired(s)
            for s in ("ps.pull", "ps.commit", "ps.replicate", "net.send")
        },
    }
    # the post-mortem bar: the promotion (the kill's terminal event)
    # dumped exactly one bundle; its recorder timeline carries the
    # commit-stream position and names the injected ps.* seams
    import glob as _glob
    import shutil

    bundles = sorted(_glob.glob(os.path.join(pm_dir, "postmortem_*.json")))
    pm_ok = False
    if len(bundles) == 1:
        with open(bundles[0]) as f:
            bundle = json.load(f)
        kinds = {e["kind"] for e in bundle["events"]}
        fired_sites = {
            e.get("site")
            for e in bundle["events"]
            if e["kind"] == "fault.fired"
        }
        pm_ok = (
            bundle["reason"] == "promotion"
            and "ps.promoted" in kinds
            and "ps.commit" in kinds  # the stream position is on tape
            and bool(
                fired_sites
                & {"ps.pull", "ps.commit", "ps.replicate", "net.send"}
            )
        )
        summary["postmortem"] = {
            "reason": bundle["reason"],
            "event_kinds": sorted(kinds),
            "fired_sites": sorted(s for s in fired_sites if s),
        }
    summary["postmortems"] = len(bundles)
    summary["postmortem_names_seam"] = pm_ok
    shutil.rmtree(pm_dir, ignore_errors=True)
    standby.stop()
    summary["ok"] = (
        hung == 0 and not errors and summary["promoted"]
        and summary["exactly_once"] and pm_ok
    )
    return summary


def _make_training_data(n, seed=0):
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    ds = loaders.synthetic_mnist(n=n, seed=seed)
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = OneHotTransformer(10, output_col="label_onehot").transform(ds)
    return ds.split(0.85, seed=seed)


def _accuracy_of(model, test, device=None):
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.predictors import ModelPredictor

    pred = ModelPredictor(model, batch_size=256, device=device).predict(test)
    return AccuracyEvaluator(label_col="label").evaluate(pred)


def _train_once(train, seed, hidden, num_epoch, workers, window=4,
                kill_at=None, fault_seed=None, join_budget=180.0,
                device=None):
    """One DOWNPOUR run with remote PS + warm standby. ``kill_at``: kill
    the primary once the primary PS has applied that many commits (None =
    unfaulted). Runs train() on a watched thread so a wedged failover
    surfaces as a counted hang, never a hung soak."""
    from distkeras_tpu_torch import DOWNPOUR
    from distkeras_tpu_torch.models import zoo

    t = DOWNPOUR(
        zoo.mnist_mlp(hidden=hidden, device=device), "pallas_sgd",
        loss="categorical_crossentropy",
        learning_rate=0.02,
        batch_size=32,
        num_epoch=num_epoch,
        num_workers=workers,
        communication_window=window,
        label_col="label_onehot",
        mode="threads",
        remote_ps=True,
        standby=True,
        worker_retries=2,
        seed=seed,
        device=device,
    )
    result = {}

    def run():
        try:
            result["model"] = t.train(train)
        except Exception as e:  # noqa: BLE001 — the finding
            result["error"] = repr(e)

    plan = _make_plan(fault_seed, fault_scale=0.4) if fault_seed is not None else None
    killer = None
    if kill_at is not None:
        def kill_when_ready():
            deadline = time.monotonic() + join_budget
            while time.monotonic() < deadline:
                svc = t.service
                if (
                    svc is not None
                    and not svc.killed
                    and t.parameter_server.num_updates >= kill_at
                ):
                    svc.kill()
                    return
                if result:
                    return  # run already over
                time.sleep(0.02)

        killer = threading.Thread(target=kill_when_ready, daemon=True)

    runner = threading.Thread(target=run, daemon=True)
    ctx = plan if plan is not None else _NullCtx()
    with ctx:
        runner.start()
        if killer is not None:
            killer.start()
        runner.join(timeout=join_budget)
    hung = runner.is_alive()

    ps = t.active_parameter_server()
    return {
        "trainer": t,
        "model": result.get("model"),
        "error": result.get("error"),
        "hung": hung,
        "applied_updates": ps.num_updates,
        "duplicates_absorbed": ps.num_duplicates,
        "seen_seq": {str(k): int(v) for k, v in ps._seen_seq.items()},
        "promotions": list(t.ps_promotions),
        "failovers": t.ps_failovers,
        "worker_failures": list(t.failures),
        "faults_fired": plan.fired() if plan is not None else 0,
    }


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def run_training_phase(seed=0, smoke=False, acc_tol=0.15,
                       acc_floor=0.8, device=None) -> dict:
    """Real DOWNPOUR traffic: unfaulted run vs primary-killed run. The
    commit LEDGERS must match exactly (same applied updates, same
    per-worker final seqs); the faulted run must clear the existing
    threads-mode convergence floor (0.8) and must not land materially
    below the unfaulted run. At
    smoke scale the data is too small for a meaningful accuracy floor,
    so only the ledger/hang/completion bar is asserted there (full runs
    assert the convergence band too).

    Full-scale config mirrors ``test_threads_mode_converges`` (n=1024,
    3 epochs, window 4, 0.8 bar there). The JAX tool also sets its
    core-cache kill-switch there (``DKT_DISABLE_CORE_CACHE``, shared
    compiled programs); the port compiles no programs, so it has no
    such switch."""
    n = 384 if smoke else 1024
    hidden = 16 if smoke else 32
    num_epoch = 2 if smoke else 3
    workers = 2 if smoke else 4
    # smoke shrinks the commit window so even the tiny partitions produce
    # a dozen commits — enough traffic for the kill to land mid-stream
    window = 2 if smoke else 4
    train, test = _make_training_data(n, seed=seed)

    clean = _train_once(train, seed, hidden, num_epoch, workers, window,
                        device=device)
    if clean["error"] or clean["hung"]:
        return {"ok": False, "clean": _strip(clean), "faulted": None}
    expected_updates = clean["applied_updates"]

    faulted = _train_once(
        train, seed, hidden, num_epoch, workers, window,
        kill_at=max(1, expected_updates // 2), fault_seed=seed,
        device=device,
    )

    acc_clean = _accuracy_of(clean["model"], test, device)
    acc_faulted = (
        _accuracy_of(faulted["model"], test, device)
        if faulted["model"] is not None
        else None
    )
    ledger_match = (
        faulted["applied_updates"] == expected_updates
        and faulted["seen_seq"] == clean["seen_seq"]
    )
    summary = {
        "smoke": smoke,
        "expected_updates": expected_updates,
        "clean": _strip(clean),
        "faulted": _strip(faulted),
        "accuracy_clean": float(acc_clean),
        "accuracy_faulted": (
            None if acc_faulted is None else float(acc_faulted)
        ),
        "ledger_match": bool(ledger_match),
    }
    ok = (
        not faulted["hung"]
        and faulted["error"] is None
        and faulted["model"] is not None
        and len(faulted["promotions"]) >= 1
        and ledger_match
    )
    if not smoke and ok:
        # the existing convergence-test tolerance is a FLOOR (threads-mode
        # bar 0.8), and that is what the faulted run must clear; the
        # parity check is one-sided — the faulted run must not land
        # materially BELOW the unfaulted one (beating it is thread-
        # scheduling luck, not a failure: run-to-run variance between two
        # identical UNFAULTED runs on a one-core host is itself ~0.1-0.2)
        ok = (
            acc_faulted is not None
            and acc_faulted >= acc_floor
            and acc_faulted >= acc_clean - acc_tol
        )
    summary["ok"] = bool(ok)
    return summary


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("trainer", "model")}


def run_soak(workers=4, windows=40, seed=0, smoke=False,
             device=None) -> dict:
    """Both phases; ``device`` is where the training phase trains
    (``None`` = the card, ``"cpu"``). The ledger phase is host numpy."""
    if smoke:
        workers, windows = 3, 12
    ledger = run_ledger_phase(workers=workers, windows=windows, seed=seed)
    training = run_training_phase(seed=seed, smoke=smoke, device=device)
    return {
        "phases": {"ledger": ledger, "training": training},
        "ok": bool(ledger["ok"] and training["ok"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--windows", type=int, default=40,
                    help="synthetic commits per worker in the ledger phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 scale: tiny shapes, ledger + completion "
                         "bar only (no accuracy floor)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args(argv)
    device = check_device(args.cpu)

    summary = run_soak(
        workers=args.workers, windows=args.windows, seed=args.seed,
        smoke=args.smoke, device=device,
    )
    json.dump(summary, sys.stdout, indent=2, default=str)
    print()
    if not summary["ok"]:
        print("SOAK FAILED: hung workers, lost/duplicated commits, or "
              "convergence divergence (see summary above)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
