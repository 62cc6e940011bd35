"""Per-optimizer accuracy-vs-time comparison on the PyTorch port — the twin
of ``examples/optimizer_comparison.py``: train the same model on the same
data under every distributed optimization scheme and compare wall-clock
time against reached accuracy.

Trainers covered: SingleTrainer (baseline), SynchronousDistributedTrainer
(all-reduce over a data group), DOWNPOUR, AEASGD, EAMSGD, ADAG, DynSGD
(the asynchronous parameter-server zoo, one thread per worker on the one
device). The port runs one process per rank: with ``--workers N > 1``
the SyncDP scheme runs as N rank processes on this host through
``job_deployment.Job`` (gloo on the CPU, and gloo ranks sharing the card
on the GPU); its seconds are the ranks' training time.

Writes ``optimizer_comparison.json`` (full curves) and ``.md`` (summary
table) under ``--out`` (default ``examples/experiments_torch``, beside and
never over the JAX package's committed ``examples/experiments``). Usage:

    python examples/optimizer_comparison_torch.py [--n 8192] [--rounds 5]
        [--workers 4] [--digits] [--cpu]

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    ADAG,
    AEASGD,
    DOWNPOUR,
    AccuracyEvaluator,
    DynSGD,
    EAMSGD,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
    SingleTrainer,
    SynchronousDistributedTrainer,
)
from distkeras_tpu_torch.data.loaders import digits, mnist  # noqa: E402
from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.models.zoo import digits_mlp, mnist_mlp  # noqa: E402
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def accuracy_of(model, test, device):
    pred = ModelPredictor(model, batch_size=256, device=device).predict(test)
    return AccuracyEvaluator(label_col="label").evaluate(pred)


def run_scheme(name, make_trainer, model_fn, train, test, rounds, target,
               device):
    """Train round by round (1 epoch per round), recording the cumulative
    wall-clock and test accuracy after each — the accuracy-vs-time curve."""
    model = model_fn(0)
    curve = []
    elapsed = 0.0
    samples = 0
    for r in range(rounds):
        trainer = make_trainer(model)
        t0 = time.perf_counter()
        model = trainer.train(train, shuffle=True)
        elapsed += time.perf_counter() - t0
        samples += len(train)
        acc = accuracy_of(model, test, device)
        curve.append({"round": r + 1, "seconds": round(elapsed, 2),
                      "accuracy": acc})
        print(f"  {name}: round {r + 1}  t={elapsed:.1f}s  acc={acc:.4f}",
              flush=True)
        if acc >= target:
            break
    time_to_target = next(
        (c["seconds"] for c in curve if c["accuracy"] >= target), None
    )
    return {
        "optimizer": name,
        "curve": curve,
        "final_accuracy": curve[-1]["accuracy"],
        "seconds_total": curve[-1]["seconds"],
        "time_to_target": time_to_target,
        "samples_per_sec": round(samples / elapsed, 1),
    }


def sync_ranks(n, device, out_path):
    """The SyncDP scheme as n rank processes over gloo: rank 0 writes its
    result to ``out_path``; prints rank 0's lines and returns the result."""
    run_local_ranks(__file__, n, [*sys.argv[1:], "--scheme-out", out_path],
                    path_flags=("--csv",), label="  SyncDP", device=device)
    with open(out_path) as f:
        return json.load(f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--csv", default=None)
    ap.add_argument(
        "--digits",
        action="store_true",
        help="run on the REAL in-repo handwritten-digit set instead of the "
        "synthetic MNIST stand-in (writes *_digits artifact files)",
    )
    ap.add_argument("--out", default=os.path.join("examples",
                                                  "experiments_torch"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    # a SyncDP rank process: rank 0 writes the scheme's result here
    ap.add_argument("--scheme-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None
    ranked = args.scheme_out is not None and multihost.initialize(
        device=device, timeout=RANK_TIMEOUT)

    if args.digits:
        raw = digits(flat=True)
        ds = MinMaxTransformer(n_min=0.0, n_max=1.0, o_min=0.0,
                               o_max=16.0)(raw)

        def model_fn(seed):
            return digits_mlp(hidden=64, seed=seed, device=device)

        task = "REAL digits (in-repo CSV, 1797 rows)"
        suffix = "_digits"
    else:
        raw = mnist(path=args.csv, n=args.n, flat=True)
        ds = MinMaxTransformer(n_min=0.0, n_max=1.0, o_min=0.0,
                               o_max=255.0)(raw)

        def model_fn(seed):
            return mnist_mlp(hidden=64, seed=seed, device=device)

        task = "MNIST MLP (hidden 64)"
        suffix = ""
    ds = OneHotTransformer(10, input_col="label", output_col="label_onehot")(ds)
    train, test = ds.split(0.9, seed=7)

    common = dict(
        loss="categorical_crossentropy",
        label_col="label_onehot",
        batch_size=32,
        num_epoch=1,
        seed=0,
        device=device,
    )
    dist = dict(
        common, num_workers=args.workers, communication_window=4,
        mode="threads"
    )

    # the sgd lrs were calibrated on the synthetic MNIST stand-in; the real
    # 8x8 digits task trains cleanly at ~4x those rates
    s = 4.0 if args.digits else 1.0
    schemes = [
        ("SingleTrainer", lambda m: SingleTrainer(
            m, "sgd", learning_rate=0.05 * s, **common)),
        ("SyncDP", lambda m: SynchronousDistributedTrainer(
            m, "sgd", learning_rate=0.05 * s, num_workers=args.workers,
            **common)),
        ("DOWNPOUR", lambda m: DOWNPOUR(
            m, "sgd", learning_rate=0.02 * s, **dist)),
        ("AEASGD", lambda m: AEASGD(
            m, "sgd", learning_rate=0.02 * s, rho=10.0, **dist)),
        ("EAMSGD", lambda m: EAMSGD(
            m, "sgd", learning_rate=0.02 * s, rho=10.0, momentum=0.3,
            **dist)),
        ("ADAG", lambda m: ADAG(
            m, "sgd", learning_rate=0.05 * s, **dist)),
        ("DynSGD", lambda m: DynSGD(
            m, "sgd", learning_rate=0.02 * s, **dist)),
    ]
    if ranked:
        make = dict(schemes)["SyncDP"]
        result = run_scheme("SyncDP", make, model_fn, train, test,
                            args.rounds, args.target, device)
        if multihost.process_id() == 0:
            with open(args.scheme_out, "w") as f:
                json.dump(result, f)
        multihost.shutdown()
        return

    import torch

    kind = torch.cuda.get_device_name(0) if device is None else "cpu"
    print(f"platform: {platform}, train={len(train)}, test={len(test)}")
    os.makedirs(args.out, exist_ok=True)
    results = []
    for name, make in schemes:
        print(f"== {name}", flush=True)
        if name == "SyncDP" and args.workers > 1:
            results.append(sync_ranks(
                args.workers, device,
                os.path.abspath(os.path.join(args.out, ".syncdp.json"))))
            os.unlink(os.path.join(args.out, ".syncdp.json"))
            continue
        results.append(run_scheme(name, make, model_fn, train, test,
                                  args.rounds, args.target, device))

    payload = {
        "platform": platform,
        "device_kind": kind,
        "task": task,
        "n_train": len(train),
        "workers": args.workers,
        "target_accuracy": args.target,
        "results": results,
    }
    out_json = os.path.join(args.out, f"optimizer_comparison{suffix}.json")
    with open(out_json, "w") as f:
        json.dump(payload, f, indent=2)

    lines = [
        "# Optimizer comparison — accuracy vs time (PyTorch port)",
        "",
        f"{task}, {len(train)} train rows, "
        f"{args.workers} workers, platform `{platform}` ({kind}). One epoch "
        f"per round; target accuracy {args.target}. Reproduce: "
        f"`python examples/optimizer_comparison_torch.py"
        f"{' --digits' if suffix else ''}`.",
        "",
        "| optimizer | time to target (s) | final acc | total time (s) "
        "| samples/sec |",
        "|---|---|---|---|---|",
    ]
    for r in results:
        ttt = f"{r['time_to_target']:.1f}" if r["time_to_target"] else "—"
        lines.append(
            f"| {r['optimizer']} | {ttt} | {r['final_accuracy']:.4f} "
            f"| {r['seconds_total']:.1f} | {r['samples_per_sec']:.0f} |"
        )
    with open(os.path.join(args.out, f"optimizer_comparison{suffix}.md"),
              "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}/optimizer_comparison{suffix}.{{json,md}}")


if __name__ == "__main__":
    main()
