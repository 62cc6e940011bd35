"""REAL-data regression end to end on the PyTorch port — the twin of
``examples/diabetes_regression.py``: the regression face of the
reference's arbitrary-model support.

load the in-repo 442-row diabetes CSV (native C++ parser, float target)
-> standardize features AND target on train statistics only (leak-free)
-> trainer (``loss="mse"``) -> predictor -> R² evaluator. R² is
scale-invariant, so standardizing the target changes nothing about the
reported number.

Modes: ``single`` (``SingleTrainer``) and ``sync``
(``SynchronousDistributedTrainer``). The port runs one process per rank:
``sync --workers 1`` trains one rank in this process; ``--workers N > 1``
launches N rank processes on this host through ``job_deployment.Job``
(gloo on the CPU, and gloo ranks sharing the card on the GPU, where NCCL
refuses two ranks on one device) and prints rank 0's lines.

Usage:
    python examples/diabetes_regression_torch.py [single|sync] [--cpu]
        [--workers 4]

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    ModelPredictor,
    RSquaredEvaluator,
    SingleTrainer,
    StandardScaleTransformer,
    SynchronousDistributedTrainer,
)
from distkeras_tpu_torch.data.loaders import diabetes  # noqa: E402
from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.models.zoo import tabular_regressor  # noqa: E402
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="single",
                    choices=["single", "sync"])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args()
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None
    ranked = args.mode == "sync" and multihost.initialize(
        device=device, timeout=RANK_TIMEOUT)
    if args.mode == "sync" and args.workers > 1 and not ranked:
        return run_local_ranks(__file__, args.workers, sys.argv[1:],
                               device=device)

    train, test = diabetes().split(0.85, seed=7)
    print(f"real diabetes: {len(train)} train rows, {len(test)} test rows")
    feats = StandardScaleTransformer().fit(train)
    target = StandardScaleTransformer(input_col="label").fit(train)
    train, test = (target.transform(feats.transform(d))
                   for d in (train, test))

    if args.mode == "single":
        trainer = SingleTrainer(
            tabular_regressor(seed=0, device=device), "adam", "mse",
            learning_rate=1e-3, batch_size=args.batch,
            num_epoch=args.epochs, seed=0, device=device,
        )
    else:
        if not ranked:
            print("sync: 1 rank in this process", flush=True)
        trainer = SynchronousDistributedTrainer(
            tabular_regressor(seed=0, device=device), "adam", "mse",
            learning_rate=1e-3,
            batch_size=max(args.batch // args.workers, 1),
            num_workers=args.workers, num_epoch=args.epochs, seed=0,
            device=device,
        )

    t0 = time.perf_counter()
    trained = trainer.train(train, shuffle=True)
    dt = time.perf_counter() - t0

    pred = ModelPredictor(trained, batch_size=256, device=device).predict(test)
    r2 = RSquaredEvaluator().evaluate(pred)
    print(f"{args.mode}: {dt:.1f}s, REAL holdout R^2 {r2:.4f} "
          "(predict-the-mean baseline scores 0.0)")
    if ranked:
        multihost.shutdown()


if __name__ == "__main__":
    main()
