"""REAL-data end to end on the PyTorch port — the twin of
``examples/real_digits.py``: the reference's mnist.py pipeline shape on
the 1,797 real 8x8 handwritten digits shipped in the repository
(``distkeras_tpu_torch/data/digits.csv``).

load CSV (native C++ parser) -> transformers (MinMax pixel scaling,
one-hot labels) -> trainer -> predictor -> evaluator. Every accuracy
printed here is measured against real-world data.

Modes: ``single`` (``SingleTrainer``), ``downpour`` (``DOWNPOUR``, one
thread per worker on the one device) and ``sync``
(``SynchronousDistributedTrainer``). The port runs one process per rank:
``sync --workers 1`` trains one rank in this process; ``--workers N > 1``
launches N rank processes on this host through ``job_deployment.Job``
(gloo on the CPU, and gloo ranks sharing the card on the GPU, where NCCL
refuses two ranks on one device) and prints rank 0's lines.

Usage:
    python examples/real_digits_torch.py [single|downpour|sync] [--cpu]
        [--workers 4] [--int8]

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    DOWNPOUR,
    AccuracyEvaluator,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
    SingleTrainer,
    SynchronousDistributedTrainer,
)
from distkeras_tpu_torch.data.loaders import digits  # noqa: E402
from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.models.zoo import digits_mlp  # noqa: E402
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="single",
                    choices=["single", "downpour", "sync"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate an int8 weight-only serving copy "
                    "(ops.quantization.quantize_model) next to f32")
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

    # load real CSV -> scale 4-bit intensities to [0,1] -> one-hot labels
    raw = digits(flat=True)
    ds = MinMaxTransformer(n_min=0.0, n_max=1.0, o_min=0.0, o_max=16.0)(raw)
    ds = OneHotTransformer(10, input_col="label", output_col="label_onehot")(ds)
    train, test = ds.split(0.85, seed=0)
    print(f"real digits: {len(train)} train rows, {len(test)} test rows")

    if args.mode == "single":
        trainer = SingleTrainer(
            digits_mlp(seed=0, device=device), "adam",
            "categorical_crossentropy", learning_rate=1e-3,
            batch_size=args.batch, num_epoch=args.epochs,
            label_col="label_onehot", seed=0, device=device,
        )
    elif args.mode == "downpour":
        trainer = DOWNPOUR(
            digits_mlp(seed=0, device=device), "sgd",
            loss="categorical_crossentropy", learning_rate=0.08,
            batch_size=args.batch, num_epoch=args.epochs,
            num_workers=args.workers, communication_window=4,
            label_col="label_onehot", mode="threads", seed=0, device=device,
        )
    else:
        if not ranked:
            print("sync: 1 rank in this process", flush=True)
        trainer = SynchronousDistributedTrainer(
            digits_mlp(seed=0, device=device), "sgd",
            "categorical_crossentropy", learning_rate=0.2,
            batch_size=max(args.batch // args.workers, 1),
            num_workers=args.workers, num_epoch=args.epochs,
            label_col="label_onehot", seed=0, device=device,
        )

    t0 = time.perf_counter()
    trained = trainer.train(train, shuffle=True)
    dt = time.perf_counter() - t0

    pred = ModelPredictor(trained, batch_size=256, device=device).predict(test)
    acc = AccuracyEvaluator(label_col="label").evaluate(pred)
    print(f"{args.mode}: {dt:.1f}s, REAL holdout accuracy {acc:.4f}")
    if args.int8:
        from distkeras_tpu_torch.ops.quantization import quantize_model

        q = quantize_model(trained.copy())
        acc_q = AccuracyEvaluator(label_col="label").evaluate(
            ModelPredictor(q, batch_size=256, device=device).predict(test)
        )
        print(f"int8 serving copy: REAL holdout accuracy {acc_q:.4f} "
              f"(drop {acc - acc_q:+.4f})")
    if ranked:
        multihost.shutdown()


if __name__ == "__main__":
    main()
