"""CIFAR-10 CNN on the PyTorch port — the twin of ``examples/cifar10.py``:
ADAG (Hermans' accumulated gradient normalization; BASELINE config 4),
one thread per worker on the one device, bf16 compute.

Usage:
    python examples/cifar10_torch.py [--epochs 3] [--workers 4]
        [--n 8192] [--cpu]

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    ADAG,
    AccuracyEvaluator,
    LabelIndexTransformer,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
)
from distkeras_tpu_torch.data.loaders import synthetic_cifar10  # noqa: E402
from distkeras_tpu_torch.models.zoo import cifar10_cnn  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args()
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None

    raw = synthetic_cifar10(n=args.n)
    ds = MinMaxTransformer(0.0, 1.0, 0.0, 255.0)(raw)
    ds = OneHotTransformer(10, input_col="label", output_col="label_onehot")(ds)
    train, test = ds.split(0.9, seed=7)

    model = cifar10_cnn(seed=0, bn_momentum=0.9, device=device)
    # sgd lr 0.05 (benchmarks.py config-4 calibration): ADAG's center moves
    # by -lr * mean-grad per commit regardless of the local optimizer
    trainer = ADAG(
        model, worker_optimizer="sgd", learning_rate=0.05,
        loss="categorical_crossentropy",
        label_col="label_onehot", batch_size=args.batch,
        num_epoch=args.epochs, num_workers=args.workers,
        communication_window=5, compute_dtype="bfloat16", device=device,
    )
    t0 = time.time()
    trained = trainer.train(train, shuffle=True)
    print(f"trained in {time.time() - t0:.1f}s; "
          f"PS updates: {trainer.parameter_server.num_updates}")

    pred = ModelPredictor(trained, device=device).predict(test)
    pred = LabelIndexTransformer(10)(pred)
    acc = AccuracyEvaluator(
        prediction_col="prediction_index", label_col="label"
    ).evaluate(pred)
    print(f"test accuracy: {acc:.4f}")


if __name__ == "__main__":
    main()
