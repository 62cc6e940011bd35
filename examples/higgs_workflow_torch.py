"""ATLAS-Higgs tabular workflow on the PyTorch port — the twin of
``examples/higgs_workflow.py``: AEASGD (elastic averaging; BASELINE
config 3), one thread per worker on the one device.

load CSV of physics features (or the synthetic stand-in) -> standard-scale
-> one-hot -> AEASGD trainer -> predictor -> evaluator.

Usage:
    python examples/higgs_workflow_torch.py [--csv FILE] [--epochs 3]
        [--workers 4] [--rho 5.0] [--n 32768] [--cpu]

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    AEASGD,
    AccuracyEvaluator,
    LabelIndexTransformer,
    ModelPredictor,
    OneHotTransformer,
    StandardScaleTransformer,
)
from distkeras_tpu_torch.data.loaders import load_csv, synthetic_higgs  # noqa: E402
from distkeras_tpu_torch.models.zoo import higgs_mlp  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=None, help="Higgs CSV (label + features)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rho", type=float, default=5.0)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args()
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None

    raw = load_csv(args.csv) if args.csv else synthetic_higgs(n=args.n)
    num_features = raw["features"].shape[1]
    ds = StandardScaleTransformer()(raw)
    ds = OneHotTransformer(2, input_col="label", output_col="label_onehot")(ds)
    train, test = ds.split(0.85, seed=7)

    model = higgs_mlp(num_features=num_features, seed=0, device=device)
    trainer = AEASGD(
        model, worker_optimizer="sgd", loss="categorical_crossentropy",
        learning_rate=0.05, label_col="label_onehot", batch_size=args.batch,
        num_epoch=args.epochs, num_workers=args.workers, rho=args.rho,
        communication_window=8, device=device,
    )
    t0 = time.time()
    trained = trainer.train(train, shuffle=True)
    print(f"trained in {time.time() - t0:.1f}s; "
          f"PS updates: {trainer.parameter_server.num_updates}")

    pred = ModelPredictor(trained, device=device).predict(test)
    pred = LabelIndexTransformer(2)(pred)
    acc = AccuracyEvaluator(
        prediction_col="prediction_index", label_col="label"
    ).evaluate(pred)
    print(f"test accuracy: {acc:.4f}")


if __name__ == "__main__":
    main()
