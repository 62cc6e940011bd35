"""MNIST end to end on the PyTorch port — the shape of ``examples/mnist.py``:
load -> transformers (MinMax pixel scaling, one-hot labels) -> trainer ->
``ModelPredictor`` -> ``AccuracyEvaluator``. BASELINE config 1
(``SingleTrainer`` on ``mnist_mlp``) and, with ``--digits``, config 6
(``digits_mlp`` on the 1,797 real 8x8 digits shipped in the repository).

Long runs checkpoint and resume: ``--checkpoint-dir`` writes one
checkpoint per epoch, and a second invocation with ``--resume`` continues
from the latest one (``--epochs`` is the total). ``--metrics-path`` appends
JSONL rows (per-epoch validation, the ``train_end`` summary);
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the run.

Usage:
    python examples/mnist_torch.py [--digits] [--device cpu]
        [--epochs 2] [--checkpoint-dir DIR [--resume]]
        [--metrics-path FILE] [--profile-dir DIR]

``--device`` defaults to CUDA; without a GPU pass ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import (  # noqa: E402
    AccuracyEvaluator,
    MinMaxTransformer,
    ModelPredictor,
    OneHotTransformer,
    SingleTrainer,
    loaders,
    zoo,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--digits", action="store_true",
                    help="BASELINE config 6: digits_mlp on the real digits")
    ap.add_argument("--csv", default=None,
                    help="MNIST CSV (label + 784 pixels); synthetic if absent")
    ap.add_argument("--n", type=int, default=16384,
                    help="synthetic MNIST rows if no CSV")
    ap.add_argument("--epochs", type=int, default=None,
                    help="total epochs (default 2; 10 with --digits)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default 64; 32 with --digits)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args(argv)

    # -- data pipeline (reference: examples/mnist.py transformer chain) ------
    if args.digits:
        raw, top, model_fn = loaders.digits(flat=True), 16.0, zoo.digits_mlp
        epochs, batch = args.epochs or 10, args.batch or 32
    else:
        raw, top, model_fn = (loaders.mnist(path=args.csv, n=args.n),
                              255.0, zoo.mnist_mlp)
        epochs, batch = args.epochs or 2, args.batch or 64
    ds = MinMaxTransformer(n_min=0.0, n_max=1.0, o_min=0.0, o_max=top)(raw)
    ds = OneHotTransformer(10, input_col="label", output_col="label_onehot")(ds)
    train, test = ds.split(0.9, seed=7)

    trainer = SingleTrainer(
        model_fn(seed=0, device=args.device), worker_optimizer="adam",
        loss="categorical_crossentropy", learning_rate=1e-3,
        label_col="label_onehot", batch_size=batch, num_epoch=epochs,
        seed=0, device=args.device, validation_data=test,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=args.metrics_path, profile_dir=args.profile_dir,
    )
    t0 = time.perf_counter()
    trained = trainer.train(train, shuffle=True, resume=args.resume)
    secs = time.perf_counter() - t0
    steps = len(trainer.get_history())
    print(f"trained {steps} steps in {secs:.1f} s "
          f"({trainer.history.samples_per_second():.0f} samples/s)")

    # -- inference + evaluation (reference: ModelPredictor -> AccuracyEvaluator)
    pred = ModelPredictor(trained, batch_size=256,
                          device=args.device).predict(test)
    acc = AccuracyEvaluator(label_col="label").evaluate(pred)
    print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
