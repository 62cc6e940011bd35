"""MNIST end to end on the PyTorch port — the shape of ``examples/mnist.py``:
load -> transformers (MinMax pixel scaling, one-hot labels) -> trainer ->
``ModelPredictor`` -> ``AccuracyEvaluator``. BASELINE config 1
(``single``: ``SingleTrainer`` on ``mnist_mlp``) and, with ``--digits``,
config 6 (``digits_mlp`` on the 1,797 real 8x8 digits shipped in the
repository); ``downpour`` (BASELINE config 2: ``DOWNPOUR`` on
``mnist_cnn``, one thread per worker on the one device) and ``sync``
(``SynchronousDistributedTrainer`` on ``mnist_cnn``, ``--zero`` for
ZeRO-1). The port runs one process per rank: ``sync --workers 1`` trains
one rank in this process, ``--workers N > 1`` launches N rank processes
on this host through ``job_deployment.Job`` (gloo on the CPU, and gloo
ranks sharing the card on the GPU) and prints rank 0's lines.

Long runs checkpoint and resume: ``--checkpoint-dir`` writes one
checkpoint per epoch, and a second invocation with ``--resume`` continues
from the latest one (``--epochs`` is the total). ``--metrics-path`` appends
JSONL rows (per-epoch validation, the ``train_end`` summary);
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the run.

Usage:
    python examples/mnist_torch.py [single|downpour|sync] [--digits]
        [--device cpu | --cpu] [--epochs 2] [--workers 8] [--zero]
        [--checkpoint-dir DIR [--resume]] [--metrics-path FILE]
        [--profile-dir DIR]

``--device`` defaults to CUDA; without a GPU pass ``--device cpu`` (or
``--cpu``, the JAX script's flag).
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
    ReshapeTransformer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    loaders,
    zoo,
)
from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402

#: flags whose value is a path: made absolute for the rank processes,
#: which run in directories of their own
PATH_FLAGS = ("--csv", "--checkpoint-dir", "--metrics-path", "--profile-dir")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="single",
                    choices=["single", "downpour", "sync"])
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
    ap.add_argument("--workers", type=int, default=8,
                    help="downpour and sync: workers (sync: rank processes)")
    ap.add_argument("--zero", action="store_true",
                    help="sync mode: ZeRO-1 — shard optimizer moments "
                    "over the data group (same trajectory)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (as --device cpu)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint")
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    setup_backend(cpu=args.device == "cpu")
    ranked = args.mode == "sync" and multihost.initialize(
        device=args.device, timeout=RANK_TIMEOUT)
    if args.mode == "sync" and args.workers > 1 and not ranked:
        return run_local_ranks(__file__, args.workers, sys.argv[1:],
                               path_flags=PATH_FLAGS, device=args.device)

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
    common = dict(
        loss="categorical_crossentropy", label_col="label_onehot",
        batch_size=batch, num_epoch=epochs, seed=0, device=args.device,
        checkpoint_dir=args.checkpoint_dir, metrics_path=args.metrics_path,
        profile_dir=args.profile_dir,
    )

    if args.mode == "single":
        trainer = SingleTrainer(
            model_fn(seed=0, device=args.device), worker_optimizer="adam",
            learning_rate=1e-3, validation_data=test, **common,
        )
    else:
        if args.digits:
            model = model_fn(seed=0, device=args.device)
        else:
            # CNN path: flat pixels reshaped to (28, 28, 1)
            reshape = ReshapeTransformer("features", "features", (28, 28, 1))
            train, test = reshape(train), reshape(test)
            model = zoo.mnist_cnn(seed=0, device=args.device)
        if args.mode == "downpour":
            # N workers' window deltas sum at the PS: the local adam lr
            # scales by 1/N (benchmarks.py config-2 calibration)
            trainer = DOWNPOUR(
                model, worker_optimizer="adam",
                learning_rate=1e-3 / args.workers,
                num_workers=args.workers, **common,
            )
        else:
            if not ranked:
                print("sync: 1 rank in this process", flush=True)
            # the sync trainer means the global-batch loss: full lr
            trainer = SynchronousDistributedTrainer(
                model, worker_optimizer="adam", learning_rate=1e-3,
                num_workers=args.workers, shard_opt_state=args.zero,
                **common,
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
    if ranked:
        multihost.shutdown()
    return acc


if __name__ == "__main__":
    main()
