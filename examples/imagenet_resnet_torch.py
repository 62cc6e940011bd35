"""ResNet-18 / ImageNet-scale on the PyTorch port — DynSGD staleness-aware
async SGD over a file-sharded streaming dataset (BASELINE config 5; the
counterpart of ``examples/imagenet_resnet.py``; 32 workers at full scale,
here all workers share the one card).

With no ImageNet on disk, the script WRITES synthetic ImageNet-shaped data
to ``.npz`` shards chunk by chunk (uint8, never holding the full dataset in
one array) and trains from ``StreamingDataset``: one shard resident per
worker at a time, preprocessing applied per chunk via ``.map``. This is the
input-pipeline shape that feeds real ImageNet: swap the synthetic writer
for shards of decoded images. The shards are byte-compatible with the JAX
package's, so ``--shard-dir`` takes a tree either package wrote.

Usage:
    python examples/imagenet_resnet_torch.py [--device cpu] [--n 2048]
        [--size 64] [--classes 100] [--workers 4] [--epochs 1]
        [--optimizer pallas_adam] [--mode threads|simulated]
        [--shard-dir DIR] [--width 1.0]

``--device`` defaults to CUDA; without a GPU pass ``--device cpu`` (and a
small ``--size``/``--width`` to keep it quick).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from distkeras_tpu_torch import (  # noqa: E402
    AccuracyEvaluator,
    Dataset,
    DynSGD,
    LabelIndexTransformer,
    ModelPredictor,
    OneHotTransformer,
    ShardWriter,
    open_shards,
)
from distkeras_tpu_torch.data.loaders import synthetic_imagenet  # noqa: E402
from distkeras_tpu_torch.models.zoo import resnet18  # noqa: E402

# one label->pattern mapping for every draw of the synthetic task: shards
# and the eval split must agree or the task is unlearnable
PROTO_SEED = 7


def write_synthetic_shards(out_dir, n, num_classes, size, rows_per_shard,
                           seed=PROTO_SEED):
    """Generate shard files chunk by chunk — peak host memory is one chunk,
    so the on-disk dataset can exceed RAM. All shards land in ONE directory
    with one sidecar, so ``open_shards(out_dir)`` round-trips."""
    with ShardWriter(out_dir) as writer:
        written = 0
        chunk_i = 0
        while written < n:
            rows = min(rows_per_shard, n - written)
            chunk = synthetic_imagenet(
                n=rows, num_classes=num_classes, size=size,
                seed=seed + chunk_i, proto_seed=PROTO_SEED,
            )
            # uint8 on disk (as real image shards would be): 4x smaller files
            writer.add({"features": chunk["features"].astype(np.uint8),
                        "label": chunk["label"]})
            written += rows
            chunk_i += 1
    return writer._paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--size", type=int, default=64, help="image side length")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--rows-per-shard", type=int, default=256)
    ap.add_argument("--shard-dir", default=None,
                    help="existing shard tree (skips synthetic generation)")
    ap.add_argument("--optimizer", default="pallas_adam",
                    help="worker optimizer (pallas_adam: the fused kernel)")
    ap.add_argument("--mode", default="threads",
                    help="threads (true async) or simulated (seeded)")
    ap.add_argument("--width", type=float, default=1.0,
                    help="ResNet filter multiplier (1.0: the real model)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    def preprocess(chunk):
        x = chunk["features"].astype(np.float32) / 255.0
        onehot = np.eye(args.classes, dtype=np.float32)[chunk["label"]]
        return {"features": x, "label": chunk["label"], "label_onehot": onehot}

    if args.shard_dir:
        root = args.shard_dir
    else:
        root = tempfile.mkdtemp(prefix="dkt_imagenet_")
        t0 = time.time()
        shard_paths = write_synthetic_shards(
            root, args.n, args.classes, args.size, args.rows_per_shard)
        print(f"wrote {len(shard_paths)} shards under {root} "
              f"in {time.time() - t0:.1f}s (reuse with --shard-dir {root})")
    train = open_shards(root).map(preprocess)

    # held-out eval set stays in memory (it is small)
    test_raw = synthetic_imagenet(
        n=max(args.n // 10, args.batch), num_classes=args.classes,
        size=args.size, seed=99, proto_seed=PROTO_SEED,
    )
    test = Dataset({
        "features": np.asarray(test_raw["features"], np.float32) / 255.0,
        "label": test_raw["label"],
    })
    test = OneHotTransformer(args.classes, input_col="label",
                             output_col="label_onehot")(test)

    model = resnet18(
        num_classes=args.classes, input_shape=(args.size, args.size, 3),
        seed=0, bn_momentum=0.9,  # short demo runs: eval stats must track
        width=args.width, device=args.device,
    )
    # adam lr 1e-3 (benchmarks.py config-5 calibration): a from-scratch
    # ResNet under DynSGD stays at a constant prediction with plain sgd
    trainer = DynSGD(
        model, worker_optimizer=args.optimizer,
        loss="categorical_crossentropy", learning_rate=1e-3,
        label_col="label_onehot", batch_size=args.batch,
        num_epoch=args.epochs, num_workers=args.workers,
        communication_window=4, compute_dtype="bfloat16", mode=args.mode,
        device=args.device,
    )
    t0 = time.time()
    trained = trainer.train(train, shuffle=True)
    print(f"trained in {time.time() - t0:.1f}s; "
          f"PS updates: {trainer.parameter_server.num_updates}; "
          f"{trainer.history.samples_per_second():.0f} samples/s")

    pred = ModelPredictor(trained, batch_size=256,
                          device=args.device).predict(test)
    pred = LabelIndexTransformer(args.classes)(pred)
    acc = AccuracyEvaluator(prediction_col="prediction_index",
                            label_col="label").evaluate(pred)
    print(f"test accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
