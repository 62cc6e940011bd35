"""Long-context sequence classification TRAINED with sequence parallelism
on the PyTorch port — the twin of ``examples/long_context.py``.

A transformer classifier trained end to end at a sequence length split
over a sequence group of ranks: each rank holds T/N tokens; with
``--sp-mode ring`` K/V blocks rotate one hop a step with an online
softmax, with ``--sp-mode ulysses`` two all-to-alls re-shard tokens into
head slices. Gradients flow back through the exchanges. The held-out
accuracy is measured with the sharded attention attached again, each
rank feeding its tokens of every test row.

The port runs one process per rank. ``--seq-parallel N`` (default: one
rank a CUDA card, one rank on the CPU) sets the group; N = 1 trains in
this process, N > 1 launches N rank processes on this host through
``job_deployment.Job`` (gloo on the CPU, and gloo ranks sharing the card
on the GPU) and prints rank 0's lines.

Usage:
    python examples/long_context_torch.py [--seq 2048] [--cpu]
    python examples/long_context_torch.py --seq 1024 --cpu --seq-parallel 4

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--sp-mode", choices=["ring", "ulysses"], default="ring",
                    help="how attention crosses the sequence shards: the "
                         "K/V ring, or Ulysses all-to-all head sharding "
                         "(heads divisible by the rank count)")
    ap.add_argument("--seq-parallel", type=int, default=0,
                    help="sequence-parallel ranks (0: one a CUDA card, or "
                         "one on the CPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args()
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None
    import torch

    n = args.seq_parallel or (torch.cuda.device_count()
                              if device is None else 1)
    ranked = multihost.initialize(device=device, timeout=RANK_TIMEOUT)
    if args.seq % n:
        raise SystemExit(
            f"--seq {args.seq} must be divisible by the rank count {n}"
        )
    if args.sp_mode == "ulysses" and args.heads % n:
        raise SystemExit(
            f"--sp-mode ulysses shards heads: --heads {args.heads} must be "
            f"divisible by the rank count {n}"
        )
    if n > 1 and not ranked:
        return run_local_ranks(__file__, n, sys.argv[1:],
                               label="seq-parallel", device=device)

    from distkeras_tpu_torch import SequenceParallelTrainer
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.data.transformers import OneHotTransformer
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.parallel.mesh import (
        attach_seq_group,
        detach_seq_group,
        make_grid,
    )
    from distkeras_tpu_torch.parallel.ring_attention import (
        attach_ring_attention,
        detach_ring_attention,
        shard_sequence,
    )
    from distkeras_tpu_torch.predictors import ModelPredictor

    kind = "gpu" if device is None else "cpu"
    print(f"devices: {n} x {kind}; seq {args.seq} -> {args.seq // n} "
          f"tokens/device")

    # TRAIN at the full --seq length with the token axis split over the
    # ranks: every gradient step back-propagates through the exchanges
    ds = loaders.synthetic_sequences(
        n=args.rows, seq_len=args.seq, vocab=args.vocab, seed=0
    )
    ds = OneHotTransformer(2, output_col="label_onehot").transform(ds)
    train, test = ds.split(0.85, seed=0)
    model = zoo.transformer_classifier(
        vocab_size=args.vocab, seq_len=args.seq, d_model=args.d_model,
        num_heads=args.heads, depth=args.depth, device=device,
    )
    trainer = SequenceParallelTrainer(
        model, "adam", "categorical_crossentropy",
        batch_size=args.batch, num_epoch=args.epochs,
        label_col="label_onehot", sp_mode=args.sp_mode, num_workers=n,
        device=device,
    )
    t0 = time.perf_counter()
    trained = trainer.train(train, shuffle=True)
    train_s = time.perf_counter() - t0
    hist = trainer.get_history()
    # batches drop the sub-batch remainder; count rows actually consumed
    rows_per_epoch = (len(train) // args.batch) * args.batch
    tokens_per_sec = rows_per_epoch * args.seq * args.epochs / train_s
    print(f"sequence-parallel training at {args.seq} tokens over "
          f"{trainer.num_workers} devices: {train_s:.1f}s "
          f"({tokens_per_sec:,.0f} tokens/s), "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # evaluate long-context: re-attach the sharded attention (training
    # detaches its hook; the returned model is dense) and feed each rank
    # its tokens of every test row
    grid = make_grid(1, n, "seq", device=device, data_axis=False)
    if args.sp_mode == "ulysses":
        from distkeras_tpu_torch.parallel.ulysses import (
            attach_ulysses_attention,
        )

        attached = attach_ulysses_attention(trained, grid)
    else:
        attached = attach_ring_attention(trained, grid)
    attach_seq_group(trained, grid.inner)
    local = Dataset({"features": shard_sequence(test["features"], grid),
                     "label": test["label"]})
    acc = AccuracyEvaluator(label_col="label").evaluate(
        ModelPredictor(trained, batch_size=max(args.batch, 8),
                       device=device).predict(local)
    )
    detach_seq_group(trained)
    detach_ring_attention(trained)
    grid.release()
    print(f"long-context ({args.seq} tokens, {args.sp_mode} attention on "
          f"{attached} blocks) test accuracy: {acc:.4f}")
    if ranked:
        multihost.shutdown()


if __name__ == "__main__":
    main()
