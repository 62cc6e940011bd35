"""Causal language-model training on the PyTorch port — the twin of
``examples/language_model.py``: ``zoo.transformer_lm`` through the normal
trainer surface (next-token loss with shift-by-one targets, per-window
next-token accuracy, optional sequence parallelism over the causal ring)
and a greedy-decode demo at the end.

The toy corpus is a "successor language" (token t+1 = token t + 1 mod V)
so learning is verifiable at a glance: the decode must count upward.

The model runs the port's hand-written kernels: the FlashAttention and
fused LayerNorm hooks are attached once the LM is built, and ``adam`` runs
as ``pallas_adam`` (the fused Adam kernel, numerically ``adam``); on the
CPU every kernel wrapper runs its plain version. ``--seq-parallel N``
trains with ``SequenceParallelTrainer`` (its ring replaces the flash
hook): N = 1 is one rank in this process, N > 1 launches N rank processes
on this host through ``job_deployment.Job`` (gloo on the CPU, and gloo
ranks sharing the card on the GPU) and prints rank 0's lines.

Usage:
    python examples/language_model_torch.py [--seq 128] [--cpu]
    python examples/language_model_torch.py --cpu --seq-parallel 2

Runs on the GPU by default; without one pass ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch.job_deployment import (  # noqa: E402
    RANK_TIMEOUT,
    run_local_ranks,
)
from distkeras_tpu_torch.parallel import multihost  # noqa: E402
from distkeras_tpu_torch.parallel.backend import setup_backend  # noqa: E402

#: flags whose value is a path: made absolute for the rank processes,
#: which run in directories of their own
PATH_FLAGS = ("--save-bundle", "--text")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seq-parallel", type=int, default=0,
                    help="shard the token axis this many ways through the "
                         "causal ring (0 = single-device attention)")
    ap.add_argument("--remat", action="store_true",
                    help="per-block activation checkpointing: activation "
                         "memory O(1) in depth at ~1/3 extra FLOPs")
    ap.add_argument("--text", metavar="PATH", nargs="?", const="", default=None,
                    help="train on a real text file, byte-level (default: "
                         "the package's corpus) instead of the toy "
                         "successor corpus")
    ap.add_argument("--int8", action="store_true",
                    help="serve the decode demo from an int8 weight-only "
                    "copy (ops.quantization.quantize_model)")
    ap.add_argument("--save-bundle", metavar="PATH", default=None,
                    help="with --int8: persist the quantized serving copy "
                    "as a serving bundle, reload it, and run the decode "
                    "demo from the RELOADED model (what a serving host "
                    "does at boot)")
    ap.add_argument("--speculative", action="store_true",
                    help="also train a small draft LM and run the decode "
                    "demo speculatively (draft-and-verify; output is "
                    "exactly the main model's greedy decode) — prints "
                    "the measured acceptance per verify round")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    args = ap.parse_args()
    if args.save_bundle and not args.int8:
        # fail BEFORE training, not after a long run
        ap.error("--save-bundle stores a QUANTIZED serving copy; "
                 "pass --int8 too")
    if args.speculative and (args.text is not None or args.seq < 8):
        ap.error("--speculative runs on the toy successor corpus with "
                 "--seq >= 8 (the draft needs the same cheap task)")
    # draft shape, valid by construction (heads must divide d_model):
    draft_heads = 2
    draft_d = max(16, args.d_model // 4)
    draft_d += draft_d % draft_heads
    platform = setup_backend(cpu=args.cpu)
    device = "cpu" if platform == "cpu" else None
    ranked = bool(args.seq_parallel) and multihost.initialize(
        device=device, timeout=RANK_TIMEOUT)
    if args.seq_parallel > 1 and not ranked:
        return run_local_ranks(__file__, args.seq_parallel, sys.argv[1:],
                               path_flags=PATH_FLAGS, label="seq-parallel",
                               device=device)

    from distkeras_tpu_torch import SequenceParallelTrainer, SingleTrainer
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.parallel.ring_attention import (
        detach_ring_attention,
    )

    if args.text is not None:
        from distkeras_tpu_torch.data import loaders

        ds = loaders.text_corpus(args.text or None, seq_len=args.seq)
        if args.vocab != 32 or args.rows != 1024:
            print("note: --text is byte-level; --vocab is forced to 256 and "
                  "--rows to the corpus window count")
        args.vocab = 256
        print(f"byte-level corpus: {len(ds)} windows of {args.seq}")
    else:
        rng = np.random.default_rng(0)
        starts = rng.integers(0, args.vocab, args.rows)
        xs = ((starts[:, None] + np.arange(args.seq)[None, :]) % args.vocab
              ).astype(np.int32)
        ds = Dataset({"features": xs, "label": xs})

    model = zoo.transformer_lm(
        vocab_size=args.vocab, seq_len=args.seq, d_model=args.d_model,
        num_heads=args.heads, depth=args.depth, seed=0, remat=args.remat,
        device=device,
    )
    attach_flash_attention(model)
    attach_fused_layernorm(model)
    kw = dict(
        loss="next_token_crossentropy",
        learning_rate=2e-3,
        batch_size=args.batch,
        num_epoch=args.epochs,
        metrics=["next_token_accuracy"],
        seed=0,
        device=device,
    )
    if args.seq_parallel:
        if not ranked:
            print("seq-parallel: 1 rank in this process", flush=True)
        trainer = SequenceParallelTrainer(
            model, "pallas_adam", num_workers=args.seq_parallel, **kw
        )
    else:
        trainer = SingleTrainer(model, "pallas_adam", **kw)

    t0 = time.time()
    trained = trainer.train(ds)
    dt = time.time() - t0
    hist = [h for h in trainer.get_history() if "next_token_accuracy" in h]
    print(f"trained {len(ds)} rows x {args.epochs} epochs in {dt:.1f}s; "
          f"next-token accuracy {float(hist[0]['next_token_accuracy']):.3f} "
          f"-> {float(hist[-1]['next_token_accuracy']):.3f}", flush=True)
    if ranked:
        multihost.shutdown()
        if multihost.process_id() != 0:
            return None

    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    # cached decode computes attention itself: the flash hook goes, the
    # fused LayerNorm stays
    detach_ring_attention(trained)
    serve_model = trained
    if args.int8:
        from distkeras_tpu_torch.ops.quantization import (
            count_quantized,
            quantize_model,
        )

        serve_model = quantize_model(trained.copy())
        print(f"serving int8 weight-only "
              f"({count_quantized(serve_model)} quantized matrices)")
        if args.save_bundle:
            from distkeras_tpu_torch.utils.serialization import (
                load_serving_bundle,
                save_serving_bundle,
            )

            save_serving_bundle(args.save_bundle, serve_model)
            serve_model = load_serving_bundle(args.save_bundle, device=device)
            attach_fused_layernorm(serve_model)  # hooks are not serialized
            print(f"serving bundle: {os.path.getsize(args.save_bundle)} "
                  f"bytes at {args.save_bundle}; decoding from the "
                  f"RELOADED copy")
    gen = CachedSequenceGenerator(serve_model, device=device)
    if args.text is not None:
        p_len = min(16, max(1, args.seq // 2))
        prompt = ds["features"][len(ds) // 2 : len(ds) // 2 + 1, :p_len]
        steps = max(1, min(48, args.seq - p_len))
        out = gen.generate(prompt, steps=steps)
        txt = bytes(out[0].tolist()).decode("latin-1")
        print(f"decode from {txt[:p_len]!r} -> {txt[p_len:]!r}")
    elif args.seq >= 8:
        # a RAGGED serving batch: three prompts of different lengths, each
        # continued `steps` tokens (the model learned "count upward", so
        # every row must keep counting from its own prompt end)
        steps = min(12, args.seq - 5)
        v = args.vocab
        prompts = [
            np.array([3 % v], np.int32),
            np.array([x % v for x in (10, 11, 12)], np.int32),
            np.arange(5, dtype=np.int32) % v,
        ]
        outs = gen.generate(prompts, steps=steps)
        for row in outs:
            print("greedy decode:", np.asarray(row).tolist())
    else:
        # tiny --seq: the single-prompt demo still fits
        steps = min(12, args.seq - 1)
        out = gen.generate(np.array([[3 % args.vocab]], np.int32),
                           steps=steps)
        print("greedy decode:", out[0].tolist())

    if args.speculative:
        # a much smaller draft on the same corpus, decoding draft-and-
        # verify: the output must equal the main model's greedy decode
        from distkeras_tpu_torch.predictors import SpeculativeGenerator

        draft = zoo.transformer_lm(
            vocab_size=args.vocab, seq_len=args.seq, d_model=draft_d,
            num_heads=draft_heads, depth=1, seed=1, device=device,
        )
        kw.pop("device")
        draft_t = SingleTrainer(draft, "adam", device=device, **kw).train(ds)
        spec = SpeculativeGenerator(trained, draft_t, k=4, device=device)
        sp_steps = min(12, args.seq - 5)
        prompt = np.array([[3 % args.vocab]], np.int32)
        out_s = spec.generate(prompt, steps=sp_steps)
        plain = CachedSequenceGenerator(trained, device=device).generate(
            prompt, steps=sp_steps
        )[0]
        match = "EXACT" if (out_s[0] == plain).all() else "MISMATCH"
        print(f"speculative decode ({match} vs greedy): "
              f"{out_s[0].tolist()}; "
              f"{sp_steps} tokens in {int(spec.last_rounds[0])} verify "
              f"rounds ({sp_steps / int(spec.last_rounds[0]):.2f} "
              f"accepted/round)")
    return None


if __name__ == "__main__":
    main()
