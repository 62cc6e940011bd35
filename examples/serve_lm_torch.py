"""Export -> serve -> query on the PyTorch port — the shape of
``examples/serve_lm.py``.

Trains the toy successor-language LM (token t+1 = token t + 1 mod V, so
correct serving shows at a glance), quantizes it to an int8 serving
bundle on disk, boots a ``ServingEngine`` from that bundle with the
LayerNorm kernel hooked, fronts it with the TCP ``ServingServer``, and
then acts as its own traffic: concurrent mixed-length ``generate``
calls, a streamed generate, a traced generate, a ``predict`` round trip,
``stats``/``metrics``, and a graceful ``stop`` that drains in-flight
work.

Usage:
    python examples/serve_lm_torch.py [--cpu] [--seq 64] [--slots 4]
        [--temperature T [--top-p P]]

The engine runs on CUDA unless ``--cpu`` is given. ``--temperature``
adds a seeded sampled generate, replayed and checked token-identical.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distkeras_tpu_torch import SingleTrainer, zoo  # noqa: E402
from distkeras_tpu_torch.data.dataset import Dataset  # noqa: E402
from distkeras_tpu_torch.obs import timeline_complete  # noqa: E402
from distkeras_tpu_torch.ops.fused_layernorm import (  # noqa: E402
    attach_fused_layernorm,
)
from distkeras_tpu_torch.ops.quantization import quantize_model  # noqa: E402
from distkeras_tpu_torch.serving import (  # noqa: E402
    SamplingParams,
    ServingClient,
    ServingEngine,
    ServingServer,
)
from distkeras_tpu_torch.utils.serialization import (  # noqa: E402
    save_serving_bundle,
    serialize_model,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=None,
                    help="add a seeded sampled generate at this temperature")
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus filter for the sampled generate")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if args.top_p is not None and args.temperature is None:
        ap.error("--top-p filters sampling; pass --temperature too")
    device = "cpu" if args.cpu else None

    # -- train the successor LM ----------------------------------------------
    rng = np.random.default_rng(0)
    starts = rng.integers(0, args.vocab, 1024)
    xs = ((starts[:, None] + np.arange(args.seq)[None, :]) % args.vocab
          ).astype(np.int32)
    model = zoo.transformer_lm(
        vocab_size=args.vocab, seq_len=args.seq, d_model=64, num_heads=4,
        depth=2, seed=0, device=device,
    )
    trained = SingleTrainer(
        model, "adam", loss="next_token_crossentropy", learning_rate=2e-3,
        batch_size=32, num_epoch=args.epochs, seed=0, device=device,
    ).train(Dataset({"features": xs, "label": xs}))

    # -- export the serving bundle, boot the engine from disk ----------------
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "lm_int8.dkt")
        save_serving_bundle(bundle, quantize_model(trained.copy()))
        print(f"serving bundle: {os.path.getsize(bundle)} bytes "
              f"(f32 model: {len(serialize_model(trained))} bytes)")
        engine = ServingEngine.from_bundle(
            bundle, num_slots=args.slots, queue_capacity=32, device=device,
        )
        attach_fused_layernorm(engine.model)
        server = ServingServer(engine).start()
        print(f"serving on {server.host}:{server.port} "
              f"({args.slots} slots, {engine.device})")

        # -- concurrent mixed-length clients ---------------------------------
        prompts = [
            np.array([3 % args.vocab], np.int32),
            np.array([x % args.vocab for x in (10, 11, 12)], np.int32),
            np.arange(5, dtype=np.int32) % args.vocab,
            np.array([x % args.vocab for x in (20, 21)], np.int32),
        ]
        steps = min(10, args.seq // 2)
        results = [None] * len(prompts)

        def client(i):
            with ServingClient(server.host, server.port) as c:
                results[i] = c.generate(prompts[i], steps)

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.time() - t0
        for row in results:
            print("served decode:", row.tolist())  # must count upward
        print(f"{len(prompts)} concurrent requests x {steps} tokens "
              f"in {dt:.2f}s")

        with ServingClient(server.host, server.port) as c:
            stream = c.generate_stream(prompts[2], steps)
            chunks = [chunk.tolist() for chunk in stream]
            assert np.array_equal(stream.sequence, results[2])
            print(f"streamed {len(chunks)} chunks, first after "
                  f"{stream.ttft_s * 1e3:.1f} ms: {chunks}")
            c.generate(prompts[1], steps, trace=True)
            spans = c.last_trace["spans"]
            print(f"trace {c.last_trace['trace_id']}: "
                  f"{[s['name'] for s in spans]} "
                  f"(complete: {timeline_complete(spans)})")
            if args.temperature is not None:
                sp = SamplingParams(temperature=args.temperature,
                                    top_p=args.top_p, seed=7)
                out = c.generate(prompts[0], steps, sampling=sp)
                again = c.generate(prompts[0], steps, sampling=sp)
                assert np.array_equal(out, again), \
                    "same seed must replay identical samples"
                print(f"sampled (seed 7), replayed identically: "
                      f"{out.tolist()}")
            logits = c.predict(xs[:2])
            print(f"predict: logits {logits.shape} over the vocab")
            st = c.stats()
            print(f"stats: {st['completed']} completed, "
                  f"{st['streamed_chunks']} streamed chunks, mean batch "
                  f"occupancy {st['mean_batch_occupancy']:.2f}, "
                  f"{st['open_connections']} open connection(s)")
            print(f"metrics: {len(c.metrics())} samples")
            c.stop()  # graceful: drains in-flight work, then closes
        server.shutdown()
        print("drained and stopped")


if __name__ == "__main__":
    main()
