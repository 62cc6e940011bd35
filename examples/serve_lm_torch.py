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
        [--temperature T [--top-p P]] [--fleet N]

The engine runs on CUDA unless ``--cpu`` is given. ``--temperature``
adds a seeded sampled generate, replayed and checked token-identical.
``--fleet N`` boots N replicas from the one bundle behind the
prefix-affinity ``FleetRouter`` instead, sends shared-header traffic
(one replica serves it all), rolls every replica over to the bundle
again and shows the upgraded fleet still serving.
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
    FleetController,
    SamplingParams,
    ServingClient,
    ServingEngine,
    ServingServer,
    local_replica_factory,
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
    ap.add_argument("--fleet", type=int, metavar="N", default=None,
                    help="serve N replicas of the bundle behind a fleet "
                    "router, then roll them over to it again")
    args = ap.parse_args(argv)
    if args.top_p is not None and args.temperature is None:
        ap.error("--top-p filters sampling; pass --temperature too")
    if args.fleet is not None and args.fleet < 2:
        ap.error("--fleet N needs N >= 2")
    if args.fleet and args.temperature is not None:
        ap.error("--temperature and --fleet are separate demos; pick one")
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
        if args.fleet:
            serve_fleet(args, bundle, device)
            return
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


def hooked_replicas(**engine_kw):
    """A ``FleetController`` factory: each replica boots from the bundle
    like the default factory's, with the LayerNorm kernel hooked into its
    model before it takes traffic (hooks are process-local and do not
    ride the bundle)."""
    boot = local_replica_factory(**engine_kw)

    def factory(bundle):
        replica = boot(bundle)
        attach_fused_layernorm(replica.engine.model)
        return replica

    return factory


def serve_fleet(args, bundle, device):
    """--fleet N: N replicas booted from ONE bundle behind the
    prefix-affinity router, concurrent shared-header clients (placement
    read off the ``served_by`` reply stamp), then a rolling bundle
    upgrade and the upgraded fleet still serving."""
    ctl = FleetController(
        bundle, replicas=args.fleet,
        factory=hooked_replicas(num_slots=args.slots, queue_capacity=32,
                                device=device),
    ).start()
    try:
        host, port = ctl.endpoint
        print(f"fleet: {args.fleet} replicas behind router {host}:{port} "
              f"({', '.join('%s:%s' % r.endpoint for r in ctl.replicas)})")
        # every prompt extends one 16-token header: prefix affinity lands
        # them all on the replica whose store holds the header's K/V
        header = (np.arange(16, dtype=np.int32) * 3 + 1) % args.vocab
        prompts = [np.concatenate([header, np.asarray(sfx, np.int32)
                                   % args.vocab])
                   for sfx in ([17], [17, 18], [17, 18, 19],
                               [17, 18, 19, 20])]
        steps = min(10, args.seq // 2)
        results = [None] * len(prompts)
        served = [None] * len(prompts)

        def client(i):
            with ServingClient(host, port) as c:
                results[i] = c.generate(prompts[i], steps)
                served[i] = c.last_served_by

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
        homes = set(served)
        print(f"{len(prompts)} shared-header requests x {steps} tokens in "
              f"{dt:.2f}s, served by {len(homes)} replica(s): "
              f"{sorted('%s:%s' % h for h in homes)}")
        # the same bundle stands in for the next training checkpoint: the
        # walk (boot the replacement, health-gate it in, drain and stop
        # the old replica) is the same either way
        ledger = ctl.rollover(bundle)
        print(f"rollover complete: {len(ledger['replaced'])} replicas "
              f"upgraded in {ledger['seconds']}s, zero requests dropped")
        with ServingClient(host, port) as c:
            out = c.generate(prompts[0], steps)
            print("served decode (upgraded fleet):", out.tolist())
            h = c.health()
            print(f"fleet health: {h['status']}, {h['active_replicas']} "
                  f"replicas in rotation")
    finally:
        ctl.stop()
    print("drained and stopped")


if __name__ == "__main__":
    main()
