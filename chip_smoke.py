#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

Run from the repository root: ``python3 chip_smoke.py`` (optionally
``--out FILE`` to also write the results as JSON). It needs one CUDA card,
the CUDA toolkit (``nvcc``) and this checkout; it imports nothing of JAX.

Phases, each fatal on failure (exit code 1, no result line):

1. Device: CUDA required (exit 2 without it); prints the card's name and
   power limit; builds every kernel of the serving path from
   ``distkeras_tpu_torch/kernels/csrc`` with nvcc (one process per source,
   all started together).
2. Kernels vs their plain PyTorch versions on the card, at the shapes the
   serving path gives them: ``layernorm_fwd`` (tolerance 1e-5 absolute in
   f32; 1e-2 absolute + 1e-2 relative in bf16/f16, one rounding step; on
   each of its paths — 16-byte chunks at D = 512 and 96, one-element
   chunks at D = 510 and for a view with a storage offset, the block
   kernel above D = 1024 — a second launch bit-equal) and
   ``flash_fwd`` (f32: O to 2e-5, lse to 1e-5 absolute, at D = 64 and a
   D = 128 row; bf16 at (8, 512, 8, 64) causal: O within 2^-7 * (sum
   p|v| + |ref|) elementwise, the rounding of P and of the output, lse to
   1e-5; a second launch bit-equal), with the device time (CUDA-graph
   replay) and the eager per-call time (CUDA events) of the kernel, the
   plain version and — for context only, never on the port's path — the
   PyTorch library call computing the same function.
2b. The training kernels vs their plain versions on the card, at the
   shapes the training step gives them: ``adam_fused`` over the 110
   leaves of the d512/L8 model, and over ``resnet18``'s 62 and
   ``mnist_cnn``'s 12 (phase 7's tables), and over the member-stacked
   tables phase 9 launches once per joint step — 4 x ``mnist_cnn``'s 12
   and 2 x d512/L8's 110 (|dp|, |dm|, |dv| <= 1e-6 absolute),
   ``flash_bwd_dq``/``flash_bwd_dkv`` (dQ, dK, dV within 1e-4 * max(1,
   max|ref|) in f32 at (8, 512, 8, 64) causal and not and (2, 200, 8, 64);
   in bf16 at (8, 512, 8, 64) causal within 2^-7 * (sum |x||y| + |ref|)
   elementwise, the rounding of P/dS and of the output; a second launch
   bit-equal) and ``layernorm_bwd`` (dx to 1e-5 absolute in f32, one bf16
   step in bf16; dgamma/dbeta to 1e-4 of their largest magnitude and
   bit-equal between two launches; D = 512 on the 16-byte vector path,
   (37, 510) and (3, 96) on the element path), timed as in phase 2.
   Then the f32 flash kernels on query rows with an infinite element
   (every score -inf): the forward gives them O = 0 and lse = -inf as
   JAX's kernel does, and the backward dQ = 0 there, dQ and dV finite and
   within 1e-4 * max(1, max|ref|), dK NaN exactly where the plain
   version's is (0 * inf).
2c. The fused SGD kernels vs their plain versions on the card over the
   same 110 leaves: ``sgd_fused`` (B1) in f32 and bf16, and
   ``sgd_momentum_fused`` (B2) in f32 with momentum 0.9 plain and Nesterov
   and in bf16 with Nesterov, two steps each, and ``sgd_fused`` in f32
   over ``cifar10_cnn``'s 16 and ``higgs_mlp``'s 6 leaves (phase 7's
   tables) and over 4 x ``higgs_mlp``'s 6 (phase 9's replicas): bit-equal (the same operation order, every step rounded),
   timed as in phase 2.
3. Predict: a ``ServingEngine`` on ``transformer_lm(8192, 512, 512, 8, 8)``
   (random weights from a seed) with the flash and LayerNorm hooks answers
   ``predict`` on 8 full 512-token sequences; the logits must agree with
   the same model's plain path to 1e-4, exactly 8 flash and 17 LayerNorm
   launches must have served it, and ``generate`` must be refused (a model
   with an attention hook is predict-only, as in the JAX package).
4. Generate: an engine with the LayerNorm hook serves 16 concurrent
   requests (prompts of 16-256 tokens through chunked prefill, 32-64 new
   tokens, 12 greedy and 4 sampled); all must finish, sampled requests must
   replay identically, every greedy token must be the argmax of the
   teacher-forced logits (or tie with it within 1e-4), and those logits
   must agree between the kernel and the plain path to 1e-4. Token
   agreement with solo ``CachedSequenceGenerator`` decode and tokens/s are
   printed.
5. Train: ``SingleTrainer`` with ``pallas_adam`` on the d512/L8 model with
   the flash and LayerNorm hooks, one shuffled epoch of the in-repo corpus
   (``loaders.text_corpus(seq_len=512)``: 136 windows, 17 steps of batch 8,
   device-resident), then the same model from the same seed with no hooks
   and ``adam`` (the plain path on the card). Every loss must be finite,
   the last below the first, every step's loss within 1e-3 (relative) of
   the plain path's, the caller's model unchanged, and the kernels launched
   exactly 17 x (17 LN forward, 17 LN backward, 8 flash forward, 8 dQ, 8
   dK/dV, 1 Adam). Samples/s and tokens/s are printed.
6a. Async, simulated mode: DOWNPOUR and ADAG with ``pallas_sgd`` (B1),
   DynSGD and AEASGD with ``FusedSGD`` at momentum 0.9 (B2; AEASGD with
   Nesterov) and EAMSGD with its own ``sgd``-Nesterov, each on a fresh
   d512/L8 model with the flash and LN hooks, 2 workers, window 4, batch
   8, one shuffled device-resident epoch of the corpus (16 steps, 4
   commits), then the same trainer with no hooks and ``sgd`` at the same
   momentum (the plain path). Every step's loss within 1e-3 (relative) of
   the plain path's, the final centers within 1e-4, 4 updates on both
   paths (DynSGD's version equal to them), no worker failure, the kernels
   launched exactly 16 x (17 LN forward, 17 LN backward, 8 flash forward,
   8 dQ, 8 dK/dV) plus 16 of the SGD kernel, none on the plain path, and
   DOWNPOUR's loss falling.
6b. Async, threads mode: DOWNPOUR + ``pallas_sgd`` with 2 worker threads
   on the card: both commit, 4 updates, no failure, exact launches for 20
   steps (the warm-up window included), one B1 table per worker. Prints
   tokens/s (over ``train()``, and over the worker threads after the
   warm-up window), the per-window host split (pull, window, commit) and
   the device's idle share (a second run under the profiler).

7. The BASELINE configs: ``benchmarks.py``'s configs 2-5 at their smoke
   rows and full width — DOWNPOUR/``mnist_cnn`` (8 workers, adam 2.5e-4,
   bf16), AEASGD/``higgs_mlp`` (4 workers, sgd 0.02, rho 10, f32),
   ADAG/``cifar10_cnn`` (4 workers, sgd 0.05, bf16, BatchNorm momentum
   0.9), DynSGD/``resnet18`` at (64, 64, 3) with 10 classes (4 workers,
   adam 1e-3, bf16) — each over one shuffled epoch of its synthetic data
   (the port's loaders, ``split(0.9, seed=7)``), window 4, simulated
   mode, seed 0, cuDNN deterministic. The kernel path (``pallas_adam``:
   B3, ``pallas_sgd``: B1) against the plain path from the same seed
   (B3's plain version ``adam_step_plain``; ``sgd``): per-step losses
   within 1e-3 relative, centers and the aggregated BatchNorm buffers
   within 1e-4, equal update counts, no worker failure, exactly one B3
   or B1 launch per step on the kernel path and none on the plain path.
   The Adam configs also run ``"adam"`` (optax's operation order) and
   print its distance. Prints samples/s, the window split and the
   held-out accuracy (``AccuracyEvaluator``) per config.

8. Checkpoint and resume. 8a: phase 5's trainer over two epochs, run
   twice uninterrupted (is the card path deterministic?), then one epoch
   with ``checkpoint_dir`` and, in a new trainer with ``metrics_path``
   and ``profile_dir``, resumed to epoch 2. The resumed parameters must
   equal the uninterrupted runs' bit for bit when those two are
   bit-identical (else stay within their own distance, and the ops
   PyTorch flags as nondeterministic are named); the resumed epoch must
   launch exactly 17 x (17, 17, 8, 8, 8, 1) of (LN forward, LN backward,
   flash forward, dQ, dK/dV, Adam); the JSONL must hold its
   ``train_end`` row and the profiler trace must name those six
   kernels. Prints the checkpoint's bytes and the save and restore
   seconds. 8b: configs 3 (AEASGD/``higgs_mlp``, ``pallas_sgd``) and 5
   (DynSGD/``resnet18``, ``pallas_adam``) as in phase 7, one epoch with
   ``checkpoint_dir``, then resumed to two epochs on the kernel path and,
   from a copy of the checkpoint, on the plain path: the center, the
   replicas and the BatchNorm buffers round-trip the checkpoint bit for
   bit, exactly twice the first epoch's commits with no duplicate, every
   worker restored with a commit seq > 0, DynSGD's version restored, one
   B1/B3 launch per step on the kernel path and none on the plain path,
   kernel and plain resumes within phase 7's bars.

9. The streaming and native data layer, the member trainers and commit
   compression (cuDNN deterministic). 9a: config 5's smoke training rows
   written to 4 uint8 shards with ``ShardWriter`` and preprocessed per
   shard with ``.map``; DynSGD/``resnet18`` with ``pallas_adam`` from
   ``open_shards`` (one shard per worker) against B3's plain version,
   phase 7's bars, its samples/s printed beside phase 7's in-memory run;
   the same shards through ``SingleTrainer`` with prefetch 2 and 0
   (bit-identical); config 6: the native library built and loaded, its
   parse of ``digits.csv`` equal to the csv module's bit for bit, and
   ``digits_mlp`` one epoch with ``pallas_adam`` against the plain path.
   9b: ``EnsembleTrainer`` (4 ``mnist_cnn`` members, config 2's data,
   adam 2.5e-4, batch 32, window 4, bf16) and ``AveragingTrainer`` (4
   ``higgs_mlp`` replicas, config 3's data, sgd 0.02, batch 64, window 4,
   2 epochs), each threaded and vmapped, each on the kernel and the plain
   path: per-member losses within 1e-3 relative and weights within 1e-4
   between the paths and between vmapped and threaded; exactly one B3/B1
   launch per joint step vmapped, one per member and step threaded. 9c:
   ``EnsembleTrainer(vmapped=True)`` with 2 d512/L8 members carrying the
   flash and LayerNorm hooks, ``pallas_adam``, batch 8, one window of 4:
   per-step losses within 1e-3 relative of the plain path (no hooks, B3's
   plain version), exactly 2 x 4 x (17, 17, 8, 8, 8) of B7/B8/B4/B5/B6
   and 4 of B3. 9d: config 2 with ``compress="int8"`` and
   ``pull_compress="bfloat16"``, config 3 with ``compress="topk:0.05"``,
   kernel against plain path under phase 7's bars, commit bytes per window
   printed against the uncompressed run (at least 3x / 4x fewer); a
   config-2 checkpoint after epoch 1 carries every worker's residual bit
   for bit and the kernel and plain resumes keep phase 8b's contract;
   with one worker (whose simulated schedule a resume keeps) the resumed
   compressed run is bit-identical to an uninterrupted one.

10. The socket parameter-server tier (cuDNN deterministic). 10a: config 2
   as in phase 7's kernel path with ``remote_ps=True`` (every pull and
   commit over a loopback socket): the center bit for bit phase 7's, 16
   commits, 56 B3 launches; samples/s beside phase 7's and the wire bytes
   per pull and per commit. 10b: a second OS process (CUDA hidden) hosts a
   ``SocketParameterServer`` over config 2's initial center; one DOWNPOUR
   worker runs its windows on the card against it through
   ``RemoteParameterServerClient``; the center read back over the wire
   bit for bit the one-worker in-process run's. 10c: phase 6a's hooked
   d512/L8 DOWNPOUR (B1) and DynSGD (B2) with ``remote_ps=True``: centers
   and losses bit for bit phase 6a's, launches exactly 16 x (17, 17, 8, 8,
   8) of B7/B8/B4/B5/B6 plus 16 of B1/B2; then DOWNPOUR with int8 commits
   and bf16 pulls over the socket, per-step losses within 1e-3 relative
   of phase 6a's plain path; wire bytes and the window split beside the
   in-process runs'. 10d: config 3 in threads with ``remote_ps``, a warm
   standby and ``worker_retries=2``, unfaulted and with the primary killed
   at half the expected commits: exactly one promotion
   (``primary-lost``), at least one client failover, a promotion
   post-mortem and the unfaulted run's commit ledger; the kill-to-promotion
   seconds and the B1 launches (60 unfaulted: 56 steps and the 4-step
   warm-up window).

11. The serving TCP front on the d512/L8 LM, over loopback. 11a: an
   LN-hooked 8-slot engine behind a ``ServingServer`` takes phase 4's
   16-request mix from 8 client threads (one ``ServingClient`` each):
   every reply equal to phase 4's in-process output, greedy and sampled,
   B7 launched and B4 not; tokens/s over the wire beside phase 4's. 11b:
   four of the mix through ``generate_stream``: the chunks concatenate to
   the unstreamed sequence; TTFT and inter-chunk p50/p99 on the host
   clock. 11e: a traced generate's timeline complete with queue, prefill
   and decode spans; ``metrics`` (JSON and Prometheus), ``timeseries``,
   ``health`` and ``stats`` answer; ``stop`` drains a request still in
   flight. 11c: a flash+LN-hooked engine scores phase 3's (8, 512) batch
   in process and over the wire: the (8, 512, 8192) f32 replies bit-equal,
   exactly 17 B7 and 8 B4 launches for the wire forward; the wall time
   beside phase 3's and the host split (reply encode, loopback, decode).
   11d: ``quantize_model`` -> ``save_serving_bundle`` ->
   ``ServingEngine.from_bundle`` on the card; four greedy wire generates
   equal to an in-process ``CachedSequenceGenerator`` on the quantized
   model; the bundle bytes beside ``serialize_model``'s f32 bytes.

``--profile`` adds where the time goes: a decode step, a predict forward,
a training step, an async window and a config-5 DynSGD/``resnet18``
window (host wall, device time by category, idle share, top kernels).

The last lines are the kernels JSON, the ``nvidia-smi`` name/power line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense peaks: f32 on the CUDA cores, TF32 and bf16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

LN_TOL_F32 = 1e-5
LN_TOL_BF16 = 1e-2
FLASH_TOL_O = 2e-5
FLASH_TOL_LSE = 1e-5
LOGIT_TOL = 1e-4
ADAM_TOL = 1e-6  # same operation order; only pow() for c1/c2 may differ
FLASH_BWD_TOL = 1e-4  # times max(1, max|ref|): f32, summation order
BWD_16BIT_ROUNDING = 2.0 ** -8  # bf16's unit roundoff (8 significant bits)
LN_BWD_TOL_DX = 1e-5
LN_BWD_TOL_DGB = 1e-4  # times max|ref|: sums over 4096 rows, other order
TRAIN_LOSS_RTOL = 1e-3  # kernel vs plain path, per step, over 17 steps
TRAIN_STEPS = 17
# phase 6: 136 corpus windows over 2 workers, batch 8, window 4 -> 2
# windows of 4 steps each
ASYNC_STEPS = 16
ASYNC_COMMITS = 4
ASYNC_LR = 0.02  # plain SGD; DOWNPOUR's loss must fall at this rate
ASYNC_LR_MOMENTUM = 0.002  # momentum 0.9: the same effective step
# kernel vs plain center after 16 steps: the paths differ only in the flash
# and LN kernels' summation order (per-step losses agree to ~1e-7 relative
# in phase 5); a missed or doubled commit moves weights by a whole window
ASYNC_CENTER_TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_time_ms(fn, iters=50, warmup=5):
    """Eager time per call: CUDA events around ``iters`` back-to-back calls.
    Where the host cannot enqueue as fast as the card runs (small shapes),
    this is the host's per-call cost, which is what the eager path pays."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters=20, reps=5, stream=None):
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``reps`` times between CUDA events — the host is out of the
    measurement, so this is what the card spends on the call's kernels.
    ``stream``: capture there (an autograd backward must be captured on
    the stream its forward ran on)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def timings(kernel, plain, library, library_stream=None):
    """Device and eager per-call times of the kernel, its plain version
    and the library call (each a zero-argument callable; a library call
    that is an autograd backward names the stream its forward ran on)."""
    out = {}
    for key, fn, stream in (("", kernel, None), ("plain_", plain, None),
                            ("library_", library, library_stream)):
        out[f"{key}ms"] = device_time_ms(fn, stream=stream)
        out[f"{key}call_ms"] = call_time_ms(fn)
    return out


def backward_call(torch, forward, inputs, grad_out):
    """A library backward to time: ``forward(*inputs)`` recorded once on a
    stream of its own; the returned call runs its backward again (graph
    kept) and the stream is returned for the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = forward(*inputs)
    torch.cuda.current_stream().wait_stream(stream)

    def call():
        torch.autograd.grad(out, inputs, grad_out, retain_graph=True)

    return call, stream


def rotating(sets):
    """Cycle through input sets so repeated launches read cold-ish memory
    (the sets together exceed the 50 MB L2 where the inputs are large)."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]

    return nxt


#: bytes the input sets of one timed call rotate through at least: twice
#: the 50 MB L2, so a small optimizer table is read from HBM each launch,
#: as a training step (whose forward and backward pass in between) finds it
COLD_BYTES = 100e6


def cold_sets(nbytes):
    """How many copies of a call's inputs keep them out of the L2."""
    return max(1, math.ceil(COLD_BYTES / nbytes))


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 2


def check_layernorm(torch, F):
    """layernorm_fwd vs its plain version on each of its paths — 16-byte
    chunks (the main path's D = 512), one-element chunks (D = 510, and x a
    view with a storage offset), the block kernel (D > 1024) — in f32,
    bf16 and f16; a second launch must give the same bits. The path is the
    launcher's own rule (``fwd_path``). At (8, 512), the decode and
    prefill shape, the eager time of the hook as decode calls it
    (``fused_layer_norm`` under ``no_grad``) is timed too."""
    from distkeras_tpu_torch.ops.fused_layernorm import (
        _reference_layer_norm,
        fused_layer_norm,
        fwd_path,
        layernorm_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (n, d), dtype, offset, path, timed in [
        ((8, 512), torch.float32, 0, "vector", True),
        ((512, 512), torch.float32, 0, "vector", True),
        ((4096, 512), torch.float32, 0, "vector", True),
        ((4096, 512), torch.bfloat16, 0, "vector", True),
        ((3, 96), torch.float32, 0, "vector", True),
        ((8, 512), torch.float16, 0, "vector", False),
        ((37, 510), torch.float32, 0, "scalar", True),
        ((37, 510), torch.bfloat16, 0, "scalar", False),
        ((8, 512), torch.float32, 1, "scalar", True),
        ((2, 2048), torch.float32, 0, "block", False),
        ((3, 2050), torch.float16, 0, "block", False),
    ]:
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (n * d * isz)))
        sets = []
        for _ in range(nsets):
            base = torch.empty(n * d + offset, device="cuda", dtype=dtype)
            base[offset:] = (torch.randn(n * d, device="cuda", generator=gen)
                             * 2 + 0.5).to(dtype)
            sets.append(base[offset:].view(n, d))
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        b = 0.1 * torch.randn(d, device="cuda", generator=gen)
        x = sets[0]
        took = fwd_path(x, g, b, torch.empty_like(x))
        y = layernorm_fwd(x, g, b, 1e-5)
        again = layernorm_fwd(x, g, b, 1e-5)
        ref = _reference_layer_norm(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.float32:
            ok = max_err <= LN_TOL_F32
        else:
            ok = bool((err <= LN_TOL_BF16 + LN_TOL_BF16
                       * ref.float().abs()).all())
        deterministic = torch.equal(y, again)
        ok = ok and deterministic and took == path
        dname = str(dtype).replace("torch.", "")
        row = {
            "shape": [n, d], "dtype": dname, "storage_offset": offset,
            "path": took, "max_abs_err": max_err,
            "deterministic": deterministic, "ok": ok,
        }
        if timed:
            nxt = rotating(sets)
            gl, bl = g.to(dtype), b.to(dtype)
            row.update(timings(
                lambda: layernorm_fwd(nxt(), g, b, 1e-5),
                lambda: _reference_layer_norm(nxt(), g, b, 1e-5),
                lambda: F.layer_norm(nxt(), (d,), gl, bl, 1e-5),
            ))
            if (n, d, offset) == (8, 512, 0) and dtype == torch.float32:
                # the host bounds these: three rounds in turns, medians
                eager = {"layernorm_fwd": lambda: layernorm_fwd(
                             nxt(), g, b, 1e-5),
                         "fused_layer_norm_no_grad": lambda: fused_layer_norm(
                             nxt(), g, b, 1e-5),
                         "F.layer_norm": lambda: F.layer_norm(
                             nxt(), (d,), gl, bl, 1e-5)}
                reads = {k: [] for k in eager}
                with torch.no_grad():
                    for _ in range(3):
                        for k, fn in eager.items():
                            reads[k].append(call_time_ms(fn, iters=200))
                row["eager_call_ms_median"] = {
                    k: sorted(r)[1] for k, r in reads.items()}
            bound_ms, bound_by = bound(2 * n * d * isz + 2 * d * 4, 8 * n * d,
                                       "float32" if isz == 4 else "bfloat16")
            row.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"layernorm_fwd {row}")
        check(ok, f"layernorm_fwd disagrees with its plain version, differs "
                  f"between two launches or took another path: {row}")
        rows.append(row)
        del sets, x, y, again, ref
    return rows


def fwd_16bit_tolerance(torch, q, k, v, causal, ref_o):
    """Elementwise tolerance of the 16-bit forward's O: the kernel rounds P
    to the input type before P V (at most 2^-8 of each term, so 2^-8 *
    sum p |v| over the keys, p normalized) and O is rounded like the
    reference's (one ulp, 2^-7 * |ref|); twice the first term covers the
    f32 sums' order."""
    from distkeras_tpu_torch.ops.flash_attention import _scores

    p = torch.softmax(_scores(q, k, causal), dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
    return BWD_16BIT_ROUNDING * (2 * pv + 2 * ref_o.float().abs()) + 1e-6


def check_flash(torch, F):
    """flash_fwd vs the plain forward: f32 O within FLASH_TOL_O and lse
    within FLASH_TOL_LSE absolute; bf16 O within the elementwise bound of
    ``fwd_16bit_tolerance``, lse within FLASH_TOL_LSE; a second launch
    must give the same bits. Bound: the path the kernel takes — 3xTF32 on
    the tensor cores in f32 (three products per FLOP at the TF32 peak),
    one bf16 pass in bf16 — with the CUDA-core f32 figure beside it."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_fwd,
        flash_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (b, t, h, d), causal, dtype in [
        ((8, 512, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), False, torch.float32),
        ((2, 1, 8, 64), True, torch.float32),
        ((2, 200, 8, 64), True, torch.float32),
        ((2, 512, 8, 64), False, torch.float32),
        ((8, 512, 8, 64), True, torch.bfloat16),
        ((8, 512, 4, 128), True, torch.float32),
    ]:
        per = 3 * b * t * h * d * 4
        nsets = max(1, min(8, (96 << 20) // per))
        sets = [
            tuple(torch.randn(b, t, h, d, device="cuda", generator=gen)
                  .to(dtype) for _ in range(3))
            for _ in range(nsets)
        ]
        q, k, v = sets[0]
        o, lse = flash_fwd(q, k, v, causal)
        o2, lse2 = flash_fwd(q, k, v, causal)
        ro, rlse = _reference_flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        deterministic = torch.equal(o, o2) and torch.equal(lse, lse2)
        diff_o = (o.float() - ro.float()).abs()
        err_o = float(diff_o.max())
        err_lse = float((lse - rlse).abs().max())
        if dtype == torch.float32:
            ratio_o = err_o / FLASH_TOL_O
        else:
            ratio_o = float((diff_o / fwd_16bit_tolerance(
                torch, q, k, v, causal, ro)).max())
        ok = deterministic and ratio_o <= 1.0 and err_lse <= FLASH_TOL_LSE
        nxt = rotating(sets)
        hsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
        hnxt = rotating(hsets)
        times = timings(
            lambda: flash_fwd(*nxt(), causal),
            lambda: _reference_flash_fwd(*nxt(), causal),
            lambda: F.scaled_dot_product_attention(*hnxt(), is_causal=causal),
        )
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        nbytes = 4 * b * t * h * d * q.element_size() + b * h * t * 4
        flops = 4 * d * pairs
        if dtype == torch.float32:
            dname = "float32"
            bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
            path = "3xTF32 mma.sync: 3 x FLOPs at the TF32 peak"
        else:
            dname = "bfloat16"
            bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
            path = "bf16 mma.sync: FLOPs at the bf16 peak"
        row = {
            "shape": [b, t, h, d], "causal": causal, "dtype": dname,
            "max_abs_err": max(err_o, err_lse), "err_o": err_o,
            "err_lse": err_lse, "o_err_over_tolerance": ratio_o,
            "deterministic": deterministic, "ok": ok, **times,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_path": path,
            "cuda_core_bound_ms": bound(nbytes, flops, "float32")[0],
        }
        log(f"flash_fwd {row}")
        check(ok, f"flash_fwd disagrees with its plain version or differs "
                  f"between two launches: {row}")
        rows.append(row)
        del sets, hsets, q, k, v, o, o2, ro
    return rows


# ----------------------------------------------------------------- phase 2b


def check_adam(torch, shapes, model=None):
    """adam_fused vs its plain version over one model's leaf shapes, from
    step count 4 (so c1/c2 are not the first step's)."""
    from distkeras_tpu_torch.ops.pallas_kernels import (
        _TableCache,
        adam_fused,
        adam_step_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(scale, fn=torch.randn):
        return [fn(s, device="cuda", generator=gen) * scale for s in shapes]

    params, grads, ms = rand(0.05), rand(1e-3), rand(1e-4)
    vs = [v * v for v in rand(1e-3)]
    hyper = (1e-3, 0.9, 0.999, 1e-8)

    def state():
        return ([p.clone() for p in params], [m.clone() for m in ms],
                [v.clone() for v in vs],
                torch.tensor([4, 0], dtype=torch.int32, device="cuda"))

    kp, km, kv, ks = state()
    table = _TableCache()
    adam_fused(kp, grads, km, kv, ks, *hyper, table)
    rp, rm, rv, rs = state()
    adam_step_plain(rp, grads, rm, rv, rs, *hyper)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max())
              for a, b in zip(kp + km + kv, rp + rm + rv))
    steps = (ks.tolist(), rs.tolist())
    ok = err <= ADAM_TOL and steps == ([5, 0], [5, 0])
    n = sum(p.numel() for p in params)
    # timed over enough copies (each with its own table) to miss the L2
    gsets = [grads] + [[g.clone() for g in grads]
                       for _ in range(cold_sets(28 * n) - 1)]
    ksets = [(kp, grads, km, kv, ks, *hyper, table)] + [
        (*state()[:1], g, *state()[1:], *hyper, _TableCache())
        for g in gsets[1:]]
    psets = [(rp, grads, rm, rv, rs, *hyper)] + [
        (*state()[:1], g, *state()[1:], *hyper) for g in gsets[1:]]
    libs = []
    for g in gsets:
        lp = [p.clone().requires_grad_() for p in params]
        for p, gl in zip(lp, g):
            p.grad = gl
        libs.append(torch.optim.Adam(lp, lr=1e-3, fused=True,
                                     capturable=True))
    for args, lib in zip(ksets, libs):  # tables and library state made
        adam_fused(*args)  # before the graph capture
        lib.step()
    knxt, pnxt, lnxt = rotating(ksets), rotating(psets), rotating(libs)
    times = timings(
        lambda: adam_fused(*knxt()),
        lambda: adam_step_plain(*pnxt()),
        lambda: lnxt().step(),
    )
    bound_ms, bound_by = bound(28 * n, 14 * n, "float32")
    row = {
        "shape": [len(shapes), n], "dtype": "float32", "max_abs_err": err,
        "model": model, "input_sets": len(ksets), "steps_after": steps,
        "table_builds": table.builds,
        "grad_pointer_uploads": table.grad_uploads, "ok": ok,
        **times, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"adam_fused {row}")
    check(ok, f"adam_fused disagrees with its plain version: {row}")
    del params, grads, ms, vs, kp, km, kv, rp, rm, rv, ksets, psets, libs
    return row


def sgd_library_call(torch, params, grads, lr, mu, nesterov):
    """The library step computing B1/B2's function, for context only:
    ``torch._foreach_add_`` without momentum; with it ``torch.optim.SGD``,
    fused where this torch offers ``fused=True`` for SGD, else foreach."""
    if mu == 0.0:
        return (lambda: torch._foreach_add_(params, grads, alpha=-lr)), \
            "torch._foreach_add_"
    lp = [p.clone().requires_grad_() for p in params]
    for p, g in zip(lp, grads):
        p.grad = g
    try:
        opt = torch.optim.SGD(lp, lr=lr, momentum=mu, nesterov=nesterov,
                              fused=True)
        name = "torch.optim.SGD(fused=True)"
    except (RuntimeError, TypeError, ValueError):
        opt = torch.optim.SGD(lp, lr=lr, momentum=mu, nesterov=nesterov,
                              foreach=True)
        name = "torch.optim.SGD(foreach=True)"
    opt.step()  # the momentum buffers exist before the capture
    return opt.step, name


SGD_CASES = ((0.0, False, "float32"), (0.9, False, "float32"),
             (0.9, True, "float32"), (0.0, False, "bfloat16"),
             (0.9, True, "bfloat16"))


def check_sgd(torch, shapes, model=None, cases=SGD_CASES):
    """sgd_fused (B1) and sgd_momentum_fused (B2) vs their plain versions
    over one model's leaf shapes (by default: f32 with momentum 0, 0.9 and
    0.9 Nesterov, and one bf16 set of each kernel). Bit-equal: the same
    operation order, each step rounded (``__f*_rn``), the same final
    rounding to bf16."""
    from distkeras_tpu_torch.ops.pallas_kernels import (
        _TableCache,
        sgd_fused,
        sgd_momentum_fused,
        sgd_momentum_step_plain,
        sgd_step_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(23)
    n = sum(math.prod(s) for s in shapes)
    rows = {"sgd_fused": [], "sgd_momentum_fused": []}
    lr = 0.02
    for mu, nesterov, dname in cases:
        dtype = getattr(torch, dname)
        params = [(torch.randn(s, device="cuda", generator=gen) * 0.05)
                  .to(dtype) for s in shapes]
        grads = [(torch.randn(s, device="cuda", generator=gen) * 1e-2)
                 .to(dtype) for s in shapes]
        ms = [torch.randn(s, device="cuda", generator=gen) * 1e-2
              for s in shapes]
        kp, km = [p.clone() for p in params], [m.clone() for m in ms]
        rp, rm = [p.clone() for p in params], [m.clone() for m in ms]
        tables = _TableCache()
        if mu == 0.0:
            kname = "sgd_fused"
            kernel_fn = lambda: sgd_fused(kp, grads, lr, tables)  # noqa: E731
            plain_fn = lambda: sgd_step_plain(rp, grads, lr)  # noqa: E731
        else:
            kname = "sgd_momentum_fused"
            kernel_fn = lambda: sgd_momentum_fused(  # noqa: E731
                kp, grads, km, lr, mu, nesterov, tables)
            plain_fn = lambda: sgd_momentum_step_plain(  # noqa: E731
                rp, grads, rm, lr, mu, nesterov)
        for _ in range(2):  # two steps: the momenta feed back
            kernel_fn()
            plain_fn()
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(kp + km, rp + rm))
        equal = all(torch.equal(a, b) for a, b in zip(kp + km, rp + rm))
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = 3 * isz * n + (8 * n if mu else 0)
        # timed over enough copies (each with its own table) to miss the L2
        sets = [(kp, grads, km, tables, rp, rm)] + [
            ([p.clone() for p in params], [g.clone() for g in grads],
             [m.clone() for m in ms], _TableCache(),
             [p.clone() for p in params], [m.clone() for m in ms])
            for _ in range(cold_sets(nbytes) - 1)]
        libs = [sgd_library_call(torch, st[0], st[1], lr, mu, nesterov)
                for st in sets]
        nxt, lnxt = rotating(sets), rotating([f for f, _ in libs])
        if mu == 0.0:
            def kernel_fn():
                p_, g_, _, t_, _, _ = nxt()
                sgd_fused(p_, g_, lr, t_)

            def plain_fn():
                _, g_, _, _, p_, _ = nxt()
                sgd_step_plain(p_, g_, lr)
        else:
            def kernel_fn():
                p_, g_, m_, t_, _, _ = nxt()
                sgd_momentum_fused(p_, g_, m_, lr, mu, nesterov, t_)

            def plain_fn():
                _, g_, _, _, p_, m_ = nxt()
                sgd_momentum_step_plain(p_, g_, m_, lr, mu, nesterov)
        for _ in sets:  # every table built before the graph capture
            kernel_fn()
        times = timings(kernel_fn, plain_fn, lambda: lnxt()())
        lib_name = libs[0][1]
        flops = (2 + (2 if mu else 0) + (2 if nesterov else 0)) * n
        bound_ms, bound_by = bound(nbytes, flops, "float32")
        row = {
            "shape": [len(shapes), n], "dtype": dname, "model": model,
            "input_sets": len(sets), "momentum": mu,
            "nesterov": nesterov, "max_abs_err": err, "bit_equal": equal,
            "ok": equal, "table_builds": tables.builds,
            "grad_pointer_uploads": tables.grad_uploads, **times,
            "library": lib_name, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"{kname} {row}")
        check(equal, f"{kname} differs from its plain version: {row}")
        rows[kname].append(row)
        del params, grads, ms, kp, km, rp, rm, sets, libs
    return rows


def bf16_bwd_tolerances(torch, q, k, v, do, lse, delta, causal, refs):
    """Elementwise tolerances of the 16-bit backward: the kernel rounds P
    and dS to the input type before the second product (at most 2^-8 of
    each term, so 2^-8 * sum |x||y| over the reduced index) and the output
    is rounded like the reference's (one ulp, 2^-7 * |ref|); twice the
    first term covers the f32 sums' order."""
    from distkeras_tpu_torch.ops.flash_attention import _reference_p_ds

    p, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    ads = ds.abs()
    sums = {
        "dq": torch.einsum("bhqk,bkhd->bqhd", ads, k.float().abs()),
        "dk": torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()),
        "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()),
    }
    return {n: BWD_16BIT_ROUNDING * (2 * sums[n] + 2 * refs[n].float().abs())
            + 1e-6 for n in sums}


def check_flash_bwd(torch, F):
    """flash_bwd_dq / flash_bwd_dkv vs the plain backward, on the forward
    kernel's O and lse (what the training step hands them): f32 within
    FLASH_BWD_TOL * max(1, max|ref|), bf16 within the elementwise bound of
    ``bf16_bwd_tolerances``; a second launch must give the same bits (no
    atomics). Bound: the path the kernels take — 3xTF32 on the tensor
    cores in f32 (three products per FLOP at the TF32 peak), one bf16 pass
    in bf16 — with the CUDA-core f32 figure beside it."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_bwd_dkv,
        _reference_flash_bwd_dq,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )

    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    gen = torch.Generator(device="cuda").manual_seed(17)
    for (b, t, h, d), causal, dtype in [
        ((8, 512, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), False, torch.float32),
        ((2, 200, 8, 64), True, torch.float32),
        ((8, 512, 8, 64), True, torch.bfloat16),
    ]:
        q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        o, lse = flash_fwd(q, k, v, causal)
        dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq2, delta2 = flash_bwd_dq(q, k, v, o, lse, do, causal)
        dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta2, causal)
        rdq, rdelta = _reference_flash_bwd_dq(q, k, v, o, lse, do, causal)
        rdk, rdv = _reference_flash_bwd_dkv(q, k, v, do, lse, rdelta, causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, a2) for a, a2 in (
            (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
        refs = {"dq": rdq, "dk": rdk, "dv": rdv, "delta": rdelta}
        got = {"dq": dq, "dk": dk, "dv": dv, "delta": delta}
        if dtype == torch.float32:
            tols = {n: FLASH_BWD_TOL * max(1.0, float(r.abs().max()))
                    for n, r in refs.items()}
        else:
            tols = bf16_bwd_tolerances(torch, q, k, v, do, lse, rdelta,
                                       causal, refs)
            tols["delta"] = FLASH_BWD_TOL * max(1.0, float(rdelta.abs().max()))
        errs = {}
        for n in refs:
            diff = (got[n].float() - refs[n].float()).abs()
            errs[n] = (float(diff.max()), float((diff / tols[n]).max()))
        ok = deterministic and all(ratio <= 1.0 for _, ratio in errs.values())
        # the library call: SDPA's backward (dQ, dK, dV at once), timed
        # for context only
        library, lib_stream = backward_call(
            torch,
            lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, is_causal=causal),
            tuple(x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v)),
            do.transpose(1, 2).contiguous(),
        )

        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        io = b * t * h * d * q.element_size()
        stats = b * h * t * 4
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        for kname, kernel_fn, plain_fn, nbytes, flops, kerr in (
            ("flash_bwd_dq",
             lambda: flash_bwd_dq(q, k, v, o, lse, do, causal),
             lambda: _reference_flash_bwd_dq(q, k, v, o, lse, do, causal),
             6 * io + 2 * stats, 6 * d * pairs, ("dq", "delta")),
            ("flash_bwd_dkv",
             lambda: flash_bwd_dkv(q, k, v, do, lse, delta, causal),
             lambda: _reference_flash_bwd_dkv(q, k, v, do, lse, rdelta,
                                              causal),
             6 * io + 2 * stats, 8 * d * pairs, ("dk", "dv")),
        ):
            times = timings(kernel_fn, plain_fn, library, lib_stream)
            if dtype == torch.float32:
                bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
                path = "3xTF32 mma.sync: 3 x FLOPs at the TF32 peak"
            else:
                bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
                path = "bf16 mma.sync: FLOPs at the bf16 peak"
            row = {
                "shape": [b, t, h, d], "causal": causal, "dtype": dname,
                "max_abs_err": max(errs[e][0] for e in kerr),
                "errs": {e: errs[e] for e in kerr},
                "deterministic": deterministic, "ok": ok, **times,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_path": path,
                "cuda_core_bound_ms": bound(nbytes, flops, "float32")[0],
            }
            log(f"{kname} {row}")
            rows[kname].append(row)
        check(ok, f"flash backward disagrees with its plain version or "
                  f"differs between two launches: {dname} {errs} "
                  f"deterministic={deterministic}")
        del q, k, v, do, o, lse, library
    return rows


def infinite_q_rows(torch, causal, rows, gen, grad=False):
    """q, k, v (and dO) of shape (2, 130, 4, 64) f32: every key's first
    component negative and each (b, t, h) of ``rows`` a query (+inf, 0,
    ..., 0), whose every score is inf * (negative) + 0 = -inf."""
    ts = [torch.randn(2, 130, 4, 64, device="cuda", generator=gen)
          for _ in range(4 if grad else 3)]
    ts[1][..., 0] = -ts[1][..., 0].abs() - 0.5
    for b, t, h in rows:
        ts[0][b, t, h] = 0.0
        ts[0][b, t, h, 0] = float("inf")
    return ts


def check_flash_infinite_rows(torch):
    """The f32 flash kernels on rows with an infinite q element, held to
    the JAX kernels' answers (their blocks run the guarded split): the
    forward gives each such row O = 0 and lse = -inf, everything finite,
    the other rows within FLASH_TOL_O / FLASH_TOL_LSE; on the forward's
    output the backward gives those rows dQ = 0, dQ and dV finite and
    within FLASH_BWD_TOL of the plain version, and dK NaN exactly where
    the plain version's is (that row's dS = 0 times the infinity). The
    backward's rows lie in the last query tile, which every key tile
    visits under causal masking too."""
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_bwd,
        _reference_flash_fwd,
        flash_bwd,
        flash_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(29)
    out = []
    for causal in (True, False):
        empty = [(0, 5, 1), (1, 129, 3)]
        q, k, v = infinite_q_rows(torch, causal, empty, gen)
        o, lse = flash_fwd(q, k, v, causal)
        ro, rlse = _reference_flash_fwd(q, k, v, causal)
        keep = torch.ones(o.shape[:3], dtype=torch.bool, device="cuda")
        rows_ok = True
        for b, t, h in empty:
            rows_ok &= bool((o[b, t, h] == 0).all()) and \
                float(lse[b, h, t, 0]) == float("-inf")
            keep[b, t, h] = False
        err_o = float((o - ro).abs()[keep].max())
        lkeep = keep.transpose(1, 2).unsqueeze(-1)
        err_lse = float((lse - rlse).abs()[lkeep].max())
        fwd_ok = (rows_ok and bool(torch.isfinite(o).all())
                  and err_o <= FLASH_TOL_O and err_lse <= FLASH_TOL_LSE)

        last = [(0, 128, 1), (1, 129, 3)]
        q, k, v, do = infinite_q_rows(torch, causal, last, gen, grad=True)
        o, lse = flash_fwd(q, k, v, causal)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal)
        rdq, rdk, rdv = _reference_flash_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        zero_rows = all(bool((dq[b, t, h] == 0).all()) for b, t, h in last)
        nan_where = torch.equal(torch.isnan(dk), torch.isnan(rdk)) and \
            bool(torch.isnan(rdk).any()) and not bool(torch.isinf(dk).any())
        fin = torch.isfinite(rdk)
        errs = {}
        for name, a, r in (("dq", dq, rdq), ("dv", dv, rdv),
                           ("dk", dk[fin], rdk[fin])):
            tol = FLASH_BWD_TOL * max(1.0, float(r.abs().max()))
            errs[name] = (float((a - r).abs().max()), tol)
        bwd_ok = (zero_rows and nan_where and bool(torch.isfinite(dq).all())
                  and bool(torch.isfinite(dv).all())
                  and all(e <= t for e, t in errs.values()))
        row = {"causal": causal, "fwd_rows_zero_and_lse_neg_inf": rows_ok,
               "fwd_err_o": err_o, "fwd_err_lse": err_lse,
               "bwd_dq_rows_zero": zero_rows,
               "bwd_dk_nan_where_plain": nan_where, "bwd_errs": errs,
               "ok": fwd_ok and bwd_ok}
        log(f"flash f32 infinite q element {row}")
        check(row["ok"], f"flash kernels on an infinite q element: {row}")
        out.append(row)
    return out


def check_layernorm_bwd(torch, F):
    from distkeras_tpu_torch.ops.fused_layernorm import (
        _reference_layer_norm_bwd,
        layernorm_bwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(19)
    for (n, d), dtype in [
        ((8, 512), torch.float32), ((4096, 512), torch.float32),
        ((4096, 512), torch.bfloat16), ((3, 96), torch.float32),
        ((37, 510), torch.float32),
    ]:
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (2 * n * d * isz)))
        sets = [tuple((torch.randn(n, d, device="cuda", generator=gen) * 2
                       + 0.5).to(dtype) for _ in range(2))
                for _ in range(nsets)]
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        x, dy = sets[0]
        dx, dg, db = layernorm_bwd(x, g, dy, 1e-5)
        rdx, rdg, rdb = _reference_layer_norm_bwd(x, g, dy, 1e-5)
        again = layernorm_bwd(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        ex = (dx.float() - rdx.float()).abs()
        if dtype == torch.float32:
            ok = float(ex.max()) <= LN_BWD_TOL_DX
        else:
            ok = bool((ex <= LN_TOL_BF16 + LN_TOL_BF16 * rdx.float().abs()).all())
        egb = [float((a - r).abs().max()) / max(1e-30, float(r.abs().max()))
               for a, r in ((dg, rdg), (db, rdb))]
        deterministic = torch.equal(again[1], dg) and torch.equal(again[2], db)
        ok = ok and max(egb) <= LN_BWD_TOL_DGB and deterministic
        nxt = rotating(sets)
        library, lib_stream = backward_call(
            torch,
            lambda a, b_, c: F.layer_norm(a, (d,), b_, c, 1e-5),
            (x.detach().clone().requires_grad_(),
             g.to(dtype).requires_grad_(),
             torch.zeros(d, device="cuda", dtype=dtype, requires_grad=True)),
            dy,
        )

        def kernel_call():
            xx, dd = nxt()
            return layernorm_bwd(xx, g, dd, 1e-5)

        def plain_call():
            xx, dd = nxt()
            return _reference_layer_norm_bwd(xx, g, dd, 1e-5)

        times = timings(kernel_call, plain_call, library, lib_stream)
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        bound_ms, bound_by = bound(3 * n * d * isz + 3 * d * 4, 16 * n * d,
                                   dname)
        row = {
            "shape": [n, d], "dtype": dname,
            "max_abs_err": float(ex.max()), "dgamma_dbeta_rel_err": egb,
            "deterministic": deterministic, "ok": ok, **times,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"layernorm_bwd {row}")
        check(ok, f"layernorm_bwd disagrees with its plain version: {row}")
        rows.append(row)
    return rows


# ------------------------------------------------------------- phases 3, 4


def detach_hooks(model):
    from distkeras_tpu_torch.models.layers import LayerNorm
    from distkeras_tpu_torch.models.sequential import walk_layers
    from distkeras_tpu_torch.parallel.ring_attention import (
        detach_ring_attention,
    )

    detach_ring_attention(model)
    for layer in walk_layers(model):
        if isinstance(layer, LayerNorm):
            layer.norm_fn = None


def forward(torch, model, seqs):
    with torch.no_grad():
        return model(torch.as_tensor(seqs, device="cuda")).float()


def run_predict(torch, np, lm):
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.engine import ServingEngine
    from distkeras_tpu_torch.serving.scheduler import EngineStoppedError

    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8).start()
    try:
        check(not eng.health()["generate_enabled"],
              "hooked model must be predict-only")
        try:
            eng.submit(np.arange(4), 4)
            raise SmokeFailure("generate was not refused on a hooked model")
        except EngineStoppedError:
            pass
        x = np.random.default_rng(3).integers(0, 8192, (8, 512)).astype(np.int32)
        eng.predict(x[:1], timeout=600)  # the batcher thread's first GEMMs
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        y = eng.predict(x, timeout=600)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
    finally:
        eng.stop()
    check(y.shape == (8, 512, 8192) and np.isfinite(y).all(),
          f"predict output malformed: {y.shape}")
    check({k: n for k, n in counts.items() if n}
          == {"layernorm_fwd": 17, "flash_fwd": 8},
          f"predict did not run through the kernels: {counts}")
    detach_hooks(lm)
    plain = forward(torch, lm, x).cpu().numpy()
    err = float(np.abs(y - plain).max())
    log(f"predict: 8x512 in {secs:.3f} s, launches {counts}, "
        f"max |kernel - plain| logits {err:.3e}")
    check(err <= LOGIT_TOL, f"predict logits disagree with the plain path: {err}")
    return {"seconds": secs, "launches": counts, "max_abs_err": err}


def run_generate(torch, np, lm):
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving.engine import ServingEngine

    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(16):
        prompt = rng.integers(0, 8192, int(rng.integers(16, 257))).astype(np.int32)
        n_new = int(rng.integers(32, 65))
        sampling = None
        if i % 4 == 3:  # 4 sampled, 2 of them filtered
            sampling = {"temperature": 0.8, "seed": 100 + i}
            if i >= 8:
                sampling.update(top_k=50, top_p=0.9)
        reqs.append((prompt, n_new, sampling))
    eng = ServingEngine(lm, num_slots=8).start()
    try:
        eng._stepper.warmup()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        handles = [eng.submit(p, n, sampling=s) for p, n, s in reqs]
        outs = [eng.wait(h, timeout=600) for h in handles]
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        replay = [
            eng.generate(p, n, sampling=s, timeout=600)
            for p, n, s in reqs if s is not None
        ]
        stats = eng.stats()
    finally:
        eng.stop()
    n_tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, reqs))
    check(all(len(o) == len(p) + n for o, (p, n, _) in zip(outs, reqs)),
          "a request did not finish with its max_new_tokens")
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"generate did not run through the LN kernel alone: {counts}")
    sampled = [o for o, (_, _, s) in zip(outs, reqs) if s is not None]
    check(all((a == b).all() for a, b in zip(sampled, replay)),
          "sampled requests did not replay identically")
    # teacher-forced logits on the kernel path vs the plain path, and every
    # greedy token = argmax (or a tie within LOGIT_TOL)
    greedy = [(o, p, n) for o, (p, n, s) in zip(outs, reqs) if s is None]
    worst_err, worst_gap = 0.0, 0.0
    kernel_logits = []
    for o, p, n in greedy:
        kernel_logits.append(forward(torch, lm, o[None])[0].cpu().numpy())
    detach_hooks(lm)
    for (o, p, n), kl in zip(greedy, kernel_logits):
        pl = forward(torch, lm, o[None])[0].cpu().numpy()
        worst_err = max(worst_err, float(np.abs(kl - pl).max()))
        gen_pos = np.arange(len(p) - 1, len(o) - 1)
        chosen = kl[gen_pos, o[gen_pos + 1]]
        worst_gap = max(worst_gap, float((kl[gen_pos].max(-1) - chosen).max()))
    check(worst_err <= LOGIT_TOL,
          f"teacher-forced logits disagree kernel vs plain: {worst_err}")
    check(worst_gap <= LOGIT_TOL,
          f"a greedy token is not the argmax of its logits (gap {worst_gap})")
    attach_fused_layernorm(lm)
    solo = CachedSequenceGenerator(lm)
    agree = total = 0
    for o, p, n in greedy:
        s = solo.generate(p[None], n)[0]
        agree += int((s[len(p):] == o[len(p):]).sum())
        total += n
    res = {
        "requests": len(reqs), "tokens": n_tokens, "seconds": secs,
        "tokens_per_s": n_tokens / secs, "launches": counts,
        "teacher_forced_max_abs_err": worst_err,
        "max_argmax_gap": worst_gap,
        "solo_token_agreement": agree / total,
        "steps": stats["steps"], "prefill_chunks": stats["prefill_chunks"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
    }
    log(f"generate: {res}")
    return res, reqs, outs


# ------------------------------------------------------------------ phase 5


def make_lm(zoo):
    return zoo.transformer_lm(vocab_size=8192, seq_len=512, d_model=512,
                              num_heads=8, depth=8, seed=0)


def train_once(torch, lm, optimizer, ds):
    from distkeras_tpu_torch.trainers import SingleTrainer

    trainer = SingleTrainer(
        lm, optimizer, "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8, window=4,
        learning_rate=1e-3, seed=0, device_resident=True,
    )
    t0 = time.monotonic()
    result = trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    return trainer, result, time.monotonic() - t0


def run_train(torch, np, zoo):
    """SingleTrainer on the kernel path, then on the plain path."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    check(len(ds) == 8 * TRAIN_STEPS, f"corpus windows: {len(ds)}")
    lm = make_lm(zoo)
    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    kernels.reset_launch_counts()
    trainer, result, secs = train_once(torch, lm, "pallas_adam", ds)
    counts = kernels.launch_counts()
    hist = trainer.get_history()
    unchanged = all(torch.equal(before[k], v)
                    for k, v in lm.state_dict().items())
    del lm, before, result
    plain_lm = make_lm(zoo)
    kernels.reset_launch_counts()
    plain_trainer, plain_result, plain_secs = train_once(
        torch, plain_lm, "adam", ds)
    plain_counts = kernels.launch_counts()
    plain_hist = plain_trainer.get_history()
    del plain_lm, plain_result
    torch.cuda.empty_cache()

    per_step = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "adam_fused": 1}
    expected = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    losses = [r["loss"] for r in hist]
    plain_losses = [r["loss"] for r in plain_hist]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    windows = trainer.history.get_timings()
    steady = windows[1:]  # the first window pays cuBLAS/allocator warm-up
    steady_sps = sum(n for n, _ in steady) / sum(t for _, t in steady)
    res = {
        "steps": len(hist), "seconds": secs, "plain_seconds": plain_secs,
        "samples_per_s": trainer.history.samples_per_second(),
        "tokens_per_s": trainer.history.samples_per_second() * 512,
        "steady_samples_per_s": steady_sps,
        "steady_tokens_per_s": steady_sps * 512,
        "plain_samples_per_s": plain_trainer.history.samples_per_second(),
        "window_seconds": [t for _, t in windows],
        "first_loss": losses[0], "last_loss": losses[-1],
        "first_accuracy": hist[0]["next_token_accuracy"],
        "last_accuracy": hist[-1]["next_token_accuracy"],
        "max_rel_loss_diff_vs_plain": rel,
        "adam_table_builds": trainer.optimizer._tables.builds,
        "adam_grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        "launches": counts,
        "plain_launches": plain_counts, "caller_unchanged": unchanged,
        "losses": losses, "plain_losses": plain_losses,
    }
    log(f"train: { {k: v for k, v in res.items() if 'losses' not in k} }")
    check(len(hist) == TRAIN_STEPS and len(plain_hist) == TRAIN_STEPS,
          f"expected {TRAIN_STEPS} steps, got {len(hist)}, {len(plain_hist)}")
    check(all(np.isfinite(losses)) and all(np.isfinite(plain_losses)),
          f"a loss is not finite: {losses} {plain_losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(rel <= TRAIN_LOSS_RTOL,
          f"kernel-path losses differ from the plain path by {rel:.3e}")
    check(unchanged, "train() changed the caller's model")
    launched = {k: n for k, n in counts.items() if n}
    check(launched == expected,
          f"training did not run through the kernels: {launched} != {expected}")
    check(set(plain_counts.values()) == {0},
          f"the plain path launched a kernel: {plain_counts}")
    return res


# ------------------------------------------------------------ phases 6a, 6b


def async_runs():
    """Phase 6a's runs: (trainer, kernel-path optimizer, plain-path
    optimizer, learning rate, the fused SGD kernel expected per step)."""
    from functools import partial

    from distkeras_tpu_torch.ops.optimizers import Sgd
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD

    def fused(nesterov):
        return partial(FusedSGD, momentum=0.9, nesterov=nesterov)

    def plain(nesterov):
        return partial(Sgd, momentum=0.9, nesterov=nesterov)

    return [
        ("DOWNPOUR", "pallas_sgd", "sgd", ASYNC_LR, "sgd_fused"),
        ("ADAG", "pallas_sgd", "sgd", ASYNC_LR, "sgd_fused"),
        ("DynSGD", fused(False), plain(False), ASYNC_LR_MOMENTUM,
         "sgd_momentum_fused"),
        ("AEASGD", fused(True), plain(True), ASYNC_LR_MOMENTUM,
         "sgd_momentum_fused"),
        # EAMSGD installs its own "sgd" with Nesterov momentum 0.9
        ("EAMSGD", "sgd", "sgd", ASYNC_LR_MOMENTUM, None),
    ]


def train_async(torch, zoo, name, optimizer, lr, ds, hooked, mode, **kw):
    """One async trainer run on a fresh d512/L8 model (seed 0), the kernel
    path (flash + LN hooks) or the plain one (``kw`` adds trainer options);
    the launch counts are set to 0 just before ``train`` and read just
    after it. Returns the trainer,
    the initial center, the seconds of ``train``, the counts and, in
    threads mode, the seconds from the threads' start to their join (after
    the warm-up window; None otherwise)."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = make_lm(zoo)
    if hooked:
        check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
        check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    start = dict(zip(lm._leaf_order(), lm.get_weights()))
    trainer = getattr(dk, name)(
        lm, optimizer, "next_token_crossentropy",
        metrics=["next_token_accuracy"], learning_rate=lr, batch_size=8,
        num_epoch=1, num_workers=2, communication_window=4, mode=mode,
        device_resident=True, seed=0, **kw,
    )
    spans = []
    run_threads = trainer._run_threads

    def timed_threads(*args):
        t = time.monotonic()
        run_threads(*args)
        torch.cuda.synchronize()
        spans.append(time.monotonic() - t)

    trainer._run_threads = timed_threads
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    trainer.train(ds, shuffle=True)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = kernels.launch_counts()
    return trainer, start, secs, counts, (spans[0] if spans else None)


def async_step_launches(steps, sgd_kernel):
    """The launches ``steps`` async training steps of the hooked model
    must make."""
    per_step = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    if sgd_kernel is not None:
        per_step[sgd_kernel] = 1
    return {k: steps * n for k, n in per_step.items()}


def window_split(np, workers):
    """Mean pull / window / commit host seconds over every worker's
    windows."""
    return {key: float(np.mean([s[key] for w in workers for s in w.splits]))
            for key in ("pull", "window", "commit")}


def run_async_simulated(torch, np, zoo, ds):
    """Phase 6a: each async trainer in simulated mode on the kernel path,
    then on the plain path (no hooks, ``sgd`` at the same momentum).
    Returns the results and the kernel path's final centers (phase 10c
    holds its socket runs to them)."""
    out, centers = {}, {}
    for name, kopt, popt, lr, sgd_kernel in async_runs():
        runs = {}
        for path, hooked, opt in (("kernel", True, kopt),
                                  ("plain", False, popt)):
            trainer, start, secs, counts, _ = train_async(
                torch, zoo, name, opt, lr, ds, hooked, "simulated")
            ps = trainer.parameter_server
            runs[path] = {
                "losses": [r["loss"] for r in trainer.get_history()],
                "center": ps.get_params(), "num_updates": ps.num_updates,
                "tag": ps.pull()[1], "failures": trainer.failures,
                "counts": counts, "seconds": secs,
                "optimizer": type(trainer.optimizer).__name__,
                "split": window_split(np, trainer.workers),
            }
            del trainer
            torch.cuda.empty_cache()
        k, p = runs["kernel"], runs["plain"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
        center_err = max(float(np.abs(k["center"][n] - p["center"][n]).max())
                         for n in start)
        moved = max(float(np.abs(p["center"][n] - start[n]).max())
                    for n in start)
        expected = async_step_launches(ASYNC_STEPS, sgd_kernel)
        launched = {c: n for c, n in k["counts"].items() if n}
        res = {
            "learning_rate": lr, "optimizer": k["optimizer"],
            "plain_optimizer": p["optimizer"], "steps": len(k["losses"]),
            "num_updates": k["num_updates"], "max_rel_loss_diff": rel,
            "center_max_abs_err": center_err, "center_max_moved": moved,
            "launches": launched, "seconds": k["seconds"],
            "plain_seconds": p["seconds"], "first_loss": k["losses"][0],
            "last_loss": k["losses"][-1], "losses": k["losses"],
            "plain_losses": p["losses"], "window_split_s": k["split"],
        }
        log(f"async {name}: { {a: b for a, b in res.items() if 'losses' not in a} }")
        check(len(k["losses"]) == len(p["losses"]) == ASYNC_STEPS,
              f"{name}: expected {ASYNC_STEPS} steps per path")
        check(all(np.isfinite(k["losses"] + p["losses"])),
              f"{name}: a loss is not finite")
        check(k["failures"] == [] == p["failures"],
              f"{name}: worker failures {k['failures']} {p['failures']}")
        check(k["num_updates"] == p["num_updates"] == ASYNC_COMMITS,
              f"{name}: num_updates {k['num_updates']} / {p['num_updates']}")
        if name == "DynSGD":
            check(k["tag"] == k["num_updates"] and p["tag"] == p["num_updates"],
                  f"DynSGD version != num_updates: {k['tag']}, {p['tag']}")
        check(rel <= TRAIN_LOSS_RTOL,
              f"{name}: kernel-path losses differ from the plain path by {rel}")
        check(center_err <= ASYNC_CENTER_TOL,
              f"{name}: final centers differ by {center_err}")
        check(launched == expected,
              f"{name} did not run through the kernels: {launched} != {expected}")
        check(set(p["counts"].values()) == {0},
              f"{name}: the plain path launched a kernel: {p['counts']}")
        if name == "DOWNPOUR":
            # each worker's last window against its first
            ls = np.array(k["losses"]).reshape(2, 2, 4).mean(-1)
            check((ls[:, -1] < ls[:, 0]).all(),
                  f"DOWNPOUR's loss did not fall: {k['losses']}")
        out[name] = res
        centers[name] = k["center"]
    return out, centers


def run_async_threads(torch, np, zoo, ds):
    """Phase 6b: DOWNPOUR + pallas_sgd with 2 worker threads on the card:
    both commit, nothing fails, exact launches (the warm-up window
    included), one B1 table per worker; tokens/s, the per-window host
    split and the device idle share (a second run under the profiler)."""
    trainer, _, secs, counts, span = train_async(
        torch, zoo, "DOWNPOUR", "pallas_sgd", ASYNC_LR, ds, True, "threads")
    ps = trainer.parameter_server
    workers = trainer.workers
    expected = async_step_launches(ASYNC_STEPS + 4, "sgd_fused")
    launched = {c: n for c, n in counts.items() if n}
    splits = window_split(np, workers)
    tokens = ASYNC_STEPS * 8 * 512
    res = {
        "seconds": secs, "tokens_per_s": tokens / secs,
        "threads_seconds": span, "threads_tokens_per_s": tokens / span,
        "commits": {w.worker_id: len(w.splits) for w in workers},
        "num_updates": ps.num_updates, "failures": trainer.failures,
        "table_builds": trainer.optimizer._tables.builds,
        "grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        "window_split_s": splits, "launches": launched,
        "losses": [r["loss"] for r in trainer.get_history()],
    }
    del trainer, workers
    torch.cuda.empty_cache()
    log(f"async threads: {res}")
    check(res["failures"] == [], f"worker failures: {res['failures']}")
    check(all(n > 0 for n in res["commits"].values())
          and len(res["commits"]) == 2, f"a worker did not commit: {res}")
    check(res["num_updates"] == ASYNC_COMMITS,
          f"num_updates {res['num_updates']} != {ASYNC_COMMITS}")
    check(launched == expected,
          f"threads run did not run through the kernels: {launched} != "
          f"{expected}")
    check(res["table_builds"] == 2,
          f"B1 tables built {res['table_builds']} times for 2 workers")
    check(all(np.isfinite(res["losses"])), "a loss is not finite")
    prof = device_profile(torch, lambda: train_async(
        torch, zoo, "DOWNPOUR", "pallas_sgd", ASYNC_LR, ds, True,
        "threads"), 1)
    res["device"] = prof
    if prof["device_ms"] is not None:
        busy = prof["device_ms"] / 1e3
        copies = prof["device_ms_by_category"].get("memcpy", 0.0) / 1e3
        res["device_idle_share"] = 1 - busy / secs
        res["compute_idle_share"] = 1 - (busy - copies) / secs
    log(f"async threads device: idle {res.get('device_idle_share')}, "
        f"kernels-only idle {res.get('compute_idle_share')}, "
        f"{ {k: v for k, v in prof.items() if k != 'top_kernels'} }")
    return res


# ------------------------------------------------------------------ phase 7


#: BASELINE configs 2-5 as ``benchmarks.py`` defines them at smoke scale
#: (``_cfg2``-``_cfg5``, ``_mnist_data``/``_higgs_data``/``_cifar_data``/
#: ``_imagenet_data``): trainer, zoo function and arguments, data recipe,
#: worker optimizer (the kernel path's), learning rate, batch size,
#: workers, extra trainer arguments and the compute dtype ``_shared``
#: gives an accelerator.
BASELINE = (
    {"id": 2, "trainer": "DOWNPOUR", "model": ("mnist_cnn", {}),
     "data": "mnist", "optimizer": "adam", "lr": 2.5e-4, "batch": 32,
     "workers": 8, "extra": {}, "dtype": "bfloat16"},
    {"id": 3, "trainer": "AEASGD", "model": ("higgs_mlp", {}),
     "data": "higgs", "optimizer": "sgd", "lr": 0.02, "batch": 64,
     "workers": 4, "extra": {"rho": 10.0}, "dtype": None},
    {"id": 4, "trainer": "ADAG", "model": ("cifar10_cnn",
                                           {"bn_momentum": 0.9}),
     "data": "cifar", "optimizer": "sgd", "lr": 0.05, "batch": 32,
     "workers": 4, "extra": {}, "dtype": "bfloat16"},
    {"id": 5, "trainer": "DynSGD", "model": ("resnet18", {
        "num_classes": 10, "input_shape": (64, 64, 3), "bn_momentum": 0.9}),
     "data": "imagenet", "optimizer": "adam", "lr": 1e-3, "batch": 32,
     "workers": 4, "extra": {}, "dtype": "bfloat16"},
)
BASELINE_LOSS_RTOL = 1e-3  # kernel vs plain path, per step
BASELINE_CENTER_TOL = 1e-4  # final centers, absolute
BASELINE_STATE_TOL = 1e-4  # aggregated BatchNorm buffers, absolute


def baseline_data(kind):
    """(train, test, post-transformers) of one config, the port's loaders
    and transformers with ``benchmarks.py``'s smoke-scale arguments."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        LabelIndexTransformer,
        MinMaxTransformer,
        OneHotTransformer,
    )

    classes, post = 10, []
    if kind == "mnist":
        ds = loaders.synthetic_mnist(
            n=2048, seed=0, flat=False, spatial=True, protos_per_class=4,
            label_noise=0.1, noise=1.2)
    elif kind == "higgs":
        ds, classes = loaders.synthetic_higgs(n=4096, seed=1), 2
    elif kind == "cifar":
        ds = loaders.synthetic_cifar10(n=2048, seed=2, protos_per_class=3,
                                       label_noise=0.1)
    else:
        ds = loaders.synthetic_imagenet(n=768, num_classes=10, size=64,
                                        seed=3, label_noise=0.1)
        post = [LabelIndexTransformer(10)]
    if kind != "higgs":
        ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = OneHotTransformer(classes, output_col="label_onehot").transform(ds)
    train, test = ds.split(0.9, seed=7)
    return train, test, post


def plain_adam(lr):
    """The plain path's optimizer for the Adam configs: B3's plain version
    (``adam_step_plain``, plain PyTorch ops on the card) behind the
    fused-apply protocol. ``"adam"`` (optax's operation order) rounds the
    update differently from B3 on 1-4% of the elements per step, and
    these networks carry that to 2e-3 of the loss within an epoch, so it
    is run beside the two paths and its distance printed, not held to
    the bars."""
    import torch

    from distkeras_tpu_torch.ops.pallas_kernels import (
        FusedAdam,
        adam_step_plain,
    )

    class PlainFusedAdam(FusedAdam):
        def fused_apply(self, params, grads, state):
            ms, vs, step = state
            with torch.no_grad():
                adam_step_plain(params, grads, ms, vs, step,
                                self.learning_rate, self.b1, self.b2,
                                self.eps)
            return params, state

    return PlainFusedAdam(lr)


def baseline_trainer(cfg, optimizer, num_epoch=1, device=None,
                     mode="simulated", **kw):
    """One config's trainer on a fresh model (seed 0): window 4, simulated
    mode unless ``mode`` says otherwise, ``num_epoch`` epochs; ``kw`` adds
    trainer options."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import zoo

    name, model_kw = cfg["model"]
    model = getattr(zoo, name)(seed=0, device=device, **model_kw)
    return getattr(dk, cfg["trainer"])(
        model, optimizer, "categorical_crossentropy",
        learning_rate=cfg["lr"], batch_size=cfg["batch"],
        num_epoch=num_epoch, num_workers=cfg["workers"],
        communication_window=4, mode=mode, label_col="label_onehot",
        compute_dtype=cfg["dtype"], seed=0, device=device, **cfg["extra"],
        **kw,
    )


def train_baseline(torch, cfg, optimizer, train, **kw):
    """One config's trainer on a fresh model (seed 0) over one shuffled
    epoch (``kw`` adds trainer options); the launch counts are set to 0
    just before ``train`` and read just after. Returns the trainer, the
    result model, the seconds and the counts."""
    from distkeras_tpu_torch import kernels

    trainer = baseline_trainer(cfg, optimizer, **kw)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    result = trainer.train(train, shuffle=True)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    return trainer, result, secs, kernels.launch_counts()


def warm_baseline(torch, cfg, train):
    """One untimed window of the config's model in training mode (cuDNN
    and cuBLAS load their kernels for these shapes), so that neither
    timed path pays the first use."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.optimizers import Sgd
    from distkeras_tpu_torch.utils.rng import RngSeq
    from distkeras_tpu_torch.workers import (
        WorkerCore,
        iter_windows,
        stack_window,
    )

    name, kw = cfg["model"]
    model = getattr(zoo, name)(seed=0, **kw)
    core = WorkerCore(model, Sgd(cfg["lr"]), "categorical_crossentropy",
                      compute_dtype=cfg["dtype"])
    cols = ["features", "label_onehot"]
    batches = next(iter_windows(train, cfg["batch"], cols, 4))
    xs, ys = (torch.from_numpy(a).cuda()
              for a in stack_window(batches, *cols))
    core.window(model, core.init_opt_state(list(model.parameters())),
                RngSeq(0), xs, ys)
    torch.cuda.synchronize()


def baseline_accuracy(model, test, post):
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.predictors import ModelPredictor

    pred = ModelPredictor(model, batch_size=256).predict(test)
    for t in post:
        pred = t.transform(pred)
    return AccuracyEvaluator(
        label_col="label",
        **({"prediction_col": "prediction_index"} if post else {}),
    ).evaluate(pred)


def run_distance(np, a, b):
    """Largest per-step relative loss difference, center difference and
    aggregated-buffer difference between two runs of one config."""
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    cen = max(float(np.abs(a["center"][n] - b["center"][n]).max())
              for n in b["center"])
    st = max((float(np.abs(a["buffers"][n] - b["buffers"][n]).max())
              for n in b["buffers"]), default=0.0)
    return rel, cen, st


def run_baseline(torch, np, smi):
    """Phase 7: BASELINE configs 2-5 through the async trainers, each on
    the kernel path (``pallas_adam``/``pallas_sgd``) and on the plain path
    (B3's plain version / ``sgd``) from the same seed, cuDNN
    deterministic. Per-step losses within 1e-3 relative, centers and the
    aggregated BatchNorm buffers within 1e-4, equal update counts, no
    worker failure, one B3/B1 launch per step on the kernel path and none
    on the plain one. The Adam configs also run ``"adam"``, whose distance
    is printed."""
    kernel_name = {"adam": "adam_fused", "sgd": "sgd_fused"}
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches, centers = {}, {}, {}
    try:
        for cfg in BASELINE:
            train, test, post = baseline_data(cfg["data"])
            warm_baseline(torch, cfg, train)
            opt = cfg["optimizer"]
            paths = [("kernel", f"pallas_{opt}"),
                     ("plain", plain_adam(cfg["lr"]) if opt == "adam"
                      else "sgd")]
            if opt == "adam":
                paths.append(("adam", "adam"))
            runs = {}
            for path, optimizer in paths:
                trainer, result, secs, counts = train_baseline(
                    torch, cfg, optimizer, train)
                ps = trainer.parameter_server
                workers = trainer.workers
                runs[path] = {
                    "losses": [r["loss"] for r in trainer.get_history()],
                    "center": ps.get_params(), "num_updates": ps.num_updates,
                    "failures": trainer.failures, "counts": counts,
                    "seconds": secs,
                    "samples_per_s": trainer.history.samples_per_second(),
                    "buffers": {n: b.detach().cpu().numpy() for n, b in
                                result.named_buffers()},
                    "split": window_split(np, workers),
                    "accuracy": baseline_accuracy(result, test, post),
                }
                del trainer, result, workers, ps
                torch.cuda.empty_cache()
            k, p = runs["kernel"], runs["plain"]
            rel, cen, st = run_distance(np, k, p)
            steps = len(k["losses"])
            kname = kernel_name[opt]
            expected = {kname: steps}
            launched = {c: n for c, n in k["counts"].items() if n}
            res = {
                "trainer": cfg["trainer"], "model": cfg["model"][0],
                "optimizer": f"pallas_{opt}", "compute_dtype": cfg["dtype"],
                "workers": cfg["workers"], "steps": steps,
                "num_updates": k["num_updates"], "max_rel_loss_diff": rel,
                "center_max_abs_err": cen, "buffers_max_abs_err": st,
                "buffers": len(k["buffers"]), "launches": launched,
                "seconds": k["seconds"], "plain_seconds": p["seconds"],
                "samples_per_s": k["samples_per_s"],
                "plain_samples_per_s": p["samples_per_s"],
                "window_split_s": k["split"], "accuracy": k["accuracy"],
                "plain_accuracy": p["accuracy"],
                "first_loss": k["losses"][0], "last_loss": k["losses"][-1],
                "losses": k["losses"], "plain_losses": p["losses"],
            }
            if "adam" in runs:
                a_rel, a_cen, a_st = run_distance(np, k, runs["adam"])
                res["vs_adam"] = {
                    "max_rel_loss_diff": a_rel, "center_max_abs_err": a_cen,
                    "buffers_max_abs_err": a_st,
                    "accuracy": runs["adam"]["accuracy"]}
            log(f"baseline config {cfg['id']}: "
                f"{ {a: b for a, b in res.items() if 'losses' not in a} }")
            log(f"baseline config {cfg['id']} ({cfg['trainer']} / "
                f"{cfg['model'][0]}): {res['samples_per_s']:.1f} samples/s, "
                f"window split {res['window_split_s']}, held-out accuracy "
                f"{res['accuracy']:.4f} on {smi}")
            tag = f"config {cfg['id']}"
            check(all(len(r["losses"]) == steps for r in runs.values())
                  and steps > 0, f"{tag}: step counts differ")
            check(all(np.isfinite(r["losses"]).all() for r in runs.values()),
                  f"{tag}: a loss is not finite")
            check(all(r["failures"] == [] for r in runs.values()),
                  f"{tag}: worker failures")
            check(len({r["num_updates"] for r in runs.values()}) == 1,
                  f"{tag}: update counts differ")
            check(rel <= BASELINE_LOSS_RTOL,
                  f"{tag}: kernel-path losses differ from the plain path "
                  f"by {rel}")
            check(cen <= BASELINE_CENTER_TOL,
                  f"{tag}: final centers differ by {cen}")
            check(st <= BASELINE_STATE_TOL,
                  f"{tag}: aggregated BatchNorm buffers differ by {st}")
            check(launched == expected,
                  f"{tag} did not run through {kname} once per step: "
                  f"{launched} != {expected}")
            check(all(set(r["counts"].values()) == {0}
                      for path, r in runs.items() if path != "kernel"),
                  f"{tag}: the plain path launched a kernel")
            out[f"config{cfg['id']}"] = res
            centers[cfg["id"]] = k["center"]
            for c, n in launched.items():
                launches[c] = launches.get(c, 0) + n
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches, centers


# ------------------------------------------------------------------ phase 8


#: what each of the resumed LM epoch's kernels is called in a profiler
#: trace (its ``__global__`` function)
TRACE_KERNELS = {"layernorm_fwd": "ln_fwd_", "layernorm_bwd": "ln_bwd_",
                 "flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                 "adam_fused": "adam_fused_kernel"}
LM_STEP_LAUNCHES = {"layernorm_fwd": 17, "layernorm_bwd": 17, "flash_fwd": 8,
                    "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "adam_fused": 1}
RESUME_CONFIGS = (3, 5)  # phase 8b: AEASGD/higgs_mlp, DynSGD/resnet18


def lm_trainer(zoo, num_epoch, make=None, device=None, **kw):
    """Phase 5's trainer (``pallas_adam``, batch 8, window 4, lr 1e-3,
    seed 0, device-resident) over ``num_epoch`` epochs, on a fresh
    d512/L8 model (``make(zoo)``) with the flash and LayerNorm hooks."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.trainers import SingleTrainer

    lm = (make or make_lm)(zoo)
    attach_flash_attention(lm)
    attach_fused_layernorm(lm)
    return SingleTrainer(
        lm, "pallas_adam", "next_token_crossentropy",
        metrics=["next_token_accuracy"], batch_size=8, window=4,
        learning_rate=1e-3, seed=0, device_resident=True,
        num_epoch=num_epoch, device=device, **kw,
    )


def state_copy(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def max_distance(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.values(), b.values()))


def timed(record, fn):
    """``fn`` with the seconds of each call appended to ``record``."""
    def call(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        record.append(time.monotonic() - t0)
        return out
    return call


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def nondeterministic_ops(torch, trainer, ds):
    """The ops PyTorch itself flags as nondeterministic on one epoch of
    ``trainer`` (``use_deterministic_algorithms(warn_only=True)``)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train(ds, shuffle=True)
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def trace_kernel_names(prof_dir):
    """The device kernels named in the Chrome trace(s) under ``prof_dir``."""
    names = set()
    for name in os.listdir(prof_dir):
        with open(os.path.join(prof_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        names.update(e.get("name", "") for e in events
                     if str(e.get("cat", "")).lower() == "kernel")
    return names


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_resume_lm(torch, np, zoo, ds, make=None, device=None):
    """Phase 8a: the LM trainer checkpointed after epoch 1 and resumed to
    epoch 2 in a new trainer (with ``metrics_path`` and ``profile_dir``),
    against two uninterrupted 2-epoch runs."""
    import shutil
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.utils.checkpoint import Checkpointer
    from distkeras_tpu_torch.utils.profiling import read_metrics

    steps = len(ds) // 8
    tmp = tempfile.mkdtemp(prefix="dkt_resume_lm_")
    try:
        full = []
        for _ in range(2):
            result = lm_trainer(zoo, 2, make, device).train(ds, shuffle=True)
            full.append(state_copy(result))
            del result
        runs_distance = max_distance(full[0], full[1])
        ck = os.path.join(tmp, "ck")
        first = lm_trainer(zoo, 1, make, device, checkpoint_dir=ck)
        save_s = []
        first.checkpointer.save = timed(save_s, first.checkpointer.save)
        first.train(ds, shuffle=True)
        sync(torch)
        ck_bytes = dir_bytes(ck)
        del first
        metrics, prof = os.path.join(tmp, "m.jsonl"), os.path.join(tmp, "prof")
        resumed = lm_trainer(zoo, 2, make, device, checkpoint_dir=ck,
                             metrics_path=metrics, profile_dir=prof)
        restore_s = []
        resumed._restore_latest = timed(restore_s, resumed._restore_latest)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        result = resumed.train(ds, shuffle=True, resume=True)
        sync(torch)
        secs = time.monotonic() - t0
        counts = kernels.launch_counts()
        got = state_copy(result)
        rows = read_metrics(metrics)
        traced = trace_kernel_names(prof) if device is None else None
        steps_ck = Checkpointer(ck).all_steps()
        hist = resumed.get_history()
        del result, resumed
        res = {
            "runs_distance": runs_distance,
            "resumed_distance": [max_distance(got, f) for f in full],
            "checkpoint_bytes": ck_bytes, "save_seconds": save_s,
            "restore_seconds": restore_s, "resumed_seconds": secs,
            "resumed_steps": len(hist), "checkpoint_steps": steps_ck,
            "launches": counts, "metrics_rows": [r["event"] for r in rows],
        }
        if runs_distance > 0:
            res["nondeterministic_ops"] = nondeterministic_ops(
                torch, lm_trainer(zoo, 1, make, device), ds)
        del full, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"resume lm: {res}")
    expected = {k: steps * n for k, n in LM_STEP_LAUNCHES.items()}
    launched = {k: n for k, n in counts.items() if n}
    check(res["resumed_steps"] == steps,
          f"the resumed run trained {res['resumed_steps']} steps, not {steps}")
    if runs_distance == 0:
        check(res["resumed_distance"] == [0.0, 0.0],
              "the resumed run is not bit-identical to the uninterrupted "
              f"ones: {res['resumed_distance']}")
    else:
        check(max(res["resumed_distance"]) <= runs_distance,
              f"the resumed run is {res['resumed_distance']} from the "
              f"uninterrupted ones, which are {runs_distance} apart "
              f"(nondeterministic: {res['nondeterministic_ops']})")
    check(launched == expected,
          f"the resumed epoch did not run through the kernels: {launched} "
          f"!= {expected}")
    check(res["metrics_rows"] == ["train_end"]
          and rows[0]["num_updates"] == steps,
          f"metrics rows: {res['metrics_rows']}")
    check(steps_ck == [1, 2], f"checkpoints {steps_ck}")
    if traced is not None:
        missing = [k for k, sub in TRACE_KERNELS.items()
                   if not any(sub in n for n in traced)]
        check(not missing, f"the profiler trace does not name {missing}")
    return res


def run_resume_baseline(torch, np, cfg, train, device=None):
    """Phase 8b for one BASELINE config: one epoch on the kernel path with
    ``checkpoint_dir``, then resumed to two epochs on the kernel path and,
    from a copy of the same checkpoint, on the plain path."""
    import shutil
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.utils.checkpoint import Checkpointer

    opt = cfg["optimizer"]
    kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
    plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
    tag = f"resume config {cfg['id']}"
    tmp = tempfile.mkdtemp(prefix="dkt_resume_cfg_")
    try:
        ck = os.path.join(tmp, "ck")
        first = baseline_trainer(cfg, f"pallas_{opt}", 1, device,
                                 checkpoint_dir=ck)
        save_s = []
        first.checkpointer.save = timed(save_s, first.checkpointer.save)
        kernels.reset_launch_counts()
        first.train(train, shuffle=True)
        sync(torch)
        first_counts = kernels.launch_counts()
        ck_bytes = dir_bytes(ck)
        ps = first.parameter_server
        n1, steps1 = ps.num_updates, len(first.get_history())
        # the checkpoint holds the first run's end state, bit for bit
        _, trees, meta = Checkpointer(ck).restore()
        center = ps.get_params()
        center_equal = all(np.array_equal(trees["center"][n], center[n])
                           for n in center)
        replicas_equal = buffers_equal = True
        for w in first.workers:
            snap = trees["workers"][str(w.worker_id)]
            replicas_equal &= int(snap["seq"]) == w._seq and all(
                np.array_equal(snap["params"][n], p.detach().cpu().numpy())
                for n, p in zip(w._names, w._params))
            buffers_equal &= all(
                np.array_equal(snap["state"][n], b.detach().cpu().numpy())
                for n, b in w._model.named_buffers())
        n_buffers = len(dict(first.workers[0]._model.named_buffers()))
        saved_version = meta["ps_meta"].get("version")
        del first, ps, trees
        shutil.copytree(ck, os.path.join(tmp, "ck_plain"))
        runs = {}
        for path, optimizer, d in (("kernel", f"pallas_{opt}", ck),
                                   ("plain", plain,
                                    os.path.join(tmp, "ck_plain"))):
            t = baseline_trainer(cfg, optimizer, 2, device, checkpoint_dir=d)
            restore_s = []
            t._restore_latest = timed(restore_s, t._restore_latest)
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            result = t.train(train, shuffle=True, resume=True)
            sync(torch)
            secs = time.monotonic() - t0
            ps = t.parameter_server
            runs[path] = {
                "counts": kernels.launch_counts(), "seconds": secs,
                "restore_seconds": restore_s,
                "losses": [r["loss"] for r in t.get_history()],
                "num_updates": ps.num_updates,
                "num_duplicates": ps.num_duplicates,
                "version": ps._meta.get("version"),
                "start_seqs": [w._start_seq for w in t.workers],
                "restored": all(w._restore_point is not None
                                for w in t.workers),
                "failures": t.failures, "center": ps.get_params(),
                "buffers": {n: b.detach().cpu().numpy()
                            for n, b in result.named_buffers()},
            }
            del t, result, ps
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k, p = runs["kernel"], runs["plain"]
    rel, cen, st = run_distance(np, k, p)
    res = {
        "trainer": cfg["trainer"], "model": cfg["model"][0],
        "first_updates": n1, "first_steps": steps1,
        "checkpoint_bytes": ck_bytes, "save_seconds": save_s,
        "first_launches": {c: n for c, n in first_counts.items() if n},
        "center_roundtrip_bit_equal": center_equal,
        "replicas_roundtrip_bit_equal": replicas_equal,
        "buffers_roundtrip_bit_equal": buffers_equal, "buffers": n_buffers,
        "saved_version": saved_version,
        **{f"{path}_{key}": r[key] for path, r in runs.items()
           for key in ("num_updates", "num_duplicates", "version",
                       "start_seqs", "restored", "seconds",
                       "restore_seconds")},
        "resumed_steps": len(k["losses"]),
        "launches": {c: n for c, n in k["counts"].items() if n},
        "plain_launches": {c: n for c, n in p["counts"].items() if n},
        "max_rel_loss_diff": rel, "center_max_abs_err": cen,
        "buffers_max_abs_err": st,
    }
    log(f"{tag}: {res}")
    check(first_counts == {**{c: 0 for c in first_counts}, kname: steps1},
          f"{tag}: the first epoch did not launch {kname} once per step")
    check(center_equal and replicas_equal and buffers_equal,
          f"{tag}: the checkpoint does not round-trip bit for bit")
    for path, r in runs.items():
        check(r["num_updates"] == 2 * n1 and r["num_duplicates"] == 0,
              f"{tag} ({path}): {r['num_updates']} updates after the "
              f"resume, not exactly twice {n1}")
        check(r["restored"] and all(s > 0 for s in r["start_seqs"]),
              f"{tag} ({path}): workers not restored: {r['start_seqs']}")
        check(r["failures"] == [], f"{tag} ({path}): {r['failures']}")
        if cfg["trainer"] == "DynSGD":
            check(saved_version == n1 and r["version"] == 2 * n1,
                  f"{tag} ({path}): DynSGD version {saved_version} -> "
                  f"{r['version']}, not {n1} -> {2 * n1}")
    check(len(k["losses"]) == len(p["losses"]) > 0,
          f"{tag}: resumed step counts differ")
    check(res["launches"] == {kname: len(k["losses"])},
          f"{tag}: the resumed kernel path did not launch {kname} once per "
          f"step: {res['launches']}")
    check(res["plain_launches"] == {},
          f"{tag}: the plain path launched {res['plain_launches']}")
    check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
          and st <= BASELINE_STATE_TOL,
          f"{tag}: kernel and plain resumes differ: losses {rel}, center "
          f"{cen}, buffers {st}")
    return res


def run_resume(torch, np, zoo, ds):
    """Phase 8: 8a (the LM) and 8b (configs 3 and 5, cuDNN
    deterministic); returns the results and the launches of the resumed
    runs on the kernel path."""
    lm = run_resume_lm(torch, np, zoo, ds)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"lm": lm}
    try:
        for cfg in BASELINE:
            if cfg["id"] in RESUME_CONFIGS:
                train, _, _ = baseline_data(cfg["data"])
                out[f"config{cfg['id']}"] = run_resume_baseline(
                    torch, np, cfg, train)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    launches = {}
    for r in out.values():
        for c, n in r["launches"].items():
            launches[c] = launches.get(c, 0) + n
    return out, launches


# ------------------------------------------------------------------ phase 9


#: vmapped vs threaded member training, per step and on the weights: the
#: phase 7 bars (the two paths run the same per-member arithmetic; the
#: Averaging mean sums in another order on the host than on the card)
MEMBER_LOSS_RTOL = 1e-3
MEMBER_WEIGHT_TOL = 1e-4
#: phase 9b's runs: (trainer, config whose model/data/optimizer it takes,
#: member count, epochs)
MEMBER_RUNS = (("EnsembleTrainer", 2, 4, 1), ("AveragingTrainer", 3, 4, 2))


def stream_prep(chunk):
    """Config 5's preprocessing per loaded shard (``StreamingDataset.map``):
    the phase 7 transformers on the chunk's uint8 pixels."""
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(Dataset(chunk))
    ds = OneHotTransformer(10, output_col="label_onehot").transform(ds)
    return {k: ds[k] for k in ds.columns}


def write_config5_shards(np, out_dir, shards=4):
    """Config 5's smoke training rows (phase 7's split of
    ``synthetic_imagenet`` 64 x 64, 768 rows) written with ``ShardWriter``
    as ``examples/imagenet_resnet.py`` writes them: uint8 pixels, one
    shard per chunk."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.streaming import ShardWriter

    raw = loaders.synthetic_imagenet(n=768, num_classes=10, size=64, seed=3,
                                     label_noise=0.1)
    train, _ = raw.split(0.9, seed=7)
    bounds = np.linspace(0, len(train), shards + 1).astype(int)
    with ShardWriter(out_dir) as writer:
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            writer.add({"features": train["features"][lo:hi].astype(np.uint8),
                        "label": train["label"][lo:hi]})
    return len(train)


def path_runs(torch, np, make, paths):
    """Run ``make(optimizer)`` -> (trainer, train thunk) on each
    (path, optimizer); the launch counts set to 0 just before each train
    and read just after."""
    from distkeras_tpu_torch import kernels

    runs = {}
    for path, optimizer in paths:
        trainer, go = make(optimizer)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        result = go()
        sync(torch)
        runs[path] = {
            "trainer": trainer, "result": result,
            "seconds": time.monotonic() - t0,
            "counts": {c: n for c, n in kernels.launch_counts().items()
                       if n},
            "samples_per_s": trainer.history.samples_per_second(),
        }
    return runs


def add_counts(total, counts):
    """Add one run's launch counts into ``total``."""
    for c, n in counts.items():
        total[c] = total.get(c, 0) + n
    return total


def model_state(result):
    """(weights by leaf-order name, buffers) of a trained model."""
    return ({n: w for n, w in zip(result._leaf_order(), result.get_weights())},
            {n: b.detach().cpu().numpy() for n, b in result.named_buffers()})


def history_distance(np, a, b, members=1):
    """Largest per-step relative loss difference, member by member."""
    worst = 0.0
    for i in range(members):
        ha = [r["loss"] for r in a.get_history(i if members > 1 else None)]
        hb = [r["loss"] for r in b.get_history(i if members > 1 else None)]
        check(len(ha) == len(hb) > 0, "step counts differ between paths")
        worst = max(worst, max(abs(x - y) / abs(y) for x, y in zip(ha, hb)))
    return worst


def models_distance(np, a, b):
    """Largest weight and buffer difference over lists of models."""
    wd = bd = 0.0
    for x, y in zip(a, b, strict=True):
        (wx, bx), (wy, by) = model_state(x), model_state(y)
        wd = max(wd, max(float(np.abs(wx[n] - wy[n]).max()) for n in wy))
        bd = max([bd] + [float(np.abs(bx[n] - by[n]).max()) for n in by])
    return wd, bd


def run_streaming(torch, np, smi, phase7):
    """9a: config 5 from shards (DynSGD/``resnet18``, kernel and plain
    path, phase 7's bars), the same shards through ``SingleTrainer`` with
    prefetch 2 and 0 (bit-identical), and config 6 through the native CSV
    reader."""
    import shutil
    import tempfile

    from distkeras_tpu_torch.data import native
    from distkeras_tpu_torch.data.streaming import open_shards

    cfg = next(c for c in BASELINE if c["id"] == 5)
    tmp = tempfile.mkdtemp(prefix="dkt_shards_")
    out = {}
    try:
        rows = write_config5_shards(np, tmp)
        stream = open_shards(tmp).map(stream_prep)
        check(len(stream) == rows and len(stream._paths) == 4,
              f"config 5 shards: {len(stream)} rows in "
              f"{len(stream._paths)} shards")

        def dynsgd(optimizer):
            t = baseline_trainer(cfg, optimizer)
            return t, lambda: t.train(stream, shuffle=True)

        runs = path_runs(torch, np, dynsgd,
                         (("kernel", "pallas_adam"),
                          ("plain", plain_adam(cfg["lr"]))))
        k, p = runs["kernel"], runs["plain"]
        kt, pt = k["trainer"], p["trainer"]
        steps = len(kt.get_history())
        rel = history_distance(np, kt, pt)
        (kw, kb), (pw, pb) = model_state(k["result"]), model_state(p["result"])
        cen = max(float(np.abs(kw[n] - pw[n]).max()) for n in pw)
        st = max(float(np.abs(kb[n] - pb[n]).max()) for n in pb)
        res = {
            "shards": 4, "rows": rows, "steps": steps,
            "num_updates": kt.parameter_server.num_updates,
            "max_rel_loss_diff": rel, "center_max_abs_err": cen,
            "buffers_max_abs_err": st, "launches": k["counts"],
            "samples_per_s": k["samples_per_s"],
            "plain_samples_per_s": p["samples_per_s"],
            "in_memory_samples_per_s": phase7["samples_per_s"],
            "seconds": k["seconds"],
        }
        log(f"stream config 5: {res}")
        log(f"stream config 5 (DynSGD / resnet18 from 4 shards): "
            f"{res['samples_per_s']:.1f} samples/s streamed against "
            f"{res['in_memory_samples_per_s']:.1f} in memory (phase 7) on "
            f"{smi}")
        check(kt.failures == [] and pt.failures == [],
              "stream config 5: worker failures")
        check(kt.parameter_server.num_updates
              == pt.parameter_server.num_updates == 8,
              "stream config 5: not 8 commits on both paths")
        check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
              and st <= BASELINE_STATE_TOL,
              f"stream config 5: kernel and plain paths differ: losses "
              f"{rel}, center {cen}, buffers {st}")
        check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
              f"stream config 5: launches {k['counts']} / {p['counts']}")
        out["config5"] = res
        launches = dict(k["counts"])

        # the same shards through SingleTrainer's prefetcher
        from distkeras_tpu_torch.models import zoo
        from distkeras_tpu_torch.trainers import SingleTrainer

        def single(prefetch):
            name, kw = cfg["model"]
            t = SingleTrainer(
                getattr(zoo, name)(seed=0, **kw), "pallas_adam",
                "categorical_crossentropy", learning_rate=cfg["lr"],
                batch_size=cfg["batch"], window=4, prefetch=prefetch,
                label_col="label_onehot", compute_dtype=cfg["dtype"], seed=0)
            return t, lambda: t.train(stream, shuffle=True)

        runs = path_runs(torch, np, single, (("prefetch2", 2),
                                             ("prefetch0", 0)))
        a, b = runs["prefetch2"], runs["prefetch0"]
        wd, bd = models_distance(np, [a["result"]], [b["result"]])
        sres = {"steps": len(a["trainer"].get_history()),
                "launches": a["counts"], "samples_per_s": a["samples_per_s"],
                "prefetch0_samples_per_s": b["samples_per_s"],
                "weights_max_abs_err": wd, "buffers_max_abs_err": bd}
        log(f"stream single trainer: {sres}")
        check(wd == 0 and bd == 0 and a["counts"] == b["counts"]
              == {"adam_fused": sres["steps"]},
              f"stream single trainer: prefetch 2 and 0 differ: {sres}")
        out["single_prefetch"] = sres
        add_counts(launches, a["counts"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # config 6: the real digits through the native reader
    import csv as csvmod

    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.data.transformers import (
        MinMaxTransformer,
        OneHotTransformer,
    )

    check(native.available(), "the native data library did not build")
    path = os.path.join(HERE, "distkeras_tpu_torch", "data", "digits.csv")
    t0 = time.monotonic()
    parsed, had_header = native.read_csv(path)
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    with open(path, newline="") as f:
        reader = csvmod.reader(f)
        next(reader)
        python = np.asarray([[float(v) for v in row] for row in reader],
                            np.float32)
    python_s = time.monotonic() - t0
    check(had_header and parsed.dtype == python.dtype
          and np.array_equal(parsed, python),
          "digits.csv: the native parse differs from the csv module's")
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=16)(loaders.digits(flat=True))
    ds = OneHotTransformer(10, output_col="label_onehot")(ds)
    train, test = ds.split(0.9, seed=7)

    def digits(optimizer):
        from distkeras_tpu_torch.models import zoo
        from distkeras_tpu_torch.trainers import SingleTrainer

        t = SingleTrainer(zoo.digits_mlp(seed=0), optimizer,
                          "categorical_crossentropy", learning_rate=1e-3,
                          batch_size=32, label_col="label_onehot", seed=0)
        return t, lambda: t.train(train, shuffle=True)

    runs = path_runs(torch, np, digits, (("kernel", "pallas_adam"),
                                         ("plain", plain_adam(1e-3))))
    k, p = runs["kernel"], runs["plain"]
    steps = len(k["trainer"].get_history())
    rel = history_distance(np, k["trainer"], p["trainer"])
    wd, _ = models_distance(np, [k["result"]], [p["result"]])
    dres = {"rows": int(parsed.shape[0]), "native_parse_s": native_s,
            "csv_module_parse_s": python_s, "steps": steps,
            "launches": k["counts"], "max_rel_loss_diff": rel,
            "weights_max_abs_err": wd,
            "accuracy": baseline_accuracy(k["result"], test, []),
            "samples_per_s": k["samples_per_s"]}
    log(f"config 6 (digits_mlp, native CSV): {dres} on {smi}")
    check(rel <= BASELINE_LOSS_RTOL and wd <= BASELINE_CENTER_TOL,
          f"config 6: kernel and plain paths differ: {rel}, {wd}")
    check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
          f"config 6: launches {k['counts']} / {p['counts']}")
    out["config6"] = dres
    return out, add_counts(launches, k["counts"])


def member_trainer(cfg, cls_name, members, epochs, optimizer, vmapped,
                   **kw):
    """A member trainer over config ``cfg``'s model (seed 0), optimizer
    settings, batch and compute dtype, window 4."""
    import distkeras_tpu_torch as dk
    from distkeras_tpu_torch.models import zoo

    name, model_kw = cfg["model"]
    count = ("num_models" if cls_name == "EnsembleTrainer"
             else "num_workers")
    return getattr(dk, cls_name)(
        getattr(zoo, name)(seed=0, **model_kw), optimizer,
        "categorical_crossentropy", learning_rate=cfg["lr"],
        batch_size=cfg["batch"], num_epoch=epochs, window=4,
        label_col="label_onehot", compute_dtype=cfg["dtype"], seed=0,
        vmapped=vmapped, **{count: members}, **kw)


def run_members(torch, np, smi):
    """9b: ``EnsembleTrainer`` (config 2's ``mnist_cnn``, ``pallas_adam``)
    and ``AveragingTrainer`` (config 3's ``higgs_mlp``, ``pallas_sgd``),
    each threaded and vmapped, each on the kernel and the plain path."""
    out, launches = {}, {}
    for cls_name, cfg_id, members, epochs in MEMBER_RUNS:
        cfg = next(c for c in BASELINE if c["id"] == cfg_id)
        train, _, _ = baseline_data(cfg["data"])
        opt = cfg["optimizer"]
        kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
        plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
        runs = {}
        for mode, vmapped in (("threaded", False), ("vmapped", True)):
            def make(optimizer, vmapped=vmapped):
                t = member_trainer(cfg, cls_name, members, epochs, optimizer,
                                   vmapped)
                return t, lambda: t.train(train, shuffle=True)

            for path, r in path_runs(torch, np, make,
                                     (("kernel", f"pallas_{opt}"),
                                      ("plain", plain))).items():
                runs[f"{mode}_{path}"] = r
        ensemble = cls_name == "EnsembleTrainer"

        def models(r):
            return r["result"] if ensemble else [r["result"]]

        steps = len(runs["vmapped_kernel"]["trainer"].get_history(0))
        res = {"trainer": cls_name, "model": cfg["model"][0],
               "members": members, "epochs": epochs, "optimizer":
               f"pallas_{opt}", "steps_per_member": steps}
        for a, b, tag in (("threaded_kernel", "threaded_plain", "threaded"),
                          ("vmapped_kernel", "vmapped_plain", "vmapped"),
                          ("vmapped_kernel", "threaded_kernel",
                           "vmapped_vs_threaded")):
            rel = history_distance(np, runs[a]["trainer"], runs[b]["trainer"],
                                   members)
            wd, bd = models_distance(np, models(runs[a]), models(runs[b]))
            res[tag] = {"max_rel_loss_diff": rel, "weights_max_abs_err": wd,
                        "buffers_max_abs_err": bd}
            check(rel <= MEMBER_LOSS_RTOL and wd <= MEMBER_WEIGHT_TOL
                  and bd <= BASELINE_STATE_TOL,
                  f"{cls_name} {tag}: losses {rel}, weights {wd}, "
                  f"buffers {bd}")
        for name, r in runs.items():
            res[f"{name}_samples_per_s"] = r["samples_per_s"]
            res[f"{name}_seconds"] = r["seconds"]
            res[f"{name}_launches"] = r["counts"]
        expected = {"vmapped_kernel": {kname: steps},
                    "threaded_kernel": {kname: members * steps},
                    "vmapped_plain": {}, "threaded_plain": {}}
        for name, want in expected.items():
            check(runs[name]["counts"] == want,
                  f"{cls_name} {name}: launches {runs[name]['counts']} != "
                  f"{want}")
        log(f"members {cls_name}: {res}")
        log(f"members {cls_name} ({members} x {cfg['model'][0]}): vmapped "
            f"{res['vmapped_kernel_samples_per_s']:.1f} samples/s, threaded "
            f"{res['threaded_kernel_samples_per_s']:.1f} on {smi}")
        out[cls_name] = res
        for name in ("vmapped_kernel", "threaded_kernel"):
            add_counts(launches, runs[name]["counts"])
        del runs
        torch.cuda.empty_cache()
    return out, launches


def run_member_lm(torch, np, zoo, ds, smi):
    """9c: ``EnsembleTrainer(vmapped=True)``, 2 d512/L8 members with the
    flash and LayerNorm hooks and ``pallas_adam``, batch 8 x 512, one
    window of 4 joint steps, against the same run with no hooks and B3's
    plain version."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.trainers import EnsembleTrainer

    data = ds.take(64)  # 2 members x 4 batches of 8

    def make(optimizer):
        lm = make_lm(zoo)
        if optimizer == "pallas_adam":
            attach_flash_attention(lm)
            attach_fused_layernorm(lm)
        t = EnsembleTrainer(
            lm, optimizer, "next_token_crossentropy",
            metrics=["next_token_accuracy"], batch_size=8, window=4,
            num_models=2, vmapped=True, learning_rate=1e-3, seed=0)
        return t, lambda: t.train(data)

    runs = path_runs(torch, np, make, (("kernel", "pallas_adam"),
                                       ("plain", plain_adam(1e-3))))
    k, p = runs["kernel"], runs["plain"]
    rel = history_distance(np, k["trainer"], p["trainer"], 2)
    steps = len(k["trainer"].get_history(0))
    expected = {c: 2 * steps * n for c, n in LM_STEP_LAUNCHES.items()}
    expected["adam_fused"] = steps
    losses = [r["loss"] for r in k["trainer"].get_history()]
    # the joint windows' own time (the train() wall above also holds the
    # two members' builds): per member dt / 2, so the sum is the joint time
    window_s = sum(dt for _, dt in k["trainer"].history.get_timings())
    res = {"members": 2, "steps_per_member": steps,
           "window_seconds": window_s,
           "window_tokens_per_s": 2 * steps * 8 * 512 / window_s,
           "max_rel_loss_diff": rel, "launches": k["counts"],
           "plain_launches": p["counts"], "seconds": k["seconds"],
           "plain_seconds": p["seconds"],
           "tokens_per_s": k["samples_per_s"] * 512,
           "plain_tokens_per_s": p["samples_per_s"] * 512,
           "losses": losses}
    log(f"member LM: {res} on {smi}")
    check(steps == 4 and np.isfinite(losses).all(),
          f"member LM: {steps} steps, losses {losses}")
    check(rel <= TRAIN_LOSS_RTOL,
          f"member LM: kernel and plain paths differ by {rel}")
    check(k["counts"] == expected and p["counts"] == {},
          f"member LM: launches {k['counts']} != {expected} (plain "
          f"{p['counts']})")
    del runs
    torch.cuda.empty_cache()
    return res, dict(k["counts"])


def payload_bytes(tree):
    """Bytes of the arrays in a (nested) commit payload."""
    if isinstance(tree, dict):
        return sum(payload_bytes(v) for v in tree.values())
    import numpy as np

    return int(np.asarray(tree).nbytes)


def counting_commits(ps_cls, record):
    """Patch ``ps_cls.commit`` to add each payload's bytes to ``record``;
    returns the original for restoring."""
    orig = ps_cls.commit

    def commit(self, delta, *args, **kw):
        record.append(payload_bytes(delta))
        return orig(self, delta, *args, **kw)

    ps_cls.commit = commit
    return orig


#: phase 9d: (config, compression options)
COMPRESSED = ((2, {"compress": "int8", "pull_compress": "bfloat16"}),
              (3, {"compress": "topk:0.05"}))


def run_compressed(torch, np, smi):
    """9d: configs 2 and 3 with compressed commits (and config 2 with bf16
    pulls) in simulated mode, kernel and plain path, beside the
    uncompressed kernel run's commit bytes; then config 2's compressed
    checkpoint and resume."""
    from distkeras_tpu_torch.parameter_servers import ParameterServer

    out, launches = {}, {}
    for cfg_id, comp in COMPRESSED:
        cfg = next(c for c in BASELINE if c["id"] == cfg_id)
        train, _, _ = baseline_data(cfg["data"])
        opt = cfg["optimizer"]
        kname = {"adam": "adam_fused", "sgd": "sgd_fused"}[opt]
        plain = plain_adam(cfg["lr"]) if opt == "adam" else "sgd"
        sizes = {}

        def make(spec):
            path, optimizer, kw = spec
            t = baseline_trainer(cfg, optimizer, **kw)
            record = sizes.setdefault(path, [])

            def go():
                orig = counting_commits(ParameterServer, record)
                try:
                    return t.train(train, shuffle=True)
                finally:
                    ParameterServer.commit = orig
            return t, go

        specs = (("kernel", ("kernel", f"pallas_{opt}", comp)),
                 ("plain", ("plain", plain, comp)),
                 ("raw", ("raw", f"pallas_{opt}", {})))
        runs = path_runs(torch, np, make, specs)
        k, p, r = runs["kernel"], runs["plain"], runs["raw"]
        rel = history_distance(np, k["trainer"], p["trainer"])
        (kw, kb), (pw, pb) = model_state(k["result"]), model_state(p["result"])
        cen = max(float(np.abs(kw[n] - pw[n]).max()) for n in pw)
        st = max([0.0] + [float(np.abs(kb[n] - pb[n]).max()) for n in pb])
        raw_rel = history_distance(np, k["trainer"], r["trainer"])
        steps = len(k["trainer"].get_history())
        commits = k["trainer"].parameter_server.num_updates
        res = {"trainer": cfg["trainer"], "model": cfg["model"][0], **comp,
               "steps": steps, "num_updates": commits,
               "max_rel_loss_diff": rel, "center_max_abs_err": cen,
               "buffers_max_abs_err": st,
               "commit_bytes_per_window": float(np.mean(sizes["kernel"])),
               "raw_commit_bytes_per_window": float(np.mean(sizes["raw"])),
               "vs_uncompressed_max_rel_loss_diff": raw_rel,
               "launches": k["counts"], "samples_per_s": k["samples_per_s"],
               "raw_samples_per_s": r["samples_per_s"],
               "last_loss": k["trainer"].get_history()[-1]["loss"],
               "raw_last_loss": r["trainer"].get_history()[-1]["loss"]}
        res["commit_bytes_ratio"] = (res["raw_commit_bytes_per_window"]
                                     / res["commit_bytes_per_window"])
        log(f"compressed config {cfg_id}: {res}")
        log(f"compressed config {cfg_id} ({comp}): "
            f"{res['commit_bytes_per_window']:.0f} commit bytes per window "
            f"against {res['raw_commit_bytes_per_window']:.0f} uncompressed "
            f"({res['commit_bytes_ratio']:.2f}x fewer) on {smi}")
        tag = f"compressed config {cfg_id}"
        check(all(x["trainer"].failures == [] for x in runs.values()),
              f"{tag}: worker failures")
        check(len(sizes["kernel"]) == len(sizes["plain"]) == commits
              == p["trainer"].parameter_server.num_updates > 0,
              f"{tag}: commit counts differ")
        check(rel <= BASELINE_LOSS_RTOL and cen <= BASELINE_CENTER_TOL
              and st <= BASELINE_STATE_TOL,
              f"{tag}: kernel and plain paths differ: losses {rel}, center "
              f"{cen}, buffers {st}")
        check(k["counts"] == {kname: steps} and p["counts"] == {},
              f"{tag}: launches {k['counts']} / {p['counts']}")
        check(res["commit_bytes_ratio"] > (3.0 if comp["compress"] == "int8"
                                           else 4.0),
              f"{tag}: commits only {res['commit_bytes_ratio']:.2f}x "
              "smaller")
        out[f"config{cfg_id}"] = res
        for run in (k, r):
            add_counts(launches, run["counts"])
        del runs
        torch.cuda.empty_cache()
    resume, resume_launches = run_compressed_resume(torch, np)
    out["resume"] = resume
    return out, add_counts(launches, resume_launches)


def run_compressed_resume(torch, np):
    """9d's checkpoint: config 2 compressed, one epoch with
    ``checkpoint_dir`` — every worker's ``q_residual`` in the checkpoint,
    bit-equal to the live one — then resumed to two epochs on the kernel
    and, from a copy, the plain path under phase 8b's contract (twice the
    commits, every worker restored with its residual, the two resumes
    within phase 7's bars). Then the same with one worker, whose simulated
    schedule is the same resumed or not: the resumed run must be
    bit-identical to an uninterrupted two-epoch run."""
    import shutil
    import tempfile

    from distkeras_tpu_torch.utils.checkpoint import Checkpointer

    cfg = next(c for c in BASELINE if c["id"] == 2)
    comp = dict(COMPRESSED)[2]
    train, _, _ = baseline_data(cfg["data"])
    plain = plain_adam(cfg["lr"])
    tag = "compressed resume config 2"
    tmp = tempfile.mkdtemp(prefix="dkt_resume_q8_")
    try:
        ck = os.path.join(tmp, "ck")
        first = baseline_trainer(cfg, "pallas_adam", 1, checkpoint_dir=ck,
                                 **comp)
        first.train(train, shuffle=True)
        sync(torch)
        n1 = first.parameter_server.num_updates
        _, trees, _ = Checkpointer(ck).restore()
        residuals_equal = all(
            set(trees["workers"][str(w.worker_id)]["q_residual"])
            == set(w._q_residual) and all(
                np.array_equal(
                    trees["workers"][str(w.worker_id)]["q_residual"][n], v)
                for n, v in w._q_residual.items())
            for w in first.workers)
        nonzero = all(any(np.abs(v).max() > 0 for v in w._q_residual.values())
                      for w in first.workers)
        del first, trees
        shutil.copytree(ck, os.path.join(tmp, "ck_plain"))

        def resumed(spec):
            optimizer, d = spec
            t = baseline_trainer(cfg, optimizer, 2, checkpoint_dir=d, **comp)
            return t, lambda: t.train(train, shuffle=True, resume=True)

        runs = path_runs(torch, np, resumed,
                         (("kernel", ("pallas_adam", ck)),
                          ("plain", (plain, os.path.join(tmp, "ck_plain")))))
        k, p = runs["kernel"], runs["plain"]
        rel = history_distance(np, k["trainer"], p["trainer"])
        wd, bd = models_distance(np, [k["result"]], [p["result"]])
        steps = len(k["trainer"].get_history())

        # one worker: resumed against uninterrupted, bit for bit
        one = {**cfg, "workers": 1}
        whole = baseline_trainer(one, "pallas_adam", 2, **comp)
        a = whole.train(train, shuffle=True)
        ck1 = os.path.join(tmp, "one")
        baseline_trainer(one, "pallas_adam", 1, checkpoint_dir=ck1,
                         **comp).train(train, shuffle=True)
        again = baseline_trainer(one, "pallas_adam", 2, checkpoint_dir=ck1,
                                 **comp)
        b = again.train(train, shuffle=True, resume=True)
        sync(torch)
        one_w, one_b = models_distance(np, [a], [b])
        tail = [r["loss"] for r in whole.get_history()]
        tail = tail[len(tail) - len(again.get_history()):]
        one_losses_equal = tail == [r["loss"] for r in again.get_history()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"first_updates": n1, "residuals_roundtrip_bit_equal":
           residuals_equal, "residuals_nonzero": nonzero,
           "resumed_steps": steps,
           **{f"{path}_{key}": val for path, r in runs.items()
              for key, val in (
                  ("num_updates", r["trainer"].parameter_server.num_updates),
                  ("num_duplicates",
                   r["trainer"].parameter_server.num_duplicates),
                  ("restored", all(w._restore_point is not None
                                   and w._start_seq > 0
                                   and w._q_residual is not None
                                   for w in r["trainer"].workers)))},
           "launches": k["counts"], "plain_launches": p["counts"],
           "max_rel_loss_diff": rel, "weights_max_abs_err": wd,
           "buffers_max_abs_err": bd,
           "one_worker_resumed_vs_uninterrupted": {
               "losses_equal": one_losses_equal, "weights_max_abs_err": one_w,
               "buffers_max_abs_err": one_b,
               "resumed_steps": len(again.get_history())}}
    log(f"{tag}: {res}")
    check(residuals_equal and nonzero,
          f"{tag}: the checkpoint does not carry every worker's residual")
    for path, r in runs.items():
        ps = r["trainer"].parameter_server
        check(ps.num_updates == 2 * n1 and ps.num_duplicates == 0,
              f"{tag} ({path}): {ps.num_updates} updates, not 2 x {n1}")
        check(res[f"{path}_restored"] and r["trainer"].failures == [],
              f"{tag} ({path}): workers not restored with their residual")
    check(rel <= BASELINE_LOSS_RTOL and wd <= BASELINE_CENTER_TOL
          and bd <= BASELINE_STATE_TOL,
          f"{tag}: kernel and plain resumes differ: {rel}, {wd}, {bd}")
    check(k["counts"] == {"adam_fused": steps} and p["counts"] == {},
          f"{tag}: launches {k['counts']} / {p['counts']}")
    check(one_losses_equal and one_w == 0 and one_b == 0,
          f"{tag}: one worker's resumed run is not bit-identical to the "
          f"uninterrupted one: {res['one_worker_resumed_vs_uninterrupted']}")
    return res, dict(k["counts"])


def run_phase9(torch, np, zoo, ds, smi, baseline):
    """Phase 9 (9a-9d), cuDNN deterministic as in phases 7 and 8b; returns
    the results and the kernel launches of its main-path runs."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches = {}, {}
    subphases = (
        ("9a", "streaming",
         lambda: run_streaming(torch, np, smi, baseline["config5"])),
        ("9b", "members", lambda: run_members(torch, np, smi)),
        ("9c", "member_lm", lambda: run_member_lm(torch, np, zoo, ds, smi)),
        ("9d", "compressed", lambda: run_compressed(torch, np, smi)),
    )
    try:
        for label, key, fn in subphases:
            t0 = time.monotonic()
            out[key], counts = fn()
            out[key]["seconds_total"] = time.monotonic() - t0
            log(f"phase {label} ({key}) in {out[key]['seconds_total']:.1f} s")
            add_counts(launches, counts)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches


# ----------------------------------------------------------------- phase 10


#: phase 10b's parameter-server process: a port ``SocketParameterServer``
#: over the center in the file argv[1], on a loopback port it prints, until
#: a client sends the stop action (or an hour passes)
PS_PROCESS = """
import sys
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer, SocketParameterServer)
from distkeras_tpu_torch.utils.serialization import load_params
srv = SocketParameterServer(DeltaParameterServer(load_params(sys.argv[1])),
                            host="127.0.0.1")
srv.start()
print(srv.port, flush=True)
srv.ps.stopped.wait(3600)
srv.stop()
"""


def wire_per_op(workers):
    """Bytes per pull and per commit the workers' socket clients moved (both
    directions: action byte, length prefixes, frames, status byte)."""
    out = {}
    for verb in ("pull", "commit"):
        nbytes = sum(w.ps.wire_bytes[verb] for w in workers)
        ops = sum(w.ps.wire_ops[verb] for w in workers)
        out[verb] = nbytes / ops if ops else None
    return out


def centers_equal(np, a, b):
    return a.keys() == b.keys() and all(
        a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]) for n in a)


def run_remote_config2(torch, np, smi, phase7, center7):
    """10a: config 2 as in phase 7's kernel path, with ``remote_ps=True``:
    every pull and commit crosses a loopback socket. The center must be
    phase 7's bit for bit, 16 commits, 56 B3 launches."""
    cfg = next(c for c in BASELINE if c["id"] == 2)
    train, _, _ = baseline_data(cfg["data"])
    trainer, _, secs, counts = train_baseline(
        torch, cfg, "pallas_adam", train, remote_ps=True)
    ps = trainer.parameter_server
    launched = {c: n for c, n in counts.items() if n}
    res = {
        "num_updates": ps.num_updates, "failures": trainer.failures,
        "center_bit_equal_phase7": centers_equal(np, ps.get_params(),
                                                 center7),
        "launches": launched, "seconds": secs,
        "samples_per_s": trainer.history.samples_per_second(),
        "phase7_samples_per_s": phase7["samples_per_s"],
        "wire_bytes_per": wire_per_op(trainer.workers),
        "window_split_s": window_split(np, trainer.workers),
        "phase7_window_split_s": phase7["window_split_s"],
    }
    log(f"remote config 2: {res}")
    log(f"remote config 2: {res['samples_per_s']:.1f} samples/s over the "
        f"socket against {res['phase7_samples_per_s']:.1f} in process "
        f"(phase 7); wire bytes per pull / commit "
        f"{res['wire_bytes_per']['pull']:.0f} / "
        f"{res['wire_bytes_per']['commit']:.0f} on {smi}")
    check(res["failures"] == [], f"10a: worker failures {res['failures']}")
    check(res["num_updates"] == 16, f"10a: {res['num_updates']} commits")
    check(res["center_bit_equal_phase7"],
          "10a: the remote_ps center differs from phase 7's")
    check(launched == {"adam_fused": 56},
          f"10a: launches {launched} != 56 of adam_fused")
    return res, launched


def run_ps_process(torch, np, smi):
    """10b: the parameter server in its own OS process, as dist-keras runs
    it apart from its Spark executors. A second process (CUDA hidden)
    hosts a port ``SocketParameterServer`` over config 2's initial center;
    this process runs one DOWNPOUR worker's windows on the card against it
    through ``RemoteParameterServerClient``. The center read back over the
    wire must be bit for bit the one-worker in-process simulated run's."""
    import select
    import shutil
    import socket
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.parameter_servers import (
        RemoteParameterServerClient,
    )
    from distkeras_tpu_torch.utils.device import local_devices
    from distkeras_tpu_torch.utils.serialization import save_params

    cfg = dict(next(c for c in BASELINE if c["id"] == 2), workers=1)
    train, _, _ = baseline_data(cfg["data"])
    ref = baseline_trainer(cfg, "pallas_adam")
    start = dict(zip(ref.model._leaf_order(), ref.model.get_weights()))
    ref.train(train, shuffle=True)
    want = ref.parameter_server.get_params()
    trainer = baseline_trainer(cfg, "pallas_adam")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    proc = None
    try:
        path = os.path.join(tmp, "center.dkt")
        save_params(path, start)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [HERE] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        proc = subprocess.Popen([sys.executable, "-c", PS_PROCESS, path],
                                stdout=subprocess.PIPE, env=env, cwd=HERE,
                                text=True)
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        check(ready, "10b: the parameter-server process did not start")
        port = int(proc.stdout.readline())
        client = RemoteParameterServerClient("127.0.0.1", port)
        # the trainer's own worker template, its PS the remote client
        trainer.parameter_server = client
        worker = trainer.allocate_worker(trainer._make_core(), 0,
                                         local_devices(trainer.device)[0])
        part = train.shuffle(trainer.seed).partition(1)[0]
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        worker.train(part, trainer.batch_size, num_epoch=1,
                     shuffle_seed=trainer.seed)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = {c: n for c, n in kernels.launch_counts().items() if n}
        got, _ = client.pull()
        res = {
            "center_bit_equal_in_process": centers_equal(np, got, want),
            "commits": len(worker.splits),
            "in_process_commits": ref.parameter_server.num_updates,
            "launches": counts, "seconds": secs,
            "steps": len(worker.records),
            "wire_bytes_per": wire_per_op([worker]),
            "window_split_s": window_split(np, [worker]),
            "ps_pid": proc.pid,
        }
        client.close()
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"s")  # the stop action
        res["ps_exit_code"] = proc.wait(timeout=60)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"ps process config 2: {res}")
    log(f"ps process config 2: one worker on the card, the PS in process "
        f"{res['ps_pid']}: {res['commits']} commits in "
        f"{res['seconds']:.2f} s, window split {res['window_split_s']} "
        f"on {smi}")
    check(res["center_bit_equal_in_process"],
          "10b: the center over the wire differs from the in-process run's")
    check(res["commits"] == res["in_process_commits"] > 0,
          f"10b: {res['commits']} commits against "
          f"{res['in_process_commits']}")
    check(counts == {"adam_fused": res["steps"]},
          f"10b: launches {counts} for {res['steps']} steps")
    check(res["ps_exit_code"] == 0,
          f"10b: the PS process exited with {res['ps_exit_code']}")
    return res, counts


def remote_lm_runs():
    """Phase 10c's socket runs of phase 6a's trainers: (trainer,
    kernel-path optimizer, learning rate, fused SGD kernel, compression
    options)."""
    return [(name, kopt, lr, kname, {})
            for name, kopt, _, lr, kname in async_runs()
            if name in ("DOWNPOUR", "DynSGD")] + [
        ("DOWNPOUR", "pallas_sgd", ASYNC_LR, "sgd_fused",
         {"compress": "int8", "pull_compress": "bfloat16"})]


def wire_breakdown(np, center, reps=3):
    """Host seconds (best of ``reps``) of what one uncompressed pull of
    ``center`` costs on each side of a loopback socket: the in-process
    pull's copy, the DKT1 encode, the loopback transfer of the frame
    (``networking.send_data`` to ``recv_data``) and the decode."""
    import socket
    import threading

    from distkeras_tpu_torch import networking
    from distkeras_tpu_torch.utils.serialization import (
        deserialize_params,
        serialize_params,
    )

    def best(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return min(times), out

    copy_s, _ = best(lambda: {k: np.copy(v) for k, v in center.items()})
    encode_s, blob = best(lambda: serialize_params(center))
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    sender = networking.connect("127.0.0.1", listener.getsockname()[1],
                                timeout=30)
    receiver, _ = listener.accept()
    try:
        def transfer():
            got = {}
            t = threading.Thread(
                target=lambda: got.update(data=networking.recv_data(
                    receiver)))
            t.start()
            networking.send_data(sender, blob)
            t.join(timeout=60)
            return got["data"]

        loopback_s, data = best(transfer)
    finally:
        for sock in (sender, receiver, listener):
            sock.close()
    decode_s, _ = best(lambda: deserialize_params(data))
    return {"bytes": len(blob), "copy": copy_s, "encode": encode_s,
            "loopback": loopback_s, "decode": decode_s}


def run_remote_lm(torch, np, zoo, ds, smi, phase6a, centers6a):
    """10c: phase 6a's hooked d512/L8 DOWNPOUR (B1) and DynSGD (B2) with
    ``remote_ps=True``: centers bit-identical to phase 6a's in-process
    runs, launches exactly 16 x (17, 17, 8, 8, 8) of B7/B8/B4/B5/B6 plus 16
    of B1/B2; then DOWNPOUR with int8 commits and bf16 pulls over the
    socket on the kernel path and on the plain path (no hooks, ``sgd``,
    the same compression), per-step losses within 1e-3 relative of each
    other (the distance to phase 6a's uncompressed plain path, which the
    bf16 pulls move by about bf16's rounding, is printed). Prints wire
    bytes per pull/commit, the window split beside the in-process run's
    and where an uncompressed pull's host time goes."""
    out, launches = {}, {}
    for name, opt, lr, kname, comp in remote_lm_runs():
        key = name + ("_int8_bf16" if comp else "")
        trainer, _, secs, counts, _ = train_async(
            torch, zoo, name, opt, lr, ds, True, "simulated",
            remote_ps=True, **comp)
        ps = trainer.parameter_server
        losses = [r["loss"] for r in trainer.get_history()]
        launched = {c: n for c, n in counts.items() if n}
        ref = phase6a[name]
        res = {
            "num_updates": ps.num_updates, "failures": trainer.failures,
            "steps": len(losses), "launches": launched, "seconds": secs,
            "in_process_seconds": ref["seconds"],
            "wire_bytes_per": wire_per_op(trainer.workers),
            "window_split_s": window_split(np, trainer.workers),
            "in_process_window_split_s": ref["window_split_s"],
        }
        if comp:
            del trainer
            torch.cuda.empty_cache()
            trainer, _, _, pcounts, _ = train_async(
                torch, zoo, name, "sgd", lr, ds, False, "simulated",
                remote_ps=True, **comp)
            plain = [r["loss"] for r in trainer.get_history()]
            res.update(comp)
            res["plain_launches"] = {c: n for c, n in pcounts.items() if n}
            res["max_rel_loss_diff_vs_plain"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, plain))
            res["max_rel_loss_diff_vs_uncompressed_plain"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses,
                                                    ref["plain_losses"]))
        else:
            res["center_bit_equal_phase6a"] = centers_equal(
                np, ps.get_params(), centers6a[name])
            res["losses_equal_phase6a"] = losses == ref["losses"]
        del trainer, ps
        torch.cuda.empty_cache()
        log(f"remote lm {key}: {res}")
        log(f"remote lm {key}: wire bytes per pull / commit "
            f"{res['wire_bytes_per']['pull']:.0f} / "
            f"{res['wire_bytes_per']['commit']:.0f}; window split "
            f"{res['window_split_s']} over the socket against "
            f"{res['in_process_window_split_s']} in process on {smi}")
        tag = f"10c {key}"
        check(res["failures"] == [], f"{tag}: worker failures")
        check(res["num_updates"] == ASYNC_COMMITS
              and res["steps"] == ASYNC_STEPS,
              f"{tag}: {res['num_updates']} commits, {res['steps']} steps")
        check(all(np.isfinite(losses)), f"{tag}: a loss is not finite")
        check(launched == async_step_launches(ASYNC_STEPS, kname),
              f"{tag}: launches {launched}")
        if comp:
            check(res["max_rel_loss_diff_vs_plain"] <= TRAIN_LOSS_RTOL,
                  f"{tag}: losses differ from the plain path by "
                  f"{res['max_rel_loss_diff_vs_plain']}")
            check(res["plain_launches"] == {},
                  f"{tag}: the plain path launched {res['plain_launches']}")
        else:
            check(res["center_bit_equal_phase6a"]
                  and res["losses_equal_phase6a"],
                  f"{tag}: the remote_ps run differs from phase 6a's")
        out[key] = res
        add_counts(launches, launched)
    out["wire_breakdown_s"] = wire_breakdown(np, centers6a["DOWNPOUR"])
    log(f"remote lm: one uncompressed pull's host seconds "
        f"{out['wire_breakdown_s']} on {smi}")
    return out, launches


def failover_run(torch, cfg, train, kill_at=None):
    """Config ``cfg`` in threads mode with ``remote_ps``, a warm standby
    and ``worker_retries=2``; ``kill_at``: kill the primary once it has
    applied that many commits. Returns the trainer, the launch counts,
    the seconds and the kill instant (``time.monotonic``)."""
    import threading

    from distkeras_tpu_torch import kernels

    trainer = baseline_trainer(cfg, "pallas_sgd", mode="threads",
                               remote_ps=True, standby=True,
                               worker_retries=2)
    killed = {}

    def killer():
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and "done" not in killed:
            svc = trainer.service
            if (svc is not None and not svc.killed
                    and trainer.parameter_server.num_updates >= kill_at):
                # stamped before the call: the standby may promote
                # before kill() returns
                killed["at"] = time.monotonic()
                svc.kill()
                return
            time.sleep(0.001)

    thread = None
    if kill_at is not None:
        thread = threading.Thread(target=killer, daemon=True)
        thread.start()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    try:
        trainer.train(train, shuffle=True)
        torch.cuda.synchronize()
    finally:
        killed["done"] = True
        if thread is not None:
            thread.join(timeout=10)
    secs = time.monotonic() - t0
    counts = {c: n for c, n in kernels.launch_counts().items() if n}
    return trainer, counts, secs, killed.get("at")


def run_failover(torch, np, smi):
    """10d: config 3 (AEASGD, ``higgs_mlp``, 4 workers, ``pallas_sgd``) in
    threads with ``remote_ps``, a warm standby and ``worker_retries=2``,
    unfaulted and with the primary killed at half the expected commits.
    The faulted run must finish with exactly one promotion
    (``primary-lost``), at least one client failover, a post-mortem bundle,
    and the unfaulted run's commit ledger (update count, every worker's
    last commit seq)."""
    cfg = next(c for c in BASELINE if c["id"] == 3)
    train, _, _ = baseline_data(cfg["data"])
    expected = 16
    runs = {}
    for label, kill_at in (("unfaulted", None), ("faulted", expected // 2)):
        trainer, counts, secs, kill = failover_run(torch, cfg, train,
                                                   kill_at)
        ps = trainer.active_parameter_server()
        sb = trainer.standby_service
        runs[label] = {
            "ledger": {"num_updates": ps.num_updates,
                       "seen_seq": {str(k): int(v) for k, v in
                                    sorted(ps._seen_seq.items())}},
            "num_duplicates": ps.num_duplicates,
            "promotions": list(trainer.ps_promotions),
            "failovers": trainer.ps_failovers,
            "failures": list(trainer.failures), "launches": counts,
            "seconds": secs,
            "kill_to_promotion_s": (None if kill is None or not sb.promoted
                                    else sb.promoted_at - kill),
            "postmortem": (None if sb.last_postmortem is None else
                           {k: sb.last_postmortem[k] for k in
                            ("reason", "detail")}),
            "center_finite": all(np.isfinite(v).all()
                                 for v in ps.get_params().values()),
        }
        del trainer, ps, sb
    clean, fault = runs["unfaulted"], runs["faulted"]
    res = {**runs, "ledgers_equal": clean["ledger"] == fault["ledger"]}
    log(f"failover config 3: {res}")
    log(f"failover config 3: kill -> promotion "
        f"{fault['kill_to_promotion_s']} s, {fault['failovers']} client "
        f"failovers, B1 launches {clean['launches']} unfaulted / "
        f"{fault['launches']} faulted on {smi}")
    check(clean["promotions"] == [] and clean["failures"] == []
          and clean["ledger"]["num_updates"] == expected,
          f"10d: the unfaulted run {clean}")
    check(clean["launches"] == {"sgd_fused": 60},
          f"10d: unfaulted launches {clean['launches']} != 56 steps + the "
          "4-step warm-up of sgd_fused")
    check(fault["kill_to_promotion_s"] is not None,
          "10d: the primary was not killed, or the standby never promoted")
    check(len(fault["promotions"]) == 1
          and fault["promotions"][0]["reason"] == "primary-lost",
          f"10d: promotions {fault['promotions']}")
    check(fault["failovers"] >= 1, "10d: no client failed over")
    check(res["ledgers_equal"],
          f"10d: ledgers differ: {clean['ledger']} != {fault['ledger']}")
    check(fault["postmortem"] is not None
          and fault["postmortem"]["reason"] == "promotion",
          "10d: no promotion post-mortem bundle")
    check(clean["center_finite"] and fault["center_finite"],
          "10d: a center is not finite")
    check(fault["launches"].get("sgd_fused", 0) >= 60,
          f"10d: faulted launches {fault['launches']}")
    launches = add_counts(dict(clean["launches"]), fault["launches"])
    return res, launches


def run_phase10(torch, np, zoo, ds, smi, phase7, centers7, phase6a,
                centers6a):
    """Phase 10 (10a-10d), the socket parameter-server tier on the card,
    cuDNN deterministic as in phase 7; returns the results and the kernel
    launches of its main-path runs."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, launches = {}, {}
    subphases = (
        ("10a", "remote_config2", lambda: run_remote_config2(
            torch, np, smi, phase7["config2"], centers7[2])),
        ("10b", "ps_process", lambda: run_ps_process(torch, np, smi)),
        ("10c", "remote_lm", lambda: run_remote_lm(
            torch, np, zoo, ds, smi, phase6a, centers6a)),
        ("10d", "failover", lambda: run_failover(torch, np, smi)),
    )
    try:
        for label, key, fn in subphases:
            t0 = time.monotonic()
            out[key], counts = fn()
            out[key]["seconds_total"] = time.monotonic() - t0
            log(f"phase {label} ({key}) in {out[key]['seconds_total']:.1f} s")
            add_counts(launches, counts)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    return out, launches


# ----------------------------------------------------------------- phase 11


def quantiles_ms(np, xs):
    if not xs:
        return {"p50": None, "p99": None}
    arr = np.asarray(xs) * 1e3
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99))}


def fan_out(jobs, threads):
    """Run ``jobs`` (callables) on ``threads`` threads, round-robin, one
    ``ServingClient`` per thread as a user fans out; returns the results
    in job order and raises the first failure."""
    import threading

    out = [None] * len(jobs)
    errs = []

    def work(t):
        try:
            for j in range(t, len(jobs), threads):
                out[j] = jobs[j]()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ths = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
    if errs:
        raise errs[0]
    check(not any(th.is_alive() for th in ths), "a client thread hung")
    return out


def run_wire_generate(torch, np, lm, smi, gen, gen_reqs, gen_outs):
    """11a, 11b and 11e on one LN-hooked 8-slot engine behind a
    ``ServingServer``: phase 4's mix from 8 client threads, four of it
    streamed, then the obs verbs and a ``stop`` that drains a request
    still in flight."""
    import threading

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.obs import parse_prometheus, timeline_complete
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )

    detach_hooks(lm)
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8)
    srv = ServingServer(eng).start()
    clients = [ServingClient(srv.host, srv.port, timeout=600,
                             connect_timeout=2) for _ in range(8)]
    res = {}
    try:
        eng._stepper.warmup()
        # 11a: the 16-request mix over the wire
        jobs = [
            (lambda c, p=p, n=n, s=s: c.generate(p, n, sampling=s))
            for p, n, s in gen_reqs
        ]
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        outs = fan_out([
            (lambda j=j: jobs[j](clients[j % 8])) for j in range(len(jobs))
        ], 8)
        secs = time.monotonic() - t0
        counts_a = kernels.launch_counts()
        check(all(np.array_equal(a, b) for a, b in zip(outs, gen_outs)),
              "11a: a wire reply differs from phase 4's in-process output")
        check(counts_a["layernorm_fwd"] > 0 and counts_a["flash_fwd"] == 0,
              f"11a: wire generate did not run through the LN kernel "
              f"alone: {counts_a}")
        n_tokens = sum(len(o) - len(p) for o, (p, _, _) in zip(outs, gen_reqs))
        res["generate"] = {
            "requests": len(outs), "tokens": n_tokens, "seconds": secs,
            "tokens_per_s": n_tokens / secs,
            "in_process_tokens_per_s": gen["tokens_per_s"],
            "launches": counts_a,
        }
        log(f"11a wire generate: {len(outs)} requests from 8 client "
            f"threads, {n_tokens / secs:.1f} tokens/s over the wire vs "
            f"{gen['tokens_per_s']:.1f} in process (phase 4), all equal "
            f"to phase 4's outputs, launches {counts_a} on {smi}")
        # 11b: four of the mix streamed, from four threads
        picks = [0, 1, 2, 3]  # request 3 is sampled

        def stream(j):
            p, n, s = gen_reqs[j]
            st = clients[j].generate_stream(p, n, sampling=s)
            chunks = list(st)
            return st, chunks

        kernels.reset_launch_counts()
        streams = fan_out([(lambda j=j: stream(j)) for j in picks], 4)
        counts_b = kernels.launch_counts()
        gaps = []
        for j, (st, chunks) in zip(picks, streams):
            full = np.concatenate([gen_reqs[j][0], *chunks])
            check(np.array_equal(full, gen_outs[j])
                  and np.array_equal(st.sequence, gen_outs[j]),
                  f"11b: streamed chunks of request {j} differ from the "
                  f"unstreamed sequence")
            gaps += st.inter_token_s
        ttft = [st.ttft_s for st, _ in streams]
        res["stream"] = {
            "requests": picks, "chunks": [len(c) for _, c in streams],
            "ttft_ms": [t * 1e3 for t in ttft],
            "inter_chunk_ms": quantiles_ms(np, gaps), "launches": counts_b,
        }
        log(f"11b streams: TTFT {[round(t * 1e3, 3) for t in ttft]} ms, "
            f"inter-chunk p50/p99 {res['stream']['inter_chunk_ms']} ms "
            f"(host clock) on {smi}")
        # 11e: a traced generate, the obs verbs, stop draining work
        c = clients[0]
        p, n, _ = gen_reqs[0]
        traced = c.generate(p, n, trace=True)
        spans = c.last_trace["spans"]
        names = {sp["name"] for sp in spans}
        check(np.array_equal(traced, gen_outs[0])
              and timeline_complete(spans)
              and {"serving.queue", "serving.prefill", "serving.decode",
                   "server.generate"} <= names,
              f"11e: traced timeline incomplete: {sorted(names)}")
        samples = c.metrics()
        prom = parse_prometheus(c.metrics(prometheus=True))
        ts = c.timeseries(window=60)
        health, stats = c.health(), c.stats()
        check(any(x["name"] == "serving_scheduler_completed"
                  and x["value"] >= 21 for x in samples)
              and any(name == "serving_scheduler_completed_total"
                      for name, _, _ in prom)
              and ts["ok"] and health["status"] == "serving"
              and stats["open_connections"] == len(clients),
              "11e: the metrics/timeseries/health/stats verbs misanswered")
        for cl in clients[2:]:
            cl.close()  # idle connections would hold the drain's grace
        long_p = np.arange(16, dtype=np.int32)
        held = {}

        def long_generate():
            held["out"] = clients[1].generate(long_p, 256)

        th = threading.Thread(target=long_generate)
        th.start()
        deadline = time.monotonic() + 60
        while (eng.stats()["active_slots"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.001)
        t_stop = time.monotonic()
        check(c.stop()["stopping"], "11e: stop was not acknowledged")
        th.join(timeout=120)
        srv.shutdown()
        drain_s = time.monotonic() - t_stop
        check("out" in held and len(held["out"]) == 16 + 256,
              "11e: stop did not drain the request in flight")
        res["obs"] = {
            "spans": sorted(names), "metrics_samples": len(samples),
            "prometheus_lines": len(prom),
            "timeseries_series": len(ts["series"]),
            "stop_drain_s": drain_s,
        }
        log(f"11e obs: timeline {sorted(names)}, {len(samples)} metric "
            f"samples, {len(prom)} Prometheus lines, {len(ts['series'])} "
            f"series; stop drained a 256-token request in {drain_s:.3f} s "
            f"on {smi}")
    finally:
        for cl in clients:
            cl.close()
        srv.shutdown()
    detach_hooks(lm)
    return res, [counts_a, counts_b]


def run_wire_predict(torch, np, lm, smi, pred):
    """11c: phase 3's batch through a flash+LN-hooked engine, in process
    and over the wire; bit-equal, one forward's launches, and the host
    split of the wire call."""
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )

    detach_hooks(lm)
    check(attach_flash_attention(lm) == 8, "flash hook not on 8 blocks")
    check(attach_fused_layernorm(lm) == 17, "LN hook not on 17 norms")
    eng = ServingEngine(lm, num_slots=8)
    srv = ServingServer(eng).start()
    try:
        x = np.random.default_rng(3).integers(0, 8192, (8, 512)).astype(np.int32)
        eng.predict(x[:1], timeout=600)
        t0 = time.monotonic()
        y_in = eng.predict(x, timeout=600)
        in_s = time.monotonic() - t0
        with ServingClient(srv.host, srv.port, timeout=600,
                           connect_timeout=2) as c:
            c.predict(x[:1])
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            y = c.predict(x)
            wire_s = time.monotonic() - t0
            counts = kernels.launch_counts()
    finally:
        srv.shutdown()
    detach_hooks(lm)
    check(y.shape == (8, 512, 8192) and y.dtype == np.float32,
          f"11c: wire predict malformed: {y.shape} {y.dtype}")
    check(np.array_equal(y, y_in),
          "11c: wire predict differs from the in-process predict")
    check({k: n for k, n in counts.items() if n}
          == {"layernorm_fwd": 17, "flash_fwd": 8},
          f"11c: wire predict did not run one hooked forward: {counts}")
    split = wire_breakdown(np, {"prediction": y_in}, reps=1)
    res = {
        "seconds": wire_s, "in_process_seconds": in_s,
        "phase3_seconds": pred["seconds"], "reply_bytes": split["bytes"],
        "host_split_s": {k: split[k] for k in ("encode", "loopback",
                                               "decode")},
        "launches": counts,
    }
    log(f"11c wire predict: 8x512 -> {y.shape} ({y.nbytes} bytes) in "
        f"{wire_s:.3f} s vs {in_s:.3f} s in process ({pred['seconds']:.3f} "
        f"s in phase 3), bit-equal, launches {counts}; host split of the "
        f"{split['bytes']}-byte reply: encode {split['encode']:.3f} s, "
        f"loopback {split['loopback']:.3f} s, decode {split['decode']:.3f} "
        f"s on {smi}")
    return res, counts


def run_wire_bundle(torch, np, lm, smi, gen_reqs):
    """11d: ``quantize_model`` -> ``save_serving_bundle`` ->
    ``ServingEngine.from_bundle`` on the card; greedy generate over the
    wire against an in-process ``CachedSequenceGenerator`` on the
    quantized model."""
    import tempfile

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.quantization import (
        count_quantized,
        quantize_model,
    )
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        ServingClient,
        ServingEngine,
        ServingServer,
    )
    from distkeras_tpu_torch.utils.serialization import (
        save_serving_bundle,
        serialize_model,
    )

    detach_hooks(lm)
    f32_bytes = len(serialize_model(lm))
    greedy = [r for r in gen_reqs if r[2] is None][:4]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_int8.dkt")
        t0 = time.monotonic()
        save_serving_bundle(path, quantize_model(lm.copy()))
        save_s = time.monotonic() - t0
        bundle_bytes = os.path.getsize(path)
        t0 = time.monotonic()
        eng = ServingEngine.from_bundle(path, num_slots=8)
        load_s = time.monotonic() - t0
    model = eng.model
    check(count_quantized(model) == 8 * 4 + 8 * 2 + 1,
          f"11d: {count_quantized(model)} quantized weights")
    check(attach_fused_layernorm(model) == 17, "LN hook not on 17 norms")
    srv = ServingServer(eng).start()
    clients = [ServingClient(srv.host, srv.port, timeout=600,
                             connect_timeout=2) for _ in range(4)]
    try:
        eng._stepper.warmup()
        kernels.reset_launch_counts()
        outs = fan_out([
            (lambda j=j: clients[j].generate(greedy[j][0], greedy[j][1]))
            for j in range(len(greedy))
        ], 4)
        counts = kernels.launch_counts()
    finally:
        for cl in clients:
            cl.close()
        srv.shutdown()
    check(counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0,
          f"11d: bundle generate did not run through the LN kernel: {counts}")
    solo = CachedSequenceGenerator(model)
    for (p, n, _), o in zip(greedy, outs):
        check(np.array_equal(o, solo.generate(p[None], n)[0]),
              "11d: a bundle-served decode differs from the quantized solo "
              "decode")
    res = {"bundle_bytes": bundle_bytes, "f32_model_bytes": f32_bytes,
           "ratio": f32_bytes / bundle_bytes, "save_s": save_s,
           "load_s": load_s, "requests": len(outs), "launches": counts}
    log(f"11d int8 bundle: {bundle_bytes} bytes vs {f32_bytes} for "
        f"serialize_model's f32 frame ({f32_bytes / bundle_bytes:.2f}x), "
        f"saved in {save_s:.3f} s, booted in {load_s:.3f} s; "
        f"{len(outs)} greedy wire decodes equal the quantized solo decode, "
        f"launches {counts} on {smi}")
    return res, counts


def run_phase11(torch, np, lm, smi, pred, gen, gen_reqs, gen_outs):
    """Phase 11, the serving TCP front on the card; returns the results
    and the launch counts of each subphase's main path."""
    out = {}
    t0 = time.monotonic()
    out["wire_generate"], counts = run_wire_generate(
        torch, np, lm, smi, gen, gen_reqs, gen_outs)
    out["wire_predict"], c_pred = run_wire_predict(torch, np, lm, smi, pred)
    out["bundle"], c_bundle = run_wire_bundle(torch, np, lm, smi, gen_reqs)
    out["seconds_total"] = time.monotonic() - t0
    return out, [*counts, c_pred, c_bundle]


def baseline_leaf_shapes():
    """The parameter shapes of configs 2-5's models (built on the CPU: only
    their leaf tables matter to phases 2b/2c)."""
    from distkeras_tpu_torch.models import zoo

    out = {}
    for cfg in BASELINE:
        name, kw = cfg["model"]
        model = getattr(zoo, name)(seed=0, device="cpu", **kw)
        out[name] = [p.shape for p in model.parameters()]
    return out


#: (category, substrings of the kernel names that fall in it), first match
#: wins: the port's kernels by name, then the matrix products and copies
KERNEL_CATEGORIES = (
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwToNhwc",
              "nhwcToNchw", "implicit_convolve")),
    ("flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("layernorm", ("ln_fwd_", "ln_bwd_")),
    ("adam_fused", ("adam_fused_kernel",)),
    ("sgd_fused", ("sgd_fused_kernel", "sgd_momentum_fused_kernel")),
    ("gemm", ("gemm", "splitKreduce")),
    ("memcpy", ("Memcpy", "Memset")),
)


def device_profile(torch, fn, calls):
    """``torch.profiler`` over ``calls`` calls of ``fn``: device kernel
    time per call (ms), kernels per call, and the top kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [a for a in prof.key_averages()
            if getattr(a, "device_type", None) == cuda]

    def dev_us(a):
        return getattr(a, "self_device_time_total", 0.0)

    top = sorted(kern, key=dev_us, reverse=True)[:10]
    by_category = {}
    for a in kern:
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in a.key for k in keys)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + dev_us(a) / calls / 1e3
    return {
        "device_ms": sum(dev_us(a) for a in kern) / calls / 1e3 if kern else None,
        "device_ms_by_category": by_category,
        "kernels": sum(a.count for a in kern) / calls,
        "top_kernels": [
            {"name": a.key[:80], "per_call": a.count / calls,
             "device_us_per_call": dev_us(a) / calls}
            for a in top
        ],
    }


def profile_train_step(torch, np, lm, window=4, windows=3):
    """One training step as ``SingleTrainer`` runs it (flash + LN hooks,
    pallas_adam, batch 8 x 512): windows of 4 steps ending in the one host
    read of their metrics; per-step wall and device time."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam
    from distkeras_tpu_torch.utils.rng import RngSeq
    from distkeras_tpu_torch.workers import WorkerCore, _metrics_to_records

    model = lm.copy()
    attach_flash_attention(model)
    attach_fused_layernorm(model)
    core = WorkerCore(model, FusedAdam(1e-3), "next_token_crossentropy",
                      metrics=["next_token_accuracy"])
    opt_state = core.init_opt_state(list(model.parameters()))
    rng = RngSeq(0)
    xs = torch.as_tensor(np.random.default_rng(4).integers(
        0, 8192, (window, 8, 512)), device="cuda")

    def run_window():
        _, mets = core.window(model, opt_state, rng, xs, xs)
        _metrics_to_records(mets)

    run_window()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / (windows * window) * 1e3
    prof = device_profile(torch, run_window, windows)
    prof["device_ms"] = (None if prof["device_ms"] is None
                         else prof["device_ms"] / window)
    prof["kernels"] /= window
    prof["device_ms_by_category"] = {
        c: ms / window for c, ms in prof["device_ms_by_category"].items()}
    for k in prof["top_kernels"]:
        k["per_call"] /= window
        k["device_us_per_call"] /= window
    del model, core, opt_state
    return {"wall_ms": wall, **prof}


def profile_train_epoch(torch, np, lm):
    """Phase 5's kernel-path epoch once more, on a warm process: per-window
    wall times, with the Python collector's runs and the Adam table builds
    counted, to tell a slow window's cause."""
    import gc

    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    model = lm.copy()
    attach_flash_attention(model)
    attach_fused_layernorm(model)
    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    runs = []
    for collector in (True, False):
        gc.collect()
        if not collector:
            gc.disable()
        before = sum(st["collections"] for st in gc.get_stats())
        try:
            trainer, _, secs = train_once(torch, model, "pallas_adam", ds)
        finally:
            gc.enable()
        runs.append({
            "gc_enabled": collector, "seconds": secs,
            "window_seconds": [t for _, t in trainer.history.get_timings()],
            "gc_collections": sum(st["collections"] for st in gc.get_stats())
            - before,
            "adam_table_builds": trainer.optimizer._tables.builds,
            "adam_grad_pointer_uploads": trainer.optimizer._tables.grad_uploads,
        })
    log(f"profile train_epoch_again: {runs}")
    return runs


def profile_async_window(torch, np, zoo, windows=3):
    """One async window as a ``DOWNPOURWorker`` runs it (flash + LN hooks,
    pallas_sgd, 4 steps of 8 x 512, device-resident): pull (center copy +
    H2D), the window, the commit (delta on the card, D2H, PS add) — host
    wall, the split, device time and the top kernels per window."""
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.workers import DOWNPOURWorker, WorkerCore

    lm = make_lm(zoo)
    attach_flash_attention(lm)
    attach_fused_layernorm(lm)
    core = WorkerCore(lm, FusedSGD(ASYNC_LR), "next_token_crossentropy",
                      metrics=["next_token_accuracy"])
    ps = DeltaParameterServer(dict(zip(lm._leaf_order(), lm.get_weights())))
    worker = DOWNPOURWorker(core, ps, 0, "features", "label", 4)
    worker.stage_resident(loaders.text_corpus(seq_len=512, vocab_size=8192))
    full = itertools.cycle(list(worker.iter_index_windows(1, 8, 0))[:4])

    def run_window():
        worker.begin_window_indexed(next(full))
        worker.finish_window()

    run_window()  # the replica, its table and cuBLAS warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / windows * 1e3
    splits = worker.splits[1:1 + windows]
    prof = device_profile(torch, run_window, windows)
    out = {"wall_ms": wall, **prof,
           "split_ms": {k: 1e3 * float(np.mean([s[k] for s in splits]))
                        for k in ("pull", "window", "commit")}}
    del worker, core, ps, lm
    torch.cuda.empty_cache()
    return out


def profile_resnet_window(torch, np, windows=3):
    """One DynSGD/``resnet18`` window as config 5 runs it (pallas_adam,
    bf16, 4 streamed steps of 32 x 64 x 64 x 3): host wall and its split,
    device ms by category (convolutions, B3, PS copies, GEMMs, other), the
    BatchNorm layers' own device time (their 20 forwards and backwards at
    the window's shapes, profiled alone; the elementwise and reduction
    kernels they launch fall under "other" in the window) and the idle
    share."""
    from distkeras_tpu_torch.models import layers as tl
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.models.sequential import walk_layers
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam
    from distkeras_tpu_torch.parameter_servers import DynSGDParameterServer
    from distkeras_tpu_torch.workers import DynSGDWorker, WorkerCore

    name, kw = BASELINE[3]["model"]
    model = getattr(zoo, name)(seed=0, **kw)
    core = WorkerCore(model, FusedAdam(1e-3), "categorical_crossentropy",
                      compute_dtype="bfloat16")
    ps = DynSGDParameterServer(dict(zip(model._leaf_order(),
                                        model.get_weights())))
    worker = DynSGDWorker(core, ps, 0, "features", "label_onehot", 4)
    train, _, _ = baseline_data("imagenet")
    full = itertools.cycle(list(worker.iter_window_batches(train, 32, 1, 0))
                           [:4])

    def run_window():
        worker.begin_window(next(full))
        worker.finish_window()

    run_window()  # the replica, its table and cuDNN warm
    seen = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: seen.append((mod.momentum, inp[0].shape,
                                           inp[0].dtype)))
        for layer in walk_layers(worker._model)
        if isinstance(layer, tl.BatchNorm)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(windows):
        run_window()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / windows * 1e3
    for h in hooks:
        h.remove()
    splits = worker.splits[1:1 + windows]
    prof = device_profile(torch, run_window, windows)
    per_step = seen[:len(hooks)]
    bns, xs = [], []
    for momentum, shape, dtype in per_step:
        bn = tl.BatchNorm(momentum=momentum)
        bn.init(None, tuple(shape[1:]))
        bns.append(bn.to("cuda").train())
        xs.append(torch.randn(shape, device="cuda", dtype=dtype,
                              requires_grad=True))

    def bn_step():
        outs = [bn(x) for bn, x in zip(bns, xs)]
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    bn_prof = device_profile(torch, bn_step, 4)
    out = {"wall_ms": wall, **prof,
           "batchnorm_layers": len(per_step),
           "batchnorm_device_ms_per_window": (
               None if bn_prof["device_ms"] is None
               else 4 * bn_prof["device_ms"]),
           "split_ms": {k: 1e3 * float(np.mean([s[k] for s in splits]))
                        for k in ("pull", "window", "commit")}}
    del worker, core, ps, model, bns, xs
    torch.cuda.empty_cache()
    return out


def profile_paths(torch, np, lm, zoo, steps=20):
    """Where the time goes (``--profile``): a decode step with 8 busy slots
    on the LayerNorm-hooked model, one predict forward (8 x 512) with both
    hooks, one training step and one async window — host wall per call
    (synchronized), device kernel time per call, the device's idle share,
    and the kernels that take the most device time."""
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    def wall_ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / calls * 1e3

    attach_fused_layernorm(lm)
    st = DecodeStepper(lm, num_slots=8)
    rng = np.random.default_rng(9)
    for i in range(8):
        st.admit(i, rng.integers(0, 8192, 64))
    active = np.ones(8, bool)
    out = {}
    decode = {"wall_ms": wall_ms(lambda: st.step(active), steps),
              **device_profile(torch, lambda: st.step(active), steps)}
    attach_flash_attention(lm)
    x = torch.as_tensor(rng.integers(0, 8192, (8, 512)), device="cuda")

    def fwd():
        with torch.no_grad():
            lm(x)

    predict = {"wall_ms": wall_ms(fwd, 5), **device_profile(torch, fwd, 5)}
    detach_hooks(lm)
    train = profile_train_step(torch, np, lm)
    out["train_epoch_again"] = profile_train_epoch(torch, np, lm)
    async_window = profile_async_window(torch, np, zoo)
    resnet_window = profile_resnet_window(torch, np)
    for name, r in (("decode_step", decode), ("predict_forward", predict),
                    ("train_step", train), ("async_window", async_window),
                    ("resnet18_dynsgd_window", resnet_window)):
        if r["device_ms"] is not None:
            r["device_idle_share"] = 1 - r["device_ms"] / r["wall_ms"]
        out[name] = r
        log(f"profile {name}: " + str({k: v for k, v in r.items()
                                         if k != "top_kernels"}))
        for k in r["top_kernels"]:
            log(f"  {k}")
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write results here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a decode step and a predict forward")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import distkeras_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(distkeras_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: imported the port from {pkg_dir}, not from "
              f"this checkout", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.kernels import build
    from distkeras_tpu_torch.models import zoo

    # full f32 matmuls, no TF32 anywhere (the reference precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.monotonic()
    build.build()
    log(f"kernels built from {build.CSRC} in {time.monotonic() - t0:.1f} s")
    for kname, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{kname}] {line.strip()}")

    ln_rows = check_layernorm(torch, F)
    flash_rows = check_flash(torch, F)

    lm = make_lm(zoo)
    log(f"transformer_lm d512/L8: {lm.num_params()} parameters in "
        f"{len(list(lm.parameters()))} leaves")
    lm_shapes = [p.shape for p in lm.parameters()]
    adam_rows = [check_adam(torch, lm_shapes, "transformer_lm d512/L8")]
    sgd_rows = check_sgd(torch, lm_shapes, "transformer_lm d512/L8")
    # B3 and B1 at the leaf tables of BASELINE configs 2-5 (phase 7)
    zoo_shapes = baseline_leaf_shapes()
    for mname in ("resnet18", "mnist_cnn"):
        adam_rows.append(check_adam(torch, zoo_shapes[mname], mname))
    for mname in ("cifar10_cnn", "higgs_mlp"):
        sgd_rows["sgd_fused"] += check_sgd(
            torch, zoo_shapes[mname], mname,
            cases=((0.0, False, "float32"),))["sgd_fused"]
    # the member-stacked tables of phase 9, one launch over every member's
    # leaves: 4 x mnist_cnn and 2 x d512/L8 (Ensemble), 4 x higgs_mlp
    # (Averaging)
    adam_rows.append(check_adam(torch, zoo_shapes["mnist_cnn"] * 4,
                                "4 x mnist_cnn, vmapped members"))
    adam_rows.append(check_adam(torch, lm_shapes * 2,
                                "2 x transformer_lm d512/L8, vmapped members"))
    sgd_rows["sgd_fused"] += check_sgd(
        torch, zoo_shapes["higgs_mlp"] * 4, "4 x higgs_mlp, vmapped replicas",
        cases=((0.0, False, "float32"),))["sgd_fused"]
    fbwd_rows = check_flash_bwd(torch, F)
    inf_rows = check_flash_infinite_rows(torch)
    lnb_rows = check_layernorm_bwd(torch, F)
    torch.cuda.empty_cache()

    pred = run_predict(torch, np, lm)
    gen, gen_reqs, gen_outs = run_generate(torch, np, lm)
    log(f"generate: {gen['requests']} requests, "
        f"{gen['tokens_per_s']:.1f} tokens/s on {smi}")
    train = run_train(torch, np, zoo)
    log(f"train: {train['steps']} steps, {train['samples_per_s']:.1f} "
        f"samples/s = {train['tokens_per_s']:.0f} tokens/s (steady "
        f"{train['steady_tokens_per_s']:.0f} tokens/s) on {smi}")
    ds = loaders.text_corpus(seq_len=512, vocab_size=8192)
    async_sim, async_centers = run_async_simulated(torch, np, zoo, ds)
    async_thr = run_async_threads(torch, np, zoo, ds)
    log(f"async threads: {async_thr['threads_tokens_per_s']:.0f} tokens/s "
        f"after the warm-up ({async_thr['tokens_per_s']:.0f} over train()), "
        f"window split {async_thr['window_split_s']} on {smi}")
    t7 = time.monotonic()
    baseline, baseline_launches, baseline_centers = run_baseline(
        torch, np, smi)
    log(f"baseline configs 2-5 in {time.monotonic() - t7:.1f} s")
    t8 = time.monotonic()
    resume, resume_launches = run_resume(torch, np, zoo, ds)
    lm_resume = resume["lm"]
    log(f"resume: LM checkpoint {lm_resume['checkpoint_bytes']} bytes, "
        f"save {lm_resume['save_seconds']} s, restore "
        f"{lm_resume['restore_seconds']} s on {smi}; phase 8 in "
        f"{time.monotonic() - t8:.1f} s")
    t9 = time.monotonic()
    members, member_launches = run_phase9(torch, np, zoo, ds, smi, baseline)
    log(f"phase 9 in {time.monotonic() - t9:.1f} s")
    t10 = time.monotonic()
    socket_tier, socket_launches = run_phase10(
        torch, np, zoo, ds, smi, baseline, baseline_centers, async_sim,
        async_centers)
    del baseline_centers, async_centers
    log(f"phase 10 in {time.monotonic() - t10:.1f} s")
    front, front_launches = run_phase11(torch, np, lm, smi, pred, gen,
                                        gen_reqs, gen_outs)
    log(f"phase 11 in {front['seconds_total']:.1f} s on {smi}")
    profile = profile_paths(torch, np, lm, zoo) if args.profile else None

    phases = [pred["launches"], gen["launches"], train["launches"],
              async_thr["launches"], baseline_launches, resume_launches,
              member_launches, socket_launches, *front_launches,
              *(r["launches"] for r in async_sim.values())]
    launches = {k: sum(c.get(k, 0) for c in phases) for k in kernels.LAUNCHES}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")

    def entry(kname, source, replaces, rows, main_shape):
        main = next(r for r in rows if r["shape"] == main_shape
                    and r.get("dtype", "float32") == "float32")
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "jax": replaces.split("/")[-1],
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ok": all(r["ok"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main_shape,
            "shapes": rows,
        }

    kline = {"kernels": [
        entry("layernorm_fwd",
              "distkeras_tpu_torch/kernels/csrc/layernorm_fwd.cu",
              "distkeras_tpu/ops/fused_layernorm.py:113", ln_rows, [8, 512]),
        entry("flash_fwd", "distkeras_tpu_torch/kernels/csrc/flash_fwd.cu",
              "distkeras_tpu/ops/flash_attention.py:123", flash_rows,
              [8, 512, 8, 64]),
        entry("layernorm_bwd",
              "distkeras_tpu_torch/kernels/csrc/layernorm_bwd.cu",
              "distkeras_tpu/ops/fused_layernorm.py:135", lnb_rows,
              [4096, 512]),
        entry("flash_bwd_dq", "distkeras_tpu_torch/kernels/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:285",
              fbwd_rows["flash_bwd_dq"], [8, 512, 8, 64]),
        entry("flash_bwd_dkv",
              "distkeras_tpu_torch/kernels/csrc/flash_bwd.cu",
              "distkeras_tpu/ops/flash_attention.py:295",
              fbwd_rows["flash_bwd_dkv"], [8, 512, 8, 64]),
        entry("adam_fused", "distkeras_tpu_torch/kernels/csrc/adam_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:168", adam_rows,
              adam_rows[0]["shape"]),
        entry("sgd_fused", "distkeras_tpu_torch/kernels/csrc/sgd_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:98", sgd_rows["sgd_fused"],
              sgd_rows["sgd_fused"][0]["shape"]),
        entry("sgd_momentum_fused",
              "distkeras_tpu_torch/kernels/csrc/sgd_fused.cu",
              "distkeras_tpu/ops/pallas_kernels.py:120",
              sgd_rows["sgd_momentum_fused"],
              sgd_rows["sgd_momentum_fused"][0]["shape"]),
    ]}
    check(not any(m == "jax" or m.startswith(("jax.", "distkeras_tpu."))
                  or m == "distkeras_tpu" for m in sys.modules),
          "JAX or the JAX package was imported")
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "device": device,
                       "kernels": kline["kernels"], "predict": pred,
                       "generate": gen, "train": train,
                       "async_simulated": async_sim,
                       "async_threads": async_thr, "baseline": baseline,
                       "resume": resume, "phase9": members,
                       "phase10": socket_tier, "phase11": front,
                       "profile": profile,
                       "flash_infinite_q": inf_rows},
                      f, indent=1)
    print(json.dumps(kline), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    except Exception:  # noqa: BLE001 — any phase failing fails the run
        traceback.print_exc()
        code = 1
    sys.exit(code)
