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
   f32; 1e-2 absolute + 1e-2 relative in bf16, one bf16 rounding step) and
   ``flash_fwd`` (O to 2e-5, lse to 1e-5 absolute), with the device time
   (CUDA-graph replay) and the eager per-call time (CUDA events) of the
   kernel, the plain version and — for context only, never on the port's
   path — the PyTorch library call computing the same function.
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

The last lines are the kernels JSON, the ``nvidia-smi`` name/power line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, no TF32

LN_TOL_F32 = 1e-5
LN_TOL_BF16 = 1e-2
FLASH_TOL_O = 2e-5
FLASH_TOL_LSE = 1e-5
LOGIT_TOL = 1e-4


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


def device_time_ms(fn, iters=20, reps=5):
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``reps`` times between CUDA events — the host is out of the
    measurement, so this is what the card spends on the call's kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def timings(kernel, plain, library):
    """Device and eager per-call times of the kernel, its plain version
    and the library call (each a zero-argument callable)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = device_time_ms(fn)
        out[f"{key}call_ms"] = call_time_ms(fn)
    return out


def rotating(sets):
    """Cycle through input sets so repeated launches read cold-ish memory
    (the sets together exceed the 50 MB L2 where the inputs are large)."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]

    return nxt


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phase 2


def check_layernorm(torch, F):
    from distkeras_tpu_torch.ops.fused_layernorm import (
        _reference_layer_norm,
        layernorm_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (n, d), dtype in [
        ((8, 512), torch.float32), ((512, 512), torch.float32),
        ((4096, 512), torch.float32), ((4096, 512), torch.bfloat16),
        ((3, 96), torch.float32),
    ]:
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (n * d * isz)))
        sets = []
        for _ in range(nsets):
            x = (torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5
                 ).to(dtype)
            sets.append(x)
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        b = 0.1 * torch.randn(d, device="cuda", generator=gen)
        x = sets[0]
        y = layernorm_fwd(x, g, b, 1e-5)
        ref = _reference_layer_norm(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs()
        max_err = float(err.max())
        if dtype == torch.float32:
            ok = max_err <= LN_TOL_F32
        else:
            ok = bool((err <= LN_TOL_BF16 + LN_TOL_BF16
                       * ref.float().abs()).all())
        nxt = rotating(sets)
        gl, bl = g.to(dtype), b.to(dtype)
        times = timings(
            lambda: layernorm_fwd(nxt(), g, b, 1e-5),
            lambda: _reference_layer_norm(nxt(), g, b, 1e-5),
            lambda: F.layer_norm(nxt(), (d,), gl, bl, 1e-5),
        )
        dname = "float32" if dtype == torch.float32 else "bfloat16"
        bound_ms, bound_by = bound(2 * n * d * isz + 2 * d * 4, 8 * n * d, dname)
        row = {
            "shape": [n, d], "dtype": dname, "max_abs_err": max_err,
            "ok": ok, **times, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"layernorm_fwd {row}")
        check(ok, f"layernorm_fwd disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def check_flash(torch, F):
    from distkeras_tpu_torch.ops.flash_attention import (
        _reference_flash_fwd,
        flash_fwd,
    )

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (b, t, h, d), causal in [
        ((8, 512, 8, 64), True), ((8, 512, 8, 64), False),
        ((2, 1, 8, 64), True), ((2, 200, 8, 64), True),
        ((2, 512, 8, 64), False),
    ]:
        per = 3 * b * t * h * d * 4
        nsets = max(1, min(8, (96 << 20) // per))
        sets = [
            tuple(torch.randn(b, t, h, d, device="cuda", generator=gen)
                  for _ in range(3))
            for _ in range(nsets)
        ]
        q, k, v = sets[0]
        o, lse = flash_fwd(q, k, v, causal)
        ro, rlse = _reference_flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = float((o - ro).abs().max())
        err_lse = float((lse - rlse).abs().max())
        ok = err_o <= FLASH_TOL_O and err_lse <= FLASH_TOL_LSE
        nxt = rotating(sets)
        hsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
        hnxt = rotating(hsets)
        times = timings(
            lambda: flash_fwd(*nxt(), causal),
            lambda: _reference_flash_fwd(*nxt(), causal),
            lambda: F.scaled_dot_product_attention(*hnxt(), is_causal=causal),
        )
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        bound_ms, bound_by = bound(
            4 * b * t * h * d * 4 + b * h * t * 4, 4 * d * pairs, "float32"
        )
        row = {
            "shape": [b, t, h, d], "causal": causal, "dtype": "float32",
            "max_abs_err": max(err_o, err_lse), "err_o": err_o,
            "err_lse": err_lse, "ok": ok, **times,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"flash_fwd {row}")
        check(ok, f"flash_fwd disagrees with its plain version: {row}")
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
    check(counts == {"layernorm_fwd": 17, "flash_fwd": 8},
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
    return res


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
    return {
        "device_ms": sum(dev_us(a) for a in kern) / calls / 1e3 if kern else None,
        "kernels": sum(a.count for a in kern) / calls,
        "top_kernels": [
            {"name": a.key[:80], "per_call": a.count / calls,
             "device_us_per_call": dev_us(a) / calls}
            for a in top
        ],
    }


def profile_paths(torch, np, lm, steps=20):
    """Where the time goes (``--profile``): a decode step with 8 busy slots
    on the LayerNorm-hooked model, and one predict forward (8 x 512) with
    both hooks — host wall per call (synchronized), device kernel time per
    call, the device's idle share, and the kernels that take the most
    device time."""
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
    for name, r in (("decode_step", decode), ("predict_forward", predict)):
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

    lm = zoo.transformer_lm(vocab_size=8192, seq_len=512, d_model=512,
                            num_heads=8, depth=8, seed=0)
    log(f"transformer_lm d512/L8: {lm.num_params()} parameters")
    pred = run_predict(torch, np, lm)
    gen = run_generate(torch, np, lm)
    log(f"generate: {gen['requests']} requests, "
        f"{gen['tokens_per_s']:.1f} tokens/s on {smi}")
    profile = profile_paths(torch, np, lm) if args.profile else None

    launches = {
        k: pred["launches"][k] + gen["launches"][k] for k in kernels.LAUNCHES
    }
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")

    def entry(kname, source, replaces, rows, main_shape):
        main = next(r for r in rows if r["shape"] == main_shape)
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
                       "generate": gen, "profile": profile},
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
