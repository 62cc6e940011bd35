#!/usr/bin/env python3
"""This checkout's flash (B4, B5, B6) and LayerNorm-forward (B7) kernels
against another checkout's, on one CUDA card, in one process.

Run from the repository root: ``python3 kernel_ab.py --base DIR [--out
FILE]``, where DIR is another checkout of the repository, for instance the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. It builds ``flash_fwd.cu``, ``flash_bwd.cu`` and
``layernorm_fwd.cu`` of both checkouts, and a copy of this checkout's
``layernorm_fwd.cu`` whose row kernel is launched with programmatic
dependent launch (PDL: ``cudaLaunchKernelEx`` with programmatic stream
serialization, ``griddepcontrol.wait`` before the first load), one nvcc per
source, all started together, and prints each flash kernel's registers and
spills. Then:

1. On finite f32 inputs at the training step's shapes, the flash kernels
   of both checkouts must give the same bits (O, lse; dQ, delta; dK, dV).
2. Device time per launch (CUDA-graph replay, as ``chip_smoke.py`` times
   kernels) of each kernel of both checkouts at the main path's shapes, in
   turns: base, this, this, base.
3. This checkout's f32 flash kernels on inputs with an infinite q element
   in every query tile, so that every block runs its guarded second pass.
4. PDL: the decode step (8 slots, the LayerNorm hook) and the predict
   forward (8 x 512, both hooks) of ``transformer_lm`` d512/L8 under
   ``torch.profiler`` with this checkout's forward launcher and with the
   PDL copy, in turns; and a CUDA graph of 17 (matrix product, LayerNorm)
   pairs at the decode shape.

Prints one line per row and, last, a JSON object with the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "layernorm_fwd.cu")
PDL_WAIT = ("  const int lane = threadIdx.x;\n"
            "  const long long row = (long long)blockIdx.x * kRowsPerBlock"
            " + threadIdx.y;\n")
PDL_LAUNCH = ("  ln_fwd_warp<T, E, NC><<<(unsigned)grid, block, 0, stream>>>(\n"
              "      static_cast<const T*>(x), g, b, static_cast<T*>(y), rows,"
              " d, eps);\n")
PDL_LAUNCH_EX = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, ln_fwd_warp<T, E, NC>, static_cast<const T*>(x),
                     g, b, static_cast<T*>(y), rows, d, eps);
"""
FLASH_SHAPES = [((8, 512, 8, 64), True), ((8, 512, 8, 64), False),
                ((2, 200, 8, 64), True)]
LN_SHAPES = [((8, 512), "float32"), ((4096, 512), "float32"),
             ((4096, 512), "bfloat16"), ((3, 96), "float32")]


def pdl_source(src):
    """This checkout's layernorm_fwd.cu with the row kernel under PDL."""
    for piece in (PDL_WAIT, PDL_LAUNCH):
        if src.count(piece) != 1:
            raise RuntimeError(f"layernorm_fwd.cu no longer has {piece!r}")
    src = src.replace(PDL_WAIT, PDL_WAIT.replace(
        "  const int lane", '  asm volatile("griddepcontrol.wait;" ::: '
        '"memory");\n  const int lane', 1))
    return src.replace(PDL_LAUNCH, PDL_LAUNCH_EX)


def build_all(build, base_csrc):
    """(tag, source) -> {kernel name: ctypes fn}; the flash sources'
    ptxas reports per function are printed."""
    out_dir = build.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tag, csrc in (("base", base_csrc), ("this", build.CSRC)):
        for src in SOURCES:
            jobs[(tag, src)] = csrc / src
    jobs[("pdl", "layernorm_fwd.cu")] = out_dir / "layernorm_fwd_pdl.cu"
    jobs[("pdl", "layernorm_fwd.cu")].write_text(
        pdl_source((build.CSRC / "layernorm_fwd.cu").read_text()))
    procs = {}
    for (tag, src), path in jobs.items():
        lib = out_dir / f"{tag}_{src}.so"
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               str(lib), str(path)]
        procs[(tag, src)] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (tag, src), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {src}:\n{log}")
        if src.startswith("flash"):
            fn_name = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    fn_name = m.group(1)
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {tag} {src} {fn_name}: {line.strip()}")
        cdll = ctypes.CDLL(str(lib))
        for name, (ksrc, symbol, argtypes) in build.KERNELS.items():
            if ksrc == src:
                fn = getattr(cdll, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns.setdefault(tag, {})[name] = fn
    return fns


def flash_calls(torch, fns, q, k, v, do, causal):
    """Zero-argument launches of one checkout's three flash kernels on
    fixed inputs (outputs allocated once), and their outputs."""
    b, t, h, d = q.shape
    scale = 1.0 / d ** 0.5
    out = {n: torch.empty_like(q) for n in ("o", "dq", "dk", "dv")}
    for n in ("lse", "delta"):
        out[n] = torch.empty(b, h, t, 1, device="cuda")

    def check(name, err):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def stream():  # the capture's stream while a CUDA graph records
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        check("flash_fwd", fns["flash_fwd"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out["o"].data_ptr(),
            out["lse"].data_ptr(), b, t, h, d, scale, int(causal), 0, stream()))

    def dq():
        check("flash_bwd_dq", fns["flash_bwd_dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out["o"].data_ptr(),
            do.data_ptr(), out["lse"].data_ptr(), out["delta"].data_ptr(),
            out["dq"].data_ptr(), b, t, h, d, scale, int(causal), 0, stream()))

    def dkv():
        check("flash_bwd_dkv", fns["flash_bwd_dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out["lse"].data_ptr(), out["delta"].data_ptr(),
            out["dk"].data_ptr(), out["dv"].data_ptr(), b, t, h, d, scale,
            int(causal), 0, stream()))

    return {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv}, out


def in_turns(chip_smoke, calls, order=("base", "this", "this", "base")):
    """Device time per launch (us) of each tag's call, measured in the
    given order; the mean of each tag's readings and the readings."""
    reads = {tag: [] for tag in calls}
    for tag in order:
        reads[tag].append(1e3 * chip_smoke.device_time_ms(calls[tag]))
    return {tag: {"us": sum(r) / len(r), "reads": r} for tag, r in reads.items()}


def flash_rows(torch, chip_smoke, fns):
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(31)
    for shape, causal in FLASH_SHAPES:
        q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen)
                       for _ in range(4))
        calls, outs = {}, {}
        for tag in ("base", "this"):
            calls[tag], outs[tag] = flash_calls(torch, fns[tag], q, k, v, do,
                                                causal)
            for fn in calls[tag].values():
                fn()
        torch.cuda.synchronize()
        same = {n: torch.equal(outs["base"][n], outs["this"][n])
                for n in outs["this"]}
        print(f"flash bits equal {list(shape)} causal={causal}: {same}",
              flush=True)
        # every query tile holds an infinite q element: every block of the
        # three kernels runs its guarded second pass
        qi = q.clone()
        qi[:, ::64, :, 0] = float("inf")
        inf_calls, _ = flash_calls(torch, fns["this"], qi, k, v, do, causal)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            turns = in_turns(chip_smoke, {t: calls[t][name] for t in calls})
            inf_us = 1e3 * chip_smoke.device_time_ms(inf_calls[name])
            row = {"kernel": name, "shape": list(shape), "causal": causal,
                   "dtype": "float32", "base_us": turns["base"]["us"],
                   "this_us": turns["this"]["us"],
                   "reads": {t: turns[t]["reads"] for t in turns},
                   "this_us_every_block_guarded": inf_us,
                   "bits_equal": all(same.values())}
            print(row, flush=True)
            rows.append(row)
        del q, k, v, do, qi, calls, outs, inf_calls
    return rows


def ln_rows(torch, chip_smoke, fns):
    from distkeras_tpu_torch import kernels

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(37)
    for (n, d), dname in LN_SHAPES:
        dtype = getattr(torch, dname)
        isz = torch.tensor([], dtype=dtype).element_size()
        nsets = max(1, min(16, (96 << 20) // (n * d * isz)))
        sets = [(torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5)
                .to(dtype) for _ in range(nsets)]
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        b = 0.1 * torch.randn(d, device="cuda", generator=gen)
        code = kernels.cuda_dtype_code(dtype)
        calls, outs = {}, {}
        for tag in ("base", "this", "pdl"):
            y = torch.empty(n, d, device="cuda", dtype=dtype)
            nxt = chip_smoke.rotating(sets)

            def call(fn=fns[tag]["layernorm_fwd"], y=y, nxt=nxt):
                err = fn(nxt().data_ptr(), g.data_ptr(), b.data_ptr(),
                         y.data_ptr(), n, d, 1e-5, code,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"layernorm_fwd: CUDA error {err}")

            calls[tag], outs[tag] = call, y
        for tag in calls:  # each output from sets[0], compared before
            fns[tag]["layernorm_fwd"](  # the timed calls overwrite them
                sets[0].data_ptr(), g.data_ptr(), b.data_ptr(),
                outs[tag].data_ptr(), n, d, 1e-5, code,
                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        diff = float((outs["base"].float() - outs["this"].float()).abs().max())
        pdl_same = torch.equal(outs["pdl"], outs["this"])
        turns = in_turns(chip_smoke, {t: calls[t] for t in ("base", "this")})
        row = {"kernel": "layernorm_fwd", "shape": [n, d], "dtype": dname,
               "base_us": turns["base"]["us"], "this_us": turns["this"]["us"],
               "reads": {t: turns[t]["reads"] for t in turns},
               "pdl_us": 1e3 * chip_smoke.device_time_ms(calls["pdl"]),
               "base_vs_this_max_abs_diff": diff, "pdl_bits_equal": pdl_same}
        print(row, flush=True)
        rows.append(row)
    return rows


def pdl_paths(torch, np, chip_smoke, fns):
    """The decode step and the predict forward with this checkout's
    forward launcher and with the PDL copy, in turns (this, pdl, pdl,
    this): host wall per call, device time and the LayerNorm's share from
    ``torch.profiler``; and a graph of 17 (product, LayerNorm) pairs."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.serving.engine import DecodeStepper

    lm = chip_smoke.make_lm(zoo)
    tln.attach_fused_layernorm(lm)
    st = DecodeStepper(lm, num_slots=8)
    rng = np.random.default_rng(9)
    for i in range(8):
        st.admit(i, rng.integers(0, 8192, 64))
    active = np.ones(8, bool)
    x = torch.as_tensor(rng.integers(0, 8192, (8, 512)), device="cuda")
    hooked = lm.copy()
    tln.attach_fused_layernorm(hooked)
    attach_flash_attention(hooked)

    def fwd():
        with torch.no_grad():
            hooked(x)

    def wall_ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / calls * 1e3

    wx = torch.randn(8, 512, device="cuda")
    w = torch.randn(512, 1536, device="cuda") * 0.05
    g, b = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
    y = torch.empty(8, 512, device="cuda")

    rows = []
    for tag in ("this", "pdl", "pdl", "this"):
        tln._fwd_launcher = fns[tag]["layernorm_fwd"]
        fn = tln._fwd_launcher

        def pairs(fn=fn):
            for _ in range(17):
                torch.mm(wx, w)
                fn(wx.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                   8, 512, 1e-5, 0, torch.cuda.current_stream().cuda_stream)

        row = {"launcher": tag, "graph_17_pairs_us":
               1e3 * chip_smoke.device_time_ms(pairs, iters=5)}
        for name, call, n in (("decode_step", lambda: st.step(active), 20),
                              ("predict_forward", fwd, 5)):
            prof = chip_smoke.device_profile(torch, call, n)
            row[name] = {"wall_ms": wall_ms(call, n),
                         "device_ms": prof["device_ms"],
                         "layernorm_ms": prof["device_ms_by_category"]
                         .get("layernorm")}
        print(row, flush=True)
        rows.append(row)
    tln._fwd_launcher = fns["this"]["layernorm_fwd"]
    return rows


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="another checkout of the repository (its root)")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke
    from distkeras_tpu_torch.kernels import build
    from pathlib import Path

    torch.backends.cuda.matmul.allow_tf32 = False
    base_csrc = Path(args.base).resolve() / "distkeras_tpu_torch" / "kernels" / "csrc"
    if not all((base_csrc / s).is_file() for s in SOURCES):
        print(f"kernel_ab: {base_csrc} lacks {SOURCES}", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    t0 = time.monotonic()
    fns = build_all(build, base_csrc)
    print(f"built {len(fns)} x {SOURCES} in {time.monotonic() - t0:.1f} s",
          flush=True)
    result = {"nvidia_smi": smi, "flash": flash_rows(torch, chip_smoke, fns),
              "layernorm_fwd": ln_rows(torch, chip_smoke, fns),
              "pdl_paths": pdl_paths(torch, np, chip_smoke, fns)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r["bits_equal"] for r in result["flash"]) and all(
        r["pdl_bits_equal"] for r in result["layernorm_fwd"])
    print(json.dumps({"nvidia_smi": smi, "flash_bits_equal_and_pdl_same": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
