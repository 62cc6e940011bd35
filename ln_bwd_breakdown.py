#!/usr/bin/env python3
"""Where the LayerNorm backward kernel's time goes, on one CUDA card.

Run from the repository root: ``python3 ln_bwd_breakdown.py``. It builds
``distkeras_tpu_torch/kernels/csrc/layernorm_bwd.cu`` as it is and
cut-down copies of it — the fold's first level only, the fold's two
tickets without its sums, no fold (the partial rows written), and no
partial rows at all (dx only) — and times each at (4096, 512), the
training step's shape, in f32 and bf16, with the block count
``bwd_blocks`` gives (device time per call from a CUDA-graph replay, as
``chip_smoke.py`` times kernels). The differences between them are the
shares of the fold's levels, its tickets and the partial rows. Only the
full build is right, and it is held against the plain version. Prints
one line per row and, last, a JSON object with the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SHAPE = (4096, 512)
FOLD_CALL = "  fold_partials(partials, gridDim.x, d);\n}\n\n__device__ float block_sum"
PARTIALS_LOOP = "  for (int half = 0; half < 2; ++half) {"
SECOND_LEVEL = "  if (ngroups == 1) return;  // the group's first row is row 0\n"
SUMS = ("  sum_rows(pg, pb, first, 1, members, d);\n",
        "  sum_rows(pg, pb, 0, kGroup, ngroups, d);\n")


def variants(src):
    """name -> source: as built, then with less and less of the tail."""
    for piece in (FOLD_CALL, PARTIALS_LOOP, SECOND_LEVEL, *SUMS):
        if src.count(piece) != 1:
            raise RuntimeError(f"layernorm_bwd.cu no longer has {piece!r}")
    one_level = src.replace(SECOND_LEVEL, "  return;\n")
    tickets_only = src.replace(SUMS[0], "").replace(SUMS[1], "")
    no_fold = src.replace(FOLD_CALL, "}\n\n__device__ float block_sum")
    no_partials = no_fold.replace(
        PARTIALS_LOOP, "  for (int half = 0; half < 0; ++half) {")
    return {"kernel": src, "one_level": one_level,
            "tickets_only": tickets_only, "no_fold": no_fold,
            "no_partials": no_partials}


def build_all(build, sources):
    """One nvcc per variant, all started together; name -> ctypes fn."""
    out_dir = build.BUILD_DIR / "ln_bwd_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).dk_layernorm_bwd
        fn.argtypes = build.KERNELS["layernorm_bwd"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch

    if not torch.cuda.is_available():
        print("ln_bwd_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.kernels import build
    from distkeras_tpu_torch.ops import fused_layernorm as tln

    smi = chip_smoke.nvidia_smi_line()
    fns = build_all(build, variants(
        (build.CSRC / "layernorm_bwd.cu").read_text()))
    n, d = SHAPE
    nblocks = tln.bwd_blocks(n, d)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        code = kernels.cuda_dtype_code(dtype)
        sets = [tuple((torch.randn(n, d, device="cuda", generator=gen) * 2
                       + 0.5).to(dtype) for _ in range(2)) for _ in range(6)]
        g = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        nxt = chip_smoke.rotating(sets)
        for name, fn in fns.items():
            dx = torch.empty(n, d, device="cuda", dtype=dtype)
            part = torch.empty(2, nblocks, d, device="cuda")

            def call(fn=fn, dx=dx, part=part):
                x, dy = nxt()
                err = fn(x.data_ptr(), dy.data_ptr(), g.data_ptr(),
                         dx.data_ptr(), part.data_ptr(), n, d, 1e-5,
                         nblocks, code,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            row = {"variant": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [n, d], "nblocks": nblocks,
                   "us": 1e3 * chip_smoke.device_time_ms(call)}
            if name == "kernel":
                x, dy = sets[0]
                fn(x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(),
                   part.data_ptr(), n, d, 1e-5, nblocks, code,
                   torch.cuda.current_stream().cuda_stream)
                rdx, rdg, rdb = tln._reference_layer_norm_bwd(x, g, dy, 1e-5)
                torch.cuda.synchronize()
                row["dx_max_abs_err"] = float((dx.float() - rdx.float())
                                              .abs().max())
                row["dgamma_dbeta_rel_err"] = max(
                    float((a - r).abs().max() / r.abs().max())
                    for a, r in ((part[0, 0], rdg), (part[1, 0], rdb)))
            print(row, flush=True)
            rows.append(row)
    print(json.dumps({"nvidia_smi": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
