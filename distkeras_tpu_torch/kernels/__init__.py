"""Hand-written Hopper kernels of the port and their launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in ``ops``
(``fused_layernorm.layernorm_fwd``/``layernorm_bwd``,
``flash_attention.flash_fwd``/``flash_bwd``, ``pallas_kernels.FusedAdam``
and ``FusedSGD``);
this package holds the CUDA sources (``csrc/``), the build module
(``build``), and the per-kernel launch counters the wrappers bump exactly
where they launch — so a run can show which kernels its main path went
through. With ``DKT_LAUNCH_COUNTS_DIR`` set, every process that imports
this package writes its counts to ``<dir>/<pid>.json`` when it exits, so
a harness can add up the launches of a run that spans processes (an
example and the rank processes it starts).
"""

from __future__ import annotations

import atexit
import json
import os
import threading

import torch

#: kernel name -> launches since the last reset
LAUNCHES = {
    "layernorm_fwd": 0,
    "layernorm_bwd": 0,
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "adam_fused": 0,
    "sgd_fused": 0,
    "sgd_momentum_fused": 0,
}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with _lock:
        return dict(LAUNCHES)


#: the directory each process writes its launch counts to at exit
ENV_COUNTS_DIR = "DKT_LAUNCH_COUNTS_DIR"


def _write_counts(out_dir: str) -> None:
    with open(os.path.join(out_dir, f"{os.getpid()}.json"), "w") as f:
        json.dump(launch_counts(), f)


if os.environ.get(ENV_COUNTS_DIR):
    atexit.register(_write_counts, os.environ[ENV_COUNTS_DIR])


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def cuda_dtype_code(dtype) -> int:
    """The launchers' dtype argument: 0 f32, 1 bf16, 2 f16."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(
            f"kernel takes float32, bfloat16 or float16; got {dtype}"
        )
    return _DTYPE_CODES[dtype]


def check_launch(name: str, err: int) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"kernel {name} launch failed: CUDA error {err}")
    count_launch(name)
