"""Build the port's hand-written CUDA kernels from this checkout's sources.

Each ``csrc/*.cu`` exports one ``extern "C"`` launcher per kernel
(``flash_bwd.cu`` and ``sgd_fused.cu`` have two). ``nvcc`` compiles it
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library with a plain C interface, which ``ctypes`` loads; tensors pass as
``data_ptr()`` integers and the launch rides PyTorch's current stream. Sources include only the
CUDA headers, never PyTorch's, so a build takes seconds rather than the
minutes a ``torch/extension.h`` translation unit costs. No
``--use_fast_math``: sqrt, division and exp are IEEE, as in the plain
versions.

Builds happen at first use, one ``nvcc`` per source, all started together,
into ``_build/`` beside this file (listed in ``.gitignore``). A library is
named after the content hash of its source and of every header the source
includes with quotes (``flash_common.cuh``, shared by both flash sources),
so an edited source or header rebuilds every library built from it and an
unchanged one is reused by later processes on the same machine. A missing
``nvcc``, a failed compile or a failed load raises ``RuntimeError``: there
is no fallback.

A build is the port's compile: the calling thread stalls for it. Observers
(``add_build_observer``) hear of each one twice, on the building thread:
``fn(names, None)`` before it starts and ``fn(names, seconds)`` after the
compile plus the load succeeded — the serving engine extends its watchdog's
grace on the first and records a ``build[<kernel>]`` mint on its compile
ledger on the second.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: kernel name -> (source file, exported symbol, ctypes argtypes)
KERNELS = {
    "layernorm_fwd": (
        "layernorm_fwd.cu",
        "dk_layernorm_fwd",
        [_P, _P, _P, _P, _L, _I, _F, _I, _P],
    ),
    "layernorm_bwd": (
        "layernorm_bwd.cu",
        "dk_layernorm_bwd",
        [_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P],
    ),
    "flash_fwd": (
        "flash_fwd.cu",
        "dk_flash_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "flash_bwd_dq": (
        "flash_bwd.cu",
        "dk_flash_bwd_dq",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "flash_bwd_dkv": (
        "flash_bwd.cu",
        "dk_flash_bwd_dkv",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "adam_fused": (
        "adam_fused.cu",
        "dk_adam_fused",
        [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _P, _I, _P],
    ),
    "sgd_fused": (
        "sgd_fused.cu",
        "dk_sgd_fused",
        [_P, _P, _P, _I, _I, _F, _I, _P],
    ),
    "sgd_momentum_fused": (
        "sgd_fused.cu",
        "dk_sgd_momentum_fused",
        [_P, _P, _P, _I, _I, _F, _F, _I, _I, _P],
    ),
}

_lock = threading.Lock()
_fns: dict[str, object] = {}
_observers: list = []
#: nvcc's ``-Xptxas -v`` report per source file (registers, shared
#: memory, spills) from the builds this process ran
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the one on ``PATH``. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use on a machine with the CUDA "
            "toolkit"
        )
    return found


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def _source_files(src: Path) -> list[Path]:
    """``src`` and every header it includes with quotes, directly or
    through another header (resolved beside the including file)."""
    files, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc
                 for inc in _QUOTED_INCLUDE.findall(path.read_text())]
    return files


def _library_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256()
    for path in _source_files(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _compile_all(names) -> None:
    """Start one nvcc per missing library (one per source, however many
    kernels it holds), wait for all, raise on any failure with the
    compiler's output."""
    todo = {}
    for name in names:
        out = _library_path(name)
        if not out.is_file():
            todo.setdefault(out, KERNELS[name][0])
    if not todo:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for out, src in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(CSRC / src),
        ]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[src] = log
        if proc.returncode != 0:
            errors.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def add_build_observer(fn) -> None:
    """Call ``fn(names, seconds)`` around every build: ``seconds`` is None
    before it starts, then the wall seconds of the compile and the load."""
    with _lock:
        _observers.append(fn)


def remove_build_observer(fn) -> None:
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def _notify(observers, names, seconds) -> None:
    for fn in observers:
        try:
            fn(list(names), seconds)
        except Exception:  # noqa: BLE001 — observability boundary
            pass


def build(names=None) -> dict:
    """Compile (where needed) and load the named kernels (default: all);
    returns ``{name: ctypes function}``."""
    names = list(KERNELS if names is None else names)
    with _lock:
        missing = [n for n in names if n not in _fns]
        if missing:
            observers = list(_observers)
            _notify(observers, missing, None)
            t0 = time.perf_counter()
            _compile_all(missing)
            for name in missing:
                _, symbol, argtypes = KERNELS[name]
                try:
                    lib = ctypes.CDLL(str(_library_path(name)))
                    fn = getattr(lib, symbol)
                except (OSError, AttributeError) as e:
                    raise RuntimeError(
                        f"kernel {name}: loading {_library_path(name)} "
                        f"failed: {e}"
                    ) from e
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
            _notify(observers, missing, time.perf_counter() - t0)
        return {n: _fns[n] for n in names}


def kernel(name: str):
    """The loaded launcher of one kernel, built on first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = build([name])[name]
    return fn
