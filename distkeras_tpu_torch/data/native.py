"""ctypes bridge to the native (C++) data-path library (PyTorch port of
``distkeras_tpu.data.native``).

Builds the port's own copy of the source, ``distkeras_tpu_torch/native/
dkt_data.cpp``, into a shared library on first use (``g++ -O3 -shared
-fPIC``) under ``kernels/_build/`` beside the CUDA kernels (a directory
``.gitignore`` lists). The library is named after a hash of the source and
the compile command, so an edited source builds anew and an unchanged one
is reused by later processes; it is compiled to a temp file and published
with ``os.replace``, so concurrent processes racing to the first build
never load a half-written file. Nothing is written into the JAX package.

Host code, not a device kernel: the contract is the JAX package's —
callers check ``available()`` and take the Python path when the toolchain
is missing or ``DKT_NO_NATIVE=1``; calling an entry point while
unavailable raises a clean RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "dkt_data.cpp"
BUILD_DIR = _PKG / "kernels" / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_failed = False


def _disabled() -> bool:
    return os.environ.get("DKT_NO_NATIVE", "") == "1"


def library_path() -> Path:
    """Where the library built from this checkout's source lives: keyed
    on the content hash of the source and the compile flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"dkt_data-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    # compile to a private temp file, publish with an atomic rename: a
    # concurrent process can never dlopen a half-written .so. Any
    # filesystem/toolchain failure (read-only checkout, missing g++)
    # degrades to the Python path instead of raising.
    tmp = None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *_FLAGS, "-o", tmp, str(SRC)]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        logger.warning("native data library build failed (%s); using Python", e)
        if tmp is not None and os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


def _load():
    global _lib, _build_failed
    if _disabled():
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            out = library_path()
        except OSError as e:  # e.g. source missing from a stripped install
            logger.warning("native data library source unreadable (%s)", e)
            _build_failed = True
            return None
        if not out.is_file() and not _build(out):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            logger.warning("native data library load failed (%s)", e)
            _build_failed = True
            return None
        lib.dkt_csv_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dkt_csv_dims.restype = ctypes.c_int
        lib.dkt_csv_load.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dkt_csv_load.restype = ctypes.c_int
        lib.dkt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.dkt_free.restype = None
        lib.dkt_gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.dkt_gather_rows_f32.restype = None
        _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native data library unavailable (no C++ toolchain, build "
            "failure, or DKT_NO_NATIVE=1) — use the Python fallback path"
        )
    return lib


def available() -> bool:
    """True when the native library is usable (built or buildable)."""
    return _load() is not None


def csv_dims(path: str):
    """(rows, cols, has_header) for a numeric CSV."""
    lib = _require()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    header = ctypes.c_int()
    rc = lib.dkt_csv_dims(
        os.fsencode(path), ctypes.byref(rows), ctypes.byref(cols),
        ctypes.byref(header),
    )
    if rc != 0:
        raise OSError(f"native csv_dims failed for {path!r}")
    return rows.value, cols.value, bool(header.value)


def read_csv(path: str) -> tuple[np.ndarray, bool]:
    """Single-pass parse of a numeric CSV -> (float32 (rows, cols) array,
    had_header). One file read, one parse pass; quoted numeric fields OK;
    empty/ragged fields raise (matching the Python fallback's strictness)."""
    lib = _require()
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    header = ctypes.c_int()
    rc = lib.dkt_csv_load(
        os.fsencode(path), ctypes.byref(data), ctypes.byref(rows),
        ctypes.byref(cols), ctypes.byref(header),
    )
    if rc == -1:
        raise OSError(f"native csv read failed for {path!r}")
    if rc == -2:
        raise ValueError(
            f"native csv parse failed for {path!r}: malformed, empty, or "
            "ragged field"
        )
    try:
        n = rows.value * cols.value
        out = np.ctypeslib.as_array(data, shape=(n,)).copy() if n else (
            np.empty((0,), np.float32)
        )
    finally:
        lib.dkt_free(data)
    return out.reshape(rows.value, cols.value), bool(header.value)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]] along axis 0 for a float32 array (any rank)."""
    lib = _require()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    row_shape = src.shape[1:]
    row_elems = int(np.prod(row_shape)) if row_shape else 1
    out = np.empty((idx.shape[0], *row_shape), np.float32)
    lib.dkt_gather_rows_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.shape[0],
        row_elems,
    )
    return out
