"""Profiling, tracing and structured metrics (PyTorch port of
``distkeras_tpu.utils.profiling``).

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA's when asked for) that writes a Chrome trace
  (``trace_<ns>.json``, viewable in Perfetto or ``chrome://tracing``)
  into ``logdir``. Trainers expose it via ``profile_dir=``.
- ``annotate(name)``: a named span on that timeline
  (``torch.profiler.record_function``), for host-side phases.
- ``MetricsLogger``: append-only JSONL metrics sink (thread-safe, size
  rotation, torn-tail repair) and ``read_metrics`` — a copy of the JAX
  module's stdlib code, which the port may not import.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager


@contextmanager
def trace(logdir: str, cuda: bool = False):
    """Profile the enclosed block into a Chrome trace in ``logdir``;
    ``cuda`` adds the device's kernels and copies (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span on the profiler timeline (host-side phases)."""
    from torch.profiler import record_function

    return record_function(name)


class MetricsLogger:
    """Thread-safe JSONL sink: one JSON object per line, ``ts`` added.

    Size-bounded rotation: with ``max_bytes`` set, an append that
    would push the active file past the bound first rotates it —
    ``path`` -> ``path.1`` -> ``path.2`` -> ... up to ``keep``
    segments, the oldest dropped — so a week-long soak's sink stays
    bounded at ~``max_bytes * (keep + 1)`` instead of growing without
    limit. Rotation happens on a line boundary under the logger's
    lock, so every segment is whole-line JSONL; ``read_metrics`` reads
    across the rotated segments transparently."""

    def __init__(self, path: str, max_bytes: int | None = None,
                 keep: int = 5):
        self.path = path
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        if self.max_bytes is not None and self.max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1; got {max_bytes}")
        self.keep = int(keep)
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1; got {keep}")
        self.rotations = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        # a previous process that died mid-append left a torn final
        # line; appending past it would turn the expected crash
        # artifact (salvageable torn TAIL) into mid-file garbage the
        # reader rightly refuses — and rotation would archive it into
        # a strict segment. Drop the partial line now: read_metrics
        # was going to drop it anyway, and every later append (and
        # every rotated segment) stays whole-line JSONL. A concurrent
        # healthy writer always ends the file with a newline, so this
        # only ever cuts a genuinely torn tail.
        self._repair_torn_tail()

    def _repair_torn_tail(self):
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(size - 1)
                if f.read(1) == b"\n":
                    return
                # scan back (bounded chunks) for the last newline
                pos = size
                keep = 0
                while pos > 0:
                    step = min(4096, pos)
                    pos -= step
                    f.seek(pos)
                    chunk = f.read(step)
                    nl = chunk.rfind(b"\n")
                    if nl != -1:
                        keep = pos + nl + 1
                        break
                f.truncate(keep)
        except OSError:
            pass  # no file yet, or unreadable: nothing to repair

    def log(self, **fields):
        # open-append-close per record: no fd held between logs (a sweep can
        # construct thousands of trainers without leaking handles), and a
        # whole line lands per write so concurrent loggers never interleave
        record = {"ts": time.time(), **fields}
        line = json.dumps(record) + "\n"
        with self._lock:
            if self.max_bytes is not None:
                try:
                    size = os.path.getsize(self.path)
                except OSError:
                    size = 0
                if size > 0 and size + len(line) > self.max_bytes:
                    self._rotate_locked()
            with open(self.path, "a") as f:
                f.write(line)
        return record

    def _rotate_locked(self):
        """Shift ``path.i`` -> ``path.i+1`` (the oldest, ``path.keep``,
        is dropped), then ``path`` -> ``path.1``. Caller holds the
        lock; every move is an atomic rename."""
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self.rotations += 1

    def close(self):
        pass  # nothing held open; kept for API compatibility

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def rotated_segments(path: str) -> list:
    """Every on-disk segment of a (possibly rotated) JSONL sink,
    OLDEST FIRST: ``path.N`` ... ``path.1``, then the active
    ``path`` — so concatenating the reads preserves append order."""
    out = []
    n = 1
    while os.path.exists(f"{path}.{n}"):
        out.append(f"{path}.{n}")
        n += 1
    out.reverse()
    if os.path.exists(path) or not out:
        out.append(path)  # missing active file raises in the reader
    return out


def read_metrics(path: str, strict: bool = False):
    """Read a JSONL metrics file back into a list of dicts — across
    rotated segments (``MetricsLogger(max_bytes=...)`` writes
    ``path.N`` ... ``path.1`` plus the active ``path``; records come
    back oldest first, exactly as appended).

    A process that dies mid-append leaves a torn FINAL line of the
    ACTIVE file; by default that line is dropped and every whole
    record before it is returned (``strict=True`` restores the
    raise). Garbage anywhere else — mid-file, or in a rotated segment
    (which only ever holds whole lines, because rotation happens on a
    line boundary) — is still an error: a half-written tail is an
    expected crash artifact, a corrupt middle is not."""
    segments = rotated_segments(path)
    out = []
    for seg in segments[:-1]:
        out.extend(_read_segment(seg, salvage=False))
    out.extend(_read_segment(segments[-1], salvage=not strict))
    return out


def _read_segment(path: str, salvage: bool):
    out = []
    held = None  # previous non-empty line: parsed only once a later
    # one proves it was not the (possibly torn) final append
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if held is not None:
                out.append(json.loads(held))
            held = line
    if held is not None:
        try:
            out.append(json.loads(held))
        except json.JSONDecodeError:
            if not salvage:
                raise
            # torn final append: salvage everything before it
    return out
