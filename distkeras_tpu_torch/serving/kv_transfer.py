"""Versioned codec for serialized slot state — the disaggregated
prefill/decode transfer format (PyTorch port of
``distkeras_tpu.serving.kv_transfer``; the frames are byte-identical, so a
prefill worker of either package hands off to a decode worker of either).

``DecodeStepper.swap_out`` gives THE host representation of a live slot:
per-stage K/V rows in the ``PrefixStore`` layout (``(p, H, Dh)`` numpy per
stage in the cache dtype, bit-exact), plus the context row, the host length
and the sampler state the position-keyed RNG needs to continue mid-stream.
This module is the byte-level face of that one format: the wire frame a
prefill worker ships to a decode worker.

Frame layout (everything before the payload is the golden-pinned header)::

    b"DKTX"                      magic (4 bytes)
    version      u16 big-endian  (currently 1)
    header_len   u32 big-endian
    header       JSON            shapes/dtypes/sampler scalars + crc32
    payload      raw array bytes ctx ++ per-stage K ++ V [++ spec_prompt]

The K/V arrays ride as RAW bytes (shape and dtype named in the header): a
byte-exact blit cannot re-quantize. A bf16 row is held here as its uint16
bit pattern (numpy has no bfloat16, and the port needs no ``ml_dtypes``);
the header names it ``"bfloat16"``, as the JAX package's does, and a
``"bfloat16"`` frame decodes to uint16 rows. uint16 is never a K/V dtype of
its own (``kv_dtype`` refuses integer dtypes), so the mapping is
unambiguous. A crc32 over the payload rides the header, so a flipped byte
anywhere in the bulk is a typed :class:`KvTransferError` at decode.

Grammar state is not serialized: it is a pure function of ``(grammar spec,
eos_id, tokens consumed)``, all of which ride the frame, so the decode side
recompiles and replays it.

Failure contract: every malformed input — truncated frame, wrong magic,
unknown version, crc mismatch, shape arithmetic that does not add up —
raises :class:`KvTransferError` (a ``ServingError``, code
``kv_transfer``). Decoding never hangs and never returns partial state.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib

import numpy as np

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.obs import MetricsRegistry
from distkeras_tpu_torch.serving.client import ServingClient
from distkeras_tpu_torch.serving.resilience import (
    CLOSED,
    CircuitBreaker,
    as_breaker_config,
    as_retry_budget,
)
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.serving.scheduler import (
    PeerError,
    ServingError,
    StaleEpochError,
)
from distkeras_tpu_torch.utils.serialization import serialize_params

MAGIC = b"DKTX"
VERSION = 1
_HEAD = struct.Struct(">HI")  # version, header_len


class KvTransferError(ServingError):
    """A transfer frame could not be decoded (truncated, corrupt, wrong
    magic/version) or encoded. The retry policy is the caller's: the
    prefill side re-encodes from live state, a router re-sends the same
    bytes to a sibling decode worker (decoding is read-only until the
    frame fully validates)."""

    code = "kv_transfer"


def _dtype_name(dt: np.dtype) -> str:
    """The header's name of a K/V row dtype: uint16 rows are bf16 bits."""
    return "bfloat16" if dt == np.uint16 else str(dt)


def _dtype(name: str) -> np.dtype:
    """A header dtype name as the host row dtype: ``"bfloat16"`` is uint16
    bits; any other name must be a numpy float dtype."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    try:
        dt = np.dtype(name)
    except TypeError as e:
        raise KvTransferError(
            f"transfer frame names unknown dtype {name!r}"
        ) from e
    if dt.kind != "f":
        raise KvTransferError(
            f"transfer frame names non-float K/V dtype {name!r}"
        )
    return dt


def encode_state(state: dict, *, prompt_len: int, sampling=None,
                 eos_id=None, epoch=None) -> bytes:
    """Serialize a ``swap_out`` state dict into one transfer frame.

    ``prompt_len``: the original prompt's length — positions
    ``prompt_len..len-1`` of the context row are tokens already emitted (0
    of them on the prefill->decode hop). ``sampling``: the request's
    ``SamplingParams`` (its wire dict rides the header; the slot's live
    seed and position counter ride separately, from ``state``).
    ``epoch``: the sender's KV epoch (fabric frames only; None keeps the
    header without the key): a receiver that pinned an epoch refuses a
    mismatching frame."""
    ln = int(state["len"])
    plen = int(prompt_len)
    if not 1 <= plen <= ln:
        raise KvTransferError(f"prompt_len {plen} outside [1, len={ln}]")
    ctx = np.ascontiguousarray(np.asarray(state["ctx"], np.int32))
    if ctx.shape != (ln,):
        raise KvTransferError(
            f"ctx shape {ctx.shape} does not match len {ln}"
        )
    chunks = [ctx.tobytes()]
    stages = []
    kv_dtype = None
    for k, v in state["kv"]:
        k = np.ascontiguousarray(np.asarray(k))
        v = np.ascontiguousarray(np.asarray(v))
        if k.shape != v.shape or k.dtype != v.dtype or k.ndim != 3:
            raise KvTransferError(
                f"malformed K/V stage rows: {k.shape}/{k.dtype} vs "
                f"{v.shape}/{v.dtype}"
            )
        if kv_dtype is None:
            kv_dtype = k.dtype
        stages.append(list(k.shape))
        chunks.append(k.tobytes())
        chunks.append(v.tobytes())
    sp = state.get("spec_prompt")
    if sp is not None:
        sp = np.ascontiguousarray(np.asarray(sp, np.int32))
        chunks.append(sp.tobytes())
    payload = b"".join(chunks)
    # key order, json.dumps defaults and the crc are the JAX encoder's:
    # the same state gives the same bytes in both packages
    header = {
        "len": ln,
        "prompt_len": plen,
        "spos": int(state["spos"]),
        "seed": int(state["seed"]),
        "sampling": None if sampling is None else sampling.to_wire(),
        "eos_id": None if eos_id is None else int(eos_id),
        "stages": stages,
        "kv_dtype": ("float32" if kv_dtype is None
                     else _dtype_name(kv_dtype)),
        "spec_prompt_len": None if sp is None else int(sp.size),
        "crc": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    if epoch is not None:
        header["epoch"] = int(epoch) & 0xFFFFFFFF
    h = json.dumps(header).encode()
    return MAGIC + _HEAD.pack(VERSION, len(h)) + h + payload


def decode_state(blob: bytes) -> dict:
    """One transfer frame -> the wire-state dict: every ``swap_out`` field
    bit-exactly, plus ``prompt_len`` / ``sampling`` (a ``SamplingParams``
    or None) / ``eos_id`` / ``epoch`` for request reassembly. Any
    malformation raises :class:`KvTransferError`."""
    if len(blob) < len(MAGIC) + _HEAD.size:
        raise KvTransferError(f"truncated transfer frame ({len(blob)} bytes)")
    if blob[: len(MAGIC)] != MAGIC:
        raise KvTransferError("bad transfer frame: missing DKTX magic")
    version, hlen = _HEAD.unpack_from(blob, len(MAGIC))
    if version != VERSION:
        raise KvTransferError(
            f"unsupported transfer format version {version} (this build "
            f"speaks {VERSION})"
        )
    off = len(MAGIC) + _HEAD.size
    if len(blob) < off + hlen:
        raise KvTransferError("truncated transfer frame header")
    try:
        header = json.loads(blob[off: off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise KvTransferError(
            f"unreadable transfer frame header: {e!r}"
        ) from e
    payload = blob[off + hlen:]
    try:
        want_crc = int(header["crc"])
        ln = int(header["len"])
        plen = int(header["prompt_len"])
        stages = [tuple(int(d) for d in s) for s in header["stages"]]
        kv_dtype = _dtype(header["kv_dtype"])
        sp_len = header.get("spec_prompt_len")
        spos, seed = int(header["spos"]), int(header["seed"])
        sampling = SamplingParams.from_wire(header.get("sampling"))
    except (KeyError, TypeError, ValueError) as e:
        raise KvTransferError(
            f"transfer frame header missing/invalid field: {e!r}"
        ) from e
    if zlib.crc32(payload) & 0xFFFFFFFF != want_crc:
        raise KvTransferError(
            "transfer frame payload crc mismatch (corrupt or truncated in "
            "flight)"
        )
    if ln < 1 or any(len(s) != 3 or min(s) < 0 for s in stages):
        raise KvTransferError(
            f"transfer frame shapes do not add up: len {ln}, stages "
            f"{stages}"
        )
    need = ln * 4 + sum(
        2 * int(np.prod(s)) * kv_dtype.itemsize for s in stages
    ) + (0 if sp_len is None else int(sp_len) * 4)
    if len(payload) != need:
        raise KvTransferError(
            f"transfer frame payload is {len(payload)} bytes, header "
            f"describes {need}"
        )
    if not 1 <= plen <= ln:
        raise KvTransferError(
            f"transfer frame prompt_len {plen} outside [1, len={ln}]"
        )
    pos = 0

    def take(dtype, shape):
        nonlocal pos
        n = int(np.prod(shape))
        arr = np.frombuffer(payload, dtype=dtype, count=n, offset=pos)
        pos += n * np.dtype(dtype).itemsize
        return arr.reshape(shape).copy()  # writable, detached from the frame

    ctx = take(np.int32, (ln,))
    kv = []
    for shape in stages:
        k = take(kv_dtype, shape)
        v = take(kv_dtype, shape)
        kv.append((k, v))
    sp = None if sp_len is None else take(np.int32, (int(sp_len),))
    return {
        "version": version,
        "len": ln,
        "prompt_len": plen,
        "ctx": ctx,
        "kv": kv,
        "spos": spos,
        "seed": seed,
        "sampling": sampling,
        "eos_id": header.get("eos_id"),
        "spec_prompt": sp,
        # the fabric's epoch stamp; None on a frame without one
        "epoch": header.get("epoch"),
    }


def encode_prefix(tokens, kv, *, epoch=None) -> bytes:
    """Serialize a prefix-cache entry — host ``PrefixStore`` rows for an
    exact token prefix — as one transfer frame, the ``kv.fetch`` reply
    format: ``len == prompt_len == tokens.size``, sampler scalars zero
    (the fetching side owns the request's sampler; fetched pages only
    pre-warm its prefix cache)."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32)).reshape(-1)
    if tokens.size < 1:
        raise KvTransferError("cannot encode an empty prefix")
    state = {"len": int(tokens.size), "ctx": tokens, "kv": kv, "spos": 0,
             "seed": 0}
    return encode_state(state, prompt_len=int(tokens.size), epoch=epoch)


class PeerFabric:
    """Pooled point-to-point client fabric for worker-to-worker KV
    movement — the transport of the fleet KV fabric.

    ``fetch`` pulls a sibling's cached prefix pages (the ``kv.fetch``
    verb); ``push`` ships a prefill worker's DKTX frame straight to its
    decode worker. Both share:

    - per-endpoint pooled ``ServingClient``s with client-side retry off
      (the fabric owns its retries);
    - a per-endpoint ``CircuitBreaker``: an open breaker SKIPS the op,
      typed :class:`PeerError`, without spending retry budget;
    - one shared ``RetryBudget``: each original op deposits, each retry
      withdraws;
    - the ``kv.peer`` fault seam, fired before any wire I/O.

    Fail-soft by contract: every failure is typed (:class:`PeerError` /
    :class:`StaleEpochError`) and the caller degrades — a fetch to local
    recompute, a push to the router's relay. Fetch replies are validated
    (codec, epoch, ctx equality) before the caller sees any state."""

    def __init__(self, registry=None, retry_budget=True, breaker=True,
                 fetch_timeout=10.0, push_timeout=120.0,
                 connect_timeout=2.0, max_fetch_retries=1):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.fetch_timeout = float(fetch_timeout)
        self.push_timeout = float(push_timeout)
        self.connect_timeout = float(connect_timeout)
        self.max_fetch_retries = int(max_fetch_retries)
        self.budget = as_retry_budget(retry_budget)
        self._breaker_cfg = as_breaker_config(breaker)
        self._breakers: dict = {}
        # (host, port, kind) -> idle clients: a fetch (short timeout) never
        # inherits a push socket's decode-length timeout or the reverse
        self._pool: dict = {}
        self._lock = threading.Lock()
        self.counters = self.registry.group(
            "serving_kv_peer",
            (
                "fetches",          # fetch attempts (client side)
                "fetch_ok",         # validated frames received
                "fetch_degraded",   # fetches degraded to recompute
                "fetch_retries",    # budget-granted re-dials
                "breaker_skips",    # ops skipped, breaker open
                "pushes",           # direct-push attempts
                "push_ok",          # pushed + decode replied ok
                "push_degraded",    # push failed -> router relay
                "fetch_served",     # serving half: frames shipped
                "fetch_miss",       # serving half: typed miss replies
                "stale_refusals",   # serving half: epoch mismatches
                "bytes_in",         # peer frame bytes received (fetch)
                "bytes_out",        # peer frame bytes sent (push+serve)
            ),
        )

    # -- pooling / breakers -------------------------------------------------

    @staticmethod
    def _ep(endpoint) -> tuple:
        return (str(endpoint[0]), int(endpoint[1]))

    def breaker(self, endpoint):
        """This endpoint's breaker (made on first use; None when breakers
        are off)."""
        if self._breaker_cfg is None:
            return None
        key = self._ep(endpoint)
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(**self._breaker_cfg)
            return br

    def _checkout(self, endpoint, kind):
        key = self._ep(endpoint) + (kind,)
        with self._lock:
            pool = self._pool.get(key)
            if pool:
                return pool.pop()
        return ServingClient(
            key[0], key[1],
            timeout=self.fetch_timeout if kind == "fetch"
            else self.push_timeout,
            retry=False, connect_timeout=self.connect_timeout,
        )

    def _checkin(self, endpoint, kind, cli, ok):
        if not ok:
            cli.close()
            return
        with self._lock:
            self._pool.setdefault(self._ep(endpoint) + (kind,), []).append(cli)

    def _roundtrip(self, endpoint, kind, header, payload):
        cli = self._checkout(endpoint, kind)
        ok = False
        try:
            reply, body = cli._roundtrip(header, payload,
                                         raise_on_error=False)
            ok = True
            return reply, body
        finally:
            self._checkin(endpoint, kind, cli, ok)

    def _gate(self, endpoint):
        """The breaker gate every peer op passes first: closed lets it
        through, open/half-open grants at most one probe, else the op is
        skipped typed with no retry-budget spend. Returns ``(breaker,
        probing)``."""
        br = self.breaker(endpoint)
        if br is None or br.state == CLOSED:
            return br, False
        granted, _ = br.try_probe()
        if not granted:
            self.counters["breaker_skips"] += 1
            raise PeerError(
                f"peer {self._ep(endpoint)} breaker is {br.state} (cause: "
                f"{br.open_cause}); skipping peer op"
            )
        return br, True

    @staticmethod
    def _outcome(br, probing, ok):
        if br is None:
            return
        if probing:
            br.record_probe(ok)
        elif ok:
            br.record_success()
        else:
            br.record_failure()

    # -- the two peer operations --------------------------------------------

    def fetch(self, endpoint, tokens, epoch=None):
        """Pull a sibling's cached prefix pages for ``tokens``: one
        ``kv.fetch`` roundtrip, the reply frame validated (codec, epoch,
        ctx equality against the requested tokens). Returns the decoded
        state dict, or None on a clean typed miss. Raises
        :class:`StaleEpochError` / :class:`PeerError` on every failure."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.counters["fetches"] += 1
        br, probing = self._gate(endpoint)
        faults.fire("kv.peer", direction="fetch", endpoint=self._ep(endpoint),
                    tokens=int(tokens.size))
        if self.budget is not None:
            self.budget.note_attempt()
        header = {"verb": "kv.fetch"}
        if epoch is not None:
            header["epoch"] = int(epoch)
        payload = serialize_params(tokens)
        attempt = 0
        while True:
            try:
                reply, body = self._roundtrip(endpoint, "fetch", header,
                                              payload)
            except (ConnectionError, TimeoutError, OSError) as e:
                self._outcome(br, probing, False)
                err = PeerError(
                    f"peer fetch from {self._ep(endpoint)} died on the "
                    f"wire: {e!r}"
                )
                if attempt >= self.max_fetch_retries or (
                    self.budget is not None and not self.budget.acquire()
                ):
                    raise err from e
                attempt += 1
                self.counters["fetch_retries"] += 1
                # re-gate: this failure may have opened the breaker, and an
                # open breaker outranks a granted retry token
                br, probing = self._gate(endpoint)
                continue
            if not reply.get("ok"):
                code = reply.get("error")
                detail = reply.get("detail", "")
                # a typed reply is the sibling working: not a breaker failure
                self._outcome(br, probing, True)
                if code == "stale_epoch":
                    raise StaleEpochError(
                        f"peer {self._ep(endpoint)} refused stale epoch "
                        f"{epoch}: {detail}"
                    )
                raise PeerError(
                    f"peer fetch refused by {self._ep(endpoint)}: {code}: "
                    f"{detail}"
                )
            self._outcome(br, probing, True)
            if not reply.get("hit"):
                return None  # clean miss: the digest was stale or evicted
            try:
                state = decode_state(bytes(body))
            except KvTransferError as e:
                # a corrupt frame from a live sibling: typed, no retry (it
                # would resend the same bytes); the caller recomputes
                raise PeerError(
                    f"peer fetch frame from {self._ep(endpoint)} failed "
                    f"validation: {e}"
                ) from e
            if epoch is not None and state.get("epoch") != int(epoch):
                raise PeerError(
                    f"peer fetch frame epoch {state.get('epoch')} != "
                    f"requested {int(epoch)} (sibling restarted "
                    f"mid-exchange)"
                )
            p = int(state["len"])
            if p > tokens.size or not np.array_equal(
                np.asarray(state["ctx"], np.int32)[:p], tokens[:p]
            ):
                raise PeerError(
                    f"peer fetch frame ctx does not match the requested "
                    f"prefix (served {p} positions)"
                )
            self.counters["fetch_ok"] += 1
            self.counters["bytes_in"] += len(body)
            return state

    def push(self, endpoint, header, payload):
        """Direct disaggregated push: ship ``payload`` (a DKTX frame) to
        the decode worker under ``header`` (a ``kv.transfer`` header) and
        return its ``(reply, body)``. No retry here: a failed push raises
        typed :class:`PeerError` and the caller hands the frame back to
        the router; typed decode replies are returned, not raised."""
        self.counters["pushes"] += 1
        br, probing = self._gate(endpoint)
        faults.fire("kv.peer", direction="push", endpoint=self._ep(endpoint),
                    nbytes=len(payload))
        if self.budget is not None:
            self.budget.note_attempt()
        try:
            reply, body = self._roundtrip(endpoint, "push", header, payload)
        except (ConnectionError, TimeoutError, OSError) as e:
            self._outcome(br, probing, False)
            self.counters["push_degraded"] += 1
            raise PeerError(
                f"peer push to {self._ep(endpoint)} died on the wire: {e!r}"
            ) from e
        # the hop itself worked, whatever the decode said
        self._outcome(br, probing, True)
        if reply.get("ok"):
            self.counters["push_ok"] += 1
            self.counters["bytes_out"] += len(payload)
        else:
            self.counters["push_degraded"] += 1
        return reply, body

    # -- observability / lifecycle ------------------------------------------

    def snapshot(self) -> dict:
        """The fabric ledger (rides ``health``/``stats``)."""
        with self._lock:
            breakers = {f"{h}:{p}": br.snapshot()
                        for (h, p), br in self._breakers.items()}
            pooled = sum(len(v) for v in self._pool.values())
        out = dict(self.counters)
        out["breakers"] = breakers
        out["budget"] = None if self.budget is None else self.budget.snapshot()
        out["pooled_clients"] = pooled
        return out

    def close(self) -> None:
        with self._lock:
            clients = [c for pool in self._pool.values() for c in pool]
            self._pool.clear()
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
