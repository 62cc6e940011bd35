"""Int8 delta compression with error feedback — the async tier's
bandwidth option (PyTorch port of ``distkeras_tpu.utils.compression``; the
codecs are host numpy, so both packages do the same arithmetic on the same
arrays and produce the same wire payloads).

The reference ships full pickled float32 weight sets on every pull/commit
(reference: distkeras/networking.py -> send_data/recv_data; SURVEY §5.8:
"no compression"); its ceiling is the one link every update crosses. Here the
async algorithms' COMMIT payloads (gradient deltas, elastic
displacements) can ride as int8: per-leaf symmetric linear quantization
(scale = max|x| / 127) cuts commit bytes ~4x, and the worker keeps the
quantization error as a residual added to its NEXT delta (error feedback,
a la 1-bit SGD / EF-SGD) so the error is carried, not lost — cumulative
drift stays bounded by one quantization step instead of growing with the
step count.

Trees are the port's parameter dicts (``{name: array}``, the parameter
server's center layout, in the JAX leaf order); the codecs walk them key
by key where the JAX package walks pytrees leaf by leaf.

Wire format: ``{"__dkt_q8__": {"q": int8 tree, "s": float32 scale tree}}``
— plain arrays. ``ParameterServer.commit`` transparently dequantizes, so
every PS rule (Delta/ADAG/DynSGD) works with compression on.
"""


from __future__ import annotations

import numpy as np

Q8_KEY = "__dkt_q8__"


def _map(fn, *trees):
    """``fn`` over the leaves of one or more parameter dicts, key by key in
    the first dict's order (the port's counterpart of a pytree map)."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _quantize_leaf(a):
    a = np.asarray(a, np.float32)
    amax = np.max(np.abs(a)) if a.size else np.float32(0)
    if not np.isfinite(amax):
        # a NaN/Inf delta means the worker diverged; quantizing it would
        # poison the error-feedback residual for every later commit
        # (np.round(nan) -> undefined int8), so fail loudly at the commit
        # boundary instead (ADVICE r3 #3)
        raise FloatingPointError(
            "non-finite delta leaf (max|x| = %r): refusing to quantize a "
            "diverged update" % amax
        )
    scale = np.float32(amax / 127.0)
    if scale == 0.0:
        return np.zeros(a.shape, np.int8), scale
    return np.clip(np.round(a / scale), -127, 127).astype(np.int8), scale


def _dequantize_leaf(q, scale):
    return q.astype(np.float32) * np.float32(scale)


def quantize_tree(tree):
    """-> (payload, dequantized tree). The payload is what goes on the
    wire; the dequantized tree is what the PS will reconstruct (callers
    use it to compute the error-feedback residual without a round trip)."""
    pairs = _map(_quantize_leaf, tree)
    qs = {k: q for k, (q, _) in pairs.items()}
    ss = {k: s for k, (_, s) in pairs.items()}
    deq = _map(_dequantize_leaf, qs, ss)
    return {Q8_KEY: {"q": qs, "s": ss}}, deq


def dequantize_tree(payload):
    body = payload[Q8_KEY]
    return _map(_dequantize_leaf, body["q"], body["s"])


def is_compressed(delta) -> bool:
    return isinstance(delta, dict) and set(delta.keys()) == {Q8_KEY}


def maybe_decompress(delta):
    """PS-side entry: pass raw deltas through, reconstruct compressed ones
    (int8-quantized or top-k-sparsified)."""
    if is_compressed(delta):
        return dequantize_tree(delta)
    if is_topk(delta):
        return topk_decompress(delta)
    return delta


BF16_KEY = "__dkt_bf16__"


def _bf16_encode_leaf(a):
    a = np.asarray(a)
    if a.dtype != np.float32:
        return a, np.int8(0)  # non-f32 leaves ride raw (flagged)
    u = a.view(np.uint32)
    # round-to-nearest-even on the truncated mantissa — EXCEPT for
    # exponent 0xFF lanes (inf/NaN): the rounding add would carry through
    # the exponent and turn a NaN center into inf (or wrap to 0.0),
    # silently masking a diverged run; truncation preserves the payload
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    nonfinite = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    out = np.where(nonfinite, u >> 16, rounded)
    # a NaN whose payload lives only in the truncated bits must stay NaN
    out = np.where(
        nonfinite & ((u & np.uint32(0x007FFFFF)) != 0),
        out | np.uint32(0x0040),
        out,
    )
    return out.astype(np.uint16), np.int8(1)


def _bf16_decode_leaf(v, flag):
    if not int(flag):
        return v
    return (v.astype(np.uint32) << 16).view(np.float32)


def bf16_encode_tree(tree):
    """Truncate float32 leaves to bfloat16-on-the-wire (uint16 payload,
    round-to-nearest); non-f32 leaves pass through, flagged. Halves pull
    bytes at bf16's 8-bit-mantissa precision — the same precision the
    compute path already runs activations at (compute_dtype)."""
    pairs = _map(_bf16_encode_leaf, tree)
    return {
        BF16_KEY: {
            "v": {k: v for k, (v, _) in pairs.items()},
            "m": {k: m for k, (_, m) in pairs.items()},
        }
    }


def bf16_decode_tree(payload):
    body = payload[BF16_KEY]
    return _map(_bf16_decode_leaf, body["v"], body["m"])


def is_bf16(tree) -> bool:
    return isinstance(tree, dict) and set(tree.keys()) == {BF16_KEY}


# ------------------------------------------------------- int8 pull tier

PULL_Q8_KEY = "__dkt_pull_q8__"

#: the values DistributedTrainer and ParameterServer accept for
#: pull_compress — ONE tuple so the two validation sites cannot drift
PULL_COMPRESS_VALUES = (None, "bfloat16", "int8")


def validate_pull_compress(spec):
    if spec not in PULL_COMPRESS_VALUES:
        raise ValueError(
            f"pull_compress must be one of {PULL_COMPRESS_VALUES}; got "
            f"{spec!r}"
        )
    return spec


def _int8_encode_leaf(a):
    """f32 leaf -> (int8 payload, scale, flag=1); anything the tier cannot
    represent faithfully rides raw with flag=0 — non-f32 leaves (integer/
    bool params are preserved by design, same as the bf16 tier) AND
    non-finite leaves (a NaN center must reach the worker AS NaN so a
    diverged run surfaces instead of killing the PS connection thread)."""
    a = np.asarray(a)
    if a.dtype != np.float32:
        return a, np.float32(0), np.int8(0)
    amax = np.max(np.abs(a)) if a.size else np.float32(0)
    if not np.isfinite(amax):
        return a, np.float32(0), np.int8(0)
    scale = np.float32(amax / 127.0)
    if scale == 0.0:
        return np.zeros(a.shape, np.int8), scale, np.int8(1)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale, np.int8(1)


def _int8_decode_leaf(v, s, flag):
    if not int(flag):
        return v
    return v.astype(np.float32) * np.float32(s)


def int8_encode_tree(tree):
    """Per-tensor symmetric int8 for the PULL direction: ~4x fewer center
    bytes than f32. One-shot rounding (error <= max|w|/254 per weight) —
    no error feedback exists on pulls because nothing accumulates; the
    async algorithms' noise tolerance absorbs it (convergence pinned by
    tests/test_compression.py). Unlike the commit-side quantize_tree this
    builds no dequantized copy (pulls don't need a residual) and passes
    non-f32 / non-finite leaves through raw, flagged."""
    triples = _map(_int8_encode_leaf, tree)
    return {
        PULL_Q8_KEY: {
            "v": {k: v for k, (v, _, _) in triples.items()},
            "s": {k: s for k, (_, s, _) in triples.items()},
            "f": {k: f for k, (_, _, f) in triples.items()},
        }
    }


def int8_decode_tree(payload):
    body = payload[PULL_Q8_KEY]
    return _map(_int8_decode_leaf, body["v"], body["s"], body["f"])


def is_pull_q8(tree) -> bool:
    return isinstance(tree, dict) and set(tree.keys()) == {PULL_Q8_KEY}


def maybe_decode_pull(center):
    """Worker-side entry: reconstruct a bf16- or int8-encoded pulled
    center (the PS encodes per its pull_compress; both wire forms are
    self-describing)."""
    if is_bf16(center):
        return bf16_decode_tree(center)
    if is_pull_q8(center):
        return int8_decode_tree(center)
    return center


def compress_with_feedback(delta, residual):
    """Worker-side entry: fold the previous residual into this delta,
    quantize, and return (wire payload, next residual)."""
    if residual is not None:
        delta = _map(lambda d, r: d + r, delta, residual)
    payload, deq = quantize_tree(delta)
    new_residual = _map(lambda d, x: d - x, delta, deq)
    return payload, new_residual


# --------------------------------------------------------------- top-k tier

TOPK_KEY = "__dkt_topk__"
DEFAULT_TOPK_FRAC = 0.01


def parse_compress_spec(spec):
    """``None | "int8" | "topk" | "topk:<frac>"`` -> (kind, frac|None).

    The fraction rides the spec string so the knob needs no extra kwarg
    through the trainer/worker constructors: ``compress="topk:0.05"``
    ships the largest 5% of each leaf's entries per commit."""
    if spec is None:
        return None, None
    if spec == "int8":
        return "int8", None
    if spec == "topk":
        return "topk", DEFAULT_TOPK_FRAC
    if isinstance(spec, str) and spec.startswith("topk:"):
        frac = float(spec.split(":", 1)[1])
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1]; got {frac}")
        return "topk", frac
    raise ValueError(
        f"compress must be None, 'int8', 'topk' or 'topk:<frac>'; got {spec!r}"
    )


def _topk_leaf(a, frac):
    a = np.asarray(a, np.float32)
    if a.size and not np.isfinite(a).all():
        raise FloatingPointError(
            "non-finite delta leaf: refusing to sparsify a diverged update"
        )
    flat = a.ravel()
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    k = max(1, int(np.ceil(frac * n)))
    if k >= n:
        idx = np.arange(n, dtype=np.int32)
    else:
        idx = np.argpartition(np.abs(flat), n - k)[n - k:].astype(np.int32)
    return idx, flat[idx]


def _topk_dense(idx, vals, shape):
    out = np.zeros(int(np.prod(shape)) if len(shape) else 1, np.float32)
    out[idx] = vals
    return out.reshape(tuple(int(d) for d in shape))


def topk_compress(tree, frac=DEFAULT_TOPK_FRAC):
    """-> (payload, dense reconstruction). Per leaf, ship only the k =
    ceil(frac * n) largest-|x| entries as (int32 index, float32 value)
    pairs — ~frac * 2 of the dense bytes (Deep-Gradient-Compression-style
    sparsification; the un-shipped mass is the caller's error-feedback
    residual). Wire format mirrors the int8 tier: plain arrays under one
    marker key, so the pickle-free DKT1 frame carries it unchanged."""
    pairs = _map(lambda a: _topk_leaf(a, frac), tree)
    shapes = _map(lambda a: np.asarray(np.shape(a), np.int64), tree)
    payload = {
        TOPK_KEY: {
            "i": {k: i for k, (i, _) in pairs.items()},
            "v": {k: v for k, (_, v) in pairs.items()},
            "s": shapes,
        }
    }
    deq = {k: _topk_dense(i, v, shapes[k]) for k, (i, v) in pairs.items()}
    return payload, deq


def topk_decompress(payload):
    body = payload[TOPK_KEY]
    return _map(_topk_dense, body["i"], body["v"], body["s"])


def is_topk(delta) -> bool:
    return isinstance(delta, dict) and set(delta.keys()) == {TOPK_KEY}


def topk_compress_with_feedback(delta, residual, frac=DEFAULT_TOPK_FRAC):
    """Worker-side entry: fold the previous residual in, sparsify, return
    (wire payload, next residual). Unshipped entries carry over entirely
    — momentum-free error feedback, the same conservation contract the
    int8 tier pins (sum of shipped + residual == sum of raw deltas)."""
    if residual is not None:
        delta = _map(lambda d, r: d + r, delta, residual)
    payload, deq = topk_compress(delta, frac)
    new_residual = _map(lambda d, x: d - x, delta, deq)
    return payload, new_residual
