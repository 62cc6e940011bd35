"""Per-request sampling: params, the counter RNG, filtering, token draws
(PyTorch port of ``distkeras_tpu.serving.sampling``; grammar masks wait).

Every sampled token draws from a key derived as
``fold_in(fold_in(PRNGKey(0), request_seed), emitted_position)`` — a pure
function of the request, so the same request replays token-identically,
solo or served, next to any neighbours. The key derivation and the
categorical draw are JAX's, bit for bit: threefry2x32 written in int64
tensor arithmetic on uint32 values, JAX's partitionable random-bits
layout (``jax_threefry_partitionable=True``, the default of jax 0.9),
bits -> uniform by the mantissa trick, ``-log(-log(u))`` Gumbel noise and
an argmax — so a seed samples the same tokens here as in the JAX package
(the float ops around the bits, ``log`` and the softmax inside
``filter_logits``, can differ in the last ulp, which moves a token only
at an exact near-tie).
"""

from __future__ import annotations

import torch

_GOLDEN = 0x9E3779B1  # 32-bit golden-ratio increment (completion seeds)
_SEED_MOD = 1 << 31
_M32 = 0xFFFFFFFF
_TINY = torch.finfo(torch.float32).tiny


def seed_for_completion(seed: int, completion: int) -> int:
    """The seed completion ``completion`` of a request samples under;
    completion 0 keeps the request seed (it is the solo reference)."""
    if completion == 0:
        return int(seed) % _SEED_MOD
    return (int(seed) + _GOLDEN * int(completion)) % _SEED_MOD


class SamplingParams:
    """Per-request sampling parameters. ``temperature=0`` (the default) is
    greedy argmax; ``top_k`` / ``top_p`` filter sampling and require
    ``temperature > 0``; ``seed`` keys the counter RNG; ``n`` asks for n
    parallel completions (the slot forking it needs is not ported yet)."""

    __slots__ = ("temperature", "top_k", "top_p", "seed", "n")

    def __init__(self, temperature=0.0, top_k=None, top_p=None, seed=0, n=1):
        self.temperature = float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.seed = int(seed) % _SEED_MOD
        self.n = int(n)
        self.validate()

    def validate(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0; got {self.temperature}"
            )
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1; got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {self.top_p}")
        if (
            (self.top_k is not None or self.top_p is not None)
            and self.temperature == 0.0
        ):
            raise ValueError(
                "top_k/top_p filter SAMPLING; temperature=0 is greedy "
                "argmax — pass a temperature > 0"
            )
        if self.n < 1:
            raise ValueError(f"n must be >= 1; got {self.n}")

    @property
    def is_default(self) -> bool:
        return self.temperature == 0.0 and self.n == 1

    def to_wire(self) -> dict:
        out = {}
        if self.temperature != 0.0:
            out["temperature"] = self.temperature
        if self.top_k is not None:
            out["top_k"] = self.top_k
        if self.top_p is not None:
            out["top_p"] = self.top_p
        if self.seed:
            out["seed"] = self.seed
        if self.n != 1:
            out["n"] = self.n
        return out

    @classmethod
    def from_wire(cls, d) -> "SamplingParams | None":
        """None / empty dict -> None (greedy); unknown keys raise."""
        if not d:
            return None
        if isinstance(d, SamplingParams):
            return d
        extra = set(d) - {"temperature", "top_k", "top_p", "seed", "n"}
        if extra:
            raise ValueError(f"unknown sampling fields {sorted(extra)}")
        return cls(**d)

    def __repr__(self):
        return f"SamplingParams({self.to_wire()})"


# --------------------------------------------------------------------------
# Counter RNG: threefry2x32 on uint32 values held in int64 tensors.
# --------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds, JAX's schedule) of counter pairs
    ``(x1, x2)`` under key ``(k1, k2)``; all broadcastable int64 tensors of
    uint32 values. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key, data):
    """``jax.random.fold_in`` on raw threefry keys: ``key`` is a pair of
    (B,) int64 words, ``data`` (B,) non-negative ints < 2^32."""
    k1, k2 = key
    return threefry2x32(k1, k2, torch.zeros_like(data), data & _M32)


def row_keys(seeds, spos):
    """One key per row: ``fold_in(fold_in(PRNGKey(0), seed), spos)``."""
    seeds = seeds.long()
    zero = torch.zeros_like(seeds)
    return fold_in(fold_in((zero, zero), seeds), spos.long())


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)`` per row, partitionable
    layout: counters (hi=0, lo=iota), output word1 ^ word2. Returns (B, n)
    int64."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` per row (mode "low")."""
    bits = random_bits(key, n)
    one = 0x3F800000  # float32 1.0's bits: the mantissa trick
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # a fill, not a copy from host memory (which waits for the stream)
    tiny = torch.full((), _TINY, dtype=torch.float32, device=f.device)
    u = torch.maximum(tiny, f * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def categorical(key, logits):
    """``jax.random.categorical`` per row: argmax(gumbel + logits)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


# --------------------------------------------------------------------------
# Filtering and the per-row draw.
# --------------------------------------------------------------------------


def filter_logits(scaled, top_k, top_p):
    """Per-row top-k / nucleus filtering of (B, V) temperature-scaled
    logits: excluded tokens become -inf. ``top_k[i] <= 0`` and
    ``top_p[i] >= 1`` disable the respective filter; with both set, the
    nucleus runs over the top-k survivors."""
    v = scaled.shape[-1]
    neg = torch.full((), float("-inf"), dtype=scaled.dtype,
                     device=scaled.device)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k <= 0, v, top_k), 1, v).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    out = torch.where(scaled < kth, neg, scaled)
    ranks = torch.arange(v, device=scaled.device)[None, :]
    sorted2 = torch.where(ranks < k[:, None], sorted_desc, neg)
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < torch.clamp(top_p, max=1.0)[:, None]
    thresh = torch.where(
        keep_sorted, sorted2, torch.full_like(sorted2, float("inf"))
    ).amin(dim=-1, keepdim=True)
    thresh = torch.where(top_p[:, None] >= 1.0, neg, thresh)
    return torch.where(out < thresh, neg, out)


def sample_tokens(logit, temps, top_k, top_p, seeds, spos, filtered=None):
    """(B, V) logits -> (B,) int64 tokens under per-row params: greedy rows
    (``temps[i] == 0``) take exact argmax; sampled rows draw
    ``categorical(key(seed_i, spos_i), filtered(logit_i / temp_i))``.
    ``filtered``: whether any row sets top-k or top-p, when the caller
    knows it from host copies (None reads it off the tensors, which on
    the card waits for the stream)."""
    greedy = torch.argmax(logit, dim=-1)
    scaled = logit / torch.clamp(temps, min=1e-6)[:, None]
    if filtered is None:
        filtered = bool((top_k > 0).any()) or bool((top_p < 1.0).any())
    if filtered:
        scaled = filter_logits(scaled, top_k, top_p)
    samp = categorical(row_keys(seeds, spos), scaled)
    return torch.where(temps > 0.0, samp, greedy)
