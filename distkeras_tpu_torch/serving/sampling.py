"""Per-request sampling: params, the counter RNG, filtering, token draws,
the speculative window samplers and the grammar mask compiler (PyTorch
port of ``distkeras_tpu.serving.sampling``).

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

``TokenMaskCompiler`` turns a grammar spec (``allow``, ``sequence``,
``choice``, ``fsm``) into per-slot incremental host state whose ``mask()``
is the allowed-token set of the next position; the stepper applies it as
an additive ``0 / -inf`` row before temperature, top-k and top-p. It is
pure host numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

#: the greedy-agreement refusal, raised only by the explicit strict mode
#: (the engine and the stepper both validate through
#: ``check_spec_sampling``)
SPEC_GREEDY_MSG = (
    "speculative serving verifies GREEDY agreement; it is only defined "
    "for temperature=0 without top_k/top_p (spec_mode='strict' — use "
    "the default spec_mode='rejection' to serve sampled requests "
    "speculatively)"
)

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


def check_spec_sampling(spec_mode: str, temperature=0.0, top_k=None,
                        top_p=None) -> str:
    """Validate a speculative engine's sampling posture; returns the mode.
    ``"rejection"`` (the default) accepts any sampling config;
    ``"strict"`` raises ``SPEC_GREEDY_MSG`` for anything non-greedy."""
    if spec_mode not in ("rejection", "strict"):
        raise ValueError(
            f"spec_mode must be 'rejection' or 'strict'; got {spec_mode!r}"
        )
    if spec_mode == "strict" and (
        temperature != 0.0 or top_k is not None or top_p is not None
    ):
        raise ValueError(SPEC_GREEDY_MSG)
    return spec_mode


class SamplingParams:
    """Per-request sampling parameters. ``temperature=0`` (the default) is
    greedy argmax; ``top_k`` / ``top_p`` filter sampling and require
    ``temperature > 0``; ``seed`` keys the counter RNG; ``n`` asks for n
    parallel completions: one prefill, then copy-on-write forks (a paged
    engine), completion j sampling under ``seed_for_completion(seed, j)``.
    ``grammar``: a ``TokenMaskCompiler`` spec dict; it constrains greedy
    and sampled selection alike."""

    __slots__ = ("temperature", "top_k", "top_p", "seed", "n", "grammar")

    def __init__(self, temperature=0.0, top_k=None, top_p=None, seed=0, n=1,
                 grammar=None):
        self.temperature = float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.seed = int(seed) % _SEED_MOD
        self.n = int(n)
        self.grammar = grammar
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
        if self.grammar is not None:
            TokenMaskCompiler.check(self.grammar)

    @property
    def is_greedy(self) -> bool:
        """True when selection is argmax (a grammar may still constrain
        the candidates)."""
        return self.temperature == 0.0

    @property
    def is_default(self) -> bool:
        """True when these params reproduce the no-params path exactly:
        greedy, unconstrained, one completion."""
        return (self.temperature == 0.0 and self.grammar is None
                and self.n == 1)

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
        if self.grammar is not None:
            out["grammar"] = self.grammar
        return out

    @classmethod
    def from_wire(cls, d) -> "SamplingParams | None":
        """None / empty dict -> None (greedy); unknown keys raise."""
        if not d:
            return None
        if isinstance(d, SamplingParams):
            return d
        extra = set(d) - {"temperature", "top_k", "top_p", "seed", "n",
                          "grammar"}
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


# --------------------------------------------------------------------------
# Speculative verify windows.
# --------------------------------------------------------------------------


def _accepted(acc):
    """(B, C-1) acceptance flags -> (B,) tokens emitted: the accepted
    prefix (up to the first rejection) plus the target's correction."""
    return acc.long().cumprod(dim=1).sum(dim=1) + 1


def greedy_window_tokens(logit, dtoks, dcnt):
    """(B, C, V) logits -> ``(argmax tokens (B, C), n_new (B,))``: accept
    the longest argmax-agreeing drafted prefix (of the ``dcnt[i]`` real
    proposals in ``dtoks`` (B, C-1)) plus the target's correction."""
    c = logit.shape[1]
    greedy = torch.argmax(logit, dim=-1)
    ranks = torch.arange(c - 1, device=logit.device)[None, :]
    agree = (dtoks.long() == greedy[:, : c - 1]) & (ranks < dcnt[:, None])
    return greedy, _accepted(agree)


def spec_window_tokens(logit, dtoks, dcnt, temps, top_k, top_p, seeds, spos,
                       filtered=None):
    """Mixed greedy / sampled acceptance over one verify window. ``logit``
    (B, C, V) holds the target's logits at the C candidate positions
    (position j distributes the token at emitted index ``spos + j``),
    ``dtoks`` (B, C-1) the proposals, ``dcnt`` how many are real. Returns
    ``(out (B, C), n_new (B,))``: row i emits the first ``n_new[i]`` of
    ``out[i]``.

    Greedy rows accept by argmax agreement and emit the argmax. Sampled
    rows accept a drafted token iff it equals the position-keyed draw
    ``categorical(key(seed, spos + j), filtered p)`` the plain step would
    make there, and emit that draw at every position — so a speculative
    sampled stream is token for token the plain sampled stream (rejection
    sampling for a point-mass proposal). ``filtered`` as in
    ``sample_tokens``."""
    b, c, v = logit.shape
    greedy = torch.argmax(logit, dim=-1)  # (B, C)
    scaled = (logit / torch.clamp(temps, min=1e-6)[:, None, None]).reshape(
        b * c, v)
    if filtered is None:
        filtered = bool((top_k > 0).any()) or bool((top_p < 1.0).any())
    if filtered:
        scaled = filter_logits(scaled, top_k.repeat_interleave(c),
                               top_p.repeat_interleave(c))
    ranks = torch.arange(c, device=logit.device)
    spos_c = (spos.long()[:, None] + ranks[None, :]).reshape(-1)
    fresh = categorical(row_keys(seeds.repeat_interleave(c), spos_c),
                        scaled).reshape(b, c)
    d = dtoks.long()
    sampled = (temps > 0.0)[:, None]
    acc = (ranks[None, : c - 1] < dcnt[:, None]) & torch.where(
        sampled, d == fresh[:, : c - 1], d == greedy[:, : c - 1])
    return torch.where(sampled, fresh, greedy), _accepted(acc)


# --------------------------------------------------------------------------
# Grammar-constrained decoding: pure-host mask compiler.
# --------------------------------------------------------------------------


class _GrammarState:
    """Per-slot incremental mask state: ``mask()`` yields the (V,) bool
    allowed-token mask for the NEXT position, ``advance(tok)`` consumes
    the emitted token, ``clone()`` branches state for a CoW fork (each
    completion walks the grammar independently)."""

    def __init__(self, vocab_size, eos_id):
        self.vocab_size = int(vocab_size)
        self.eos_id = eos_id

    def _base(self, allow_eos=False):
        m = np.zeros(self.vocab_size, bool)
        if allow_eos and self.eos_id is not None and (
            0 <= self.eos_id < self.vocab_size
        ):
            m[self.eos_id] = True
        return m

    def mask(self) -> np.ndarray:
        raise NotImplementedError

    def advance(self, tok: int) -> None:
        raise NotImplementedError

    def clone(self) -> "_GrammarState":
        raise NotImplementedError


class _AllowState(_GrammarState):
    """Fixed whitelist every position (eos always allowed, so the
    request can finish)."""

    def __init__(self, vocab_size, eos_id, tokens):
        super().__init__(vocab_size, eos_id)
        self._mask = self._base(allow_eos=True)
        for t in tokens:
            if 0 <= int(t) < vocab_size:
                self._mask[int(t)] = True

    def mask(self):
        return self._mask

    def advance(self, tok):
        pass

    def clone(self):
        c = _AllowState.__new__(_AllowState)
        c.vocab_size, c.eos_id, c._mask = self.vocab_size, self.eos_id, self._mask
        return c


class _SequenceState(_GrammarState):
    """Position-indexed allowed sets; past the last step: eos-only
    (``loop=False``, the default) or wrap to step 0 (``loop=True``)."""

    def __init__(self, vocab_size, eos_id, steps, loop=False):
        super().__init__(vocab_size, eos_id)
        self.steps = [
            [int(t) for t in step if 0 <= int(t) < vocab_size]
            for step in steps
        ]
        self.loop = bool(loop)
        self.pos = 0

    def mask(self):
        if self.pos >= len(self.steps):
            if self.loop:
                idx = self.pos % len(self.steps)
            else:
                return self._base(allow_eos=True)  # forced finish
        else:
            idx = self.pos
        m = self._base(allow_eos=self.pos >= len(self.steps))
        for t in self.steps[idx]:
            m[t] = True
        return m

    def advance(self, tok):
        self.pos += 1

    def clone(self):
        c = _SequenceState(self.vocab_size, self.eos_id, [], self.loop)
        c.steps, c.pos = self.steps, self.pos
        return c


class _ChoiceState(_GrammarState):
    """Trie over a finite set of allowed token sequences (the
    JSON-schema "enum of literal values" shape, token-level): at each
    position, the allowed tokens are the next tokens of every sequence
    still consistent with what was emitted; a fully-matched sequence
    allows eos. An off-grammar token (possible only through forced-EOS
    fallback interplay) dead-ends the state — the next mask is empty
    and the fallback fires."""

    def __init__(self, vocab_size, eos_id, sequences):
        super().__init__(vocab_size, eos_id)
        self.sequences = [
            [int(t) for t in s] for s in sequences if len(s)
        ]
        self.live = list(range(len(self.sequences)))
        self.pos = 0

    def mask(self):
        done = False
        m = self._base()
        for i in self.live:
            seq = self.sequences[i]
            if self.pos < len(seq):
                if 0 <= seq[self.pos] < self.vocab_size:
                    m[seq[self.pos]] = True
            else:
                done = True
        if done and self.eos_id is not None and (
            0 <= self.eos_id < self.vocab_size
        ):
            m[self.eos_id] = True
        return m

    def advance(self, tok):
        tok = int(tok)
        self.live = [
            i for i in self.live
            if self.pos < len(self.sequences[i])
            and self.sequences[i][self.pos] == tok
        ]
        self.pos += 1

    def clone(self):
        c = _ChoiceState(self.vocab_size, self.eos_id, [])
        c.sequences, c.live, c.pos = self.sequences, list(self.live), self.pos
        return c


class _FsmState(_GrammarState):
    """Explicit token-level DFA: ``states[s]`` maps token id -> next
    state; accept states additionally allow eos. Tokens without an
    edge are masked off; an emitted token without an edge (forced-EOS
    interplay) dead-ends the state."""

    def __init__(self, vocab_size, eos_id, start, states, accept):
        super().__init__(vocab_size, eos_id)
        self.states = {
            str(s): {int(t): str(n) for t, n in edges.items()}
            for s, edges in states.items()
        }
        self.accept = {str(s) for s in (accept or [])}
        self.state = str(start)

    def mask(self):
        edges = self.states.get(self.state, {})
        m = self._base(allow_eos=self.state in self.accept)
        for t in edges:
            if 0 <= t < self.vocab_size:
                m[t] = True
        return m

    def advance(self, tok):
        self.state = self.states.get(self.state, {}).get(int(tok), "\0dead")

    def clone(self):
        c = _FsmState.__new__(_FsmState)
        c.vocab_size, c.eos_id = self.vocab_size, self.eos_id
        c.states, c.accept, c.state = self.states, self.accept, self.state
        return c


class TokenMaskCompiler:
    """Compile grammar specs into per-slot incremental mask state.

    Specs are JSON-able dicts (they ride the wire inside
    ``SamplingParams.grammar``):

    - ``{"kind": "allow", "tokens": [...]}`` — fixed whitelist.
    - ``{"kind": "sequence", "steps": [[...], ...], "loop": false}`` —
      position i must come from ``steps[i]``; past the end, eos only
      (or wrap when ``loop``).
    - ``{"kind": "choice", "sequences": [[...], ...]}`` — one of a
      finite set of token sequences (trie-compiled; the JSON-schema
      enum shape at token level).
    - ``{"kind": "fsm", "start": s, "states": {s: {tok: s'}},
      "accept": [...]}`` — explicit token-level DFA.

    ``check`` validates STRUCTURE without a vocabulary (submit-time,
    so a bad spec is a client ``ValueError``); ``compile`` binds a
    vocab size + the request's eos id and returns the mutable state.
    """

    KINDS = ("allow", "sequence", "choice", "fsm")

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)

    @staticmethod
    def check(spec) -> None:
        """Structural validation (raises ``ValueError``); shared by
        ``SamplingParams.validate`` so malformed grammars die at the
        submit boundary, typed, before any slot state exists."""
        if not isinstance(spec, dict):
            raise ValueError(f"grammar spec must be a dict; got {type(spec).__name__}")
        kind = spec.get("kind")
        if kind not in TokenMaskCompiler.KINDS:
            raise ValueError(
                f"grammar kind must be one of {TokenMaskCompiler.KINDS}; "
                f"got {kind!r}"
            )
        if kind == "allow":
            toks = spec.get("tokens")
            if not isinstance(toks, (list, tuple)) or not toks:
                raise ValueError("allow grammar needs a non-empty 'tokens' list")
        elif kind == "sequence":
            steps = spec.get("steps")
            if not isinstance(steps, (list, tuple)) or not steps or any(
                not isinstance(s, (list, tuple)) or not s for s in steps
            ):
                raise ValueError(
                    "sequence grammar needs non-empty 'steps' of non-empty "
                    "token lists"
                )
        elif kind == "choice":
            seqs = spec.get("sequences")
            if not isinstance(seqs, (list, tuple)) or not seqs or any(
                not isinstance(s, (list, tuple)) or not s for s in seqs
            ):
                raise ValueError(
                    "choice grammar needs non-empty 'sequences' of non-empty "
                    "token lists"
                )
        else:  # fsm
            states = spec.get("states")
            if not isinstance(states, dict) or not states:
                raise ValueError("fsm grammar needs a non-empty 'states' dict")
            if str(spec.get("start")) not in {str(s) for s in states}:
                raise ValueError(
                    f"fsm start state {spec.get('start')!r} not in states"
                )
            for s, edges in states.items():
                if not isinstance(edges, dict):
                    raise ValueError(f"fsm state {s!r} edges must be a dict")

    def compile(self, spec, eos_id=None) -> _GrammarState:
        self.check(spec)
        kind = spec["kind"]
        if kind == "allow":
            return _AllowState(self.vocab_size, eos_id, spec["tokens"])
        if kind == "sequence":
            return _SequenceState(
                self.vocab_size, eos_id, spec["steps"],
                loop=bool(spec.get("loop")),
            )
        if kind == "choice":
            return _ChoiceState(self.vocab_size, eos_id, spec["sequences"])
        return _FsmState(
            self.vocab_size, eos_id, spec["start"], spec["states"],
            spec.get("accept"),
        )
