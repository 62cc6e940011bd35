"""Inference over Datasets and autoregressive decode (PyTorch port of
``distkeras_tpu.predictors``: ``ModelPredictor`` on one device,
``SequenceGenerator`` and ``CachedSequenceGenerator`` with greedy and
sampled ragged decode, ``BeamSearchGenerator``, and
``SpeculativeGenerator``'s draft-and-verify greedy decode).

JAX compiles each decode into one program; here PyTorch runs eagerly, so
the scan is a Python loop and the K/V caches are updated in place. The
ragged schedule is the JAX one — prefill to the pow2 bucket below the
shortest prompt, then one position per step for every row, rows still in
their prompt keep their prompt token, rows past their window freeze — so
greedy and sampled output match the JAX generators token for token.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.models.layers import get_activation
from distkeras_tpu_torch.ops.quantization import qmatmul, qshape
from distkeras_tpu_torch.parallel.expert_parallel import (
    MoE,
    moe_nodrop,
    moe_nodrop_shards,
)
from distkeras_tpu_torch.parallel.mesh import sum_shards
from distkeras_tpu_torch.utils.device import check_model_device


_KV_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def resolve_kv_dtype(kv_dtype) -> torch.dtype:
    """A K/V cache dtype: None is f32; a floating ``torch.dtype`` (or its
    name, e.g. ``"bfloat16"``) is kept; anything else raises
    ``ValueError``."""
    if kv_dtype is None:
        return torch.float32
    dt = getattr(torch, kv_dtype, None) if isinstance(kv_dtype, str) \
        else kv_dtype
    if dt not in _KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of float32, bfloat16, float16 (or None "
            f"for float32); got {kv_dtype!r}"
        )
    return dt


class ModelPredictor:
    """Batched forward over a Dataset column on one device. The ragged
    final batch runs at its own size (eager PyTorch needs no static
    shape), except for a model with a switch ``MoE`` layer: its capacity
    is a budget over every token of the batch, so a row's output depends
    on the batch's size, and the ragged batch is padded with zero rows to
    ``batch_size`` as the JAX predictor pads it."""

    def __init__(self, model, features_col="features",
                 output_col="prediction", batch_size=1024, device=None):
        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.device = check_model_device(model, device)
        self._pad = any(isinstance(l, MoE) for l in walk_layers(model))

    @torch.no_grad()
    def predict(self, ds: Dataset) -> Dataset:
        x = ds[self.features_col]
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = np.asarray(x[i : i + self.batch_size])
            n = len(chunk)
            if self._pad and n < self.batch_size:
                chunk = np.concatenate([chunk, np.zeros(
                    (self.batch_size - n, *chunk.shape[1:]), chunk.dtype)])
            y = self.model(torch.as_tensor(chunk, device=self.device))
            outs.append(y[:n].cpu().numpy())
        return ds.with_column(self.output_col, np.concatenate(outs, axis=0))


class SequenceGenerator:
    """Autoregressive decoding for ``zoo.transformer_lm``-shaped models,
    re-running the forward over the context at every step (O(T^2 d) per
    token — the uncached reference). ``temperature=0`` decodes greedily;
    otherwise tokens sample per row from the counter RNG keyed on
    ``(seed, emitted index)`` (``serving.sampling``), optionally filtered
    by ``top_k`` / ``top_p``."""

    def __init__(self, model, temperature=0.0, seed=0, top_k=None,
                 top_p=None, device=None):
        self.model = model
        self.device = check_model_device(model, device)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self._validate_sampling()

    def _validate_sampling(self):
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1; got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]; got {self.top_p}")
        if (
            (self.top_k is not None or self.top_p is not None)
            and self.temperature == 0
        ):
            raise ValueError(
                "top_k/top_p filter SAMPLING; temperature=0 is greedy "
                "argmax — pass a temperature > 0"
            )

    def _validate_generate_args(self, prompts, steps):
        prompts = np.asarray(prompts)
        if prompts.ndim != 2 or prompts.shape[1] < 1:
            raise ValueError(
                f"prompts must be (B, P) with P >= 1; got {prompts.shape}"
            )
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1; got {steps}")
        p = prompts.shape[1]
        seq_len = self.model.input_shape[0]
        if p + steps > seq_len:
            raise ValueError(
                f"prompt ({p}) + steps ({steps}) exceeds the model's "
                f"sequence length ({seq_len})"
            )
        return prompts, steps, seq_len

    def generate(self, prompts, steps, eos_id=None):
        """Continue each prompt by ``steps`` tokens. ``prompts``: a (B, P)
        int array, or a list of 1-D sequences of different lengths.
        Returns a (B, P + steps) array for rectangular prompts without
        ``eos_id``; otherwise a list of rows, each cut after its first
        generated ``eos_id`` (inclusive)."""
        self._validate_sampling()
        ragged = isinstance(prompts, (list, tuple)) and len(
            {len(np.atleast_1d(p)) for p in prompts}
        ) > 1
        if ragged:
            return self._generate_ragged(prompts, steps, eos_id)
        prompts, steps, seq_len = self._validate_generate_args(prompts, steps)
        b, p = prompts.shape
        ctx = np.zeros((b, seq_len), np.int64)
        ctx[:, :p] = prompts
        out = self._run_decode(ctx, np.full((b,), p), p, steps, steps)
        out = out[:, : p + steps].astype(prompts.dtype)
        if eos_id is None:
            return out
        return [self._trim_eos(row, p, int(eos_id)) for row in out]

    @staticmethod
    def _trim_eos(row, prompt_len, eos_id):
        gen = row[prompt_len:]
        hits = np.flatnonzero(gen == eos_id)
        if hits.size:
            return row[: prompt_len + hits[0] + 1]
        return row

    def _generate_ragged(self, prompts, steps, eos_id):
        rows = [np.atleast_1d(np.asarray(p)) for p in prompts]
        if any(r.ndim != 1 or r.shape[0] < 1 for r in rows):
            raise ValueError(
                "ragged prompts must be non-empty 1-D token sequences"
            )
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1; got {steps}")
        lens = np.asarray([r.shape[0] for r in rows], np.int64)
        min_len, max_len = int(lens.min()), int(lens.max())
        seq_len = self.model.input_shape[0]
        if max_len + steps > seq_len:
            raise ValueError(
                f"longest prompt ({max_len}) + steps ({steps}) exceeds "
                f"the model's sequence length ({seq_len})"
            )
        dtype = np.result_type(*[r.dtype for r in rows])
        ctx = np.zeros((len(rows), seq_len), np.int64)
        for i, r in enumerate(rows):
            ctx[i, : lens[i]] = r
        # the JAX schedule's start (pow2 below the shortest prompt), so
        # every position takes the same prefill-vs-step route as there;
        # the scan stops once the longest row has its ``steps`` tokens
        start = 1 << (min_len.bit_length() - 1)
        out = self._run_decode(ctx, lens, start, max_len - start + steps,
                               steps)
        res = [out[i, : lens[i] + steps].astype(dtype)
               for i in range(len(rows))]
        if eos_id is not None:
            res = [
                self._trim_eos(row, int(L), int(eos_id))
                for row, L in zip(res, lens)
            ]
        return res

    def _sampling_rows(self, b):
        """Per-row sampling params (one config per generator) in the
        vectorized shape ``serving.sampling`` takes — the bridge that makes
        solo decode and the served per-slot path the same computation."""
        dev = self.device
        return (
            torch.full((b,), self.temperature, dtype=torch.float32,
                       device=dev),
            torch.full((b,), 0 if self.top_k is None else self.top_k,
                       dtype=torch.int64, device=dev),
            torch.full((b,), 1.0 if self.top_p is None else self.top_p,
                       dtype=torch.float32, device=dev),
            torch.full((b,), self.seed, dtype=torch.int64, device=dev),
        )

    def _next_token(self, logit, pos, lens, rows):
        if self.temperature == 0.0:
            return torch.argmax(logit, dim=-1)
        from distkeras_tpu_torch.serving import sampling as _sp

        temps, topk, topp, seeds = rows
        epos = torch.clamp(pos + 1 - lens, min=0)  # emitted index
        return _sp.sample_tokens(logit, temps, topk, topp, seeds, epos)

    @staticmethod
    def _masked_write(ctx, lens, steps, pos, tok):
        """Write ``tok`` at column pos+1 under the ragged masks (in place):
        rows still inside their prompt keep the prompt token, rows past
        their generation window keep what is there. Returns the tokens
        actually written."""
        cur = ctx[:, pos + 1]
        in_prompt = (pos + 1) < lens
        frozen = (pos + 1) >= lens + steps
        tok = torch.where(in_prompt | frozen, cur, tok.to(ctx.dtype))
        ctx[:, pos + 1] = tok
        return tok

    @torch.no_grad()
    def _run_decode(self, ctx, lens, start, n_scan, steps):
        """Decode positions start-1 .. start+n_scan-2 over the padded
        context; returns the final context as numpy."""
        ctx = torch.as_tensor(ctx, dtype=torch.int64, device=self.device)
        lens = torch.as_tensor(lens, dtype=torch.int64, device=self.device)
        self._decode(ctx, lens, start, n_scan, steps)
        return ctx.cpu().numpy()

    def _decode(self, ctx, lens, start, n_scan, steps):
        rows = self._sampling_rows(ctx.shape[0])
        for i in range(n_scan):
            pos = start - 1 + i
            # causal: logits at pos depend on ctx[:, :pos+1] alone
            logit = self.model(ctx[:, : pos + 1])[:, pos]
            tok = self._next_token(logit, pos, lens, rows)
            self._masked_write(ctx, lens, steps, pos, tok)


def _per_shard(t):
    """A K/V argument as one tensor per shard (a lone tensor is solo)."""
    return t if isinstance(t, list) else [t]


class _StageShards:
    """One (block, optional MoE) stage over a serving mesh: each shard's
    leaves (``parallel.tensor_parallel.shard_decode_params``'s trees, at
    layer keys ``bi`` and ``mi``) and device. Each shard computes its
    heads' q, k and v from the home LayerNorm output, hands them to the
    program's ``attend`` (its K/V writes and its attention) and projects
    them by its rows of ``wo``; the MLP and the experts likewise, every
    row product summed on home (``sum_shards``). A weight the mesh does not
    split (a packed int4 matrix, an indivisible dimension) runs whole on
    home: the projection's heads are then cut out for each shard, the
    shards' attention outputs joined for ``wo``."""

    def __init__(self, trees, specs, bi, mi, devices, heads, head_dim):
        from distkeras_tpu_torch.parallel.tensor_parallel import P

        def split(spec):
            return spec != P()

        self.devices, self.home = list(devices), devices[0]
        self.heads, self.head_dim = heads, head_dim
        sp, mh = specs[bi]["mhsa"], [t[bi]["mhsa"] for t in trees]
        self.proj = {w: ([m[w] for m in mh] if split(sp[w]) else None)
                     for w in ("wq", "wk", "wv")}
        self.wo = [m["wo"] for m in mh] if split(sp["wo"]) else None
        f1, f2 = specs[bi]["fc1"], specs[bi]["fc2"]
        self.fc = None
        if split(f1["kernel"]) and split(f2["kernel"]) and (
                "bias" not in f1 or split(f1["bias"])):
            self.fc = [(t[bi]["fc1"]["kernel"], t[bi]["fc1"].get("bias"),
                        t[bi]["fc2"]["kernel"]) for t in trees]
        self.experts = None
        if mi is not None and split(specs[mi]["wi"]):
            e = trees[0][mi]["wi"].shape[0]
            self.experts = [(t[mi]["wi"], t[mi]["wo"], i * e)
                            for i, t in enumerate(trees)]

    def attention(self, mh, h_, attend):
        """The attention branch before its bias: (..., d) on home."""
        lead, nh, hd = h_.shape[:-1], self.heads, self.head_dim
        whole, parts = {}, []
        for i, dev in enumerate(self.devices):
            hs = h_.to(dev)
            qkv = []
            for w in ("wq", "wk", "wv"):
                ws = self.proj[w]
                if ws is not None:
                    qkv.append(qmatmul(hs, ws[i]).reshape(*lead, nh, hd))
                    continue
                if w not in whole:
                    whole[w] = qmatmul(h_, getattr(mh, w)).reshape(
                        *lead, -1, hd)
                qkv.append(whole[w][..., i * nh:(i + 1) * nh, :].to(dev))
            o = attend(i, *qkv)
            parts.append(o if self.wo is None else
                         qmatmul(o.reshape(*lead, nh * hd), self.wo[i]))
        if self.wo is not None:
            return sum_shards(parts, self.home)
        o = torch.cat([o.to(self.home) for o in parts], dim=-2)
        return qmatmul(o.reshape(*lead, -1), mh.wo)

    def mlp(self, blk, h2):
        """``fc2(fc1(h2))``, fc1's columns and fc2's rows shard by shard."""
        act = get_activation(blk.fc1.activation)
        parts = []
        for dev, (k1, b1, k2) in zip(self.devices, self.fc):
            hs = h2.to(dev)
            y = qmatmul(hs, k1)
            if b1 is not None:
                y = y + b1.to(hs.dtype)
            parts.append(qmatmul(act(y), k2))
        y = sum_shards(parts, self.home)
        if blk.fc2.use_bias:
            y = y + blk.fc2.bias.to(y.dtype)
        return get_activation(blk.fc2.activation)(y)


class CachedSequenceGenerator(SequenceGenerator):
    """KV-cache decoding for ``zoo.transformer_lm``-shaped models: the
    prompt prefills each block's (B, T, H, Dh) caches in one pass, then
    every generated token computes one row of attention against them.
    THE identity reference of the serving tier: every ``DecodeStepper``
    admission path is pinned token-identical to its solo greedy decode.

    Supports Embedding -> causal TransformerBlock xN -> LayerNorm -> Dense,
    each block optionally followed by a switch ``MoE`` layer
    (``zoo.moe_transformer_lm``); anything else — attention hooks,
    non-causal blocks — raises rather than decoding incorrectly. The
    LayerNorm ``norm_fn`` hook is honoured (every LN here goes through the
    layer).

    An MoE stage routes WITHOUT capacity drops (``_moe_nodrop``): every
    real token gets its top-1 expert's gated output, so the output does
    not depend on padding or batch composition. The cost is all E
    experts computed on every token (E x the FFN's FLOPs), per decoded
    token and over the prompt at prefill. The uncached forward's capacity
    drops are deliberately not reproduced, so an MoE model's greedy
    decode is not pinned to ``SequenceGenerator``'s.

    ``kv_dtype``: the caches' dtype; None keeps f32. ``torch.bfloat16``
    (or ``torch.float16``) halves the per-token cache-read bytes. K/V are
    rounded into the cache dtype on every write and read back as the
    query's dtype, so attention still accumulates in f32 (JAX's mixed
    einsum promotes the same way). An integer dtype raises ``ValueError``:
    a cache cannot hold unscaled K/V as integers."""

    def __init__(self, model, temperature=0.0, seed=0, top_k=None,
                 top_p=None, kv_dtype=None, device=None):
        super().__init__(model, temperature=temperature, seed=seed,
                         top_k=top_k, top_p=top_p, device=device)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        from distkeras_tpu_torch.models.layers import (
            Dense,
            Embedding,
            LayerNorm,
            TransformerBlock,
        )

        layers = list(model.layers)
        shape_err = ValueError(
            "CachedSequenceGenerator supports Embedding -> causal "
            "TransformerBlock xN (each optionally followed by a MoE "
            "layer) -> LayerNorm -> Dense models (zoo.transformer_lm / "
            "zoo.moe_transformer_lm); got "
            f"{[type(l).__name__ for l in layers]}"
        )
        if not (
            len(layers) >= 4
            and isinstance(layers[0], Embedding)
            and isinstance(layers[-2], LayerNorm)
            and isinstance(layers[-1], Dense)
        ):
            raise shape_err
        # the middle as (block, optional MoE) stages
        stages, mid = [], layers[1:-2]
        i = 0
        while i < len(mid):
            if not isinstance(mid[i], TransformerBlock):
                raise shape_err
            moe = mid[i + 1] if (i + 1 < len(mid)
                                 and isinstance(mid[i + 1], MoE)) else None
            stages.append((mid[i], moe))
            i += 1 if moe is None else 2
        if not stages:
            raise shape_err
        blocks = [blk for blk, _ in stages]
        if not all(b.causal for b in blocks):
            raise shape_err
        head_shapes = {
            (b.mhsa.num_heads, qshape(b.mhsa.wq)[1]) for b in blocks
        }
        if len(head_shapes) != 1:
            raise ValueError(
                "cached decode derives its cache shape from the first "
                f"block; blocks must share (num_heads, head_dim), got "
                f"{sorted(head_shapes)}"
            )
        for blk in blocks:
            if blk.mhsa.attention_fn is not None:
                raise ValueError(
                    "cached decode computes attention itself; detach the "
                    "attention_fn hook (flash/ring) before decoding"
                )
        self._emb = layers[0]
        self._stages = stages
        self._blocks = blocks
        self._final_ln = layers[-2]
        self._head = layers[-1]
        self.num_heads = blocks[0].mhsa.num_heads
        self.head_dim = qshape(blocks[0].mhsa.wq)[1] // self.num_heads
        self._shards = {}  # block -> _StageShards under a serving mesh

    _moe_nodrop = staticmethod(moe_nodrop)

    def shard(self, trees, specs, devices):
        """Run every stage over a serving mesh: ``trees`` and ``specs``
        are ``parallel.tensor_parallel.shard_decode_params``'s per-shard
        trees and ``decode_param_specs``, ``devices`` the mesh's (the
        first is home, where the model lives). Every K/V argument of the
        stage bodies is then a list of per-shard tensors holding
        ``num_heads / N`` heads each. Without a call, decode is solo."""
        n = len(devices)
        layers = list(self.model.layers)
        self._shards = {
            blk: _StageShards(
                trees, specs, str(layers.index(blk)),
                None if moe is None else str(layers.index(moe)), devices,
                self.num_heads // n, self.head_dim)
            for blk, moe in self._stages
        }

    def _stage(self, blk, moe, x, attend):
        """THE per-stage transformer body of every cached program: LN,
        q/k/v, ``attend(shard, q, k, v)`` (the program's K/V writes and its
        attention over the heads it was given, returning their (..., H,
        Dh) output), the output projection and its residual, then the
        feed-forward tail. Solo, ``attend`` runs once (shard 0, every
        head); under a mesh once per shard (``_StageShards``)."""
        mh = blk.mhsa
        h_ = blk.ln1(x)
        tp = self._shards.get(blk)
        if tp is None:
            lead, nh, hd = h_.shape[:-1], self.num_heads, self.head_dim
            q = qmatmul(h_, mh.wq).reshape(*lead, nh, hd)
            k_new = qmatmul(h_, mh.wk).reshape(*lead, nh, hd)
            v_new = qmatmul(h_, mh.wv).reshape(*lead, nh, hd)
            o = attend(0, q, k_new, v_new)
            o = qmatmul(o.reshape(*lead, nh * hd), mh.wo)
        else:
            o = tp.attention(mh, h_, attend)
        if mh.use_bias:
            o = o + mh.bo
        return self._ffn(blk, moe, x + o)

    def _ffn(self, blk, moe, x):
        """The feed-forward tail of one stage: the block's MLP residual,
        then the no-drop MoE residual when the stage has one (shard by
        shard under a mesh)."""
        tp = self._shards.get(blk)
        if tp is None or tp.fc is None:
            x = x + blk.fc2(blk.fc1(blk.ln2(x)))
        else:
            x = x + tp.mlp(blk, blk.ln2(x))
        if moe is not None:
            if tp is None or tp.experts is None:
                x = x + self._moe_nodrop(moe.expert_params(), x)
            else:
                x = x + moe_nodrop_shards(moe.router, tp.experts, x)
        return x

    def _stage_chunk(self, blk, moe, x, cache_k, cache_v, pos, qmask):
        """A C-token chunk through one (block, optional MoE) stage against
        its cache (single-token decode is C=1). x: (B, C, d); caches (B,
        T, H, Dh), or one tensor per shard under a mesh, written IN PLACE
        at rows pos..pos+C-1; qmask: (C, T) bool, True where chunk row c
        may attend position t."""
        c = x.shape[1]
        hd = self.head_dim
        ks, vs = _per_shard(cache_k), _per_shard(cache_v)

        def attend(i, q, k_new, v_new):
            ck, cv = ks[i], vs[i]
            ck[:, pos : pos + c] = k_new.to(ck.dtype)
            cv[:, pos : pos + c] = v_new.to(cv.dtype)
            scores = torch.einsum("bchd,bthd->bhct", q,
                                  ck.to(q.dtype)) / math.sqrt(hd)
            scores = scores.masked_fill(~qmask.to(ck.device)[None, None],
                                        float("-inf"))
            w = torch.softmax(scores, dim=-1)
            return torch.einsum("bhct,bthd->bchd", w, cv.to(w.dtype))

        return self._stage(blk, moe, x, attend)

    def _prefill(self, caches, x):
        """Run the pre-embedded prompt prefix ``x`` (B, PP, d) through every
        stage, filling each cache's first PP rows in place (dense causal
        attention over the prefix); returns the hidden states. MoE stages
        route as the decode steps do, so prefill and per-token outputs
        agree. ``caches``: per stage (K, V), each a tensor or, under a
        mesh, one tensor per shard."""
        from distkeras_tpu_torch.parallel.ring_attention import (
            dense_attention,
        )

        pp = x.shape[1]
        for (blk, moe), (ck, cv) in zip(self._stages, caches):
            ks, vs = _per_shard(ck), _per_shard(cv)

            def attend(i, q, k, v, ks=ks, vs=vs):
                ks[i][:, :pp] = k.to(ks[i].dtype)
                vs[i][:, :pp] = v.to(vs[i].dtype)
                # the prefix attends its own f32 K/V, as in JAX
                return dense_attention(q, k, v, causal=True)

            x = self._stage(blk, moe, x, attend)
        return x

    def embed(self, tok, pos):
        """Embed tokens at positions (broadcastable), positions clamped to
        the table like the JAX embed closure."""
        emb = self._emb
        x = emb.tokens[tok]
        if emb.with_positions:
            n_pos = emb.positions.shape[0]
            x = x + emb.positions[torch.clamp(
                torch.as_tensor(pos, device=x.device), max=n_pos - 1
            )]
        return x

    def new_caches(self, bsz, cache_len):
        shape = (bsz, cache_len, self.num_heads, self.head_dim)
        return [
            (
                torch.zeros(shape, dtype=self.kv_dtype, device=self.device),
                torch.zeros(shape, dtype=self.kv_dtype, device=self.device),
            )
            for _ in self._blocks
        ]

    def _decode_prologue(self, ctx, prompt_len, cache_len=None):
        """Allocate the per-block K/V caches and prefill positions
        0..prompt_len-2 (the step that follows consumes the last one)."""
        if cache_len is None:
            cache_len = self.model.input_shape[0]
        caches = self.new_caches(ctx.shape[0], cache_len)
        if prompt_len > 1:
            pp = prompt_len - 1
            x = self.embed(ctx[:, :pp], torch.arange(pp, device=ctx.device))
            self._prefill(caches, x)
        return caches

    def _stages_decode(self, caches, x, pos, t_mask):
        """One token through every stage against the caches (C = 1)."""
        x = x[:, None]
        qmask = t_mask[None, :]
        for (blk, moe), (ck, cv) in zip(self._stages, caches):
            x = self._stage_chunk(blk, moe, x, ck, cv, pos, qmask)
        return x[:, 0]

    def _decode(self, ctx, lens, start, n_scan, steps):
        seq_len = self.model.input_shape[0]
        caches = self._decode_prologue(ctx, start)
        rows = self._sampling_rows(ctx.shape[0])
        t_idx = torch.arange(seq_len, device=ctx.device)
        tok = ctx[:, start - 1]
        for i in range(n_scan):
            pos = start - 1 + i
            x = self.embed(tok, pos)
            x = self._stages_decode(caches, x, pos, t_idx <= pos)
            logit = self._head(self._final_ln(x))
            nxt = self._next_token(logit, pos, lens, rows)
            tok = self._masked_write(ctx, lens, steps, pos, nxt)


class BeamSearchGenerator(CachedSequenceGenerator):
    """Beam-search decoding for the causal-LM family: keep the
    ``beam_width`` highest-log-probability hypotheses per prompt instead of
    one greedy path.

    Beams ride the batch axis of the per-block K/V caches ((B*W, T, H,
    Dh); the per-token body is cached greedy decode's), and each step
    expands every live beam over the vocabulary, keeps the best
    ``beam_width`` of the B x (W*V) scored continuations, and reorders the
    contexts and caches by a parent-beam gather (``index_select``). The
    selection orders by (-score, flat index), which is
    ``jax.lax.top_k``'s order, so exact ties pick the beams JAX picks.

    ``eos_id`` finishes a hypothesis: a finished beam's only extension is
    another ``eos_id`` at zero log-probability, so its score freezes while
    open beams keep accumulating. The search ranks by raw cumulative
    log-probability; ``length_penalty`` (GNMT ``((5 + L) / 6) ** alpha``)
    applies at the final selection only. ``beam_width=1`` is greedy cached
    decode. ``last_scores`` holds the raw summed log-probability of each
    returned sequence. ``kv_dtype`` as in ``CachedSequenceGenerator``."""

    def __init__(self, model, beam_width=4, length_penalty=0.0,
                 kv_dtype=None, device=None):
        super().__init__(model, temperature=0.0, seed=0, kv_dtype=kv_dtype,
                         device=device)
        self.beam_width = int(beam_width)
        self.length_penalty = float(length_penalty)
        self._validate_beam()
        self.last_scores = None

    def _validate_beam(self):
        """Checked again at every ``generate``: the knobs are mutable."""
        if self.beam_width < 1:
            raise ValueError(
                f"beam_width must be >= 1; got {self.beam_width}"
            )
        vocab = self._emb.vocab_size
        if self.beam_width > vocab:
            raise ValueError(
                f"beam_width ({self.beam_width}) exceeds the vocabulary "
                f"({vocab}) — there are not that many distinct "
                "single-token continuations"
            )
        if self.length_penalty < 0:
            raise ValueError(
                f"length_penalty must be >= 0; got {self.length_penalty}"
            )

    def generate(self, prompts, steps, eos_id=None):
        """(B, P) prompts -> the best-scoring continuation per row: a (B, P
        + steps) array, or eos-trimmed rows with ``eos_id`` (the other
        generators' conventions). Ragged batches are refused."""
        self._validate_beam()
        if isinstance(prompts, (list, tuple)) and len(
            {len(np.atleast_1d(p)) for p in prompts}
        ) > 1:
            raise ValueError(
                "beam search decodes rectangular batches only; pad or "
                "bucket ragged prompts upstream"
            )
        prompts, steps, seq_len = self._validate_generate_args(
            np.asarray(prompts), steps
        )
        b, p = prompts.shape
        ctx = np.zeros((b, seq_len), np.int64)
        ctx[:, :p] = prompts
        eos = -1 if eos_id is None else int(eos_id)
        out, scores = self._beam_decode(
            torch.as_tensor(ctx, device=self.device), p, steps, eos
        )
        self.last_scores = scores
        out = out[:, : p + steps].astype(prompts.dtype)
        if eos_id is None:
            return out
        return [self._trim_eos(row, p, int(eos_id)) for row in out]

    @torch.no_grad()
    def _beam_decode(self, ctx, prompt_len, steps, eos):
        """The search over ``ctx`` (B, T); returns the winning rows and
        their raw scores as numpy."""
        seq_len = self.model.input_shape[0]
        w, alpha = self.beam_width, self.length_penalty
        dev = ctx.device
        bsz = ctx.shape[0]
        caches = self._decode_prologue(ctx, prompt_len)
        # beams tile onto the batch axis; beam 0 alone starts live (-inf
        # elsewhere), so the first expansion picks the W best DISTINCT
        # first tokens instead of W copies of one
        caches = [(ck.repeat_interleave(w, 0), cv.repeat_interleave(w, 0))
                  for ck, cv in caches]
        ctxw = ctx.repeat_interleave(w, 0).reshape(bsz, w, seq_len)
        cum = torch.full((bsz, w), float("-inf"), device=dev)
        cum[:, 0] = 0.0
        fin = torch.zeros((bsz, w), dtype=torch.bool, device=dev)
        glen = torch.zeros((bsz, w), dtype=torch.int64, device=dev)
        tok = ctxw[:, :, prompt_len - 1]
        t_idx = torch.arange(seq_len, device=dev)
        base = (torch.arange(bsz, device=dev) * w)[:, None]
        only_eos = None
        for i in range(steps):
            pos = prompt_len - 1 + i
            x = self.embed(tok.reshape(-1), pos)  # (B*W, d)
            x = self._stages_decode(caches, x, pos, t_idx <= pos)
            logit = self._head(self._final_ln(x))  # (B*W, V)
            vocab = logit.shape[-1]
            logp = torch.log_softmax(logit, dim=-1).reshape(bsz, w, vocab)
            if eos >= 0:
                if only_eos is None:
                    only_eos = torch.full((vocab,), float("-inf"),
                                          device=dev)
                    only_eos[eos] = 0.0
                # a finished beam extends only with eos, for free
                logp = torch.where(fin[:, :, None], only_eos, logp)
            total = (cum[:, :, None] + logp).reshape(bsz, w * vocab)
            # top W by (-score, flat index): a stable descending sort keeps
            # equal scores in index order, as jax.lax.top_k does
            cum, flat = torch.sort(total, dim=1, descending=True,
                                   stable=True)
            cum, flat = cum[:, :w], flat[:, :w]
            parent = torch.div(flat, vocab, rounding_mode="floor")
            token = flat % vocab
            ctxw = torch.gather(
                ctxw, 1, parent[:, :, None].expand(-1, -1, seq_len)
            )
            fin = torch.gather(fin, 1, parent)
            glen = torch.gather(glen, 1, parent) + (~fin).long()
            if eos >= 0:
                fin = fin | (token == eos)
            gather = (base + parent).reshape(-1)  # (B*W,)
            caches = [(ck.index_select(0, gather), cv.index_select(0, gather))
                      for ck, cv in caches]
            if pos + 1 < seq_len:
                ctxw[:, :, pos + 1] = token
            tok = token
        if alpha > 0.0:
            final = cum / ((5.0 + glen.float()) / 6.0) ** alpha
        else:
            final = cum
        best = torch.argmax(final, dim=1)  # (B,)
        rows = torch.arange(bsz, device=dev)
        return ctxw[rows, best].cpu().numpy(), cum[rows, best].cpu().numpy()


class SpeculativeGenerator:
    """Draft-and-verify (speculative) greedy decoding: a small DRAFT model
    proposes ``k`` tokens per round from its own K/V caches, the TARGET
    model verifies all ``k + 1`` positions in one chunked forward, and the
    longest agreeing prefix plus the target's correction are accepted. The
    output is the target's greedy decode; the draft changes only how many
    target forwards it takes (at least one token per round).

    JAX runs each row as one compiled ``while_loop``; here each row is a
    host loop over rounds (one host sync per round, for the accepted
    count). Rows decode one after another. ``last_rounds`` holds the
    rounds per row of the last ``generate``. ``kv_dtype`` applies to both
    models' caches, as in ``CachedSequenceGenerator``."""

    def __init__(self, target, draft, k=4, kv_dtype=None, device=None):
        self._t = CachedSequenceGenerator(target, kv_dtype=kv_dtype,
                                          device=device)
        self._d = CachedSequenceGenerator(draft, kv_dtype=kv_dtype,
                                          device=device)
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1; got {k}")
        if self._t._emb.vocab_size != self._d._emb.vocab_size:
            raise ValueError(
                "target and draft must share a vocabulary; got "
                f"{self._t._emb.vocab_size} vs {self._d._emb.vocab_size}"
            )
        if target.input_shape[0] != draft.input_shape[0]:
            raise ValueError(
                "target and draft must be built to the same sequence "
                f"length; got {target.input_shape[0]} vs "
                f"{draft.input_shape[0]}"
            )
        self.target, self.draft = target, draft
        self.device = self._t.device
        self.last_rounds = None

    def generate(self, prompts, steps, eos_id=None):
        """(B, P) prompts -> the TARGET's greedy continuation, decoded
        speculatively; the other generators' return conventions ((B,
        P + steps) array; a list of trimmed rows with ``eos_id``)."""
        self.k = int(self.k)
        if self.k < 1:  # re-validated: k is a mutable attribute
            raise ValueError(f"k must be >= 1; got {self.k}")
        prompts, steps, seq_len = self._t._validate_generate_args(
            np.asarray(prompts), steps
        )
        p = prompts.shape[1]
        outs, rounds = [], []
        for row in prompts:
            out, n = self._decode_row(row, p, steps, seq_len)
            outs.append(out.astype(prompts.dtype))
            rounds.append(n)
        self.last_rounds = np.asarray(rounds)
        out = np.stack(outs)
        if eos_id is None:
            return out
        return [SequenceGenerator._trim_eos(r, p, int(eos_id)) for r in out]

    @torch.no_grad()
    def _decode_row(self, row, p, steps, seq_len):
        """One row's rounds: a k+1-step draft chunk (the extra step writes
        the draft's K/V at the last proposed position, so a fully accepted
        round leaves no hole in its cache), then the target's k+1-token
        extension and the accepted segment written at ``pos + 1``. The
        buffers are padded by k+1 so overrun lands in masked scratch."""
        k, tgen, dgen = self.k, self._t, self._d
        t_pad = seq_len + k + 1
        dev = self.device
        ctx = torch.zeros((1, t_pad), dtype=torch.int64, device=dev)
        ctx[0, :p] = torch.as_tensor(np.asarray(row, np.int64), device=dev)
        t_caches = tgen._decode_prologue(ctx, p, cache_len=t_pad)
        d_caches = dgen._decode_prologue(ctx, p, cache_len=t_pad)
        t_idx = torch.arange(t_pad, device=dev)
        cand = torch.arange(k + 1, device=dev)
        pos, n_gen, rounds = p - 1, 0, 0
        while n_gen < steps:
            tok, props = ctx[:, pos], []
            for j in range(k + 1):
                x = dgen.embed(tok, pos + j)
                x = dgen._stages_decode(d_caches, x, pos + j,
                                        t_idx <= pos + j)
                tok = torch.argmax(dgen._head(dgen._final_ln(x)), dim=-1)
                props.append(tok)
            d_toks = torch.cat(props[:k])  # (k,)
            chunk = torch.cat([ctx[0, pos : pos + 1], d_toks])
            x = tgen.embed(chunk[None], pos + cand)  # (1, k+1, d)
            qmask = t_idx[None, :] <= (pos + cand)[:, None]
            for (blk, moe), (ck, cv) in zip(tgen._stages, t_caches):
                x = tgen._stage_chunk(blk, moe, x, ck, cv, pos, qmask)
            t_arg = torch.argmax(tgen._head(tgen._final_ln(x))[0], dim=-1)
            n_acc = int((d_toks == t_arg[:k]).long().cumprod(0).sum())
            n_new = min(n_acc + 1, steps - n_gen)
            ctx[0, pos + 1 : pos + 1 + n_new] = t_arg[:n_new]
            pos, n_gen, rounds = pos + n_new, n_gen + n_new, rounds + 1
        return ctx[0, : p + steps].cpu().numpy(), rounds
