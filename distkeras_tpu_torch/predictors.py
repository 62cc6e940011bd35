"""Inference over Datasets and autoregressive decode (PyTorch port of
``distkeras_tpu.predictors``: ``ModelPredictor`` on one device,
``SequenceGenerator`` and ``CachedSequenceGenerator`` with greedy and
sampled ragged decode; beam search and speculative decode wait).

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
from distkeras_tpu_torch.ops.quantization import qmatmul, qshape
from distkeras_tpu_torch.utils.device import check_model_device


class ModelPredictor:
    """Batched forward over a Dataset column on one device. The ragged
    final batch runs at its own size (eager PyTorch needs no static
    shape, so it is not padded)."""

    def __init__(self, model, features_col="features",
                 output_col="prediction", batch_size=1024, device=None):
        self.model = model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.device = check_model_device(model, device)

    @torch.no_grad()
    def predict(self, ds: Dataset) -> Dataset:
        x = ds[self.features_col]
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = torch.as_tensor(x[i : i + self.batch_size],
                                    device=self.device)
            outs.append(self.model(chunk).cpu().numpy())
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


class CachedSequenceGenerator(SequenceGenerator):
    """KV-cache decoding for ``zoo.transformer_lm``-shaped models: the
    prompt prefills each block's (B, T, H, Dh) caches in one pass, then
    every generated token computes one row of attention against them.
    THE identity reference of the serving tier: every ``DecodeStepper``
    admission path is pinned token-identical to its solo greedy decode.

    Supports Embedding -> causal TransformerBlock xN -> LayerNorm -> Dense;
    anything else — MoE stages (not ported), attention hooks, non-causal
    blocks — raises rather than decoding incorrectly. The LayerNorm
    ``norm_fn`` hook is honoured (every LN here goes through the layer).
    The caches are f32 (the JAX ``kv_dtype`` knob is not ported yet)."""

    def __init__(self, model, temperature=0.0, seed=0, top_k=None,
                 top_p=None, device=None):
        super().__init__(model, temperature=temperature, seed=seed,
                         top_k=top_k, top_p=top_p, device=device)
        from distkeras_tpu_torch.models.layers import (
            Dense,
            Embedding,
            LayerNorm,
            TransformerBlock,
        )

        layers = list(model.layers)
        shape_err = ValueError(
            "CachedSequenceGenerator supports Embedding -> causal "
            "TransformerBlock xN -> LayerNorm -> Dense models "
            "(zoo.transformer_lm); got "
            f"{[type(l).__name__ for l in layers]}"
        )
        if not (
            len(layers) >= 4
            and isinstance(layers[0], Embedding)
            and isinstance(layers[-2], LayerNorm)
            and isinstance(layers[-1], Dense)
            and all(isinstance(l, TransformerBlock) for l in layers[1:-2])
        ):
            raise shape_err
        blocks = layers[1:-2]
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
        self._blocks = blocks
        self._final_ln = layers[-2]
        self._head = layers[-1]
        self.num_heads = blocks[0].mhsa.num_heads
        self.head_dim = qshape(blocks[0].mhsa.wq)[1] // self.num_heads

    def _stage_chunk(self, blk, x, cache_k, cache_v, pos, qmask):
        """A C-token chunk through one block against its cache — THE
        per-stage transformer body (single-token decode is C=1). x: (B, C,
        d); caches (B, T, H, Dh), written IN PLACE at rows pos..pos+C-1;
        qmask: (C, T) bool, True where chunk row c may attend position t."""
        mh = blk.mhsa
        b, c, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        h_ = blk.ln1(x)
        q = qmatmul(h_, mh.wq).reshape(b, c, nh, hd)
        k_new = qmatmul(h_, mh.wk).reshape(b, c, nh, hd)
        v_new = qmatmul(h_, mh.wv).reshape(b, c, nh, hd)
        cache_k[:, pos : pos + c] = k_new
        cache_v[:, pos : pos + c] = v_new
        scores = torch.einsum("bchd,bthd->bhct", q, cache_k) / math.sqrt(hd)
        scores = scores.masked_fill(~qmask[None, None], float("-inf"))
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhct,bthd->bchd", w, cache_v)
        o = qmatmul(o.reshape(b, c, nh * hd), mh.wo)
        if mh.use_bias:
            o = o + mh.bo
        x = x + o
        return x + blk.fc2(blk.fc1(blk.ln2(x)))

    def _prefill(self, caches, x):
        """Run the pre-embedded prompt prefix ``x`` (B, PP, d) through every
        block, filling each cache's first PP rows in place (dense causal
        attention over the prefix); returns the hidden states."""
        from distkeras_tpu_torch.parallel.ring_attention import (
            dense_attention,
        )

        bsz, pp, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        for blk, (ck, cv) in zip(self._blocks, caches):
            mh = blk.mhsa
            h_ = blk.ln1(x)
            q = qmatmul(h_, mh.wq).reshape(bsz, pp, nh, hd)
            k = qmatmul(h_, mh.wk).reshape(bsz, pp, nh, hd)
            v = qmatmul(h_, mh.wv).reshape(bsz, pp, nh, hd)
            ck[:, :pp] = k
            cv[:, :pp] = v
            o = dense_attention(q, k, v, causal=True)
            o = qmatmul(o.reshape(bsz, pp, nh * hd), mh.wo)
            if mh.use_bias:
                o = o + mh.bo
            x = x + o
            x = x + blk.fc2(blk.fc1(blk.ln2(x)))
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
                torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device),
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
        """One token through every block against the caches (C = 1)."""
        x = x[:, None]
        qmask = t_mask[None, :]
        for blk, (ck, cv) in zip(self._blocks, caches):
            x = self._stage_chunk(blk, x, ck, cv, pos, qmask)
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
