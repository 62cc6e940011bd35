"""Single-device attention and the attention-hook helpers (PyTorch port of
the parts of ``distkeras_tpu.parallel.ring_attention`` that serving uses).

``dense_attention`` is ``MultiHeadSelfAttention``'s default, the prefill's
attention, and the plain version the flash kernel is held against. The
ring and blockwise variants are not ported yet.
"""

from __future__ import annotations

import torch


def dense_attention(q, k, v, causal=False):
    """Plain softmax attention in the (B, T, H, D) layout: scale 1/sqrt(D),
    -inf causal mask (key position <= query position), f32 accumulation,
    output in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attach_attention_fn(model, fn) -> int:
    """Point every MultiHeadSelfAttention's ``attention_fn`` at ``fn``;
    returns how many were attached. Hooks are process-local and not
    serialized."""
    from distkeras_tpu_torch.models.layers import MultiHeadSelfAttention
    from distkeras_tpu_torch.models.sequential import walk_layers

    n = 0
    for layer in walk_layers(model):
        if isinstance(layer, MultiHeadSelfAttention):
            layer.attention_fn = fn
            n += 1
    return n


def detach_ring_attention(model) -> int:
    """Remove every attention hook (flash or otherwise): each
    MultiHeadSelfAttention reverts to dense attention. Returns how many
    hooks were removed."""
    from distkeras_tpu_torch.models.layers import MultiHeadSelfAttention
    from distkeras_tpu_torch.models.sequential import walk_layers

    count = 0
    for layer in walk_layers(model):
        if (
            isinstance(layer, MultiHeadSelfAttention)
            and layer.attention_fn is not None
        ):
            layer.attention_fn = None
            count += 1
    return count
