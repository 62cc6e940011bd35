"""Attention over a split sequence and on one device, and the
attention-hook helpers (PyTorch port of
``distkeras_tpu.parallel.ring_attention``).

``dense_attention`` is ``MultiHeadSelfAttention``'s default, the prefill's
attention, and the plain version the flash kernel is held against.
``blockwise_attention`` is the memory-efficient single-device form: a loop
over K/V blocks with an online softmax, so the full (Tq, Tk) score matrix
never materializes (peak score memory (Tq, block_size)).

``ring_attention`` is sequence parallelism: one process per rank, each
holding its block of T/N tokens of q, k and v (``shard_sequence`` cuts
it). Each rank attends its queries to the K/V block it holds with the
same online softmax, then passes the block one hop around the ring
(``DataMesh.ring_step``: ``batch_isend_irecv``, JAX's ``lax.ppermute``);
after N steps every query has seen every key. The causal mask uses the
global offsets of both blocks. The backward is the ring's transpose:
dK and dV travel back around it. The block math is plain PyTorch, as
JAX computes it outside any Pallas kernel.
"""

from __future__ import annotations

import functools

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


def _block_attention(q, k, v, acc, m, l, q_off, k_off, scale, causal):
    """One online-softmax accumulation step of the (B, Tq, H, D) queries
    at position offset ``q_off`` against one K/V block at key offset
    ``k_off``; acc (B, Tq, H, D) f32, m, l (B, H, Tq) the running max and
    normalizer. Returns the updated (acc, m, l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_off + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row with no visible key yet keeps m == -inf: exp(-inf - -inf) is
    # nan, so the shift is guarded to 0 (and the correction with it)
    shift = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                        m_new)
    p = torch.exp(s - shift[..., None])
    correction = torch.exp(torch.where(torch.isneginf(m), shift, m) - shift)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    acc_new = acc * correction.transpose(1, 2)[..., None] + pv
    return acc_new, m_new, l_new


def _finalize(acc, l, out_dtype):
    """Normalize the accumulator; a row with no visible key (l == 0)
    divides by 1."""
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l.transpose(1, 2)[..., None]).to(out_dtype)


def blockwise_attention(q, k, v, causal=False, block_size=512):
    """Memory-efficient self-attention on one device: a loop over K/V
    blocks of ``block_size`` keys with the online softmax of
    ``_block_attention``, numerically ``dense_attention``. q, k, v: (B,
    T, H, D); T divisible by ``block_size``, or at most it (one block is
    the dense case). Cross-attention (k/v of another length) raises."""
    b, t, h, d = q.shape
    if k.shape[1] != t or v.shape[1] != t:
        raise ValueError(
            "blockwise_attention is self-attention only: expected "
            f"k/v seq length {t} (q's), got k={k.shape[1]}, v={v.shape[1]}"
        )
    if t <= block_size:
        return dense_attention(q, k, v, causal=causal)
    if t % block_size:
        raise ValueError(
            f"seq length {t} not divisible by block_size {block_size}"
        )
    scale = 1.0 / (d**0.5)
    acc, m, l = _init_carry(q)
    for off in range(0, t, block_size):
        acc, m, l = _block_attention(
            q, k[:, off : off + block_size], v[:, off : off + block_size],
            acc, m, l, 0, off, scale, causal,
        )
    return _finalize(acc, l, q.dtype)


def _init_carry(q):
    """A fresh online-softmax carry for the queries ``q``: zero
    accumulator, -inf running max, zero normalizer."""
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), float("-inf"), device=q.device),
            torch.zeros((b, h, t), device=q.device))


def _seq_group(mesh, axis_name):
    """The group the sequence is split over: a ``GridMesh``'s inner group
    (its axis must be ``axis_name``) or a ``DataMesh`` itself."""
    names = getattr(mesh, "axis_names", ())
    if hasattr(mesh, "inner"):
        if names[-1] != axis_name:
            raise ValueError(f"mesh {mesh.shape} has no {axis_name!r} axis")
        return mesh.inner
    return mesh


def shard_sequence(x, mesh, axis_name="seq", axis=1):
    """This rank's block of a global array (tensor or numpy) along its
    sequence ``axis``:
    rank i of the sequence group takes tokens ``[i*T/N, (i+1)*T/N)``
    (JAX places the same blocks under ``P(batch, "seq")``). Raises when T
    does not divide by the group size."""
    g = _seq_group(mesh, axis_name)
    t = x.shape[axis]
    if t % g.num_workers:
        raise ValueError(
            f"seq length {t} not divisible by mesh axis "
            f"{axis_name}={g.num_workers}"
        )
    n = t // g.num_workers
    index = [slice(None)] * x.ndim
    index[axis] = slice(g.rank * n, (g.rank + 1) * n)
    return x[tuple(index)]


def _ring_attention_local(q, k, v, group, scale, causal):
    """The rank's body: its queries against every rank's K/V block, the
    blocks arriving one hop at a time (rank i holds rank (i - step)'s
    block at step ``step``)."""
    n, me = group.num_workers, group.rank
    acc, m, l = _init_carry(q)
    q_off = me * q.shape[1]
    kv = torch.stack((k, v))
    for step in range(n):
        src = (me - step) % n  # whose block this rank holds now
        acc, m, l = _block_attention(q, kv[0], kv[1], acc, m, l, q_off,
                                     src * k.shape[1], scale, causal)
        if step + 1 < n:
            kv = group.ring_step(kv)
    return _finalize(acc, l, q.dtype)


def ring_attention(q, k, v, mesh, axis_name="seq", causal=False):
    """Multi-head attention over a sequence split over ``axis_name``: q, k,
    v are this rank's (batch, seq/N, heads, head_dim) blocks
    (``shard_sequence``), the output is the rank's block of the global
    attention. ``mesh``: a ``GridMesh`` with that axis, or the sequence
    group's ``DataMesh``. Every rank of the group must call it (it runs
    the ring's exchanges). The batch rows are the rank's own, so a (data,
    seq) grid needs no ``batch_axis``: each data slice runs its own ring."""
    group = _seq_group(mesh, axis_name)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ring_attention_local(q, k, v, group, scale, causal)


def attach_blockwise_attention(model, block_size=512) -> int:
    """Point every MultiHeadSelfAttention at :func:`blockwise_attention`
    (single-device long-context mode); returns how many were attached. A
    process-local hook, not serialized."""
    return attach_attention_fn(
        model, functools.partial(blockwise_attention, block_size=block_size)
    )


def attach_ring_attention(model, mesh, axis_name="seq") -> int:
    """Point every MultiHeadSelfAttention at :func:`ring_attention` over
    ``mesh``; returns how many were attached. Process-local: the hook
    closes over the live group and is not serialized."""
    return attach_attention_fn(
        model,
        functools.partial(ring_attention, mesh=mesh, axis_name=axis_name),
    )


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
    """Remove every attention hook (ring, Ulysses, flash or otherwise):
    each MultiHeadSelfAttention reverts to dense attention. Returns how
    many hooks were removed."""
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
