"""Ulysses sequence parallelism: head-sharded attention between two
all-to-alls (PyTorch port of ``distkeras_tpu.parallel.ulysses``).

The second scheme beside the ring (``parallel.ring_attention``): instead
of rotating K/V blocks N-1 times, ONE all-to-all re-shards the rank's
(batch, seq/N, heads, d) block of q, k and v, stacked, to (batch, seq,
heads/N, d); every rank attends over the full sequence for its heads,
and a second all-to-all restores the token split (DeepSpeed-Ulysses).
The trade against the ring:

- communication: 2 all-to-alls of activation size against N-1 K/V hops;
- constraint: num_heads must divide by the group size (the ring has none);
- memory: each rank sees the FULL sequence for its heads;
  ``inner="blockwise"`` streams K/V blocks through the online softmax
  (``ring_attention.blockwise_attention``), so score memory stays (seq,
  block) instead of (seq, seq).

One process per rank: q, k, v are the rank's blocks (``ring_attention.
shard_sequence`` cuts them), the exchanges are
``DataMesh.all_to_all`` (``torch.distributed.all_to_all_single``), whose
backward is the reverse exchange.
"""

from __future__ import annotations

import functools

import torch

from distkeras_tpu_torch.parallel.ring_attention import (
    _seq_group,
    attach_attention_fn,
    blockwise_attention,
    dense_attention,
)


def _ulysses_local(q, k, v, group, causal, inner, block_size):
    # (3, b, t/N, h, d) -> (3, b, t, h/N, d): q/k/v stacked so the
    # re-shard is ONE collective (two per attention)
    qkv = group.all_to_all(torch.stack((q, k, v)), split_dim=3, concat_dim=2)
    qh, kh, vh = qkv.unbind(0)
    if inner == "blockwise":
        out = blockwise_attention(qh, kh, vh, causal=causal,
                                  block_size=block_size)
    else:
        out = dense_attention(qh, kh, vh, causal=causal)
    # (b, t, h/N, d) -> (b, t/N, h, d)
    return group.all_to_all(out, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mesh, axis_name="seq", causal=False,
                      inner="dense", inner_block_size=512):
    """Attention over a sequence split over ``axis_name`` through
    head-sharding all-to-alls. Same contract as ``ring_attention``: q, k,
    v are this rank's (batch, seq/N, heads, head_dim) blocks, the output
    its block of the global attention; num_heads must divide by the group
    size (a global length that does not divide by it is refused where the
    blocks are cut, by ``shard_sequence``). ``inner`` picks the attention
    over the full sequence: "dense"
    or "blockwise" (``inner_block_size`` is its K/V block; the FULL
    sequence length must divide by it when longer)."""
    group = _seq_group(mesh, axis_name)
    n = group.num_workers
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses shards heads over {axis_name}: num_heads "
            f"{q.shape[2]} not divisible by {n} (use the ring for "
            "head counts below the mesh size)"
        )
    if inner not in ("dense", "blockwise"):
        raise ValueError(f"inner must be 'dense' or 'blockwise'; got {inner!r}")
    return _ulysses_local(q, k, v, group, causal, inner, inner_block_size)


def attach_ulysses_attention(model, mesh, axis_name="seq", inner="dense",
                             inner_block_size=512) -> int:
    """Point every MultiHeadSelfAttention at :func:`ulysses_attention`
    over ``mesh``; returns how many were attached. Process-local, like the
    ring hook (closes over a live group; not serialized);
    ``ring_attention.detach_ring_attention`` removes these too."""
    return attach_attention_fn(
        model,
        functools.partial(ulysses_attention, mesh=mesh, axis_name=axis_name,
                          inner=inner, inner_block_size=inner_block_size),
    )
