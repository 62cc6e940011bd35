"""FlashAttention forward (PyTorch port of ``distkeras_tpu.ops.flash_attention``).

On CUDA tensors ``flash_attention`` launches the hand-written Hopper kernel
``kernels/csrc/flash_fwd.cu`` — online softmax over 64-row K/V tiles,
causal tiles above the diagonal skipped, any T (the tail tile is masked),
head dim up to 128 — or raises. The TPU module's "dense" and "blockwise"
fallbacks were VMEM/tiling artifacts and do not exist here: on CUDA
``effective_path`` is always "flash". On CPU tensors the plain version
runs (``dense_attention``; ``_reference_flash_fwd`` adds the logsumexp).
The backward kernels belong to the training slice; the autograd function
raises until then.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.parallel.ring_attention import dense_attention

#: the CUDA kernel's tiles (query rows per block, keys per K/V tile)
BLOCK_Q = 64
BLOCK_K = 64
MAX_HEAD_DIM = 128


def _reference_flash_fwd(q, k, v, causal):
    """Plain version of the kernel: (B, T, H, D) -> (O in q's dtype, lse
    (B, H, T, 1) f32), lse being the scaled-score logsumexp."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    return dense_attention(q, k, v, causal=causal), lse


def flash_fwd(q, k, v, causal):
    """Launch the CUDA kernel; returns (O (B, T, H, D), lse (B, H, T, 1)).
    Raises on anything the kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd launches on CUDA tensors only")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_fwd wants equal (B, T, H, D) q/k/v; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_fwd wants q, k, v of one dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd wants contiguous q, k, v")
    b, t, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd supports head_dim <= {MAX_HEAD_DIM}; got {d}")
    code = kernels.cuda_dtype_code(q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    from distkeras_tpu_torch.kernels.build import kernel

    fn = kernel("flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, t, h, d, 1.0 / (d ** 0.5), int(bool(causal)),
            code, torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check_launch("flash_fwd", err)
    return o, lse


class _FlashFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, _ = flash_fwd(q, k, v, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError("flash/LN backward: training slice")


def effective_path(t, head_dim, device="cuda"):
    """(path, bq, bk) that ``flash_attention`` runs for sequence length
    ``t``: "flash" with the kernel's 64x64 tiles on CUDA (any t), "plain"
    (the dense reference, whole sequence) on the CPU. Raises for a head dim
    the kernel does not take."""
    if torch.device(device).type == "cpu":
        return "plain", t, t
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"flash kernel supports head_dim <= {MAX_HEAD_DIM}; got {head_dim}"
        )
    return "flash", BLOCK_Q, BLOCK_K


def flash_attention(q, k, v, causal=False):
    """Fused self-attention in the framework layout (B, T, H, D)."""
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            "flash_attention is self-attention only: expected k/v seq "
            f"length {q.shape[1]} (q's), got k={k.shape[1]}, v={v.shape[1]}"
        )
    if q.device.type == "cpu":
        return dense_attention(q, k, v, causal=causal)
    return _FlashFwd.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal)
    )


def attach_flash_attention(model) -> int:
    """Point every MultiHeadSelfAttention at ``flash_attention``; returns
    how many were attached. Process-local — not serialized."""
    from distkeras_tpu_torch.parallel.ring_attention import attach_attention_fn

    return attach_attention_fn(model, flash_attention)
