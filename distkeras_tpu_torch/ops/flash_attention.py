"""FlashAttention forward and backward (PyTorch port of
``distkeras_tpu.ops.flash_attention``).

On CUDA tensors ``flash_attention`` launches the hand-written Hopper
kernels: the forward ``kernels/csrc/flash_fwd.cu`` (online softmax over
64-row K/V tiles on the accumulators, causal tiles above the diagonal
skipped) and, under autograd, the FlashAttention-2 backward
``kernels/csrc/flash_bwd.cu`` (a dQ kernel over query tiles, then a dK/dV
kernel over key tiles, no atomics). Every product of both runs on the
tensor cores with ``mma.sync`` (3xTF32 for f32 inputs, one pass for
bf16/f16), the streamed tiles double-buffered with ``cp.async``, through
the helpers of ``kernels/csrc/flash_common.cuh``; each kernel takes any T
(the tail tile is masked) and head dim up to 128 — or raises. An f32 block
that meets an infinite or NaN value runs its loop again with a guarded
3xTF32 split, so an infinite operand gives the exact f32 product (a row
whose every score is -inf gets O = 0 and lse = -inf, as in JAX). The TPU
module's "dense" and "blockwise" fallbacks were VMEM/tiling artifacts and
do not exist here: on CUDA ``effective_path`` is always "flash". On CPU
tensors the same autograd function runs the plain versions
(``_reference_flash_fwd`` / ``_reference_flash_bwd``, the FA2 math on
whole matrices).
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch import kernels

#: the CUDA kernels' tiles (query rows per block, keys per K/V tile), the
#: same for the forward and both backward kernels
BLOCK_Q = 64
BLOCK_K = 64
MAX_HEAD_DIM = 128


def _scores(q, k, causal):
    """Scaled f32 scores (B, H, Tq, Tk), causal entries masked to -inf."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def _reference_flash_fwd(q, k, v, causal):
    """Plain version of the kernel: (B, T, H, D) -> (O in q's dtype, lse
    (B, H, T, 1) f32), lse being the scaled-score logsumexp. A row whose
    every score is -inf (it attends nothing) keeps the JAX kernel's guards
    (flash_attention.py:82,102,104 there): the shift is 0, l == 0 divides
    by 1, so O = 0 and lse = -inf where a plain softmax gives NaN."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    empty = torch.isneginf(m)
    p = torch.exp(s - torch.where(empty, torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float())
    lse = torch.where(empty, m, m + torch.log(l_safe))
    return o.to(q.dtype), lse


def _reference_p_ds(q, k, v, do, lse, delta, causal):
    """p = exp(s - lse) (masked: 0; lse = -inf shifts by 0, the JAX
    guard) and ds = p * (dO v^T - delta) * scale, (B, H, Tq, Tk) f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    shift = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(_scores(q, k, causal) - shift)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta) * scale


def _reference_flash_bwd_dq(q, k, v, o, lse, do, causal):
    """Plain version of the dQ kernel: (dQ in q's dtype, delta (B, H, T, 1)
    f32 = rowsum(dO * O))."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).unsqueeze(-1)
    _, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta


def _reference_flash_bwd_dkv(q, k, v, do, lse, delta, causal):
    """Plain version of the dK/dV kernel: (dK, dV) in k's/v's dtype."""
    p, ds = _reference_p_ds(q, k, v, do, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _reference_flash_bwd(q, k, v, o, lse, do, causal):
    """Plain version of the backward kernels: the FlashAttention-2 math of
    ``_dq_kernel``/``_dkv_kernel`` on whole matrices. All (B, T, H, D)
    except lse (B, H, T, 1); returns (dQ, dK, dV) in q's dtype."""
    dq, delta = _reference_flash_bwd_dq(q, k, v, o, lse, do, causal)
    return (dq, *_reference_flash_bwd_dkv(q, k, v, do, lse, delta, causal))


def _check_qkv(name, *ts):
    q = ts[0]
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if q.ndim != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(
            f"{name} wants equal (B, T, H, D) tensors; got "
            + ", ".join(str(tuple(t.shape)) for t in ts)
        )
    if any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} wants tensors of one dtype")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} wants contiguous tensors")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(
            f"{name} supports head_dim <= {MAX_HEAD_DIM}; got {q.shape[3]}"
        )
    return q.shape


def flash_fwd(q, k, v, causal):
    """Launch the CUDA kernel; returns (O (B, T, H, D), lse (B, H, T, 1)).
    Raises on anything the kernel does not take."""
    b, t, h, d = _check_qkv("flash_fwd", q, k, v)
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


def _check_lse(name, lse, shape, device):
    if (lse.dtype != torch.float32 or tuple(lse.shape) != shape
            or not lse.is_contiguous() or lse.device != device):
        raise ValueError(
            f"{name} wants a contiguous f32 row statistic of shape {shape} "
            f"on {device}; got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )


def flash_bwd_dq(q, k, v, o, lse, do, causal):
    """Launch the dQ kernel; returns (dQ in q's dtype, delta (B, H, T, 1)
    f32 = rowsum(dO * O), which the kernel computes and the dK/dV kernel
    reads). Raises on anything the kernel does not take."""
    b, t, h, d = _check_qkv("flash_bwd_dq", q, k, v, o, do)
    _check_lse("flash_bwd_dq", lse, (b, h, t, 1), q.device)
    code = kernels.cuda_dtype_code(q.dtype)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    from distkeras_tpu_torch.kernels.build import kernel

    with torch.cuda.device(q.device):
        err = kernel("flash_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, t, h, d, 1.0 / (d ** 0.5), int(bool(causal)), code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check_launch("flash_bwd_dq", err)
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal):
    """Launch the dK/dV kernel; returns (dK, dV) in q's dtype. Raises on
    anything the kernel does not take."""
    b, t, h, d = _check_qkv("flash_bwd_dkv", q, k, v, do)
    _check_lse("flash_bwd_dkv", lse, (b, h, t, 1), q.device)
    _check_lse("flash_bwd_dkv", delta, (b, h, t, 1), q.device)
    code = kernels.cuda_dtype_code(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    from distkeras_tpu_torch.kernels.build import kernel

    with torch.cuda.device(q.device):
        err = kernel("flash_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, h, d, 1.0 / (d ** 0.5), int(bool(causal)), code,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check_launch("flash_bwd_dkv", err)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal):
    """The backward on CUDA: the dQ kernel, then the dK/dV kernel on the
    same stream; returns (dQ, dK, dV) in q's dtype."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    """Kernels on CUDA tensors, their plain versions on CPU tensors. The
    forward keeps (q, k, v, O, lse) for the backward, as the JAX custom
    VJP does; under ``torch.no_grad`` nothing is kept and no backward
    runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        fwd = flash_fwd if q.is_cuda else _reference_flash_fwd
        o, lse = fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_bwd if q.is_cuda else _reference_flash_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def effective_path(t, head_dim, device="cuda"):
    """(path, bq, bk) that ``flash_attention`` runs for sequence length
    ``t``: "flash" with the kernels' 64x64 tiles on CUDA (any t), "plain"
    (the whole-matrix reference, whole sequence) on the CPU. Raises for a
    head dim the kernels do not take."""
    if torch.device(device).type == "cpu":
        return "plain", t, t
    if head_dim > MAX_HEAD_DIM:
        raise ValueError(
            f"flash kernel supports head_dim <= {MAX_HEAD_DIM}; got {head_dim}"
        )
    return "flash", BLOCK_Q, BLOCK_K


def effective_bwd_blocks(t, head_dim, device="cuda"):
    """(bq, bk) the BACKWARD runs for sequence length ``t``: the CUDA
    kernels' tiles (the same as the forward's; no budget re-clamp, shared
    memory holds them at every head dim up to 128), or the whole sequence
    on the CPU. Read by harnesses so an artifact names the path that ran."""
    _, bq, bk = effective_path(t, head_dim, device)
    return bq, bk


def flash_attention(q, k, v, causal=False):
    """Fused self-attention in the framework layout (B, T, H, D),
    differentiable: the backward runs the dQ and dK/dV kernels."""
    if k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]:
        raise ValueError(
            "flash_attention is self-attention only: expected k/v seq "
            f"length {q.shape[1]} (q's), got k={k.shape[1]}, v={v.shape[1]}"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal)
    )


def attach_flash_attention(model) -> int:
    """Point every MultiHeadSelfAttention at ``flash_attention``; returns
    how many were attached. Process-local — not serialized."""
    from distkeras_tpu_torch.parallel.ring_attention import attach_attention_fn

    return attach_attention_fn(model, flash_attention)
