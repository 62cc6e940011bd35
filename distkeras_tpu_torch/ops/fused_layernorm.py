"""Fused LayerNorm forward (PyTorch port of ``distkeras_tpu.ops.fused_layernorm``).

On a CUDA tensor ``fused_layer_norm`` launches the hand-written Hopper
kernel ``kernels/csrc/layernorm_fwd.cu`` (one pass per row: mean, biased
variance, normalize, affine, f32 compute, output in x's dtype) or raises.
On a CPU tensor it runs ``_reference_layer_norm``, the plain version with
the same math. The backward kernel belongs to the training slice; the
autograd function raises until then.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch import kernels


def _reference_layer_norm(x, gamma, beta, epsilon):
    """The plain path — identical math to ``LayerNorm``'s own."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layernorm_fwd(x2, gamma, beta, epsilon):
    """Launch the CUDA kernel on contiguous (rows, D) ``x2``; returns y in
    x2's dtype. Raises on anything the kernel does not take."""
    if not x2.is_cuda:
        raise ValueError("layernorm_fwd launches on CUDA tensors only")
    if x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(
            f"layernorm_fwd wants a contiguous (rows, D) tensor; got shape "
            f"{tuple(x2.shape)}, strides {x2.stride()}"
        )
    rows, d = x2.shape
    if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError(
            f"gamma/beta must be ({d},); got {tuple(gamma.shape)}, "
            f"{tuple(beta.shape)}"
        )
    code = kernels.cuda_dtype_code(x2.dtype)
    g = gamma.to(device=x2.device, dtype=torch.float32).contiguous()
    b = beta.to(device=x2.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x2)
    from distkeras_tpu_torch.kernels.build import kernel

    fn = kernel("layernorm_fwd")
    with torch.cuda.device(x2.device):
        err = fn(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            rows, d, float(epsilon), code,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    kernels.check_launch("layernorm_fwd", err)
    return y


class _LayerNormFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, epsilon):
        return layernorm_fwd(x2, gamma, beta, epsilon)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError("flash/LN backward: training slice")


def fused_layer_norm(x, gamma, beta, epsilon=1e-5):
    """LayerNorm over the trailing axis. ``x``: (..., D); ``gamma``/``beta``:
    (D,). CUDA: the kernel, for any D and any row count. CPU: the plain
    version."""
    if x.device.type == "cpu":
        return _reference_layer_norm(x, gamma, beta, epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    return _LayerNormFwd.apply(x2, gamma, beta, float(epsilon)).reshape(
        x.shape
    )


def attach_fused_layernorm(model) -> int:
    """Point every LayerNorm at ``fused_layer_norm``; returns how many were
    attached. Process-local, like the attention hooks — not serialized."""
    from distkeras_tpu_torch.models.layers import LayerNorm
    from distkeras_tpu_torch.models.sequential import walk_layers

    n = 0
    for layer in walk_layers(model):
        if isinstance(layer, LayerNorm):
            layer.norm_fn = fused_layer_norm
            n += 1
    return n
