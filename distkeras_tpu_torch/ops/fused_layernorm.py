"""Fused LayerNorm forward and backward (PyTorch port of
``distkeras_tpu.ops.fused_layernorm``).

On a CUDA tensor ``fused_layer_norm`` launches the hand-written Hopper
kernels or raises: the forward ``kernels/csrc/layernorm_fwd.cu`` (one
memory trip per row: mean, biased variance, normalize, affine, f32
compute, output in x's dtype) and, under autograd, the backward
``kernels/csrc/layernorm_bwd.cu`` (statistics recomputed from x, dx in x's
dtype, per-block f32 partial sums of dgamma/dbeta folded in the same
launch, in a fixed order).
On a CPU tensor the same functions run the plain versions,
``_reference_layer_norm`` and ``_reference_layer_norm_bwd``, with the same
math. Where no gradient can flow (under ``torch.no_grad``, or when none
of x, gamma, beta requires grad: decode, prefill, predict) the forward is
called directly, without the autograd function.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch import kernels

#: warps per block of the backward kernel (D <= 1024) and rows each walks
_BWD_WARPS = 8
_BWD_ROWS_PER_WARP = 2


def _reference_layer_norm(x, gamma, beta, epsilon):
    """The plain path — identical math to ``LayerNorm``'s own."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + epsilon)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _reference_layer_norm_bwd(x2, gamma, dy2, epsilon):
    """Plain version of the backward kernel on (rows, D): returns (dx in
    x2's dtype, dgamma f32 (D,), dbeta f32 (D,))."""
    x = x2.float()
    dy = dy2.float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + epsilon)
    xhat = xc * rstd
    a = dy * gamma.float()
    m1 = a.mean(dim=-1, keepdim=True)
    m2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (a - m1 - xhat * m2)
    return dx.to(x2.dtype), (dy * xhat).sum(0), dy.sum(0)


def _check_rows(name, x2, d_like, any_rank=False):
    """The wrappers' checks: a contiguous CUDA (rows, D) tensor (with
    ``any_rank``, any contiguous (..., D)) and (D,) gamma/beta; returns the
    launcher's dtype code."""
    if not x2.is_cuda:
        raise ValueError(f"{name} launches on CUDA tensors only")
    if (x2.ndim != 2 and not (any_rank and x2.ndim)) or not x2.is_contiguous():
        raise ValueError(
            f"{name} wants a contiguous (rows, D) tensor; got shape "
            f"{tuple(x2.shape)}, strides {x2.stride()}"
        )
    d = x2.shape[-1]
    for t in d_like:
        if t.shape != (d,):
            raise ValueError(
                f"{name}: gamma/beta must be ({d},); got "
                + ", ".join(str(tuple(t.shape)) for t in d_like)
            )
    return kernels.cuda_dtype_code(x2.dtype)


def _f32_like(t, x):
    """``t`` as a contiguous f32 tensor on ``x``'s device: itself when it
    already is one (the layer's own f32 parameters), else a copy."""
    if (t.dtype == torch.float32 and t.get_device() == x.get_device()
            and t.is_contiguous()):
        return t
    return t.to(device=x.device, dtype=torch.float32).contiguous()


#: the forward's ctypes launcher, loaded (built where needed) at first use
_fwd_launcher = None


def fwd_path(x2, gamma, beta, y):
    """The path ``dk_layernorm_fwd`` takes for these tensors, by the
    launcher's own rule (layernorm_fwd.cu, ``launch``): "block" for D >
    1024, else "vector" (16-byte chunks) when a row is a whole number of
    16-byte chunks and all four pointers are 16-byte aligned, else
    "scalar"."""
    d = x2.shape[-1]
    if d > 1024:
        return "block"
    aligned = not any(t.data_ptr() % 16 for t in (x2, gamma, beta, y))
    return "vector" if aligned and d * x2.element_size() % 16 == 0 else "scalar"


def layernorm_fwd(x2, gamma, beta, epsilon):
    """Launch the CUDA kernel on contiguous (rows, D) ``x2``; returns y in
    x2's dtype. Raises on anything the kernel does not take."""
    return _launch_fwd(x2, gamma, beta, epsilon,
                       _check_rows("layernorm_fwd", x2, (gamma, beta)))


def _launch_fwd(x, gamma, beta, epsilon, code):
    """The launch on a checked contiguous CUDA ``x`` (..., D), whose
    leading dimensions are the rows; y has x's shape and dtype."""
    global _fwd_launcher
    d = x.shape[-1]
    g, b = _f32_like(gamma, x), _f32_like(beta, x)
    y = torch.empty_like(x)
    if _fwd_launcher is None:
        from distkeras_tpu_torch.kernels.build import kernel

        _fwd_launcher = kernel("layernorm_fwd")
    index = x.get_device()
    # the current stream's raw handle, without building a Stream object
    args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.numel() // max(d, 1), d, float(epsilon), code,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = _fwd_launcher(*args)
    else:
        with torch.cuda.device(index):
            err = _fwd_launcher(*args)
    kernels.check_launch("layernorm_fwd", err)
    return y


def bwd_blocks(rows, d):
    """Blocks (and so partial rows) the backward kernel runs with:
    ``_BWD_WARPS`` warps of ``_BWD_ROWS_PER_WARP`` rows each for D <= 1024
    (256 blocks at 4096 rows: one wave at two per SM of an H100, 16 warps
    each with a row in flight), else one block per row up to 1024 blocks.
    Fixed by the shape, so dgamma/dbeta are summed in one order run after
    run."""
    if d <= 1024:
        per_block = _BWD_WARPS * _BWD_ROWS_PER_WARP
        return max(1, min(-(-rows // per_block), 65535))
    return max(1, min(rows, 1024))


def layernorm_bwd(x2, gamma, dy2, epsilon):
    """Launch the CUDA backward kernel on contiguous (rows, D) ``x2`` and
    ``dy2`` (one dtype); returns (dx in x2's dtype, dgamma f32 (D,),
    dbeta f32 (D,)). One launch: the kernel folds its per-block partial
    rows into row 0 of its (2, nblocks, D) workspace, and dgamma/dbeta are
    views of that row. Raises on anything the kernel does not take."""
    code = _check_rows("layernorm_bwd", x2, (gamma,))
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype or not (
            dy2.is_contiguous() and dy2.device == x2.device):
        raise ValueError(
            f"layernorm_bwd wants dy like x: contiguous {tuple(x2.shape)} "
            f"{x2.dtype}; got {tuple(dy2.shape)} {dy2.dtype}"
        )
    rows, d = x2.shape
    if rows == 0:
        z = torch.zeros(d, dtype=torch.float32, device=x2.device)
        return torch.empty_like(x2), z, z.clone()
    g = gamma.to(device=x2.device, dtype=torch.float32).contiguous()
    nblocks = bwd_blocks(rows, d)
    dx = torch.empty_like(x2)
    partials = torch.empty((2, nblocks, d), dtype=torch.float32,
                           device=x2.device)
    from distkeras_tpu_torch.kernels.build import kernel

    fn = kernel("layernorm_bwd")
    with torch.cuda.device(x2.device):
        err = fn(
            x2.data_ptr(), dy2.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partials.data_ptr(), rows, d, float(epsilon), nblocks, code,
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    kernels.check_launch("layernorm_bwd", err)
    return dx, partials[0, 0], partials[1, 0]


class _FusedLayerNorm(torch.autograd.Function):
    """Kernels on CUDA tensors, plain versions on CPU tensors. The function
    owns the f32 cast of gamma/beta (they arrive as the layer's
    parameters), so their gradients reach the parameters, in their own
    dtypes (fused_layernorm.py:170-173 of the JAX package). The forward
    keeps (x2, gamma, beta): beta only for its dtype."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, epsilon):
        ctx.save_for_backward(x2, gamma, beta)
        ctx.epsilon = epsilon
        if x2.is_cuda:
            return layernorm_fwd(x2, gamma, beta, epsilon)
        return _reference_layer_norm(x2, gamma, beta, epsilon)

    @staticmethod
    def backward(ctx, dy2):
        x2, gamma, beta = ctx.saved_tensors
        dy2 = dy2.contiguous()
        bwd = layernorm_bwd if x2.is_cuda else _reference_layer_norm_bwd
        dx, dg, db = bwd(x2, gamma, dy2, ctx.epsilon)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None


def fused_layer_norm(x, gamma, beta, epsilon=1e-5):
    """LayerNorm over the trailing axis. ``x``: (..., D); ``gamma``/``beta``:
    (D,). CUDA: the kernels, for any D and any row count. CPU: the plain
    versions. Differentiable in x, gamma and beta; where no gradient can
    flow, the forward runs without the autograd function (and on a
    contiguous CUDA x without reshaping it)."""
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if not torch.is_grad_enabled() or not (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        if x.is_cpu:
            return _reference_layer_norm(x, gamma, beta, float(epsilon))
        x = x.contiguous()
        return _launch_fwd(x, gamma, beta, epsilon, _check_rows(
            "layernorm_fwd", x, (gamma, beta), any_rank=True))
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    return _FusedLayerNorm.apply(x2, gamma, beta, float(epsilon)).reshape(
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
