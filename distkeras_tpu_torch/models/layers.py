"""Layers (PyTorch port of ``distkeras_tpu.models.layers``): the dense,
convolutional, pooling, normalization and transformer layers of the zoo.

Each layer is an ``nn.Module`` that owns its parameters under the JAX
package's names (``kernel``/``bias``, ``tokens``/``positions``,
``gamma``/``beta``, ``wq``/``wk``/``wv``/``wo``/``bo``), so a model's
``state_dict`` keys are the JAX params tree flattened with dots and
``utils.convert.params_from_jax`` loads one into the other. Non-
trainable state (``BatchNorm``'s moving ``mean``/``var``) lives in
buffers under the JAX state tree's names;
``utils.convert.state_from_jax`` loads it. ``init(gen, in_shape)``
creates the parameters from an explicit ``torch.Generator`` and returns
the output shape; ``forward`` computes, in training mode under
``nn.Module.train()`` (dropout live) and in eval mode under ``eval()``
(dropout the identity). Layers that draw random bits in training mode
(``uses_train_rng``) take ``forward(x, rng=seed)``, an integer seed from
``utils.rng``; their bits match JAX's in distribution only.
``get_config`` is JSON-identical to the JAX layer's.

``Dense.kernel`` keeps the JAX layout ``(in, out)``: ``y = x @ kernel``.
Images stay NHWC at every layer boundary and ``Conv2D.kernel`` stays HWIO;
the convolutions and pools view NHWC memory as cuDNN's channels-last NCHW
inside the layer. ``SAME`` padding is XLA's: ``lo = total // 2`` and
``hi = total - lo`` per spatial axis, so a strided window pads more at the
bottom/right, which the layers pad explicitly where it is asymmetric.
"""

from __future__ import annotations

import contextlib
import logging
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.ops.quantization import qmatmul, qshape
from distkeras_tpu_torch.utils.rng import split_seed

# ---------------------------------------------------------------- activations

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the exact erf form, so the approximation is named explicitly
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
}


def get_activation(name):
    if name is None:
        return _ACTIVATIONS["linear"]
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


# ------------------------------------------------------------------- registry

_LAYER_REGISTRY = {}


def register_layer(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_config(cfg: dict):
    cfg = dict(cfg)
    cls = _LAYER_REGISTRY[cfg.pop("layer")]
    return cls(**cfg)


# ----------------------------------------------------------------------- init


def _param(t):
    return nn.Parameter(t)


def _glorot_uniform(gen, shape, fan_in, fan_out):
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty(shape).uniform_(-limit, limit, generator=gen)


def _normal(gen, shape, std):
    return torch.empty(shape).normal_(0.0, std, generator=gen)


# ---------------------------------------------------------------------- remat

_RECOMPUTE = threading.local()


class _Recomputing(contextlib.AbstractContextManager):
    """Marks the thread that replays a checkpointed forward in the
    backward (autograd's device thread on CUDA)."""

    def __enter__(self):
        _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1

    def __exit__(self, *exc):
        _RECOMPUTE.depth -= 1


def recomputing() -> bool:
    """True while a ``remat`` forward is being replayed: layers that update
    state in their forward (``BatchNorm``) skip the update then, so the
    state advances once per forward, as JAX threads it once."""
    return getattr(_RECOMPUTE, "depth", 0) > 0


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward replays ``fn`` instead of keeping its activations, with
    ``recomputing()`` true during the replay."""
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _Recomputing()),
    )


# ---------------------------------------------------------------------- base


class Layer(nn.Module):
    """Base layer: ``init`` creates parameters, ``forward`` computes."""

    # True for layers that take ``forward(x, rng=seed)`` (dropout)
    uses_train_rng = False

    def init(self, gen, in_shape):
        return in_shape

    def forward(self, x):
        return x

    def get_config(self) -> dict:
        return {"layer": type(self).__name__}

    def sublayers(self):
        """Nested Layer children (composite layers override) — lets model
        walkers (hook attachment) reach every layer."""
        return []


# --------------------------------------------------------------------- layers


@register_layer
class Dense(Layer):
    """y = act(x @ kernel + bias), kernel (in, out)."""

    def __init__(self, units, activation=None, use_bias=True):
        super().__init__()
        self.units = int(units)
        self.activation = activation
        self.use_bias = bool(use_bias)

    def init(self, gen, in_shape):
        fan_in = in_shape[-1]
        self.kernel = _param(
            _glorot_uniform(gen, (fan_in, self.units), fan_in, self.units)
        )
        if self.use_bias:
            self.bias = _param(torch.zeros(self.units))
        return (*in_shape[:-1], self.units)

    def forward(self, x):
        y = qmatmul(x, self.kernel)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return get_activation(self.activation)(y)

    def get_config(self):
        return {
            "layer": "Dense",
            "units": self.units,
            "activation": self.activation,
            "use_bias": self.use_bias,
        }


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(a) for a in v)


def _check_padding(padding):
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID'; got {padding!r}")
    return padding


def _same_pads(size, k, s):
    """XLA's SAME split of one spatial axis: (lo, hi)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _window_out(in_hw, window, strides, padding):
    """Output (H, W) of a conv or pool window, as XLA computes it."""
    if padding == "SAME":
        return tuple(-(-n // s) for n, s in zip(in_hw, strides))
    return tuple((n - k) // s + 1 for n, k, s in zip(in_hw, window, strides))


def _pad_nchw(x, window, strides, padding, value):
    """``x`` (an NCHW view) and the symmetric padding left for the op
    itself: ``SAME`` pads that differ between the two sides are applied
    here with ``value``, symmetric ones are handed to the op."""
    if padding == "VALID":
        return x, (0, 0)
    (t, b), (l, r) = (_same_pads(n, k, s) for n, k, s in
                      zip(x.shape[2:], window, strides))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class _HWIOGrad(torch.autograd.Function):
    """The identity whose backward makes the gradient contiguous: the
    convolution reads the HWIO kernel through a permuted OIHW view, so its
    gradient arrives in the view's layout, and the fused optimizers take
    contiguous gradients only."""

    @staticmethod
    def forward(ctx, w):
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


@register_layer
class Conv2D(Layer):
    """NHWC convolution with an HWIO ``kernel`` (and ``bias`` (filters,));
    the kernel is cast to the input's dtype."""

    def __init__(self, filters, kernel_size, strides=1, padding="SAME",
                 activation=None, use_bias=True):
        super().__init__()
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _check_padding(padding)
        self.activation = activation
        self.use_bias = bool(use_bias)

    def init(self, gen, in_shape):
        h, w, cin = in_shape
        kh, kw = self.kernel_size
        self.kernel = _param(_glorot_uniform(
            gen, (kh, kw, cin, self.filters), kh * kw * cin,
            kh * kw * self.filters,
        ))
        if self.use_bias:
            self.bias = _param(torch.zeros(self.filters))
        return (*_window_out((h, w), self.kernel_size, self.strides,
                             self.padding), self.filters)

    def forward(self, x):
        w = _HWIOGrad.apply(self.kernel).to(x.dtype).permute(3, 2, 0, 1)
        xc, pad = _pad_nchw(x.permute(0, 3, 1, 2), self.kernel_size,
                            self.strides, self.padding, 0.0)
        y = F.conv2d(xc, w.contiguous(memory_format=torch.channels_last),
                     stride=self.strides, padding=pad).permute(0, 2, 3, 1)
        if self.use_bias:
            y = y + self.bias.to(x.dtype)
        return get_activation(self.activation)(y)

    def get_config(self):
        return {
            "layer": "Conv2D",
            "filters": self.filters,
            "kernel_size": list(self.kernel_size),
            "strides": list(self.strides),
            "padding": self.padding,
            "activation": self.activation,
            "use_bias": self.use_bias,
        }


class _Pool2D(Layer):
    def __init__(self, pool_size=2, strides=None, padding="VALID"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides if strides is not None
                             else self.pool_size)
        self.padding = _check_padding(padding)

    def init(self, gen, in_shape):
        h, w, c = in_shape
        return (*_window_out((h, w), self.pool_size, self.strides,
                             self.padding), c)

    def get_config(self):
        return {
            "layer": type(self).__name__,
            "pool_size": list(self.pool_size),
            "strides": list(self.strides),
            "padding": self.padding,
        }


@register_layer
class MaxPool2D(_Pool2D):
    """Window max; ``SAME`` pads with -inf."""

    def forward(self, x):
        xc, pad = _pad_nchw(x.permute(0, 3, 1, 2), self.pool_size,
                            self.strides, self.padding, float("-inf"))
        return F.max_pool2d(xc, self.pool_size, self.strides,
                            padding=pad).permute(0, 2, 3, 1)


@register_layer
class AvgPool2D(_Pool2D):
    """Window sum over zero padding divided by the full window size (the
    JAX layer's ``reduce_window`` sum / (ph * pw))."""

    def forward(self, x):
        xc, pad = _pad_nchw(x.permute(0, 3, 1, 2), self.pool_size,
                            self.strides, self.padding, 0.0)
        return F.avg_pool2d(xc, self.pool_size, self.strides, padding=pad,
                            count_include_pad=True).permute(0, 2, 3, 1)


@register_layer
class GlobalAvgPool2D(Layer):
    """(B, H, W, C) -> (B, C): mean over the spatial axes."""

    def init(self, gen, in_shape):
        return (in_shape[-1],)

    def forward(self, x):
        return x.mean(dim=(1, 2))


@register_layer
class Flatten(Layer):
    """(B, ...) -> (B, prod(...)) in row-major order: (H, W, C) for NHWC
    images, the order the JAX layer's reshape gives."""

    def init(self, gen, in_shape):
        size = 1
        for d in in_shape:
            size *= d
        return (size,)

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


def _dropout(x, rate, seed):
    """Inverted dropout of ``x`` with its mask drawn from ``seed`` on x's
    device — the one copy, shared by ``Dropout`` and the residual dropout
    of ``TransformerBlock``."""
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


@register_layer
class Dropout(Layer):
    """Inverted dropout; the identity in eval mode. Needs a seed in
    training mode: the mask is drawn from a generator built from it on
    x's device, so a recomputation (``remat``) draws the same mask."""

    uses_train_rng = True

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, rng=None):
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("Dropout in training mode requires an rng seed")
        return _dropout(x, self.rate, rng)

    def get_config(self):
        return {"layer": "Dropout", "rate": self.rate}


@register_layer
class Activation(Layer):
    def __init__(self, activation):
        super().__init__()
        self.activation = activation

    def forward(self, x):
        return get_activation(self.activation)(x)

    def get_config(self):
        return {"layer": "Activation", "activation": self.activation}


@register_layer
class Embedding(Layer):
    """Token embedding (+ optional learned positions) for (B, T) int ids."""

    def __init__(self, vocab_size, dim, with_positions=True):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.with_positions = bool(with_positions)

    def init(self, gen, in_shape):
        (t,) = in_shape
        self.tokens = _param(_normal(gen, (self.vocab_size, self.dim), 0.02))
        if self.with_positions:
            self.positions = _param(_normal(gen, (t, self.dim), 0.02))
        return (t, self.dim)

    def forward(self, x):
        y = self.tokens[x.long()]
        if self.with_positions:
            y = y + self.positions[None, : y.shape[1]]
        return y

    def get_config(self):
        return {
            "layer": "Embedding",
            "vocab_size": self.vocab_size,
            "dim": self.dim,
            "with_positions": self.with_positions,
        }


@register_layer
class LayerNorm(Layer):
    """Normalize over the trailing feature axis with learned scale/shift.

    ``norm_fn`` is a process-local hook: point it at
    ``ops.fused_layernorm.fused_layer_norm`` to run the CUDA kernel. Not
    serialized — a layer rebuilt from its config computes the plain path
    until the hook is re-attached."""

    def __init__(self, epsilon=1e-5):
        super().__init__()
        self.epsilon = float(epsilon)
        self.norm_fn = None  # override to plug in the fused kernel

    def init(self, gen, in_shape):
        d = in_shape[-1]
        self.gamma = _param(torch.ones(d))
        self.beta = _param(torch.zeros(d))
        return in_shape

    def forward(self, x):
        if self.norm_fn is not None:
            return self.norm_fn(x, self.gamma, self.beta, self.epsilon)
        from distkeras_tpu_torch.ops.fused_layernorm import (
            _reference_layer_norm,
        )

        return _reference_layer_norm(x, self.gamma, self.beta, self.epsilon)

    def get_config(self):
        if self.norm_fn is not None:
            logging.getLogger(__name__).warning(
                "LayerNorm.norm_fn is process-local and is not serialized; "
                "the deserialized layer will use the plain path until the "
                "fused kernel is re-attached"
            )
        return {"layer": "LayerNorm", "epsilon": self.epsilon}


@register_layer
class GlobalAvgPool1D(Layer):
    """(B, T, D) -> (B, D): mean over the sequence axis."""

    def init(self, gen, in_shape):
        t, d = in_shape
        return (d,)

    def forward(self, x):
        return x.mean(dim=1)


@register_layer
class MultiHeadSelfAttention(Layer):
    """Multi-head self-attention over (batch, seq, features).

    ``attention_fn`` is a process-local hook (e.g.
    ``ops.flash_attention.flash_attention``); None computes
    ``parallel.ring_attention.dense_attention``. Not serialized."""

    def __init__(self, num_heads, head_dim=None, causal=False, use_bias=True):
        super().__init__()
        self.num_heads = int(num_heads)
        self.head_dim = None if head_dim is None else int(head_dim)
        self.causal = bool(causal)
        self.use_bias = bool(use_bias)
        self.attention_fn = None

    def init(self, gen, in_shape):
        d = in_shape[-1]
        hd = self.head_dim or d // self.num_heads
        if self.head_dim is None and d % self.num_heads:
            raise ValueError(
                f"features {d} not divisible by num_heads {self.num_heads}"
            )
        inner = self.num_heads * hd
        for name, shape in [
            ("wq", (d, inner)), ("wk", (d, inner)),
            ("wv", (d, inner)), ("wo", (inner, d)),
        ]:
            setattr(self, name, _param(
                _glorot_uniform(gen, shape, shape[0], shape[1])
            ))
        if self.use_bias:
            self.bo = _param(torch.zeros(d))
        return (*in_shape[:-1], d)

    def forward(self, x):
        from distkeras_tpu_torch.parallel.ring_attention import (
            dense_attention,
        )

        b, t, _ = x.shape
        h = self.num_heads
        hd = qshape(self.wq)[1] // h

        def proj(w):
            return qmatmul(x, w).reshape(b, t, h, hd)

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        attn = self.attention_fn or dense_attention
        o = attn(q, k, v, causal=self.causal)
        o = qmatmul(o.reshape(b, t, h * hd), self.wo)
        if self.use_bias:
            o = o + self.bo.to(x.dtype)
        return o

    def get_config(self):
        if self.attention_fn is not None:
            logging.getLogger(__name__).warning(
                "MultiHeadSelfAttention.attention_fn is process-local and "
                "is not serialized; the deserialized layer will use dense "
                "attention until the hook is re-attached"
            )
        return {
            "layer": "MultiHeadSelfAttention",
            "num_heads": self.num_heads,
            "head_dim": self.head_dim,
            "causal": self.causal,
            "use_bias": self.use_bias,
        }


@register_layer
class TransformerBlock(Layer):
    """Pre-LN transformer block: x + MHSA(LN(x)), then x + MLP(LN(x)), the
    MLP being Dense(mlp_ratio*d, gelu) -> Dense(d).

    ``remat=True`` runs the block under ``torch.utils.checkpoint``
    (non-reentrant) while gradients are recorded: the backward recomputes
    the block's activations instead of keeping them, trading FLOPs for
    memory; numerics are unchanged. ``dropout`` applies inverted residual
    dropout to the attention and MLP branch outputs in training mode
    (identity in eval), its masks drawn from seeds split off ``rng``."""

    def __init__(self, num_heads, mlp_ratio=4, causal=False, remat=False,
                 dropout=0.0):
        super().__init__()
        self.num_heads = int(num_heads)
        self.mlp_ratio = int(mlp_ratio)
        self.causal = bool(causal)
        self.remat = bool(remat)
        self.dropout = float(dropout)
        # declare the rng only when dropout is live (as the JAX layer does)
        self.uses_train_rng = self.dropout > 0.0
        self.ln1 = LayerNorm()
        self.mhsa = MultiHeadSelfAttention(self.num_heads, causal=self.causal)
        self.ln2 = LayerNorm()
        self.fc1 = None  # built in init (needs d)
        self.fc2 = None

    def sublayers(self):
        parts = [self.mhsa, self.ln1, self.ln2]
        if self.fc1 is not None:
            parts += [self.fc1, self.fc2]
        return parts

    def init(self, gen, in_shape):
        t, d = in_shape
        self.fc1 = Dense(self.mlp_ratio * d, activation="gelu")
        self.fc2 = Dense(d)
        for layer in (self.ln1, self.mhsa, self.ln2, self.fc1):
            layer.init(gen, in_shape)
        self.fc2.init(gen, (t, self.mlp_ratio * d))
        return in_shape

    def forward(self, x, rng=None):
        if self.remat and torch.is_grad_enabled():
            return remat(self._forward, x, rng)
        return self._forward(x, rng)

    def _forward(self, x, rng):
        drop = self.training and self.dropout > 0.0
        if drop:
            if rng is None:
                raise ValueError(
                    "TransformerBlock(dropout>0) in training mode requires "
                    "an rng seed"
                )
            r1, r2 = split_seed(rng, 2)
        a = self.mhsa(self.ln1(x))
        x = x + (_dropout(a, self.dropout, r1) if drop else a)
        h = self.fc2(self.fc1(self.ln2(x)))
        return x + (_dropout(h, self.dropout, r2) if drop else h)

    def get_config(self):
        return {
            "layer": "TransformerBlock",
            "num_heads": self.num_heads,
            "mlp_ratio": self.mlp_ratio,
            "causal": self.causal,
            "remat": self.remat,
            "dropout": self.dropout,
        }


@register_layer
class BatchNorm(Layer):
    """Batch normalization over every axis but the last (the channels).

    ``gamma``/``beta`` are parameters; the moving statistics are the
    buffers ``mean``/``var`` (f32). In training mode the layer normalizes
    with the batch's statistics, taken in f32 (the biased variance), and
    updates the buffers in place, without gradient: ``new = momentum * old
    + (1 - momentum) * batch`` — once per forward, never in a ``remat``
    replay. In eval mode it normalizes with the buffers. The normalization
    runs in the input's dtype."""

    def __init__(self, momentum=0.99, epsilon=1e-5, scale=True, center=True):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = bool(scale)
        self.center = bool(center)

    def init(self, gen, in_shape):
        c = in_shape[-1]
        if self.scale:
            self.gamma = _param(torch.ones(c))
        if self.center:
            self.beta = _param(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        return in_shape

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.ndim - 1))
            x32 = x.float()
            mean = x32.mean(dim=axes)
            var = (x32 - mean).square().mean(dim=axes)
            if not recomputing():
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if self.scale:
            y = y * self.gamma.to(x.dtype)
        if self.center:
            y = y + self.beta.to(x.dtype)
        return y

    def get_config(self):
        return {
            "layer": "BatchNorm",
            "momentum": self.momentum,
            "epsilon": self.epsilon,
            "scale": self.scale,
            "center": self.center,
        }
