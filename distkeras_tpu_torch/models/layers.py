"""Layers of the transformer LM family (PyTorch port of
``distkeras_tpu.models.layers``, the subset the serving path runs).

Each layer is an ``nn.Module`` that owns its parameters under the JAX
package's names (``kernel``/``bias``, ``tokens``/``positions``,
``gamma``/``beta``, ``wq``/``wk``/``wv``/``wo``/``bo``), so a model's
``state_dict`` keys are the JAX params tree flattened with dots and
``utils.convert.params_from_jax`` loads one into the other. ``init(gen,
in_shape)`` creates the parameters from an explicit ``torch.Generator``
and returns the output shape; ``forward`` is the eval-mode computation
(dropout is the identity; backward through the kernels belongs to the
training slice). ``get_config`` is JSON-identical to the JAX layer's.

``Dense.kernel`` keeps the JAX layout ``(in, out)``: ``y = x @ kernel``.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.ops.quantization import qmatmul, qshape

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


# ---------------------------------------------------------------------- base


class Layer(nn.Module):
    """Base layer: ``init`` creates parameters, ``forward`` computes."""

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
    MLP being Dense(mlp_ratio*d, gelu) -> Dense(d). Eval only: ``dropout``
    is the identity and ``remat`` (a training-memory knob) changes
    nothing; both ride the config for parity with the JAX layer."""

    def __init__(self, num_heads, mlp_ratio=4, causal=False, remat=False,
                 dropout=0.0):
        super().__init__()
        self.num_heads = int(num_heads)
        self.mlp_ratio = int(mlp_ratio)
        self.causal = bool(causal)
        self.remat = bool(remat)
        self.dropout = float(dropout)
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

    def forward(self, x):
        x = x + self.mhsa(self.ln1(x))
        return x + self.fc2(self.fc1(self.ln2(x)))

    def get_config(self):
        return {
            "layer": "TransformerBlock",
            "num_heads": self.num_heads,
            "mlp_ratio": self.mlp_ratio,
            "causal": self.causal,
            "remat": self.remat,
            "dropout": self.dropout,
        }
