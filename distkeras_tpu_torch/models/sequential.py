"""Sequential model container and the ``Residual`` block (PyTorch port of
``distkeras_tpu.models.sequential``).

A ``Sequential`` is an ``nn.Module`` over a layer list; its children are
named ``"0".."N"`` like the JAX params tree, so ``state_dict()`` keys read
``"1.mhsa.wq"`` where the JAX tree reads ``params["1"]["mhsa"]["wq"]``.
``build(input_shape, seed, device)`` creates every parameter from one
seeded ``torch.Generator`` (the numbers differ from JAX's init; load JAX
weights through ``utils.convert.params_from_jax`` to compare the two).

A built model starts in eval mode (what serving runs); ``train()`` /
``eval()`` — ``nn.Module``'s switch — select training mode, in which
``forward(x, rng=seed)`` hands each random-drawing layer its own seed.
``copy()`` is an independent model with the same weights, buffers and
hooks;
``get_weights``/``set_weights`` move flat numpy lists in the JAX
package's leaf order (its dicts flatten with sorted keys).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.models.layers import (
    Layer,
    get_activation,
    layer_from_config,
    register_layer,
)
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.rng import split_seed


@register_layer
class Residual(Layer):
    """y = act(main(x) + shortcut(x)); the shortcut defaults to the
    identity. The branches' layers are the children ``main_{i}`` and
    ``short_{i}``, so parameter and buffer names are the JAX tree's."""

    def __init__(self, layers, shortcut=None, activation="relu"):
        super().__init__()
        self.layers = [l if isinstance(l, Layer) else layer_from_config(l)
                       for l in layers]
        self.shortcut = [l if isinstance(l, Layer) else layer_from_config(l)
                         for l in (shortcut or [])]
        self.activation = activation
        for i, layer in enumerate(self.layers):
            self.add_module(f"main_{i}", layer)
        for i, layer in enumerate(self.shortcut):
            self.add_module(f"short_{i}", layer)
        self.uses_train_rng = any(l.uses_train_rng for l in self.sublayers())

    def init(self, gen, in_shape):
        shape = in_shape
        for layer in self.layers:
            shape = layer.init(gen, shape)
        sshape = in_shape
        for layer in self.shortcut:
            sshape = layer.init(gen, sshape)
        if tuple(sshape) != tuple(shape):
            raise ValueError(
                f"Residual branch shapes differ: main {tuple(shape)} vs "
                f"shortcut {tuple(sshape)}"
            )
        return shape

    def forward(self, x, rng=None):
        n = len(self.layers) + len(self.shortcut)
        rngs = split_seed(rng, n) if rng is not None else [None] * n
        y, s = x, x
        for layer, r in zip(self.layers, rngs):
            y = layer(y, rng=r) if layer.uses_train_rng else layer(y)
        for layer, r in zip(self.shortcut, rngs[len(self.layers):]):
            s = layer(s, rng=r) if layer.uses_train_rng else layer(s)
        return get_activation(self.activation)(y + s)

    def get_config(self):
        return {
            "layer": "Residual",
            "layers": [l.get_config() for l in self.layers],
            "shortcut": [l.get_config() for l in self.shortcut],
            "activation": self.activation,
        }

    def sublayers(self):
        return list(self.layers) + list(self.shortcut)


def walk_layers(model_or_layers):
    """Depth-first generator over a model's layers including sublayers —
    THE traversal the hook attach/detach helpers share."""
    stack = list(getattr(model_or_layers, "layers", model_or_layers))
    while stack:
        layer = stack.pop()
        yield layer
        stack.extend(layer.sublayers())


class Sequential(nn.Module):
    """Declarative layer stack; call ``build(input_shape)`` to materialize."""

    def __init__(self, layers=None):
        super().__init__()
        self.layers = []
        self.input_shape = None
        self.output_shape = None
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Layer):
        self.add_module(str(len(self.layers)), layer)
        self.layers.append(layer)

    def build(self, input_shape, seed=0, device=None):
        """``input_shape`` excludes the batch dim, e.g. ``(seq_len,)``.
        ``device=None`` means CUDA (raises without a GPU)."""
        dev = resolve_device(device)
        self.input_shape = tuple(int(d) for d in input_shape)
        gen = torch.Generator().manual_seed(int(seed))
        shape = self.input_shape
        for layer in self.layers:
            shape = layer.init(gen, shape)
        self.output_shape = tuple(shape)
        self.to(dev)
        return self.eval()

    def forward(self, x, rng=None):
        """``rng``: an integer seed, split one per layer (as the JAX model
        splits its key); only layers with ``uses_train_rng`` receive theirs."""
        rngs = (split_seed(rng, len(self.layers)) if rng is not None
                else [None] * len(self.layers))
        for layer, r in zip(self.layers, rngs):
            x = layer(x, rng=r) if layer.uses_train_rng else layer(x)
        return x

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def predict(self, x, batch_size=None):
        """Inference in eval mode on the current weights: ``x`` (numpy or
        a tensor) in batches of ``batch_size`` rows (all at once when
        None), on the model's device; returns a numpy array. The
        model's mode is restored after."""
        dev = next(self.parameters()).device
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        if x.dtype == torch.float64:  # JAX's canonical float32
            x = x.float()
        n = x.shape[0]
        step = n if batch_size is None or n <= batch_size else batch_size
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                outs = [self(x[i:i + step].to(dev)).cpu().numpy()
                        for i in range(0, n, max(step, 1))]
        finally:
            self.train(was_training)
        return np.concatenate(outs, axis=0)

    def summary(self) -> str:
        """One line a layer with its parameter count, then the total: the
        JAX package's ``Model.summary`` text."""
        lines = [f"Model(input_shape={self.input_shape})"]
        for i, layer in enumerate(self.layers):
            cfg = {k: v for k, v in layer.get_config().items()
                   if k != "layer"}
            args = ", ".join(f"{k}={v!r}" for k, v in cfg.items())
            n = sum(p.numel() for p in layer.parameters())
            lines.append(f"  {i}: {type(layer).__name__}({args})  "
                         f"params={n}")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

    def copy(self) -> "Sequential":
        """An independent model: same layers, hooks and mode, its own
        parameters and buffers."""
        return copy.deepcopy(self)

    def _leaf_order(self):
        """Parameter names in the JAX package's ``jax.tree.leaves`` order:
        nested dicts flatten with their keys sorted at every level."""
        return sorted(dict(self.named_parameters()),
                      key=lambda name: name.split("."))

    def get_weights(self):
        """Flat list of numpy arrays in the JAX leaf order (the
        parameter-server wire format)."""
        own = dict(self.named_parameters())
        return [own[n].detach().cpu().numpy().copy()
                for n in self._leaf_order()]

    def set_weights(self, weights):
        """Load a ``get_weights``-ordered list in place."""
        names = self._leaf_order()
        if len(weights) != len(names):
            raise ValueError(
                f"expected {len(names)} weight arrays, got {len(weights)}"
            )
        own = dict(self.named_parameters())
        with torch.no_grad():
            for n, w in zip(names, weights):
                p = own[n]
                p.copy_(torch.tensor(np.asarray(w)).reshape(p.shape))

    def get_config(self):
        return [layer.get_config() for layer in self.layers]

    @classmethod
    def from_config(cls, configs) -> "Sequential":
        return cls([layer_from_config(c) for c in configs])
