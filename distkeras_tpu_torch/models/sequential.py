"""Sequential model container (PyTorch port of ``distkeras_tpu.models.sequential``).

A ``Sequential`` is an ``nn.Module`` over a layer list; its children are
named ``"0".."N"`` like the JAX params tree, so ``state_dict()`` keys read
``"1.mhsa.wq"`` where the JAX tree reads ``params["1"]["mhsa"]["wq"]``.
``build(input_shape, seed, device)`` creates every parameter from one
seeded ``torch.Generator`` (the numbers differ from JAX's init; load JAX
weights through ``utils.convert.params_from_jax`` to compare the two).
"""

from __future__ import annotations

import torch
from torch import nn

from distkeras_tpu_torch.models.layers import Layer, layer_from_config
from distkeras_tpu_torch.utils.device import resolve_device


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

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def get_config(self):
        return [layer.get_config() for layer in self.layers]

    @classmethod
    def from_config(cls, configs) -> "Sequential":
        return cls([layer_from_config(c) for c in configs])
