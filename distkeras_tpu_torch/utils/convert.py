"""Weight bridge: load the JAX package's ``model.params`` into the port.

The JAX tree is a nested dict keyed ``"0".."N"`` then by layer and
parameter name; the port's ``state_dict`` keys are the same path joined
with dots. Layouts are the JAX ones, unchanged: ``Dense.kernel`` stays
``(in, out)`` (the port multiplies ``x @ kernel``, it is not an
``nn.Linear``), attention projections stay ``(d, heads*head_dim)`` and
``(heads*head_dim, d)``. So both packages compute the same function on
the same numbers. Quantized leaves are not bridged.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            if "q" in v and "s" in v:
                raise NotImplementedError(
                    f"{key}: quantized weights are not bridged; bridge the "
                    "f32 tree and quantize in the port"
                )
            yield from _flatten(v, key + ".")
        else:
            yield key, np.asarray(v)


def params_from_jax(model, params):
    """Copy a JAX params tree (leaves as numpy or anything ``np.asarray``
    takes) into ``model``'s parameters in place; returns the model. Keys
    and shapes must match exactly."""
    flat = dict(_flatten(params))
    own = dict(model.named_parameters())
    missing, extra = sorted(set(own) - set(flat)), sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(
            f"params do not match the model: missing {missing}, "
            f"unexpected {extra}"
        )
    with torch.no_grad():
        for name, p in own.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {tuple(arr.shape)} != {tuple(p.shape)}"
                )
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model
