"""Parameter-dict arithmetic (PyTorch port of ``distkeras_tpu.utils.tree``).

The JAX package's parameters are pytrees; the port's are ``state_dict``-
keyed dicts of tensors (``"1.mhsa.wq"`` -> tensor). The parameter-server
delta rules and the member trainers' merges are written against these.
"""

from __future__ import annotations

import numpy as np
import torch


def _zip(a, b):
    if a.keys() != b.keys():
        raise ValueError(
            f"parameter dicts differ: {sorted(a.keys() ^ b.keys())}"
        )
    return ((k, a[k], b[k]) for k in a)


def tree_add(a, b):
    """a + b, key-wise."""
    return {k: x + y for k, x, y in _zip(a, b)}


def tree_sub(a, b):
    """a - b, key-wise."""
    return {k: x - y for k, x, y in _zip(a, b)}


def tree_scale(a, s):
    """s * a for scalar s, key-wise."""
    return {k: x * s for k, x in a.items()}


def tree_mean(trees):
    """Element-wise mean of a list of parameter dicts (AveragingTrainer's
    merge rule)."""
    if not trees:
        raise ValueError("tree_mean of empty list")
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def host_copy(a):
    """Owned CPU copy of every tensor (detached), e.g. to seed a worker
    with weights that its in-place updates must not reach."""
    return {k: torch.as_tensor(v).detach().to("cpu", copy=True)
            for k, v in a.items()}


def tree_allclose(a, b, rtol=1e-5, atol=1e-6):
    """Host-side structural + numerical equality check (for tests)."""
    if a.keys() != b.keys():
        return False
    return all(
        np.allclose(torch.as_tensor(x).detach().cpu().numpy(),
                    torch.as_tensor(y).detach().cpu().numpy(),
                    rtol=rtol, atol=atol)
        for _, x, y in _zip(a, b)
    )
