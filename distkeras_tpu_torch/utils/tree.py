"""Parameter-dict arithmetic (PyTorch port of ``distkeras_tpu.utils.tree``).

The JAX package's parameters are pytrees; the port's are ``state_dict``-
keyed dicts (``"1.mhsa.wq"`` -> tensor or, for the parameter server's
host-resident center and the workers' snapshots, numpy array); these
helpers take tensors and arrays alike.
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


def tree_zeros_like(a):
    """Zeros shaped like each leaf, key-wise."""
    return {k: torch.zeros_like(x) if isinstance(x, torch.Tensor)
            else np.zeros_like(x) for k, x in a.items()}


def _vdot(x, y):
    if isinstance(x, torch.Tensor):
        return torch.vdot(x.reshape(-1), torch.as_tensor(y).reshape(-1))
    return np.vdot(x, y)


def tree_dot(a, b):
    """Sum of element-wise products across all leaves: a 0-d tensor for
    tensor leaves, a numpy scalar for arrays."""
    return sum(_vdot(x, y) for _, x, y in _zip(a, b))


def tree_norm(a):
    """Global L2 norm across all leaves."""
    sq = tree_dot(a, a)
    return torch.sqrt(sq) if isinstance(sq, torch.Tensor) else np.sqrt(sq)


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


def to_host(tree):
    """The same structure (dicts, lists, tuples, namedtuples) with every
    tensor and array leaf an owned host numpy copy — a snapshot that later
    in-place updates of the live tensors cannot reach. Tensors are copied
    off the device in one pass over the tree."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def copy_tree_(dst, src):
    """Copy ``src`` (tensors, arrays or numbers in ``dst``'s structure)
    into ``dst``'s tensors in place, each cast to its target's dtype and
    device; the structures and shapes must match."""
    if isinstance(dst, torch.Tensor):
        value = torch.as_tensor(np.asarray(src) if not isinstance(
            src, torch.Tensor) else src)
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(
                f"shape {tuple(value.shape)} != {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(value)
        return
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"keys differ: {sorted(set(dst) ^ set(src))}")
        for k in dst:
            copy_tree_(dst[k], src[k])
        return
    for d, s in zip(dst, src, strict=True):
        copy_tree_(d, s)


def tree_signature(tree):
    """The structure and leaf shapes of a tree, with lists and tuples
    alike (a decoded checkpoint keeps each container's kind, but two
    layouts that differ only in it hold the same state)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_signature(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(tree_signature(v) for v in tree))
    return ("leaf", tuple(np.shape(tree)))
