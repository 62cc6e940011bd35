"""The port's device contract.

Entry points take ``device=None``, which means ``"cuda"``. Without a GPU
they raise rather than drop quietly to the CPU; a caller that wants the
CPU (the tests, which compare against the JAX package) asks for it with
``device="cpu"``. On the CPU every kernel wrapper runs its plain PyTorch
version; on the GPU it launches its kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run its plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_model_device(model, device=None) -> torch.device:
    """Resolve ``device`` and require the model to live on it (a model on
    another device is a caller error, never moved behind their back)."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type:
        raise ValueError(
            f"model parameters live on {have}, but device={dev} was asked "
            f"for; build the model there (zoo.transformer_lm(device=...))"
        )
    return have


def local_devices(device=None) -> list:
    """The devices a trainer places its workers on, round-robin (the role
    of ``jax.local_devices()`` in the JAX package's distributed trainer):
    the one device ``device`` resolves to, with a CUDA index made explicit
    (the current card's when none is given). Every worker of a trainer
    runs on that card; spreading workers over several cards waits for the
    multi-card slices of the port."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev]
