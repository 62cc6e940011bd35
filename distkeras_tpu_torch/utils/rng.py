"""Deterministic seed streams (PyTorch port of ``distkeras_tpu.utils.rng``).

JAX threads PRNG keys explicitly; the port threads integer seeds drawn
from an explicit ``torch.Generator``. A consumer that needs random bits
(``Dropout``, the residual dropout of ``TransformerBlock``) builds its own
generator from its seed on the tensor's device, so the same seed gives the
same bits on every call — which is what lets ``torch.utils.checkpoint``
recompute a dropout mask exactly. The bits are not JAX's: the two match in
distribution only.
"""

from __future__ import annotations

import torch

_SEED_HIGH = 2 ** 62


def _draw(gen, n):
    return [int(s) for s in torch.randint(_SEED_HIGH, (n,), generator=gen)]


def split_seed(seed: int, n: int):
    """``n`` independent seeds derived from ``seed`` (``jax.random.split``'s
    role)."""
    return _draw(torch.Generator().manual_seed(int(seed)), n)


class RngSeq:
    """A stream of integer seeds: ``next()`` is deterministic in the seed."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next(self) -> int:
        return _draw(self._gen, 1)[0]

    def next_n(self, n: int):
        return _draw(self._gen, n)

    def get_state(self):
        """The generator's state (a byte tensor), for snapshots."""
        return self._gen.get_state()

    def set_state(self, state):
        """Continue from a ``get_state`` snapshot (a byte tensor or the
        uint8 array a checkpoint holds)."""
        self._gen.set_state(torch.as_tensor(state, dtype=torch.uint8))

    def fork(self, index: int) -> "RngSeq":
        """Deterministic per-worker fork (worker index -> independent
        stream); the parent stream does not advance."""
        probe = torch.Generator()
        probe.set_state(self._gen.get_state())
        base = _draw(probe, 1)[0]
        return RngSeq(split_seed(base, int(index) + 1)[-1])
