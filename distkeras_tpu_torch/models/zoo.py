"""Model zoo (PyTorch port of ``distkeras_tpu.models.zoo``): the causal
language model the serving and training slices run, and the MNIST MLP the
asynchronous trainers' tests and examples run."""

from __future__ import annotations

from distkeras_tpu_torch.models.layers import (
    Dense,
    Embedding,
    LayerNorm,
    TransformerBlock,
)
from distkeras_tpu_torch.models.sequential import Sequential


def mnist_mlp(hidden=500, num_classes=10, seed=0, device=None):
    """MLP over flattened 28x28 inputs (input shape (784,)): two ReLU
    ``Dense`` layers and a softmax one. ``device=None`` builds on CUDA."""
    return Sequential(
        [
            Dense(hidden, activation="relu"),
            Dense(hidden, activation="relu"),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((784,), seed=seed, device=device)


def transformer_lm(
    vocab_size=256,
    seq_len=128,
    d_model=128,
    num_heads=4,
    depth=2,
    seed=0,
    remat=False,
    dropout=0.0,
    device=None,
):
    """Causal language model: Embedding -> causal TransformerBlock xN ->
    LayerNorm -> logits over the vocabulary (no softmax). Weights come from
    a seeded ``torch.Generator``; ``device=None`` builds on CUDA."""
    model = Sequential(
        [
            Embedding(vocab_size, d_model),
            *[
                TransformerBlock(num_heads, causal=True, remat=remat,
                                 dropout=dropout)
                for _ in range(depth)
            ],
            LayerNorm(),
            Dense(vocab_size),
        ]
    )
    return model.build((seq_len,), seed=seed, device=device)
