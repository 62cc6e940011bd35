"""Model zoo (PyTorch port of ``distkeras_tpu.models.zoo``): the
architectures behind the BASELINE configs, the real-data MLPs, and the
transformer classifier and language model.

1. ``mnist_mlp``   — SingleTrainer anchor
2. ``mnist_cnn``   — DOWNPOUR config
3. ``higgs_mlp``   — AEASGD ATLAS-Higgs tabular classifier
4. ``cifar10_cnn`` — ADAG config
5. ``resnet18``    — DynSGD / ImageNet-shaped config

All NHWC, f32 parameters; trainers may compute in bf16. Every function
takes ``device=None``, which builds on CUDA. The mixture-of-experts
builders put a switch ``MoE`` layer (``parallel.expert_parallel``) after
every transformer block.
"""

from __future__ import annotations

from distkeras_tpu_torch.models.layers import (
    Activation,
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GlobalAvgPool1D,
    GlobalAvgPool2D,
    LayerNorm,
    MaxPool2D,
    TransformerBlock,
)
from distkeras_tpu_torch.models.sequential import Residual, Sequential


def _scaled(channels: int, width: float) -> int:
    """Channel count under a width multiplier, floored at 8 so narrow
    variants keep every layer trainable."""
    return max(8, int(channels * width))


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


def mnist_cnn(num_classes=10, seed=0, width=1.0, device=None):
    """Small convnet over (28, 28, 1) images. ``width``: channel
    multiplier (conv FLOPs scale ~width^2)."""
    w = lambda c: _scaled(c, width)  # noqa: E731
    return Sequential(
        [
            Conv2D(w(32), 3, activation="relu", padding="SAME"),
            Conv2D(w(32), 3, activation="relu", padding="SAME"),
            MaxPool2D(2),
            Conv2D(w(64), 3, activation="relu", padding="SAME"),
            Conv2D(w(64), 3, activation="relu", padding="SAME"),
            MaxPool2D(2),
            Flatten(),
            Dense(w(256), activation="relu"),
            Dropout(0.5),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((28, 28, 1), seed=seed, device=device)


def digits_mlp(hidden=64, num_classes=10, seed=0, device=None):
    """MLP over the in-repo 8x8 handwritten-digit set
    (``data.loaders.digits``, flattened 64-pixel inputs)."""
    return Sequential(
        [
            Dense(hidden, activation="relu"),
            Dense(hidden, activation="relu"),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((64,), seed=seed, device=device)


def tabular_regressor(num_features=10, hidden=64, seed=0, device=None):
    """MLP regressor with a linear (B, 1) head; pairs with ``loss="mse"``
    and the in-repo ``loaders.diabetes()``."""
    return Sequential(
        [
            Dense(hidden, activation="relu"),
            Dense(hidden, activation="relu"),
            Dense(1),
        ]
    ).build((num_features,), seed=seed, device=device)


def higgs_mlp(num_features=30, hidden=600, num_classes=2, seed=0,
              device=None):
    """ATLAS-Higgs-style tabular classifier (wide MLP over ~30 features)."""
    return Sequential(
        [
            Dense(hidden, activation="relu"),
            Dropout(0.3),
            Dense(hidden, activation="relu"),
            Dropout(0.3),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((num_features,), seed=seed, device=device)


def cifar10_cnn(num_classes=10, seed=0, bn_momentum=0.99, width=1.0,
                device=None):
    """VGG-ish convnet over (32, 32, 3) with BatchNorm. ``bn_momentum``:
    the moving statistics' momentum (short runs want ~0.9). ``width``: see
    :func:`mnist_cnn`."""
    bn = lambda: BatchNorm(momentum=bn_momentum)  # noqa: E731
    w = lambda c: _scaled(c, width)  # noqa: E731
    return Sequential(
        [
            Conv2D(w(64), 3, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            Conv2D(w(64), 3, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            MaxPool2D(2),
            Conv2D(w(128), 3, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            Conv2D(w(128), 3, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            MaxPool2D(2),
            Flatten(),
            Dense(w(256), activation="relu"),
            Dropout(0.5),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((32, 32, 3), seed=seed, device=device)


def transformer_classifier(
    vocab_size=64,
    seq_len=64,
    d_model=64,
    num_heads=4,
    depth=2,
    num_classes=2,
    seed=0,
    remat=False,
    device=None,
):
    """Sequence classifier: Embedding -> TransformerBlock xN (not causal)
    -> LayerNorm -> mean-pool -> softmax head."""
    return Sequential(
        [
            Embedding(vocab_size, d_model),
            *[TransformerBlock(num_heads, remat=remat) for _ in range(depth)],
            LayerNorm(),
            GlobalAvgPool1D(),
            Dense(num_classes, activation="softmax"),
        ]
    ).build((seq_len,), seed=seed, device=device)


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


def moe_transformer_lm(
    vocab_size=256,
    seq_len=128,
    d_model=128,
    num_heads=4,
    depth=2,
    num_experts=8,
    seed=0,
    remat=False,
    device=None,
):
    """Causal language model with a switch-MoE feed-forward after each
    block: Embedding -> (causal TransformerBlock, MoE) xN -> LayerNorm ->
    logits. Routing mixes nothing across tokens and a token's capacity
    place is positional, so a row stays causal; whether a token is
    dropped can depend on the other rows of the batch (capacity is a
    budget over all tokens), as in any capacity-dropped switch MoE."""
    from distkeras_tpu_torch.parallel.expert_parallel import MoE

    layers = [Embedding(vocab_size, d_model)]
    for _ in range(depth):
        layers += [
            TransformerBlock(num_heads, causal=True, remat=remat),
            MoE(num_experts),
        ]
    layers += [LayerNorm(), Dense(vocab_size)]
    return Sequential(layers).build((seq_len,), seed=seed, device=device)


def moe_transformer_classifier(
    vocab_size=64,
    seq_len=64,
    d_model=64,
    num_heads=4,
    depth=2,
    num_experts=8,
    num_classes=2,
    seed=0,
    device=None,
):
    """Sequence classifier with a switch-MoE feed-forward after each
    (non-causal) transformer block -> LayerNorm -> mean-pool -> softmax
    head. The load-balance loss reaches the training loss through
    ``WorkerCore``'s ``aux_loss_weight``."""
    from distkeras_tpu_torch.parallel.expert_parallel import MoE

    layers = [Embedding(vocab_size, d_model)]
    for _ in range(depth):
        layers += [TransformerBlock(num_heads), MoE(num_experts)]
    layers += [LayerNorm(), GlobalAvgPool1D(),
               Dense(num_classes, activation="softmax")]
    return Sequential(layers).build((seq_len,), seed=seed, device=device)


def _basic_block(filters, stride=1, downsample=False, bn_momentum=0.99):
    bn = lambda: BatchNorm(momentum=bn_momentum)  # noqa: E731
    shortcut = (
        [Conv2D(filters, 1, strides=stride, padding="SAME", use_bias=False),
         bn()]
        if downsample
        else None
    )
    return Residual(
        [
            Conv2D(filters, 3, strides=stride, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            Conv2D(filters, 3, padding="SAME", use_bias=False),
            bn(),
        ],
        shortcut=shortcut,
        activation="relu",
    )


def resnet18(
    num_classes=1000, input_shape=(224, 224, 3), small_stem=False, seed=0,
    bn_momentum=0.99, width=1.0, device=None,
):
    """ResNet-18 (NHWC). ``small_stem=True`` swaps the 7x7/s2 + max-pool
    stem for a 3x3/s1 one (the CIFAR-scale variant). ``bn_momentum``: see
    :func:`cifar10_cnn`. ``width``: filter multiplier over the whole trunk
    (the same 18-layer topology)."""
    bn = lambda: BatchNorm(momentum=bn_momentum)  # noqa: E731
    w = lambda c: _scaled(c, width)  # noqa: E731
    stem = (
        [Conv2D(w(64), 3, strides=1, padding="SAME", use_bias=False), bn(),
         Activation("relu")]
        if small_stem
        else [
            Conv2D(w(64), 7, strides=2, padding="SAME", use_bias=False),
            bn(),
            Activation("relu"),
            MaxPool2D(3, strides=2, padding="SAME"),
        ]
    )
    blk = lambda *a, **kw: _basic_block(  # noqa: E731
        *a, bn_momentum=bn_momentum, **kw)
    body = [
        blk(w(64)),
        blk(w(64)),
        blk(w(128), stride=2, downsample=True),
        blk(w(128)),
        blk(w(256), stride=2, downsample=True),
        blk(w(256)),
        blk(w(512), stride=2, downsample=True),
        blk(w(512)),
    ]
    head = [GlobalAvgPool2D(), Dense(num_classes, activation="softmax")]
    return Sequential(stem + body + head).build(input_shape, seed=seed,
                                                device=device)


ZOO = {
    "mnist_mlp": mnist_mlp,
    "mnist_cnn": mnist_cnn,
    "higgs_mlp": higgs_mlp,
    "cifar10_cnn": cifar10_cnn,
    "resnet18": resnet18,
    "transformer_classifier": transformer_classifier,
    "moe_transformer_classifier": moe_transformer_classifier,
}
