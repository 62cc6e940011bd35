"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

The JAX package beside it is the reference; module names match it so each
counterpart is easy to find. This package imports ``torch`` and never
``jax``, nor anything of ``distkeras_tpu``. Entry points take
``device=None``, meaning CUDA; without a GPU they raise unless the caller
asks for ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version. On CUDA the hand-written Hopper kernels run (built from
``kernels/csrc`` at first use) or the call raises.

Ported so far: the serving slice — the transformer LM family
(``models``), ``ModelPredictor`` and the sequence generators
(``predictors``), the dense-bank ``ServingEngine`` (``serving``) — and
the training slice — ``SingleTrainer`` (``trainers``, ``workers``),
losses, metrics and the sgd/adam/pallas_adam optimizers (``ops``), the
data loaders and prefetcher (``data``). Kernels (``kernels/csrc``):
LayerNorm forward and backward, FlashAttention forward and backward (dQ,
dK/dV), and the fused multi-tensor Adam.
"""

from distkeras_tpu_torch.data import loaders
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.layers import (
    Dense,
    Dropout,
    Embedding,
    LayerNorm,
    MultiHeadSelfAttention,
    TransformerBlock,
)
from distkeras_tpu_torch.models.sequential import Sequential
from distkeras_tpu_torch.ops.flash_attention import (
    attach_flash_attention,
    flash_attention,
)
from distkeras_tpu_torch.ops.fused_layernorm import (
    attach_fused_layernorm,
    fused_layer_norm,
)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam
from distkeras_tpu_torch.predictors import (
    CachedSequenceGenerator,
    ModelPredictor,
    SequenceGenerator,
)
from distkeras_tpu_torch.serving.engine import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.trainers import SingleTrainer, Trainer
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.workers import SingleTrainerWorker, WorkerCore

__all__ = [
    "CachedSequenceGenerator",
    "Dataset",
    "DecodeStepper",
    "Dense",
    "Dropout",
    "Embedding",
    "FusedAdam",
    "LayerNorm",
    "ModelPredictor",
    "MultiHeadSelfAttention",
    "SamplingParams",
    "Sequential",
    "SequenceGenerator",
    "ServingEngine",
    "SingleTrainer",
    "SingleTrainerWorker",
    "Trainer",
    "TrainingHistory",
    "TransformerBlock",
    "WorkerCore",
    "attach_flash_attention",
    "attach_fused_layernorm",
    "flash_attention",
    "fused_layer_norm",
    "get_loss",
    "get_metric",
    "get_optimizer",
    "loaders",
    "params_from_jax",
    "zoo",
]
