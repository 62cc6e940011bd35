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
(``predictors``), the dense-bank ``ServingEngine`` (``serving``); the
training slice — ``SingleTrainer`` (``trainers``, ``workers``), losses,
metrics and the sgd/adam/pallas_sgd/pallas_adam optimizers (``ops``),
the data loaders and prefetcher (``data``); and the asynchronous
parameter-server tier — ``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``ADAG``,
``DynSGD`` over the in-process parameter servers
(``parameter_servers``), in thread or seeded simulated mode, with the
numpy feature transformers (``data.transformers``) and the evaluators;
and the CNN and tabular model zoo — ``Conv2D``, the pools, ``Flatten``,
``BatchNorm``, ``Residual`` and the ``mnist_cnn``/``higgs_mlp``/
``cifar10_cnn``/``resnet18``/MLP/transformer-classifier models
(``models``), with the weight and state bridge (``utils.convert``); and
checkpoint/resume (``utils.checkpoint`` over the pickle-free codec of
``utils.serialization``), the JSONL metrics sink and the profiler trace
(``utils.profiling``), the whole optimizer table and the named
learning-rate schedules (``ops.optimizers``); the streaming and native
data layer: ``StreamingDataset`` over ``.npz`` shards (``data.streaming``)
and the C++ CSV reader and row gather (``data.native``, built with g++ at
first use); the member trainers ``EnsembleTrainer`` and
``AveragingTrainer`` (threaded or stepped together); and commit/pull
compression for the async tier (``utils.compression``); the socket
parameter-server tier: ``SocketParameterServer`` with warm-standby
replication and ``RemoteParameterServerClient`` (``parameter_servers``,
over ``networking``), the fault-injection seams (``faults``) and the PS's
metrics, time-series and flight-recorder books (``obs``); the switch
mixture-of-experts layer and its LM and classifier builders
(``parallel.expert_parallel``, ``models.zoo``), served and trained on
every path, and single-device blockwise attention
(``parallel.ring_attention``); and synchronous data parallelism —
``SynchronousDistributedTrainer`` with global-batch ``BatchNorm`` and
ZeRO-1, one process per rank over ``torch.distributed``
(``parallel.multihost``, ``parallel.mesh``), launched by
``job_deployment.Job``; tensor parallelism for training
(``SynchronousDistributedTrainer(model_parallel=)``,
``parallel.tensor_parallel``) and sequence parallelism
(``SequenceParallelTrainer`` over the ring of
``parallel.ring_attention`` or the all-to-alls of ``parallel.ulysses``);
expert parallelism (``SynchronousDistributedTrainer(expert_parallel=)``,
the expert mesh of ``parallel.expert_parallel``, with global-batch
routing under any data group) and pipeline parallelism
(``PipelineParallelTrainer`` over ``parallel.pipeline_parallel``).
Kernels (``kernels/csrc``): LayerNorm forward and backward,
FlashAttention forward and backward (dQ, dK/dV), the fused multi-tensor
Adam, and the fused multi-tensor SGD without and with momentum.
"""

from distkeras_tpu_torch.data import loaders
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.streaming import (
    ShardWriter,
    StreamingDataset,
    open_shards,
    write_shards,
)
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
)
from distkeras_tpu_torch.evaluators import AccuracyEvaluator, LossEvaluator
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.layers import (
    Activation,
    AvgPool2D,
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
    MultiHeadSelfAttention,
    TransformerBlock,
)
from distkeras_tpu_torch.models.sequential import Residual, Sequential
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
from distkeras_tpu_torch.ops.optimizers import get_optimizer, get_schedule
from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam, FusedSGD
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
    RemoteParameterServerClient,
    SocketParameterServer,
)
from distkeras_tpu_torch.predictors import (
    BeamSearchGenerator,
    CachedSequenceGenerator,
    ModelPredictor,
    SequenceGenerator,
)
from distkeras_tpu_torch.serving.engine import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AveragingTrainer,
    DistributedTrainer,
    DynSGD,
    EnsembleTrainer,
    PipelineParallelTrainer,
    SequenceParallelTrainer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
)
from distkeras_tpu_torch.utils.checkpoint import Checkpointer
from distkeras_tpu_torch.utils.convert import (
    opt_state_from_jax,
    params_from_jax,
    state_from_jax,
)
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.utils.profiling import MetricsLogger
from distkeras_tpu_torch.workers import SingleTrainerWorker, WorkerCore

__all__ = [
    "ADAG",
    "ADAGParameterServer",
    "Activation",
    "AEASGD",
    "AccuracyEvaluator",
    "AveragingTrainer",
    "BatchNorm",
    "AvgPool2D",
    "BeamSearchGenerator",
    "CachedSequenceGenerator",
    "Checkpointer",
    "Conv2D",
    "Dataset",
    "DOWNPOUR",
    "DecodeStepper",
    "DeltaParameterServer",
    "Dense",
    "DenseTransformer",
    "DistributedTrainer",
    "Dropout",
    "DynSGD",
    "DynSGDParameterServer",
    "EAMSGD",
    "EnsembleTrainer",
    "Embedding",
    "FusedAdam",
    "Flatten",
    "FusedSGD",
    "GlobalAvgPool2D",
    "GlobalAvgPool1D",
    "LabelIndexTransformer",
    "LayerNorm",
    "LossEvaluator",
    "MaxPool2D",
    "MetricsLogger",
    "MinMaxTransformer",
    "ModelPredictor",
    "MultiHeadSelfAttention",
    "OneHotTransformer",
    "ParameterServer",
    "RemoteParameterServerClient",
    "ReshapeTransformer",
    "Residual",
    "SamplingParams",
    "Sequential",
    "SequenceGenerator",
    "PipelineParallelTrainer",
    "SequenceParallelTrainer",
    "ServingEngine",
    "ShardWriter",
    "SingleTrainer",
    "SingleTrainerWorker",
    "SocketParameterServer",
    "StandardScaleTransformer",
    "StreamingDataset",
    "SynchronousDistributedTrainer",
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
    "get_schedule",
    "loaders",
    "open_shards",
    "opt_state_from_jax",
    "params_from_jax",
    "state_from_jax",
    "write_shards",
    "zoo",
]
