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
(``PipelineParallelTrainer`` over ``parallel.pipeline_parallel``), with
the 3-D pipeline x data x tensor composition on a ``parallel.mesh.
Grid3D``; and the examples' bootstrap (``parallel.backend``), which
raises without a card instead of falling back to the CPU. Every JAX
package ``__init__``'s names are exported from the same path here, but
JAX's built ``Model`` handle (``Sequential.build`` returns the module).
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
    Transformer,
)
from distkeras_tpu_torch.evaluators import (
    AccuracyEvaluator,
    LossEvaluator,
    PerplexityEvaluator,
    RSquaredEvaluator,
)
from distkeras_tpu_torch.faults import FaultPlan, InjectedFault
from distkeras_tpu_torch.job_deployment import Job
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
from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    SloSpec,
    TraceContext,
)
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
    CommitNotAcknowledgedError,
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServer,
    ParameterServerError,
    RemoteParameterServerClient,
    SocketParameterServer,
    StandbyError,
)
from distkeras_tpu_torch.predictors import (
    BeamSearchGenerator,
    CachedSequenceGenerator,
    ModelPredictor,
    SequenceGenerator,
    SpeculativeGenerator,
)
from distkeras_tpu_torch.serving import ServingClient, ServingServer
from distkeras_tpu_torch.serving.engine import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
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
    "AccuracyEvaluator",
    "Activation",
    "ADAG",
    "ADAGParameterServer",
    "AEASGD",
    "AsynchronousDistributedTrainer",
    "attach_flash_attention",
    "attach_fused_layernorm",
    "AveragingTrainer",
    "AvgPool2D",
    "BatchNorm",
    "BeamSearchGenerator",
    "CachedSequenceGenerator",
    "Checkpointer",
    "CommitNotAcknowledgedError",
    "Conv2D",
    "Dataset",
    "DecodeStepper",
    "DeltaParameterServer",
    "Dense",
    "DenseTransformer",
    "DistributedTrainer",
    "DOWNPOUR",
    "Dropout",
    "DynSGD",
    "DynSGDParameterServer",
    "EAMSGD",
    "Embedding",
    "EnsembleTrainer",
    "FaultPlan",
    "flash_attention",
    "Flatten",
    "FlightRecorder",
    "fused_layer_norm",
    "FusedAdam",
    "FusedSGD",
    "get_loss",
    "get_metric",
    "get_optimizer",
    "get_schedule",
    "GlobalAvgPool1D",
    "GlobalAvgPool2D",
    "InjectedFault",
    "Job",
    "LabelIndexTransformer",
    "LayerNorm",
    "loaders",
    "LossEvaluator",
    "MaxPool2D",
    "MetricsLogger",
    "MetricsRegistry",
    "MinMaxTransformer",
    "ModelPredictor",
    "MultiHeadSelfAttention",
    "OneHotTransformer",
    "open_shards",
    "opt_state_from_jax",
    "ParameterServer",
    "ParameterServerError",
    "params_from_jax",
    "PerplexityEvaluator",
    "PipelineParallelTrainer",
    "RemoteParameterServerClient",
    "ReshapeTransformer",
    "Residual",
    "RetryPolicy",
    "RSquaredEvaluator",
    "SamplingParams",
    "SequenceGenerator",
    "SequenceParallelTrainer",
    "Sequential",
    "ServingClient",
    "ServingEngine",
    "ServingServer",
    "ShardWriter",
    "SingleTrainer",
    "SingleTrainerWorker",
    "SloSpec",
    "SocketParameterServer",
    "SpeculativeGenerator",
    "StandardScaleTransformer",
    "StandbyError",
    "state_from_jax",
    "StreamingDataset",
    "SynchronousDistributedTrainer",
    "TraceContext",
    "Trainer",
    "TrainingHistory",
    "Transformer",
    "TransformerBlock",
    "WorkerCore",
    "write_shards",
    "zoo",
]
