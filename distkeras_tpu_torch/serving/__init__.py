"""Online serving (PyTorch port of ``distkeras_tpu.serving``): continuous
batching over the decode path, scheduler -> engine -> server, plus the
client.

- ``scheduler``: host-side request scheduling (continuous batching,
  windowed batching for batch scoring, backpressure, deadlines, drain,
  streaming chunk FIFOs) and the typed serving errors.
- ``engine``: the device face (``DecodeStepper``: a dense bank or, with
  ``paged=True``, block-paged K/V pools; with ``speculative=``, the
  draft -> verify -> rollback loop over ``NgramDrafter`` or
  ``ModelDrafter``) and ``ServingEngine``, with its
  metrics registry, recorder, history, SLOs and trace ring;
  ``ServingEngine.from_bundle`` boots from a quantized serving bundle.
- ``paging``: ``PageAllocator``, the host half of the paged KV cache
  (free list, refcounts, the null sentinel page, typed exhaustion).
- ``prefix_cache``: the host ``PrefixStore`` (exact-prefix pow2 ladder,
  two-touch admission, byte-bounded LRU, the fleet digest) and the paged
  tier's ``DevicePrefixIndex`` (page-aligned prefixes shared by
  reference, reclaimed under pool pressure). ``ServingEngine`` builds a
  store by default (``prefix_cache=True``).
- ``sampling``: per-request ``SamplingParams`` (``n > 1``: completion
  groups over copy-on-write forks; ``grammar``: constrained decoding),
  the counter-based RNG, the speculative window samplers and the grammar
  ``TokenMaskCompiler``.
- ``qos``: ``QosPolicy`` (priority classes, per-tenant weighted fair
  queuing, preemption by KV swap) and the ``TokenBucket`` admission
  quota.
- ``server``/``client``: the length-prefixed TCP wire carrying DKT1
  frames — ``ServingServer``/``serve`` and ``ServingClient``/
  ``TokenStream`` (streaming generate), byte-compatible with the JAX
  package's.
- ``kv_transfer``: the versioned byte codec of a slot's host state (the
  DKTX frame a prefill worker hands to a decode worker, byte-identical to
  the JAX package's) and ``PeerFabric``, the pooled worker-to-worker
  client spine of ``kv.fetch`` pulls and direct pushes.
- ``resilience``: the client's ``RetryBudget`` and hedge-delay
  ``LatencyTracker``, the router's ``CircuitBreaker`` and the engine
  door's ``AdmissionController`` (``ServingEngine(shed=)``).

Robustness (see also ``distkeras_tpu_torch/faults.py``): the scheduler
assigns BLAME for device-step failures (a masked retry, then bisection) so
a poison request fails alone with ``InternalError`` and its slot is
quarantined for ``quarantine_steps`` iterations while every other stream
decodes on token-identical; a supervisor watchdog restarts a dead or
wedged scheduler thread (in-flight work failed typed, stepper rebuilt and
warmed) under ``max_restarts`` with ``networking.RetryPolicy``'s backoff
(``restart_backoff``). ``overlap=True`` runs the overlapped loop; the
engine's ``OverlapLedger`` and ``CompileLedger`` (``obs``, re-exported
here) measure its bubble and its program mints.
"""

from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.obs import CompileLedger, OverlapLedger
from distkeras_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    DeadlineExceededError,
    EngineStoppedError,
    InternalError,
    OverloadedError,
    PeerError,
    PoolExhaustedError,
    QuotaExhaustedError,
    ServeRequest,
    ServingError,
    ShedError,
    StaleEpochError,
    WindowedBatcher,
    WrongRoleError,
)
from distkeras_tpu_torch.serving.sampling import (
    SamplingParams,
    TokenMaskCompiler,
)
from distkeras_tpu_torch.serving.paging import PageAllocator
from distkeras_tpu_torch.serving.qos import QosPolicy, TokenBucket
from distkeras_tpu_torch.serving.prefix_cache import (
    DevicePrefixIndex,
    PrefixStore,
)
from distkeras_tpu_torch.serving.engine import (
    DecodeStepper,
    ModelDrafter,
    NgramDrafter,
    ServingEngine,
)
from distkeras_tpu_torch.serving.kv_transfer import (
    KvTransferError,
    PeerFabric,
    decode_state,
    encode_state,
)
from distkeras_tpu_torch.serving.resilience import (
    AdmissionController,
    CircuitBreaker,
    LatencyTracker,
    RetryBudget,
)
from distkeras_tpu_torch.serving.server import ServingServer, serve
from distkeras_tpu_torch.serving.client import ServingClient, TokenStream

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "CompileLedger",
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DecodeStepper",
    "DevicePrefixIndex",
    "EngineStoppedError",
    "InternalError",
    "KvTransferError",
    "LatencyTracker",
    "ModelDrafter",
    "NgramDrafter",
    "OverlapLedger",
    "OverloadedError",
    "PageAllocator",
    "PeerError",
    "PeerFabric",
    "PoolExhaustedError",
    "PrefixStore",
    "QosPolicy",
    "QuotaExhaustedError",
    "RetryBudget",
    "RetryPolicy",
    "SamplingParams",
    "ServeRequest",
    "ServingClient",
    "ServingEngine",
    "ServingError",
    "ServingServer",
    "ShedError",
    "StaleEpochError",
    "TokenBucket",
    "TokenMaskCompiler",
    "TokenStream",
    "WindowedBatcher",
    "WrongRoleError",
    "decode_state",
    "encode_state",
    "serve",
]
