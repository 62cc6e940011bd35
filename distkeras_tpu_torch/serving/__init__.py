"""Online serving (PyTorch port of ``distkeras_tpu.serving``): continuous
batching over the decode path, scheduler -> engine -> server, plus the
client.

- ``scheduler``: host-side request scheduling (continuous batching,
  windowed batching for batch scoring, backpressure, deadlines, drain,
  streaming chunk FIFOs) and the typed serving errors.
- ``engine``: the device face (``DecodeStepper``) and ``ServingEngine``,
  with its metrics registry, recorder, history, SLOs and trace ring;
  ``ServingEngine.from_bundle`` boots from a quantized serving bundle.
- ``sampling``: per-request ``SamplingParams`` and the counter-based RNG.
- ``server``/``client``: the length-prefixed TCP wire carrying DKT1
  frames — ``ServingServer``/``serve`` and ``ServingClient``/
  ``TokenStream`` (streaming generate), byte-compatible with the JAX
  package's.
- ``resilience``: the client's ``RetryBudget`` and hedge-delay
  ``LatencyTracker``.
"""

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
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.serving.engine import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.resilience import (
    LatencyTracker,
    RetryBudget,
)
from distkeras_tpu_torch.serving.server import ServingServer, serve
from distkeras_tpu_torch.serving.client import ServingClient, TokenStream

__all__ = [
    "ContinuousBatcher",
    "DeadlineExceededError",
    "DecodeStepper",
    "EngineStoppedError",
    "InternalError",
    "LatencyTracker",
    "OverloadedError",
    "PeerError",
    "PoolExhaustedError",
    "QuotaExhaustedError",
    "RetryBudget",
    "SamplingParams",
    "ServeRequest",
    "ServingClient",
    "ServingEngine",
    "ServingError",
    "ServingServer",
    "ShedError",
    "StaleEpochError",
    "TokenStream",
    "WindowedBatcher",
    "WrongRoleError",
    "serve",
]
