"""paddle_tpu_torch.serving — continuous-batching LLM serving over the
paged KV cache (counterpart of ``paddle_tpu/serving``).

- :mod:`.engine` — :class:`ServingEngine`: iteration-level scheduler over a
  fixed-shape decode batch, per-slot positions, in-place page pools; the
  restart / requeue, load shedding, health and numeric-guard paths.
- :mod:`.block_manager` — :class:`BlockManager`: paged KV block allocation,
  capacity-based admission, exact-key or radix prefix sharing.
- :mod:`.prefix_index` — :class:`RadixPrefixIndex`, the radix mode's
  longest-shared-run index; :mod:`.kv_spill` — :class:`KVSpillTier`, its
  host-memory tier.
- :mod:`.qos` — QoS tiers: :class:`QoSConfig`, :class:`TierPolicy`,
  :class:`TieredQueue` and the brownout ladder.
- :mod:`.adapter` — :class:`GPTAdapter`: the prefill / step calls.
- :mod:`.api` — :class:`ContinuousBatchingPredictor`, the
  ``paddle.inference``-shaped facade.
- :mod:`.speculative` — :class:`NgramDrafter` and the verifier of
  ``ServingEngine(speculative_k=...)``.
- :mod:`.quant` — int8 serving: ``ServingEngine(kv_dtype="int8",
  weight_dtype="int8")``'s adapter, weight conversion and the calibration
  harness.

The engine's ``serving.*`` metric families, spans, telemetry providers,
memory ledger rows and numerics stream come from
:mod:`paddle_tpu_torch.observability` and :mod:`paddle_tpu_torch.profiler`.
"""

from ..observability.slo import SLOPolicy  # noqa: F401
from ..resilience.retry import EngineStoppedError, NumericFault  # noqa: F401
from .adapter import GPTAdapter  # noqa: F401
from .api import ContinuousBatchingPredictor  # noqa: F401
from .block_manager import BlockManager, PageAllocation  # noqa: F401
from .engine import (RequestHandle, RequestRejectedError,  # noqa: F401
                     SamplingParams, ServingEngine)
from .kv_spill import KVSpillTier  # noqa: F401
from .prefix_index import RadixPrefixIndex  # noqa: F401
from .qos import QoSConfig, TieredQueue, TierPolicy, brownout  # noqa: F401
from .speculative import NgramDrafter  # noqa: F401
