"""paddle_tpu_torch.serving — continuous-batching LLM serving over the
paged KV cache (counterpart of ``paddle_tpu/serving``; its core path).

- :mod:`.engine` — :class:`ServingEngine`: iteration-level scheduler over a
  fixed-shape decode batch, per-slot positions, in-place page pools.
- :mod:`.block_manager` — :class:`BlockManager`: paged KV block allocation,
  capacity-based admission, optional exact-key prefix sharing.
- :mod:`.adapter` — :class:`GPTAdapter`: the prefill / step calls.
- :mod:`.api` — :class:`ContinuousBatchingPredictor`, the
  ``paddle.inference``-shaped facade.
- :mod:`.speculative` — :class:`NgramDrafter` and the verifier of
  ``ServingEngine(speculative_k=...)``.
- :mod:`.quant` — int8 serving: ``ServingEngine(kv_dtype="int8",
  weight_dtype="int8")``'s adapter, weight conversion and the calibration
  harness.
"""

from ..resilience.retry import EngineStoppedError  # noqa: F401
from .adapter import GPTAdapter  # noqa: F401
from .api import ContinuousBatchingPredictor  # noqa: F401
from .block_manager import BlockManager, PageAllocation  # noqa: F401
from .engine import (RequestHandle, RequestRejectedError,  # noqa: F401
                     SamplingParams, ServingEngine)
from .speculative import NgramDrafter  # noqa: F401
