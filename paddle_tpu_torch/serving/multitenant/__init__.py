"""paddle_tpu_torch.serving.multitenant — many tenants, ONE engine
(counterpart of ``paddle_tpu/serving/multitenant``).

- :mod:`.lora` — paged multi-LoRA: :class:`LoRAStore` (rank-bucketed
  global adapter pools, BlockManager-pattern slot allocation with
  refcounts + idle LRU), :class:`LoRAAdapter` definitions, and the
  LoRA-aware engine adapters.
- :mod:`.grammar` — constrained decoding: regex / JSON-schema ->
  character DFA -> token FSM (:class:`CompiledGrammar`), applied as
  per-row logit masks in the batched sampler and the speculative
  verifier.
- :mod:`.engine` — :class:`MultiTenantEngine`: the ServingEngine
  subclass batching LoRA tenants, schema-constrained rows and
  embed / score requests in one scheduler.
"""

from .engine import MultiTenantEngine  # noqa: F401
from .grammar import (  # noqa: F401
    CompiledGrammar, compile_json_schema, compile_regex,
    json_schema_to_regex,
)
from .lora import (  # noqa: F401
    LoRAAdapter, LoRAGPTAdapter, LoRAQuantizedGPTAdapter, LoRAStore,
    TenantLease,
)

__all__ = [
    "MultiTenantEngine", "LoRAStore", "LoRAAdapter", "TenantLease",
    "LoRAGPTAdapter", "LoRAQuantizedGPTAdapter", "CompiledGrammar",
    "compile_regex", "compile_json_schema", "json_schema_to_regex",
]
