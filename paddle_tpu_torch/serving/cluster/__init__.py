"""paddle_tpu_torch.serving.cluster — multi-replica serving behind a
prefix-affinity router (counterpart of ``paddle_tpu/serving/cluster``).

- :mod:`.pool` — :class:`ReplicaPool`: N :class:`~..engine.ServingEngine`
  replicas over one shared model, each with its own scheduler,
  BlockManager, page pools and ``replica=`` label, placed on the card by
  default, round-robin over ``devices=``.
- :mod:`.router` — :class:`PrefixAffinityRouter`: rendezvous hashing of
  prompt prefixes (or LoRA adapter names) to replicas, health-aware, with
  a least-loaded fallback and random / round-robin / least-loaded control
  policies.
- :mod:`.service` — :class:`ServingCluster`: submit / generate / stream
  across the pool, cross-replica requeue of in-flight requests when a
  replica is lost (greedy ids equal an uninterrupted run's), the
  ``/statusz`` section, the ``/healthz`` component, ``cluster.*`` series
  and the :class:`~..qos.AutoScaler` wiring.
"""

from .pool import ReplicaPool  # noqa: F401
from .router import (  # noqa: F401
    POLICIES, ROUTABLE_STATES, PrefixAffinityRouter, RouteDecision,
    prefix_key, routing_key,
)
from .service import ClusterHandle, ServingCluster  # noqa: F401

__all__ = [
    "ReplicaPool", "PrefixAffinityRouter", "RouteDecision", "prefix_key",
    "routing_key", "POLICIES", "ROUTABLE_STATES", "ServingCluster",
    "ClusterHandle",
]
