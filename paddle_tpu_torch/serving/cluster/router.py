"""Prefix-affinity request router, the front end of the serving cluster
(counterpart of ``paddle_tpu/serving/cluster/router.py``; pure host-side
Python, kept here as its own copy).

The BlockManager's prefix sharing only pays off when requests with a
common prompt prefix land on the same replica: a prefix page cached on
replica 2 is invisible to replica 5.  The router maps the first
``affinity_tokens`` prompt tokens to a replica by **rendezvous hashing**
(highest random weight): every (prefix, replica) pair gets a stable score
(the first 8 bytes of ``sha1(key | index)``), the prefix's *affine
replica* is the top scorer, and when a replica leaves the routable set only
its prefixes move.  The same prompt, adapter and replica count pick the
same replica as the TPU package's router.

Health-aware fallback: replicas whose ``health_state()`` reads
``draining`` / ``stopped`` / ``error`` are not routable; a routable but
*saturated* affine replica (a queue of ``saturation_queue`` requests, or a
stalled scheduler) falls back to the least-loaded routable replica.

**Deepest-match placement:** with ``prefix_cache="radix"`` replicas, the
state snapshots carry each radix index's digest summary
(:func:`~..prefix_index.prefix_digest` of every resident page-boundary
prefix); the affinity policy routes to the unsaturated replica with the
deepest resident match, falling back to rendezvous when none matches.
``prefix_match=False`` restores pure rendezvous.

Control policies: ``random`` (seeded), ``round_robin`` and
``least_loaded``.  Every decision records the affine replica, so the
affinity hit rate is comparable across policies.  The router never
touches an engine: it reads state snapshots and returns a
:class:`RouteDecision`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import random

from ..prefix_index import prefix_digest

#: health states a replica may receive traffic in
ROUTABLE_STATES = ("healthy", "degraded")

POLICIES = ("affinity", "least_loaded", "random", "round_robin")


@dataclasses.dataclass
class RouteDecision:
    """One routing decision.  ``replica`` is the chosen index into the
    states list; ``affine`` the prefix's rendezvous winner over ALL
    replicas (dead or alive — it says where the prefix's pages would
    accumulate in a fully healthy pool); ``hit`` whether they coincide;
    ``reason`` the machine-readable branch taken."""

    replica: int
    affine: int
    hit: bool
    reason: str
    policy: str
    #: resident radix pages the chosen replica already holds for this
    #: prompt (0 outside deepest-match routing) — the placement win in
    #: pages, observable per decision
    prefix_pages: int = 0


def prefix_key(prompt_ids, affinity_tokens):
    """Canonical bytes for a prompt's routing prefix (its first
    ``affinity_tokens`` ids).  Prompts shorter than the window key on what
    they have — two prompts only share a key when one's window is a prefix
    the other matches exactly."""
    head = [int(t) for t in list(prompt_ids)[:max(int(affinity_tokens), 1)]]
    return (",".join(map(str, head))).encode()


def routing_key(prompt_ids, affinity_tokens, adapter=None):
    """The rendezvous key a request hashes on: **adapter affinity** when
    the request names a LoRA tenant (multi-tenant serving — same-tenant
    requests land together so the adapter is paged into ONE replica's
    pools instead of occupying a slot on all of them), else the prompt's
    prefix key (prefix-page affinity).  The two namespaces cannot
    collide: adapter keys carry a ``adapter|`` prefix no token spelling
    produces."""
    if adapter is not None:
        return b"adapter|" + str(adapter).encode()
    return prefix_key(prompt_ids, affinity_tokens)


class PrefixAffinityRouter:
    """See module docstring.

    ``saturation_queue``: a replica with this many queued requests no
    longer receives affine traffic (``None`` = its ``num_slots``, i.e. a
    full extra batch already waiting).  A replica whose health reasons
    include a stalled scheduler is treated as saturated regardless of
    queue depth — a wedged replica's queue may be short AND hopeless.
    """

    def __init__(self, n_replicas, affinity_tokens=16, policy="affinity",
                 saturation_queue=None, seed=0, prefix_match=True):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.n_replicas = int(n_replicas)
        self.affinity_tokens = int(affinity_tokens)
        self.policy = policy
        self.saturation_queue = None if saturation_queue is None \
            else int(saturation_queue)
        self.prefix_match = bool(prefix_match)
        self._rng = random.Random(seed)
        self._rr = itertools.count()

    def resize(self, n_replicas):
        """Retarget the router at ``n_replicas`` (elastic pools — the
        autoscaler grew or shrank membership).  Rendezvous hashing is
        stateless over the index range, so this is exactly the stability
        property the scheme exists for: when the pool shrinks only the
        removed index's prefixes move; when it grows only the prefixes
        the new index wins migrate to it."""
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = n_replicas

    # ------------------------------------------------------------- hashing
    def _score(self, key, idx):
        h = hashlib.sha1(key + b"|" + str(idx).encode()).digest()
        return int.from_bytes(h[:8], "big")

    def _affine_for_key(self, key):
        return max(range(self.n_replicas),
                   key=lambda i: self._score(key, i))

    def affine_index(self, prompt_ids, adapter=None):
        """The request's rendezvous winner over ALL replica indices
        (adapter affinity when ``adapter`` names a tenant)."""
        return self._affine_for_key(
            routing_key(prompt_ids, self.affinity_tokens, adapter))

    # -------------------------------------------------------------- policy
    @staticmethod
    def _load(st):
        return st.get("queue_depth", 0) + st.get("active", 0)

    def _saturated(self, st):
        if st.get("stalled"):
            return True
        cap = self.saturation_queue if self.saturation_queue is not None \
            else max(1, int(st.get("num_slots", 1)))
        return st.get("queue_depth", 0) >= cap

    def _match_depth(self, prompt_ids, st):
        """Resident radix pages this replica already holds for the
        prompt: walk the prompt's page-boundary digests against the
        replica's exported summary until the first miss (a resident run
        exports every boundary along its path, so matches are contiguous
        from the root).  0 without a summary — non-radix replicas never
        attract deepest-match traffic."""
        summ = st.get("prefix_index") or {}
        digests = summ.get("digests")
        ps = int(summ.get("page_size") or 0)
        if not digests or ps < 1:
            return 0
        dig = set(digests)
        toks = [int(t) for t in list(prompt_ids)]
        depth = 0
        for k in range(1, len(toks) // ps + 1):
            if prefix_digest(toks[:k * ps]) not in dig:
                break
            depth = k
        return depth

    def _least_loaded(self, key, candidates, states):
        # rendezvous score as the tie-break so equal-load choices are
        # stable per prefix instead of always index 0
        return min(candidates,
                   key=lambda i: (self._load(states[i]),
                                  -self._score(key, i)))

    def route(self, prompt_ids, states, adapter=None):
        """Pick a replica for this prompt given live state snapshots
        (dicts with ``state``/``stalled``/``queue_depth``/``active``/
        ``num_slots``).  ``adapter`` switches the rendezvous key to the
        tenant's (see :func:`routing_key`).  Returns ``None`` when no
        replica is routable — the caller sheds the request."""
        if len(states) != self.n_replicas:
            raise ValueError(f"router built for {self.n_replicas} replicas, "
                             f"got {len(states)} states")
        key = routing_key(prompt_ids, self.affinity_tokens, adapter)
        affine = self._affine_for_key(key)
        routable = [i for i, st in enumerate(states)
                    if st.get("state") in ROUTABLE_STATES]
        if not routable:
            return None
        pages = 0
        if self.policy == "random":
            chosen = self._rng.choice(routable)
            reason = "random"
        elif self.policy == "round_robin":
            chosen = routable[next(self._rr) % len(routable)]
            reason = "round_robin"
        elif self.policy == "least_loaded":
            chosen = self._least_loaded(key, routable, states)
            reason = "least_loaded"
        else:
            # affinity: deepest resident radix match first (adapter
            # affinity keeps tenant keys on the rendezvous path — the
            # LoRA pools, not the KV pages, are the scarce resource
            # there), then the rendezvous winner, then fallback
            chosen = None
            if self.prefix_match and adapter is None:
                unsat = [i for i in routable
                         if not self._saturated(states[i])]
                depths = {i: self._match_depth(prompt_ids, states[i])
                          for i in unsat}
                best = max(depths.values(), default=0)
                if best > 0:
                    chosen = max(
                        (i for i in unsat if depths[i] == best),
                        key=lambda i: self._score(key, i))
                    reason, pages = "prefix_match", best
            if chosen is None:
                if affine in routable \
                        and not self._saturated(states[affine]):
                    chosen, reason = affine, "affinity"
                else:
                    # affine replica down or saturated: least-loaded
                    # fallback, preferring unsaturated replicas so a
                    # wedged replica's queue doesn't keep accreting
                    unsat = [i for i in routable
                             if not self._saturated(states[i])]
                    chosen = self._least_loaded(key, unsat or routable,
                                                states)
                    reason = "fallback_unroutable" \
                        if affine not in routable else "fallback_saturated"
        return RouteDecision(replica=chosen, affine=affine,
                             hit=chosen == affine, reason=reason,
                             policy=self.policy, prefix_pages=pages)
