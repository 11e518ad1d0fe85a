"""Host-memory KV spill tier — the middle rung of the hierarchical cache
(counterpart of ``paddle_tpu/serving/kv_spill.py``).  Its counts are the
``serving.kv_spill_*`` series (``replica=`` label) and, for
:meth:`KVSpillTier.stats`, plain attributes.

Device pages -> host spill -> recompute: when the radix prefix index
(:mod:`.prefix_index`) evicts an idle page to refill the free list, the
BlockManager hands ``(prefix_key, page)`` here FIRST, and the tier copies
the page's bytes out of every pool — payload AND scale pools for int8
serving, since the snapshot walks the whole pool tuple — into host
memory.  A later allocate whose radix match ends where a spilled prefix
begins RESURRECTS it: the engine copies the host bytes into a freshly
popped device page (in place, one copy per pool) and the page rejoins the
resident tree as cached K/V, so the prompt tokens it covers skip prefill
like a device hit, at one host-to-device copy instead of a forward pass.

Budgeted and LRU within the tier: ``budget_bytes`` (256 MiB unless
given) caps the host bytes; the least recently spilled entries drop when
a new spill would overflow.

The engine clears the tier in ``_recover``: a rebuilt BlockManager starts
with an empty radix tree, and a coherent cold start is worth more than a
warm one that needs cross-checking.
"""

from __future__ import annotations

import collections
import threading

_DEFAULT_BUDGET = 256 << 20  # 256 MiB of host memory unless told otherwise


class KVSpillTier:
    """Content-addressed host cache of evicted KV pages.

    The tier is transport-agnostic: the engine attaches ``snapshot(page)
    -> tuple[torch.Tensor]`` (device to host, one copy per pool) and
    ``restore(page, payload)`` (host to device) callables, so one tier
    serves every pool layout — (kp, vp) native or (kp, vp, ks, vs) int8,
    where walking the tuple keeps payload+scale pairs together by
    construction."""

    def __init__(self, replica="0", budget_bytes=None):
        self.replica = str(replica)
        self.budget_bytes = _DEFAULT_BUDGET if budget_bytes is None \
            else int(budget_bytes)
        self._entries = collections.OrderedDict()  # key -> tuple of host tensors
        self._nbytes = 0
        self._snapshot = None
        self._restore = None
        self._lock = threading.Lock()
        self._spills = 0
        self._resurrections = 0
        self._drops = 0
        from ..profiler import metrics as _metrics

        self._m_spills = _metrics.bind(_metrics.counter(
            "serving.kv_spill_pages",
            "idle KV pages spilled to the host tier instead of dropped"),
            replica=self.replica)
        self._m_resurrections = _metrics.bind(_metrics.counter(
            "serving.kv_spill_resurrections",
            "spilled pages re-paged into device slots on a prefix hit"),
            replica=self.replica)
        self._m_drops = _metrics.bind(_metrics.counter(
            "serving.kv_spill_drops",
            "spilled pages dropped LRU to stay inside the host budget"),
            replica=self.replica)
        self._m_bytes = _metrics.bind(_metrics.gauge(
            "serving.kv_spill_bytes",
            "host DRAM bytes resident in the KV spill tier"),
            replica=self.replica)

    def attach(self, snapshot, restore):
        self._snapshot = snapshot
        self._restore = restore

    # ------------------------------------------------------------- inventory
    def nbytes(self):
        """Resident host bytes."""
        return self._nbytes

    def __len__(self):
        return len(self._entries)

    def contains(self, key):
        return key in self._entries

    def stats(self):
        return {
            "entries": len(self._entries),
            "bytes": self._nbytes,
            "budget_bytes": self.budget_bytes,
            "spills": self._spills,
            "resurrections": self._resurrections,
            "drops": self._drops,
        }

    # -------------------------------------------------------------- transfer
    def spill(self, key, page):
        """Copy ``page``'s bytes host-side under ``key`` (the full token
        prefix the page encodes).  Called by the BlockManager at evict
        time, BEFORE the device row is handed back for reuse.  Returns
        False when unattached or the page alone exceeds the budget."""
        if self._snapshot is None:
            return False
        payload = tuple(self._snapshot(page))
        nb = sum(int(a.nbytes) for a in payload)
        with self._lock:
            if nb > self.budget_bytes:
                self._m_drops.inc()
                self._drops += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._nbytes -= sum(int(a.nbytes) for a in old)
            while self._entries and self._nbytes + nb > self.budget_bytes:
                _, dropped = self._entries.popitem(last=False)
                self._nbytes -= sum(int(a.nbytes) for a in dropped)
                self._m_drops.inc()
                self._drops += 1
            self._entries[key] = payload
            self._nbytes += nb
            self._m_spills.inc()
            self._spills += 1
            self._m_bytes.set(self._nbytes)
        return True

    def resurrect(self, key, page):
        """Re-page a spilled entry into device slot ``page`` and drop the
        host copy (the page can spill again later).  Returns False when
        the key is absent — the caller falls back to fresh allocation
        plus prefill compute, the bottom rung of the hierarchy."""
        with self._lock:
            payload = self._entries.pop(key, None)
            if payload is None:
                return False
            self._nbytes -= sum(int(a.nbytes) for a in payload)
            self._m_resurrections.inc()
            self._resurrections += 1
            self._m_bytes.set(self._nbytes)
        self._restore(page, payload)
        return True

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._nbytes = 0
            self._m_bytes.set(0)
