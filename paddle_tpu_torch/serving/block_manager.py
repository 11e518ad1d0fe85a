"""Paged KV block manager — the allocator side of the serving engine
(counterpart of ``paddle_tpu/serving/block_manager.py``, its exact-key
mode; the radix prefix index and the host spill tier wait for a later
slice).

The engine owns per-layer GLOBAL page pools ``[L, P, page_size, h, d]``;
this module owns which of the ``P`` rows belong to which live sequence.
Host-side Python only: the device sees the ``[B, NP]`` page table the
engine builds from these allocations.

Capacity-based admission: :meth:`BlockManager.allocate` returns ``None``
when the pool cannot cover a sequence's worst case (prompt +
max_new_tokens), and the engine keeps the request queued.

Prefix sharing (``prefix_sharing=True``): a page FULLY covered by a prompt
is keyed by the token prefix it encodes (K/V at position p is a function
of tokens 0..p and the weights), so live sequences with equal prompt
prefixes share those pages, refcounted.  Decode never writes them (a
sequence's first generated token lands at ``len(prompt)``, past every
fully covered page).  When the last holder leaves, a shared page parks in
an idle cache, resurrected by the next equal prefix or evicted LRU when
the free list runs dry.  Sharing saves memory, not compute: prefill still
runs for every sequence.
"""

from __future__ import annotations

import collections
import threading


class PageAllocation:
    """One live sequence's pages, in sequence order.  The first
    ``len(shared_keys)`` entries are refcounted prefix pages; the rest are
    private and return to the free list on :meth:`BlockManager.free`."""

    __slots__ = ("pages", "shared_keys")

    def __init__(self, pages, shared_keys=()):
        self.pages = list(pages)
        self.shared_keys = tuple(shared_keys)

    @property
    def num_shared(self):
        return len(self.shared_keys)

    def __len__(self):
        return len(self.pages)


class BlockManager:
    def __init__(self, num_pages, page_size, prefix_sharing=False,
                 bytes_per_page=None, pool_dtype=None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_sharing = bool(prefix_sharing)
        # device accounting: what one page costs across all layers, K and
        # V, scale pools included, and what the pool rows are made of —
        # the engine fills these in so capacity math talks in bytes
        self.bytes_per_page = int(bytes_per_page) \
            if bytes_per_page is not None else None
        self.pool_dtype = str(pool_dtype) if pool_dtype is not None else None
        self._free = collections.deque(range(self.num_pages))
        self._active = {}                       # prefix key -> [page, refs]
        self._idle = collections.OrderedDict()  # prefix key -> page (refs 0)
        # allocate/free are serialized by the engine's scheduler thread,
        # but the allocator stays correct for any caller
        self._mut = threading.Lock()
        self.hits = 0           # sharable pages reused (active or idle)
        self.misses = 0         # sharable pages allocated fresh
        self.evictions = 0      # idle prefix pages reclaimed, LRU

    # ------------------------------------------------------------ accounting
    def pages_for(self, num_tokens):
        return -(-int(num_tokens) // self.page_size)

    @property
    def free_pages(self):
        """Pages obtainable right now (free list + evictable idle cache)."""
        return len(self._free) + len(self._idle)

    @property
    def used_pages(self):
        return self.num_pages - self.free_pages

    def utilization(self):
        return self.used_pages / self.num_pages

    def stats(self):
        """Allocator snapshot, in bytes too when the engine supplied
        ``bytes_per_page`` (an int8 pool's page costs about half a bf16
        one: the resident-sequence win)."""
        st = {"num_pages": self.num_pages, "page_size": self.page_size,
              "used_pages": self.used_pages, "free_pages": self.free_pages,
              "utilization": self.utilization(),
              "prefix_sharing": self.prefix_sharing,
              "bytes_per_page": self.bytes_per_page,
              "pool_dtype": self.pool_dtype}
        if self.bytes_per_page is not None:
            st["pool_bytes"] = self.num_pages * self.bytes_per_page
            st["used_bytes"] = self.used_pages * self.bytes_per_page
            st["kv_bytes_per_token"] = self.bytes_per_page / self.page_size
        if self.prefix_sharing:
            st["prefix_cache"] = {"hits": self.hits, "misses": self.misses,
                                  "evictions": self.evictions}
        return st

    def max_resident_sequences(self, tokens_per_seq, budget_bytes=None):
        """How many sequences of ``tokens_per_seq`` worst case fit — in this
        pool, or in a pool of ``budget_bytes`` device memory at this
        manager's ``bytes_per_page``."""
        per_seq = self.pages_for(tokens_per_seq)
        pages = self.num_pages
        if budget_bytes is not None:
            if self.bytes_per_page is None:
                raise ValueError("budget_bytes needs bytes_per_page")
            pages = int(budget_bytes) // self.bytes_per_page
        return pages // per_seq

    # ------------------------------------------------------------ allocation
    def _pop_free(self):
        if self._free:
            return self._free.popleft()
        # free list dry: evict the least-recently-idled shared prefix page
        _, page = self._idle.popitem(last=False)
        self.evictions += 1
        return page

    def _prefix_hits(self, prompt_ids, n_sharable):
        """Longest run of already-resident prefix pages.  A miss at page i
        implies misses after it: whoever registered a longer prefix also
        registered every shorter one."""
        hits = []
        for i in range(n_sharable):
            key = tuple(prompt_ids[:(i + 1) * self.page_size])
            if key in self._active or key in self._idle:
                hits.append(key)
            else:
                break
        return hits

    def can_allocate(self, prompt_ids, num_tokens):
        with self._mut:
            return self._plan(prompt_ids, num_tokens) is not None

    def _plan(self, prompt_ids, num_tokens):
        need = self.pages_for(num_tokens)
        n_sharable = 0
        if self.prefix_sharing:
            # pages fully covered by the prompt; decode's first write goes
            # to position len(prompt), past all of them
            n_sharable = min(len(prompt_ids) // self.page_size, need)
        hits = self._prefix_hits(prompt_ids, n_sharable) if n_sharable else []
        fresh = need - len(hits)
        idle_hits = sum(1 for k in hits if k in self._idle)
        if fresh > len(self._free) + (len(self._idle) - idle_hits):
            return None
        return need, n_sharable, hits

    def allocate(self, prompt_ids, num_tokens):
        """Reserve pages covering ``num_tokens`` (the prompt AND every token
        the sequence may generate) for a sequence with this prompt;
        ``None`` when the pool can't cover it."""
        prompt_ids = [int(t) for t in prompt_ids]
        if num_tokens < len(prompt_ids):
            raise ValueError("num_tokens must cover the prompt")
        with self._mut:
            plan = self._plan(prompt_ids, num_tokens)
            if plan is None:
                return None
            return self._allocate_legacy(prompt_ids, plan)

    def _allocate_legacy(self, prompt_ids, plan):
        need, n_sharable, hits = plan
        pages, keys = [], []
        self.hits += len(hits)
        for key in hits:
            ent = self._active.get(key)
            if ent is not None:
                ent[1] += 1
            else:
                ent = self._active[key] = [self._idle.pop(key), 1]
            pages.append(ent[0])
            keys.append(key)
        for i in range(len(hits), need):
            key = tuple(prompt_ids[:(i + 1) * self.page_size]) \
                if i < n_sharable else None
            # idle keys are not prefix-closed (LRU eviction drops them
            # independently), so a key past the first miss can still sit
            # idle: claim it here, or free() would later overwrite the
            # idle entry and orphan its page
            if key is not None and key in self._idle:
                page = self._idle.pop(key)
                self.hits += 1
            else:
                page = self._pop_free()
                if key is not None:
                    self.misses += 1
            pages.append(page)
            if key is not None:     # new sharable prefix page: register it
                self._active[key] = [page, 1]
                keys.append(key)
        return PageAllocation(pages, keys)

    def free(self, alloc: PageAllocation):
        """Release a retired sequence's pages: private pages return to the
        free list; shared prefix pages decref and park in the idle cache
        when the last holder leaves."""
        with self._mut:
            for key in alloc.shared_keys:
                ent = self._active[key]
                ent[1] -= 1
                if ent[1] == 0:
                    del self._active[key]
                    self._idle[key] = ent[0]
            for page in alloc.pages[alloc.num_shared:]:
                self._free.append(page)
            alloc.pages = []
            alloc.shared_keys = ()
