"""Paged KV block manager — the allocator side of the serving engine
(counterpart of ``paddle_tpu/serving/block_manager.py``).

The engine owns per-layer GLOBAL page pools ``[L, P, page_size, h, d]``;
this module owns which of the ``P`` rows belong to which live sequence.
Host-side Python only: the device sees the ``[B, NP]`` page table the
engine builds from these allocations.

Capacity-based admission: :meth:`BlockManager.allocate` returns ``None``
when the pool cannot cover a sequence's worst case (prompt +
max_new_tokens), and the engine keeps the request queued.

Prefix sharing (``prefix_sharing=True``, the engine's ``"lru"`` mode): a
page FULLY covered by a prompt is keyed by the token prefix it encodes
(K/V at position p is a function of tokens 0..p and the weights), so live
sequences with equal prompt prefixes share those pages, refcounted.
Decode never writes them (a sequence's first generated token lands at
``len(prompt)``, past every fully covered page).  When the last holder
leaves, a shared page parks in an idle cache, resurrected by the next
equal prefix or evicted LRU when the free list runs dry.  This mode saves
memory, not compute: prefill still runs for every sequence.

Hierarchical KV cache (``radix=True``): exact-key matching is replaced by
the page-granular radix tree of :mod:`.prefix_index` — ``allocate``
reuses the *longest shared page run* (a partial-prefix match bumps the
refcounts on the shared run; only the divergent tail gets fresh pages)
and reports how many leading pages already hold valid K/V
(``PageAllocation.cached_pages``), so the engine STARTS prefill at
``cached_pages * page_size`` tokens instead of recomputing the run.  With
a :class:`~.kv_spill.KVSpillTier` attached, idle pages evicted to refill
the free list spill their bytes to host memory first, and a later
allocate whose match ends where a spilled prefix begins resurrects them
into fresh device pages — still cached, one copy instead of a forward
pass.
"""

from __future__ import annotations

import collections
import threading


class PageAllocation:
    """One live sequence's pages, in sequence order.  The first
    ``len(shared_keys)`` entries are refcounted prefix pages; the rest are
    private and return to the free list on :meth:`BlockManager.free`.
    ``cached_pages`` counts the LEADING shared pages whose K/V was already
    valid at allocate time (radix hit or spill resurrection) — the prompt
    tokens they cover need no prefill; it is always 0 in exact-key mode,
    where sharing saves memory but not compute."""

    __slots__ = ("pages", "shared_keys", "cached_pages")

    def __init__(self, pages, shared_keys=(), cached_pages=0):
        self.pages = list(pages)
        self.shared_keys = tuple(shared_keys)
        self.cached_pages = int(cached_pages)

    @property
    def num_shared(self):
        return len(self.shared_keys)

    def __len__(self):
        return len(self.pages)


class BlockManager:
    def __init__(self, num_pages, page_size, prefix_sharing=False,
                 replica="0", bytes_per_page=None, pool_dtype=None,
                 radix=False, spill=None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.replica = str(replica)
        self.radix = bool(radix)
        self.prefix_sharing = bool(prefix_sharing) or self.radix
        # device accounting: what one page costs across all layers, K and
        # V, scale pools included, and what the pool rows are made of —
        # the engine fills these in so capacity math talks in bytes
        self.bytes_per_page = int(bytes_per_page) \
            if bytes_per_page is not None else None
        self.pool_dtype = str(pool_dtype) if pool_dtype is not None else None
        self._free = collections.deque(range(self.num_pages))
        self._active = {}                       # prefix key -> [page, refs]
        self._idle = collections.OrderedDict()  # prefix key -> page (refs 0)
        self._index = None
        self._spill = None
        if self.radix:
            from .prefix_index import RadixPrefixIndex

            self._index = RadixPrefixIndex(self.page_size)
            self._spill = spill  # KVSpillTier or None (radix mode only)
        elif spill is not None:
            raise ValueError("the KV spill tier needs radix=True (spilled "
                             "pages are resurrected through the radix "
                             "index's content addresses)")
        # allocate/free are serialized by the engine's scheduler thread,
        # but the allocator stays correct for any caller
        self._mut = threading.Lock()
        # hits = sharable pages whose key was resident (active refcount
        # bump, idle resurrection or host-tier re-page), misses = sharable
        # pages allocated fresh, evictions = idle prefix pages reclaimed
        # because the free list ran dry, saved_tokens = prompt tokens the
        # hit pages cover (a 100-page hit weighs 100x a 1-page hit).  The
        # serving.prefix_cache_* series carry replica= (the engine's id),
        # so N engines in one process stay distinct; the attributes stay
        # for stats()
        from ..profiler import metrics as _metrics

        self._m_hits = _metrics.bind(_metrics.counter(
            "serving.prefix_cache_hits",
            "prefix-sharing pages reused from the active/idle cache"),
            replica=self.replica)
        self._m_misses = _metrics.bind(_metrics.counter(
            "serving.prefix_cache_misses",
            "sharable prefix pages that had to be allocated fresh"),
            replica=self.replica)
        self._m_evictions = _metrics.bind(_metrics.counter(
            "serving.prefix_cache_evictions",
            "idle prefix pages evicted LRU to refill the free list"),
            replica=self.replica)
        self._m_saved = _metrics.bind(_metrics.counter(
            "serving.prefix_cache_saved_tokens",
            "prompt tokens covered by prefix-cache page hits "
            "(hit pages x page_size)"),
            replica=self.replica)
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._saved_tokens = 0
        self._resurrections = 0

    # ------------------------------------------------------------ accounting
    def pages_for(self, num_tokens):
        return -(-int(num_tokens) // self.page_size)

    @property
    def _idle_count(self):
        return self._index.idle_pages if self.radix else len(self._idle)

    @property
    def free_pages(self):
        """Pages obtainable right now (free list + evictable idle cache)."""
        return len(self._free) + self._idle_count

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
            pc = {"hits": self._hits, "misses": self._misses,
                  "evictions": self._evictions,
                  "saved_tokens": self._saved_tokens,
                  "mode": "radix" if self.radix else "lru"}
            if self.radix:
                pc["resurrections"] = self._resurrections
                pc["index"] = self._index.stats()
                if self._spill is not None:
                    pc["spill"] = self._spill.stats()
            st["prefix_cache"] = pc
        return st

    def index_summary(self):
        """Resident-prefix digests (:meth:`RadixPrefixIndex.summary`), the
        input of cross-replica placement; None in exact-key mode."""
        if not self.radix:
            return None
        with self._mut:
            return self._index.summary()

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
        if self.radix:
            ev = self._index.evict_one()
            if ev is None:
                raise RuntimeError("page pool exhausted with nothing idle "
                                   "(admission plan should have refused)")
            key, page = ev
            self._m_evictions.inc()
            self._evictions += 1
            if self._spill is not None:
                # copy the bytes out BEFORE the row is reused
                self._spill.spill(key, page)
            return page
        _, page = self._idle.popitem(last=False)
        self._m_evictions.inc()
        self._evictions += 1
        return page

    def _prefix_hits(self, prompt_ids, n_sharable):
        """Longest run of already-resident prefix pages (exact-key mode).
        A miss at page i implies misses after it: whoever registered a
        longer prefix also registered every shorter one."""
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
        if self.radix:
            blocks = self._index.blocks_of(prompt_ids, n_sharable)
            depth, idle_matched = self._index.match_depth(
                prompt_ids, n_sharable)
            fresh = need - depth
            if fresh > len(self._free) + (self._index.idle_pages
                                          - idle_matched):
                return None
            return need, n_sharable, blocks
        hits = self._prefix_hits(prompt_ids, n_sharable) if n_sharable else []
        fresh = need - len(hits)
        idle_hits = sum(1 for k in hits if k in self._idle)
        if fresh > len(self._free) + (len(self._idle) - idle_hits):
            return None
        return need, n_sharable, hits

    def _record_hits(self, pages, prompt_len):
        self._m_hits.inc(pages)
        self._hits += pages
        saved = pages * self.page_size
        if prompt_len is not None:
            saved = min(saved, max(int(prompt_len) - 1, 0))
        self._m_saved.inc(saved)
        self._saved_tokens += saved

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
            if self.radix:
                return self._allocate_radix(prompt_ids, plan)
            return self._allocate_legacy(prompt_ids, plan)

    def _resurrect_run(self, prompt_ids, blocks, cached, n, may_evict):
        """Extend a matched run of ``cached`` pages with spilled ones,
        re-paged into fresh device pages, up to ``n`` pages; returns the
        run's new blocks and pages."""
        ps = self.page_size
        new_blocks, new_pages = [], []
        while (self._spill is not None and cached < n
               and (len(self._free) + (self._index.idle_pages
                                       if may_evict else 0)) > 0):
            key = tuple(prompt_ids[:(cached + 1) * ps])
            if not self._spill.contains(key):
                break
            page = self._pop_free()
            if not self._spill.resurrect(key, page):
                # raced away (not under the mutex): the page holds junk —
                # return it; the fresh loop registers it as to-be-written
                self._free.appendleft(page)
                break
            new_blocks.append(blocks[cached])
            new_pages.append(page)
            cached += 1
            self._resurrections += 1
        return new_blocks, new_pages

    def _allocate_radix(self, prompt_ids, plan):
        need, n_sharable, blocks = plan
        ps = self.page_size
        # tier 1 — device-resident radix match: pin the longest shared
        # run (splitting a mid-run divergence at the page boundary)
        pages, _, tip = self._index.acquire(blocks)
        # tier 2 — host-tier resurrection: extend the run with spilled
        # pages re-paged into fresh device pages (still valid K/V)
        new_blocks, new_pages = self._resurrect_run(
            prompt_ids, blocks, len(pages), n_sharable, may_evict=True)
        cached = len(pages) + len(new_pages)
        if cached:
            self._record_hits(cached, len(prompt_ids))
        # tier 3 — recompute: fresh sharable pages for the divergent
        # tail (prefill will write them), then private pages
        fresh_shar = n_sharable - cached
        if fresh_shar > 0:
            self._m_misses.inc(fresh_shar)
            self._misses += fresh_shar
            for i in range(cached, n_sharable):
                new_blocks.append(blocks[i])
                new_pages.append(self._pop_free())
        self._index.insert(tip, new_blocks, new_pages)
        pages = pages + new_pages
        keys = [tuple(prompt_ids[:(i + 1) * ps]) for i in range(n_sharable)]
        for _ in range(n_sharable, need):
            pages.append(self._pop_free())
        return PageAllocation(pages, keys,
                              cached_pages=min(cached, n_sharable))

    def _allocate_legacy(self, prompt_ids, plan):
        need, n_sharable, hits = plan
        pages, keys = [], []
        if hits:
            self._record_hits(len(hits), len(prompt_ids))
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
                self._record_hits(1, len(prompt_ids))
            else:
                page = self._pop_free()
                if key is not None:
                    self._m_misses.inc()
                    self._misses += 1
            pages.append(page)
            if key is not None:     # new sharable prefix page: register it
                self._active[key] = [page, 1]
                keys.append(key)
        # exact-key sharing saves memory, never compute
        return PageAllocation(pages, keys)

    def free(self, alloc: PageAllocation):
        """Release a retired sequence's pages: private pages return to the
        free list; shared prefix pages decref and park in the idle cache
        when the last holder leaves."""
        with self._mut:
            if self.radix:
                if alloc.shared_keys:
                    full = alloc.shared_keys[-1]
                    self._index.release(self._index.blocks_of(
                        full, len(alloc.shared_keys)))
            else:
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
            alloc.cached_pages = 0

    # ----------------------------------------------- passthrough run sharing
    def acquire_run(self, prompt_ids, limit=None):
        """Pin (and extend) the shared run for a dispatch that holds no
        decode slot (the reference's embed / score requests): the longest
        resident radix match is refcounted, spilled extensions resurrect,
        and — unlike :meth:`allocate` — the remaining sharable blocks
        register fresh pages only while the free list has slack (warming
        the cache never evicts someone else's resident prefix).  Returns
        ``(pages, cached_pages)``, or ``None`` outside radix mode and for
        prompts shorter than a page.  The caller MUST :meth:`release_run`
        the same prompt and depth afterwards."""
        if not self.radix:
            return None
        prompt_ids = [int(t) for t in prompt_ids]
        n = len(prompt_ids) // self.page_size
        if limit is not None:
            n = min(n, int(limit))
        if n <= 0:
            return None
        with self._mut:
            blocks = self._index.blocks_of(prompt_ids, n)
            pages, _, tip = self._index.acquire(blocks)
            new_blocks, new_pages = self._resurrect_run(
                prompt_ids, blocks, len(pages), n, may_evict=False)
            cached = len(pages) + len(new_pages)
            if cached:
                self._record_hits(cached, None)
            while len(pages) + len(new_pages) < n and self._free:
                i = len(pages) + len(new_pages)
                new_blocks.append(blocks[i])
                new_pages.append(self._free.popleft())
                self._m_misses.inc()
                self._misses += 1
            self._index.insert(tip, new_blocks, new_pages)
            return pages + new_pages, cached

    def release_run(self, prompt_ids, depth):
        """Unpin a run :meth:`acquire_run` returned (``depth`` =
        ``len(pages)``); the run parks idle and stays resident."""
        if not self.radix or depth <= 0:
            return
        prompt_ids = [int(t) for t in prompt_ids]
        with self._mut:
            self._index.release(self._index.blocks_of(prompt_ids, depth))
