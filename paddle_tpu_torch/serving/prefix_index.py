"""Page-granular radix prefix index — longest-shared-run prefix matching
(counterpart of ``paddle_tpu/serving/prefix_index.py``, a copy of it).

Where the exact-key :class:`~.block_manager.BlockManager` cache keys each
page by its FULL token prefix, the radix index stores resident prefixes
as a compressed tree over page-sized token blocks.  ``acquire`` walks the
tree and returns the *longest shared page run* — an arbitrary partial
match, refcounted as a unit — and the caller allocates fresh pages only
for the divergent tail.  K/V at position p is a function of tokens 0..p
and the weights, so every page on a matched run already holds the bytes
a prefill would write, which is what lets the engine skip prefill for
``matched_pages * page_size`` tokens (``PageAllocation.cached_pages``).

Structure: each node carries a RUN of ``(block, page)`` pairs — ``block``
a ``page_size``-token tuple, ``page`` the pool row holding it — plus one
refcount for the whole run.  Matching that ends mid-run SPLITS the node
at the boundary so refcounts stay uniform per node; refcounts are
therefore non-increasing with depth, so a node with ``refs == 0`` roots
an entirely idle subtree.  Idle nodes park in an LRU order; eviction
takes the least-recently-idled subtree and frees its pages tail-first
(deepest node, last block first), so an interior page is never dropped
while a descendant survives.  Evicted pages are handed to the caller's
spill hook before the row is reused (:mod:`.kv_spill` re-pages them
later).

Host-side Python over plain ints and tuples; the BlockManager calls it
under its own mutex.
"""

from __future__ import annotations

import collections
import hashlib


def prefix_digest(token_ids):
    """Stable short digest of a token prefix: :meth:`RadixPrefixIndex.summary`
    exports one per resident page-boundary prefix, the currency of
    cross-replica placement (a router digests an incoming prompt the same
    way to find the replica with the deepest resident run)."""
    raw = ",".join(str(int(t)) for t in token_ids).encode()
    return hashlib.sha1(raw).hexdigest()[:16]


class _Node:
    __slots__ = ("blocks", "pages", "refs", "children", "parent", "ckey")

    def __init__(self, blocks, pages, refs, parent):
        self.blocks = list(blocks)   # page-sized token tuples, in order
        self.pages = list(pages)     # pool rows, parallel to blocks
        self.refs = int(refs)        # holders of THIS run (uniform per node)
        self.children = {}           # first-block tuple -> _Node
        self.parent = parent
        self.ckey = self.blocks[0] if self.blocks else None

    def depth_pages(self):
        return len(self.blocks)


class RadixPrefixIndex:
    def __init__(self, page_size):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self._root = _Node((), (), 0, None)
        self._idle = collections.OrderedDict()   # _Node -> None, LRU order
        self._idle_pages = 0
        self._resident_pages = 0
        self._nodes = 0
        self._splits = 0
        self._summary_cache = None

    # ------------------------------------------------------------- inspection
    @property
    def idle_pages(self):
        """Pages in refs==0 runs — evictable without touching a live
        sequence (the BlockManager's free_pages includes them)."""
        return self._idle_pages

    @property
    def resident_pages(self):
        return self._resident_pages

    def blocks_of(self, prompt_ids, limit):
        """The first ``limit`` page-sized token blocks of a prompt."""
        ps = self.page_size
        return [tuple(int(t) for t in prompt_ids[i * ps:(i + 1) * ps])
                for i in range(limit)]

    def _walk(self, blocks):
        """Longest resident match: list of ``(node, k)`` pairs — ``k``
        blocks matched inside each node (only the last pair may be
        partial) — without mutating the tree."""
        path, i, node = [], 0, self._root
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            k = 1
            while (k < len(child.blocks) and i + k < len(blocks)
                   and child.blocks[k] == blocks[i + k]):
                k += 1
            path.append((child, k))
            if k < len(child.blocks):
                break
            i += k
            node = child
        return path

    def match_depth(self, prompt_ids, limit):
        """(matched pages, matched pages currently idle) for a prompt,
        without acquiring — the BlockManager's admission plan uses the
        idle count to know how many evictable pages a hit would pin."""
        path = self._walk(self.blocks_of(prompt_ids, limit))
        depth = sum(k for _, k in path)
        idle = sum(k for node, k in path if node.refs == 0)
        return depth, idle

    # --------------------------------------------------------------- mutation
    def _split(self, node, k):
        """Split ``node`` after its k-th block; the suffix becomes a child
        carrying the original's children and refcount."""
        suf = _Node(node.blocks[k:], node.pages[k:], node.refs, node)
        suf.children = node.children
        for ch in suf.children.values():
            ch.parent = suf
        node.blocks = node.blocks[:k]
        node.pages = node.pages[:k]
        node.children = {suf.ckey: suf}
        self._nodes += 1
        self._splits += 1
        if node.refs == 0:
            # both halves stay idle and individually evictable
            self._idle[suf] = None
        self._summary_cache = None

    def acquire(self, blocks):
        """Pin the longest resident run covering ``blocks``: bump every
        node on the matched path (splitting the last node if the match
        ends mid-run) and return ``(pages, idle_reactivated, tip)`` —
        the matched pages in prefix order, how many came out of the idle
        cache, and the deepest matched node (:meth:`insert`'s attachment
        point; the root when nothing matched)."""
        path = self._walk(blocks)
        if path and path[-1][1] < len(path[-1][0].blocks):
            self._split(path[-1][0], path[-1][1])
        pages, reactivated = [], 0
        tip = self._root
        for node, k in path:
            if node.refs == 0:
                self._idle.pop(node, None)
                self._idle_pages -= len(node.pages)
                reactivated += len(node.pages)
            node.refs += 1
            pages.extend(node.pages)
            tip = node
        return pages, reactivated, tip

    def insert(self, tip, blocks, pages):
        """Register a fresh run of ``blocks``/``pages`` under ``tip`` (the
        node :meth:`acquire` returned) with refs=1.  The caller has
        already pinned the path above, so the child-refs <= parent-refs
        invariant holds by construction."""
        if not blocks:
            return tip
        if len(blocks) != len(pages):
            raise ValueError("insert needs one page per block")
        node = _Node(blocks, pages, 1, tip)
        tip.children[node.ckey] = node
        self._nodes += 1
        self._resident_pages += len(pages)
        self._summary_cache = None
        return node

    def release(self, blocks):
        """Unpin a full path (the exact depth a prior acquire+insert
        covered — always a node boundary, since boundaries are only ever
        added).  Runs whose refcount hits zero park in the idle LRU."""
        path = self._walk(blocks)
        depth = sum(k for _, k in path)
        if depth != len(blocks):
            raise KeyError(
                f"release of unregistered prefix: matched {depth} of "
                f"{len(blocks)} pages")
        last, k = path[-1] if path else (self._root, 0)
        if path and k < len(last.blocks):
            raise KeyError("release depth falls mid-run")
        for node, _ in path:
            if node.refs <= 0:
                raise RuntimeError("refcount underflow in prefix index")
            node.refs -= 1
            if node.refs == 0:
                self._idle[node] = None
                self._idle_pages += len(node.pages)

    def evict_one(self):
        """Reclaim ONE page from the least-recently-idled subtree,
        tail-first: descend to the deepest idle descendant and pop its
        last ``(block, page)`` pair.  Returns ``(key_tokens, page)`` —
        the full token prefix the page encodes (the spill tier's content
        address) — or ``None`` when nothing is idle."""
        if not self._idle:
            return None
        node = next(iter(self._idle))
        while node.children:
            node = next(iter(node.children.values()))
        block = node.blocks.pop()
        page = node.pages.pop()
        self._idle_pages -= 1
        self._resident_pages -= 1
        # content address: every block from the root down to (and
        # including) the one this page encoded
        toks = list(block)
        cur = node
        while cur is not None:
            for b in reversed(cur.blocks):
                toks[:0] = b
            cur = cur.parent
        if not node.blocks:
            if node.parent is not None:
                node.parent.children.pop(node.ckey, None)
            self._idle.pop(node, None)
            self._nodes -= 1
        self._summary_cache = None
        return tuple(toks), page

    def clear(self):
        self._root = _Node((), (), 0, None)
        self._idle.clear()
        self._idle_pages = 0
        self._resident_pages = 0
        self._nodes = 0
        self._summary_cache = None

    # ---------------------------------------------------------------- export
    def stats(self):
        return {
            "nodes": self._nodes,
            "resident_pages": self._resident_pages,
            "idle_pages": self._idle_pages,
            "splits": self._splits,
        }

    def summary(self, max_depth=16, max_entries=512):
        """Resident-prefix digest set for cross-replica placement: one
        :func:`prefix_digest` per resident page-boundary prefix, depth
        capped (routing only needs the head of the tree) and entry
        capped (states snapshots stay JSON-small).  Cached until the
        tree's structure changes — routers snapshot this on every
        route, eviction/insert is the rare event."""
        if self._summary_cache is not None:
            return self._summary_cache
        digests = []
        stack = [(self._root, [])]
        while stack and len(digests) < max_entries:
            node, toks = stack.pop()
            for b in node.blocks:
                toks = toks + list(b)
                if len(toks) // self.page_size > max_depth:
                    break
                digests.append(prefix_digest(toks))
                if len(digests) >= max_entries:
                    break
            if len(toks) // self.page_size <= max_depth:
                for ch in node.children.values():
                    stack.append((ch, toks))
        self._summary_cache = {
            "page_size": self.page_size,
            "digests": digests,
            "resident_pages": self._resident_pages,
        }
        return self._summary_cache
