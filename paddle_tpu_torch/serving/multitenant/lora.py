"""Paged multi-LoRA: adapter definitions, the rank-bucketed LoRAStore,
and the LoRA-aware engine adapters (counterpart of
``paddle_tpu/serving/multitenant/lora.py``).

S-LoRA-style serving: every registered fine-tune's low-rank pairs live in
GLOBAL rank-bucketed device pools — one ``A [L, C+1, d_in, r]`` /
``B [L, C+1, r, d_out]`` pair per (decoder Linear target, rank bucket) —
and each batch row gathers ITS adapter by slot id inside the engine's
prefill / decode / verify steps (:mod:`paddle_tpu_torch.ops.lora`).  The
program count is a function of the CONFIGURED rank buckets, never of the
adapter population: registering, evicting or hot-swapping an adapter
changes pool *contents* — page-ins write pool rows in place with
``copy_``, never rebinding a pool — so no program is minted or
recaptured for it (the CUDA graphs hold the pools' addresses).

Slot management follows the BlockManager pattern at adapter granularity
(:class:`_SlotAllocator` = refcounted active set + idle-LRU cache + free
list): an adapter is *registered* on the host (cheap), *paged in* to a
device slot on first acquire, refcounted while any live request uses it,
parked idle on release, and evicted LRU when the pool needs the slot — an
idle re-acquire is a pure refcount bump, no device write.  Slot row 0 of
every pool is the reserved NULL adapter (zeros): base-model rows gather
exact-zero deltas, so one batch freely mixes tenants and the base model.

Pools default to the MODEL dtype but can pin ``dtype=`` (e.g. bf16
adapters over an int8-weight base: the bypass runs on the ``Int8Linear``
output), and :class:`LoRAQuantizedGPTAdapter` runs the same gathers over
int8 KV pools, so quantized serving and multi-LoRA stack.

Weights carried across: :class:`LoRAAdapter` takes the reference's
numpy pairs ``{(layer, target): (A [d_in, r], B [r, d_out])}`` as they
are, and :meth:`LoRAAdapter.random` makes the reference's draws from the
same ``numpy.RandomState``.
"""

from __future__ import annotations

import collections
import threading
import weakref

import numpy as np
import torch

from ...ops.lora import gather_adapter
from ..adapter import GPTAdapter
from ..quant.adapter import QuantizedGPTAdapter

#: decoder Linear targets a LoRA pair may attach to, in pool order
TARGETS = ("qkv", "out_proj", "ffn1", "ffn2")


class LoRAAdapter:
    """One tenant's fine-tune: per-(layer, target) low-rank pairs.

    ``weights[(layer_idx, target)] = (A [d_in, rank], B [rank, d_out])``
    host arrays; targets may cover any subset of :data:`TARGETS` (missing
    (layer, target) pairs contribute nothing — their pool rows stay the
    null zeros).  ``scaling`` (the classic alpha/rank) is folded into B
    when the adapter is registered."""

    def __init__(self, name, rank, weights, scaling=1.0):
        self.name = str(name)
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.scaling = float(scaling)
        self.weights = {}
        for (layer, target), (a, b) in weights.items():
            if target not in TARGETS:
                raise ValueError(f"unknown LoRA target {target!r} "
                                 f"(expected one of {TARGETS})")
            a = np.asarray(a)
            b = np.asarray(b)
            if a.shape[1] != self.rank or b.shape[0] != self.rank:
                raise ValueError(
                    f"({layer}, {target}): A {a.shape} / B {b.shape} do not "
                    f"carry rank {self.rank}")
            self.weights[(int(layer), target)] = (a, b)

    @classmethod
    def random(cls, model, name, rank, targets=("qkv", "out_proj"),
               seed=0, scale=0.02, scaling=1.0):
        """A seeded random adapter over every decoder layer — the test /
        example stand-in for a real fine-tune (the reference's draws)."""
        rng = np.random.RandomState(seed)
        shapes = target_shapes(model)
        weights = {}
        for layer in range(num_decoder_layers(model)):
            for t in targets:
                d_in, d_out = shapes[t]
                weights[(layer, t)] = (
                    rng.normal(0, scale, (d_in, rank)),
                    rng.normal(0, scale, (rank, d_out)))
        return cls(name, rank, weights, scaling=scaling)

    def __repr__(self):
        return (f"LoRAAdapter({self.name!r}, rank={self.rank}, "
                f"pairs={len(self.weights)})")


def _linear_shape(blk, target):
    """``(d_in, d_out)`` of a decoder Linear; torch keeps ``[out, in]``
    (an ``Int8Linear``'s ``weight_int8`` too)."""
    lin = getattr(blk, target)
    w = getattr(lin, "weight", None)
    if w is None:                       # Int8Linear (weight_dtype="int8")
        w = lin.weight_int8
    return (int(w.shape[1]), int(w.shape[0]))


def target_shapes(model):
    """(d_in, d_out) per LoRA target for this model's decoder blocks."""
    blk = model.gpt.layers[0]
    return {t: _linear_shape(blk, t) for t in TARGETS}


def num_decoder_layers(model):
    return len(model.gpt.layers)


class _SlotAllocator:
    """BlockManager's allocation pattern at adapter-slot granularity:
    refcounted active rows, an idle LRU of resident-but-unused rows, and
    a free list.  Rows are 0-based; the store maps them to pool row+1
    (pool row 0 is the null adapter)."""

    def __init__(self, capacity):
        self.capacity = int(capacity)
        self._free = collections.deque(range(self.capacity))
        self._active = {}                       # name -> [row, refs]
        self._idle = collections.OrderedDict()  # name -> row (LRU)

    def acquire(self, name):
        """-> (row, resident, evicted_name) or None when every slot is
        pinned by live requests."""
        ent = self._active.get(name)
        if ent is not None:
            ent[1] += 1
            return ent[0], True, None
        if name in self._idle:
            row = self._idle.pop(name)
            self._active[name] = [row, 1]
            return row, True, None
        evicted = None
        if self._free:
            row = self._free.popleft()
        elif self._idle:
            evicted, row = self._idle.popitem(last=False)
        else:
            return None                 # all slots pinned by live requests
        self._active[name] = [row, 1]
        return row, False, evicted

    def release(self, name):
        ent = self._active[name]
        ent[1] -= 1
        if ent[1] == 0:
            del self._active[name]
            self._idle[name] = ent[0]

    def forget(self, name):
        """Drop an idle residency (explicit evict)."""
        if name in self._idle:
            self._free.append(self._idle.pop(name))

    def refs(self, name):
        ent = self._active.get(name)
        return ent[1] if ent is not None else 0

    def resident(self, name):
        return name in self._active or name in self._idle

    def reset(self):
        self._free = collections.deque(range(self.capacity))
        self._active.clear()
        self._idle.clear()


class TenantLease:
    """One live request's hold on a paged-in adapter (released at
    retirement; refcounts are per request, mirroring prefix pages)."""

    __slots__ = ("name", "bucket", "row")

    def __init__(self, name, bucket, row):
        self.name = name
        self.bucket = int(bucket)
        self.row = int(row)             # pool row (null row 0 excluded)


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


class LoRAStore:
    """See module docstring.  ``ranks`` fixes the bucket set (and with it
    every program's key) up front; ``capacity`` is adapter slots PER
    bucket; ``targets`` the decoder Linears carrying pairs.  The pools
    live on the model's device.

    Thread model: ``register`` / ``evict`` run on caller threads (host
    registry only); ``acquire`` / ``release`` and the page-in writes run
    on engine scheduler threads (on the card, in the scheduler's stream
    order with its graph replays).  One lock covers both."""

    def __init__(self, model, capacity=8, ranks=(8,), targets=None,
                 dtype=None):
        self.model = model
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.ranks = tuple(sorted(int(r) for r in ranks))
        if not self.ranks or any(r < 1 for r in self.ranks):
            raise ValueError(f"ranks must be positive, got {ranks}")
        self.targets = tuple(targets) if targets is not None \
            else ("qkv", "out_proj")
        for t in self.targets:
            if t not in TARGETS:
                raise ValueError(f"unknown target {t!r}")
        self.num_layers = num_decoder_layers(model)
        self._shapes = target_shapes(model)
        wte = model.gpt.word_embeddings.weight
        self.device = wte.device
        self.dtype = wte.dtype if dtype is None else (
            dtype if isinstance(dtype, torch.dtype)
            else getattr(torch, str(dtype)))
        self._lock = threading.RLock()
        self._registry = {}     # name -> (bucket_idx, padded host {t: (A,B)})
        self._alloc = [_SlotAllocator(self.capacity) for _ in self.ranks]
        self._row_owner = [dict() for _ in self.ranks]  # row -> name
        self._pools = self._init_pools()
        from ...profiler import metrics as _metrics

        self._m_swaps = _metrics.counter(
            "serving.lora_swaps",
            "adapter page-ins (device pool writes); an idle re-acquire is "
            "a refcount bump, not a swap")
        self._m_resident = _metrics.gauge(
            "serving.lora_resident", "adapters resident in the device pools")
        self._m_registered = _metrics.gauge(
            "serving.lora_registered", "adapters in the host registry")
        self._register_memory()

    def _register_memory(self):
        """Per-rank-bucket ledger owners ``lora.r<r>``: each bucket's A/B
        pools register as one owner, so the /statusz owner table shows
        where multi-tenant device memory goes by rank.  Sources close over
        a weakref (the ledger never pins the store); replica="shared": one
        store may serve several engines."""
        from ...observability import memory as _obs_memory

        led = _obs_memory.ledger()
        ref = weakref.ref(self)
        per_bucket = 2 * len(self.targets)
        for bi, r in enumerate(self.ranks):
            def src(bi=bi):
                st = ref()
                if st is None:
                    return None
                return list(
                    st._pools[bi * per_bucket:(bi + 1) * per_bucket])
            led.register(f"lora.r{r}", src, replica="shared",
                         device=str(self.device),
                         meta={"kind": "lora", "rank": r,
                               "capacity": self.capacity,
                               "targets": list(self.targets)})

    # ------------------------------------------------------------- identity
    def signature(self):
        """Static tuple baked into every program key: programs depend on
        pool SHAPES (buckets, capacity, targets, dtype), never on which
        adapters currently occupy them (the reference's spelling)."""
        return (self.ranks, self.capacity, self.targets,
                _dtype_name(self.dtype), self.num_layers)

    @property
    def n_args(self):
        """Device tensors :meth:`device_args` contributes per dispatch."""
        return 2 * len(self.targets) * len(self.ranks)

    def family_suffix(self):
        """Perf-attribution suffix of the LoRA program families, e.g.
        ``@lora-r8`` / ``@lora-r4+16`` (one decode program per rank-bucket
        SET — the adapter count never appears)."""
        return "@lora-r" + "+".join(str(r) for r in self.ranks)

    def _init_pools(self):
        pools = []
        for r in self.ranks:
            for t in self.targets:
                d_in, d_out = self._shapes[t]
                pools.append(torch.zeros(
                    (self.num_layers, self.capacity + 1, d_in, r),
                    dtype=self.dtype, device=self.device))
                pools.append(torch.zeros(
                    (self.num_layers, self.capacity + 1, r, d_out),
                    dtype=self.dtype, device=self.device))
        return tuple(pools)

    def pool_bytes(self):
        return int(sum(p.numel() * p.element_size() for p in self._pools))

    def device_args(self):
        """The flat pool tuple every LoRA dispatch reads (read-only in the
        steps; page-ins write rows in place, so the tensors — and the
        addresses a captured graph holds — never change)."""
        return self._pools

    # ------------------------------------------------------------- registry
    def bucket_for(self, rank):
        for i, r in enumerate(self.ranks):
            if rank <= r:
                return i
        raise ValueError(
            f"rank {rank} exceeds every configured bucket {self.ranks}; "
            "rank buckets are fixed at store construction (they define "
            "the program family)")

    def register(self, adapter: LoRAAdapter):
        """Host-side registration (cheap; the device page-in is deferred
        to the first acquire).  Re-registering a name replaces its
        weights: the old residency is invalidated, so the NEXT request
        picks up the new weights without an engine restart.  Raises while
        live requests hold the old weights."""
        bi = self.bucket_for(adapter.rank)
        rb = self.ranks[bi]
        padded = {}
        for t in self.targets:
            d_in, d_out = self._shapes[t]
            a = np.zeros((self.num_layers, d_in, rb), np.float64)
            b = np.zeros((self.num_layers, rb, d_out), np.float64)
            for layer in range(self.num_layers):
                pair = adapter.weights.get((layer, t))
                if pair is None:
                    continue
                a[layer, :, :adapter.rank] = pair[0]
                b[layer, :adapter.rank, :] = pair[1] * adapter.scaling
            padded[t] = (self._host(a), self._host(b))
        with self._lock:
            old = self._registry.get(adapter.name)
            if old is not None and self._alloc[old[0]].refs(adapter.name):
                raise RuntimeError(
                    f"adapter {adapter.name!r} is held by live request(s); "
                    "re-register after they retire, or use a new name")
            self._invalidate_rows(adapter.name)
            self._registry[adapter.name] = (bi, padded)
            self._m_registered.set(len(self._registry))
        return adapter.name

    def _host(self, a):
        """A padded float64 pair half as a host tensor in the pool dtype
        (through float32, as the reference's cast of the same array)."""
        return torch.from_numpy(a.astype(np.float32)).to(self.dtype)

    def _invalidate_rows(self, name):
        for bi, owners in enumerate(self._row_owner):
            rows = [row for row, n in owners.items() if n == name]
            for row in rows:
                del owners[row]
            self._alloc[bi].forget(name)

    def evict(self, name):
        """Drop an adapter from the registry AND its idle residency.
        Raises while live requests still hold it."""
        with self._lock:
            if name not in self._registry:
                raise KeyError(f"adapter {name!r} is not registered")
            bi = self._registry[name][0]
            if self._alloc[bi].refs(name):
                raise RuntimeError(
                    f"adapter {name!r} is held by "
                    f"{self._alloc[bi].refs(name)} live request(s)")
            self._invalidate_rows(name)
            del self._registry[name]
            self._m_registered.set(len(self._registry))
            self._update_resident_gauge()

    def registered(self, name):
        return name in self._registry

    @property
    def names(self):
        return sorted(self._registry)

    # ------------------------------------------------------------ residency
    def acquire(self, name):
        """Pin ``name`` into a device slot for one request.  Returns a
        :class:`TenantLease`, or ``None`` when every slot of the bucket is
        pinned by live requests (the engine keeps the request queued)."""
        with self._lock:
            ent = self._registry.get(name)
            if ent is None:
                raise KeyError(f"adapter {name!r} is not registered")
            bi, padded = ent
            got = self._alloc[bi].acquire(name)
            if got is None:
                return None
            row, resident, evicted = got
            owners = self._row_owner[bi]
            if evicted is not None and owners.get(row) == evicted:
                del owners[row]
            if not resident or owners.get(row) != name:
                self._page_in(bi, row, padded)
                owners[row] = name
                self._m_swaps.inc()
            self._update_resident_gauge()
            return TenantLease(name, bi, row + 1)

    def release(self, lease: TenantLease):
        with self._lock:
            self._alloc[lease.bucket].release(lease.name)

    @torch.inference_mode(False)
    @torch.no_grad()
    def _page_in(self, bi, row, padded):
        """Write one adapter's rows into the bucket's pools IN PLACE."""
        base = 2 * len(self.targets) * bi
        for ti, t in enumerate(self.targets):
            a, b = padded[t]
            k = base + 2 * ti
            self._pools[k][:, row + 1].copy_(a)
            self._pools[k + 1][:, row + 1].copy_(b)

    def _update_resident_gauge(self):
        self._m_resident.set(sum(
            sum(1 for n in self._registry if al.resident(n))
            for al in self._alloc))

    # There is deliberately no reset-on-restart hook: the adapter pools
    # are read-only in the steps, so they survive an engine crash intact;
    # the engine's recovery releases every in-flight lease and
    # re-admission re-acquires them (an idle resurrection, no device
    # write), which keeps restarted output byte-identical.

    # ----------------------------------------------------------- device side
    def gather_layers(self, aid, lw):
        """The per-layer ``lora=`` structure the GPT forward consumes,
        gathering per-row pairs from the pool tensors.  ``aid
        [n_buckets, B]`` int32 slot rows (0 = null); ``lw`` the flat tuple
        in :meth:`device_args` order.  Runs inside the engine's step."""
        n = self.n_args
        if len(lw) != n:
            raise TypeError(f"expected {n} adapter pool tensors, "
                            f"got {len(lw)}")
        out = []
        for layer in range(self.num_layers):
            d = {}
            for ti, t in enumerate(self.targets):
                flat = []
                for bi in range(len(self.ranks)):
                    rows = aid[bi]
                    k = 2 * len(self.targets) * bi + 2 * ti
                    flat.append(gather_adapter(lw[k][layer], rows))
                    flat.append(gather_adapter(lw[k + 1][layer], rows))
                d[t] = tuple(flat)
            out.append(d)
        return out

    # ------------------------------------------------------------- insight
    def stats(self):
        with self._lock:
            tenants = {}
            for name, (bi, _) in self._registry.items():
                al = self._alloc[bi]
                tenants[name] = {
                    "rank_bucket": self.ranks[bi],
                    "resident": al.resident(name),
                    "refs": al.refs(name),
                }
            return {
                "ranks": list(self.ranks),
                "capacity": self.capacity,
                "targets": list(self.targets),
                "dtype": _dtype_name(self.dtype),
                "pool_bytes": self.pool_bytes(),
                "adapters": tenants,
            }


# ------------------------------------------------------- engine adapters
class _LoRAAdapterMixin:
    """Extends an engine adapter's closures with the trailing multi-LoRA
    arguments ``(aid [n_buckets, B] int32, *adapter_pools)`` and threads
    the per-row gathered pairs into the GPT forward (``lora=``) — all
    through the base adapter's single ``_split_extra`` hook.  KV pool
    handling (the quantized 4-tensor layout too) is inherited
    untouched."""

    def __init__(self, model, page_size, store: LoRAStore):
        super().__init__(model, page_size)
        self.store = store

    def _split_extra(self, args):
        n = self.n_pools
        want = n + 3 + self.store.n_args
        if len(args) != want:
            raise TypeError(
                f"{type(self).__name__} closures take {n} pools + table + "
                f"lens + aid + {self.store.n_args} adapter pools; got "
                f"{len(args)} trailing args")
        pools, table, lens = self._split(args[:n + 2])
        aid, lw = args[n + 2], args[n + 3:]
        return pools, table, lens, self.store.gather_layers(aid, lw)


class LoRAGPTAdapter(_LoRAAdapterMixin, GPTAdapter):
    """Multi-LoRA over full-precision paged KV pools."""


class LoRAQuantizedGPTAdapter(_LoRAAdapterMixin, QuantizedGPTAdapter):
    """Multi-LoRA over int8 paged KV pools (+ scale pools): the adapter
    gathers ride the same steps that quantize into the pool writes and
    run K4."""
