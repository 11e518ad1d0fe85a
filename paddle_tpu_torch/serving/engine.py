"""Continuous-batching LLM serving engine (counterpart of
``paddle_tpu/serving/engine.py``).

One fixed-shape batch of ``num_slots`` decode slots runs against per-layer
GLOBAL page pools; a background scheduler thread executes iterations:

1. admit waiting prompts into free slots while the page pool can cover
   their worst case (prompt + max_new_tokens) — each admission runs one
   prefill that writes the prompt's K/V into its pages and samples the
   first token;
2. run ONE decode step for the whole batch — every slot at its OWN
   position (per-slot lengths and page-table rows), inactive slots pointed
   at a scratch page — then bring the sampled tokens to the host;
3. retire slots that hit EOS / max_new_tokens / their deadline / a
   cancellation; their pages return to the :class:`BlockManager` at once
   and the slot backfills from the queue on the next iteration.

Prefill prompts are right-padded to a page-count bucket (exact up to
``_PREFILL_POW2_PAGES`` pages, then the next power of two), as in the TPU
package.  The pools are updated in place by the adapter.  The scheduler
thread runs under ``torch.inference_mode`` (grad mode is per thread).

The engine runs on the card unless ``device="cpu"``; it moves the model
to its device (``nn.Module.to`` moves in place).

Resilience: a health state machine (``health_state()``: healthy,
degraded, draining, stopped, error); load shedding at submit with
distinct reasons (``RequestRejectedError.reason``: ``queue_full`` past
``max_queue``, ``deadline_unmeetable`` when a stall or the queue-position
estimate already exceeds the deadline, ``draining``, ``brownout`` on QoS
engines); a :class:`~..observability.watchdog.ServingWatchdog`
(``watchdog_s``).  A failure in the scheduler — a CUDA fault surfaces at
the next sync, when the sampled tokens come to the host — is classified
by :func:`~..resilience.retry.classify_failure`: a transient one restarts
the engine (fresh pools and BlockManager) and re-queues every in-flight
request as prompt + tokens-so-far with the remaining budget, so greedy
ids are those of an uninterrupted run, up to ``max_engine_restarts``
within ``restart_cooldown_s``; a fatal one (or a burned budget, or a
recovery that itself fails) fails every in-flight and queued request with
that error and leaves the engine stopped.  The fault sites
``serving.scheduler_wedge`` and ``serving.step_crash`` (and their
``@<replica>`` twins) of :mod:`..observability.faults` drive these paths.

NaN-safe serving (``numeric_guard=True``): each dispatch also flags the
rows whose logits are non-finite, in the same host transfer as the
tokens, and exactly those requests fail (``status="error"``,
:class:`~..resilience.retry.NumericFault`); the others' tokens are
unchanged.

Speculative decoding (``speculative_k > 0``, :mod:`.speculative`): each
iteration drafts up to k tokens per slot by n-gram suffix match over the
slot's own context and verifies them in ONE multi-token step (the
adapter's ``verify``: the chunk cache variant, K3 / K4 over the
``[B*(k+1)]``-row expansion); the scheduler consumes the longest accepted
prefix plus the bonus token (1..k+1 tokens per slot per step), with the
EOS / budget / deadline / cancel checks per emitted token.  Greedy rows
accept by exact argmax match, so greedy output equals the plain engine's;
temperature rows use rejection sampling.  An iteration that drafted
nothing anywhere runs the plain step, as the TPU package schedules it.

Chunked prefill (``prefill_chunk_tokens=N``): a prompt longer than N is
admitted at once and ingested N tokens per scheduler iteration through
the adapter's ``prefill_chunk`` (the same chunk variant), round-robin over
the slots mid-prefill and interleaved with the decode step, so one long
prompt no longer stalls the decode batch for its whole prefill; the final
chunk's token seeds decode.

Hierarchical KV cache (``prefix_cache="radix"``): the BlockManager's
radix index reuses the longest shared page run of a prompt, and the
prefill runs only the divergent tail — ONE ``prefill_chunk`` at the
cached offset (K3 / K4 through ``paged_chunk_attend(_quant)`` on the
card).  ``kv_spill=True`` adds the host tier (:mod:`.kv_spill`): evicted
idle pages are copied to host memory and copied back on the next matching
prefix.  ``prefix_cache="lru"`` (or ``prefix_sharing=True``) is the
exact-key sharing, which saves memory but recomputes every prefill.

QoS tiers (``qos=True`` or a :class:`~.qos.QoSConfig`): ``submit(tier=)``
selects the request's queue, admission weight, SLO accounting and
preemption rank; a high-tier request preempts a lower-tier decode slot
(requeued like a restart, so its greedy ids do not change), and the
protected tier's SLO burn rate sheds lower tiers at admission.

Quantized serving: ``kv_dtype="int8"`` stores the page pools as int8 with
parallel float32 scale pools (:class:`~.quant.QuantizedGPTAdapter`; the
writes quantize and decode runs the dequantizing kernel K4), about 1.9x
the resident sequences per pool byte at head_dim 64;
``weight_dtype="int8"`` converts the model's Linears to ``Int8Linear`` in
place (:func:`~.quant.quantize_model_weights`, idempotent).

Observability: every ``serving.*`` family of the reference engine, in
the port's metrics registry (:mod:`..profiler.metrics`), each series
labelled ``replica=<id>`` — the ``serving.ttft_seconds``,
``serving.ttft_cold_seconds``, ``serving.inter_token_seconds``,
``serving.step_seconds``, ``serving.prefill_seconds`` and
``serving.prefill_chunk_seconds`` histograms (TTFT / ITL edges aligned to
an ``SLOPolicy``'s targets), the occupancy / pool / health gauges, and the
request, token, shed, restart, requeue, preemption, numeric-fault and
speculative counters; :meth:`ServingEngine.stats` reports the same counts.
Programs, as the reference keys them: each dispatch runs the program of
its static key — ``serve_step``, ``serve_prefill/<bucket>``,
``serve_prefill_chunk/<c>`` (chunks and radix cached tails) and
``verify/k<k>`` — minted once per key in the model's program store
(:func:`~..text.models._decode.program_store`) and counted by
``serving.step_traces`` / ``prefill_traces`` / ``prefill_chunk_traces``
/ ``verify_traces``, with a row in the program ledger
(:mod:`..observability.programs`) and per-family device time in the
roofline table (:mod:`..observability.perf`).  On the card a program is a
CUDA graph (:class:`~..jit.graphs.Program`) over static input buffers
(filled from pinned host rows, ``non_blocking``), the pools and this
engine's generator, the sampler and the numeric guard's inject vector
inside it; all of an engine's graphs share one memory pool, which the
memory ledger counts (``programs.graph_pool``).  Its first dispatch by
this engine builds the kernels, runs the step eagerly and captures it;
later dispatches replay it, and the one host sync of a dispatch is its
outputs' transfer.  A second engine over the same model finds the key
minted (no count) and captures its own graph over its own pools, billed
to the waiting request's ``compile_s``.  On the CPU a program is the eager
step bound to its key.  :meth:`ServingEngine.warmup` replays a
:class:`~..observability.programs.WarmupManifest` with inert dispatches
before :meth:`~ServingEngine.start`, so the first request mints and
captures nothing.  A request is *cold* (its TTFT also lands in
``serving.ttft_cold_seconds``) when it waited out a first dispatch.
Spans (:mod:`..observability.tracing`): ``serving.submit``,
``serving.prefill`` / ``serving.prefill_cached`` /
``serving.prefill_chunk`` on the request's trace, one
``serving.decode_step`` / ``serving.verify_step`` per iteration linking
every active request's trace.  ``telemetry_port=`` (or
``PADDLE_TELEMETRY_PORT``) serves ``/metrics`` ``/healthz`` ``/statusz``
with this engine's health (gating unless ``health_gating=False``) and
status sections; the flight recorder arms from ``PADDLE_FLIGHT_DIR``; the
memory ledger holds the engine's pools and weights, and with
``PADDLE_HBM_BUDGET_BYTES`` set, ``submit`` sheds ``hbm_budget`` when a
request's pages would not fit what the budget leaves after the weights;
an OOM in the scheduler dumps a flight record; guarded dispatches feed
their logits' stats row to the numerics stream (resolved off the step).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import logging
import os
import queue as _queue
import threading
import time
import traceback
import weakref

import numpy as np
import torch

from ..device import resolve_device
from ..jit.graphs import Program, rng_position, set_rng_position
from ..observability import faults as _faults
from ..observability import memory as _obs_memory
from ..observability import numerics as _numerics
from ..observability import perf as _perf
from ..observability import programs as _programs
from ..observability import tracing as _tracing
from ..profiler import metrics as _metrics
from ..resilience.retry import (EngineStoppedError, NumericFault,
                                classify_failure)
from ..text.models._decode import make_batched_sampler, nonfinite_rows
from .adapter import GPTAdapter
from .block_manager import BlockManager

_logger = logging.getLogger("paddle_tpu_torch.serving")

_HEALTH_CODE = {"healthy": 0, "degraded": 1, "draining": 2, "stopped": 3,
                "error": 4}

# prefill bucketing: prompts up to this many pages pad to their own page
# count; above it, page counts round up to the next power of two
_PREFILL_POW2_PAGES = 4


class RequestRejectedError(RuntimeError):
    """Raised by submit() for requests the engine can never serve or
    sheds.  ``reason``: ``unservable`` (too long for the model or the page
    pool), ``queue_full``, ``deadline_unmeetable`` (the deadline cannot be
    met given the queue or a stall), ``brownout`` (a QoS tier shed while
    the protected tier burns its error budget), ``hbm_budget`` (the pages
    would not fit ``PADDLE_HBM_BUDGET_BYTES``) or ``draining``."""

    def __init__(self, message, reason="rejected"):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling.  ``temperature <= 0`` is greedy; top_k/top_p
    are engine-level."""

    temperature: float = 0.0


@dataclasses.dataclass
class Request:
    prompt: list
    max_new_tokens: int
    sampling: SamplingParams
    eos_token_id: int | None
    deadline: float | None      # absolute time.time() seconds
    handle: "RequestHandle"
    # multi-tenant serving (serving.multitenant; every field defaults to
    # the single-tenant base-model request, so the plain engine's paths
    # are untouched): the tenant's registered LoRA adapter name, the
    # compiled token FSM constraining this row's output, the request kind
    # (generate | embed | score), the embed pooling, and the store lease
    # held while the request is admitted
    adapter: str | None = None
    grammar: object = None
    mode: str = "generate"
    pooling: str = "mean"
    lease: object = None
    # QoS tier name — None on engines without a tier table; carried
    # verbatim across requeues (restart recovery, preemption)
    tier: str | None = None


class RequestHandle:
    """Caller-side view of a submitted request.

    ``result(timeout)`` blocks for the generated ids; ``stream()`` yields
    tokens as the engine produces them (abandoning the iterator cancels
    the request and frees its pages); ``cancel()`` retires it at the next
    iteration."""

    def __init__(self, request_id, prompt_len):
        self.request_id = request_id
        self.prompt_len = prompt_len
        # multi-tenant surface: the request kind, the embed / score result
        # (``value``), the tenant's adapter name, and a constrained row's
        # live FSM state (on the HANDLE, so a restart's re-admission
        # resumes the grammar where the emitted tokens left it)
        self.mode = "generate"
        self.value = None
        self.adapter = None
        self._fsm_state = None
        self.token_ids = []            # generated ids (appended by the engine)
        # wall-clock stamp of every emission: the request's timeline, which
        # observability.slo evaluates
        self.token_times = []
        self.status = "queued"
        # QoS: the resolved tier (None on non-QoS engines) and how many
        # times a higher tier evicted it from a decode slot
        self.tier = None
        self.preemptions = 0
        # distributed-tracing identity: every span this request touches
        # (submit -> prefill -> each decode iteration) carries or links it
        self.trace_id = _tracing.new_trace_id()
        # first-dispatch stalls it waited out (build, run and capture of a
        # program before its first token)
        self.compile_s = 0.0
        self._hbm_pages = 0            # pre-flight page reservation
        self.submitted_at = time.time()
        self.admitted_at = None        # queue -> slot (first dispatch start)
        self.first_token_at = None
        self.finished_at = None
        self._events = _queue.Queue()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._error = None

    def cancel(self):
        self._cancel.set()

    @property
    def cancelled(self):
        return self._cancel.is_set()

    @property
    def done(self):
        return self._done.is_set()

    @property
    def ttft(self):
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    # ------------------------------------------------ TTFT decomposition
    @property
    def queue_s(self):
        """Submit -> admission wait (None until admitted)."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def prefill_s(self):
        """TTFT minus queueing minus first-dispatch stalls: the dispatch
        work itself, defined as the remainder so the decomposition sums
        exactly (``queue_s + compile_s + prefill_s == ttft``)."""
        t = self.ttft
        if t is None or self.queue_s is None:
            return None
        return max(0.0, t - self.queue_s - self.compile_s)

    def ttft_breakdown(self):
        """Cold-start forensics: where this request's first token went.
        ``None`` until the first token lands."""
        t = self.ttft
        if t is None:
            return None
        return {"ttft_s": t, "queue_s": self.queue_s,
                "compile_s": self.compile_s, "prefill_s": self.prefill_s,
                "cold": self.compile_s > 0.0, "trace_id": self.trace_id}

    def _raise_error(self):
        # stopped mid-flight / this row's logits went non-finite: verdicts
        # about this request, surfaced as they are
        if isinstance(self._error, (EngineStoppedError, NumericFault)):
            raise self._error
        raise RuntimeError("serving engine failed") from self._error

    def result(self, timeout=None):
        """Generated token ids (blocks until the request finishes);
        ``mode="embed"`` requests return the pooled hidden-state vector,
        ``mode="score"`` the per-token logprob list."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s")
        if self._error is not None:
            self._raise_error()
        if self.mode != "generate":
            return self.value
        return list(self.token_ids)

    def stream(self):
        """Token-at-a-time iterator.  Abandoning it (``close()`` /
        ``break`` + GC) cancels the request so its pages free."""
        try:
            while True:
                kind, val = self._events.get()
                if kind != "token":
                    break
                yield val
            if self._error is not None:
                self._raise_error()
        finally:
            if not self._done.is_set():
                self.cancel()

    __iter__ = stream


class _Slot:
    __slots__ = ("handle", "req", "alloc", "table_row", "length", "last",
                 "produced", "temp", "eos", "max_new", "deadline",
                 "last_token_t", "prefilled", "idx")

    def __init__(self, req, alloc, table_row):
        self.handle = req.handle
        self.req = req
        self.alloc = alloc
        self.table_row = table_row          # np.int32 [<= NP] real pages
        self.length = len(req.prompt)       # tokens whose K/V are in pages
        self.last = 0                       # last sampled token id
        self.produced = 0
        self.temp = float(req.sampling.temperature)
        self.eos = req.eos_token_id
        self.max_new = req.max_new_tokens
        self.deadline = req.deadline
        self.last_token_t = None            # inter-token latency stamp
        self.idx = None                     # its decode lane
        # chunked prefill: prompt tokens whose K/V have landed so far; None
        # once ingestion is complete (or for a monolithic prefill).  While
        # it is an int, the slot's host row stays inert (scratch table,
        # length 0), so decode steps compute a junk lane for it
        self.prefilled = None


class ServingEngine:
    """See module docstring.  Typical use::

        engine = ServingEngine(model, num_slots=4, page_size=16)
        with engine:
            h = engine.submit([1, 2, 3], max_new_tokens=64)
            for tok in h.stream():
                ...
    """

    def __init__(self, model, num_slots=4, page_size=16, max_model_len=None,
                 num_pages=None, top_k=0, top_p=1.0, prefix_sharing=False,
                 max_queue=None, seed=0, adapter=None, watchdog_s=None,
                 telemetry_port=None, max_engine_restarts=3,
                 degraded_stall_s=2.0, restart_cooldown_s=10.0,
                 speculative_k=0, draft_max_ngram=3,
                 draft_min_ngram=1, replica="0", device=None,
                 health_gating=True, slo=None, kv_dtype=None,
                 weight_dtype=None, numeric_guard=None,
                 prefill_chunk_tokens=None, qos=None, prefix_cache=None,
                 kv_spill=False, kv_spill_budget_bytes=None):
        if prefill_chunk_tokens:
            prefill_chunk_tokens = int(prefill_chunk_tokens)
            if prefill_chunk_tokens < 1:
                raise ValueError(f"prefill_chunk_tokens must be >= 1, "
                                 f"got {prefill_chunk_tokens}")
        else:
            prefill_chunk_tokens = None
        self._chunk_tokens = prefill_chunk_tokens
        self._prefill_rr = 0    # round-robin cursor over prefilling slots
        kv_dtype = str(kv_dtype).lower() if kv_dtype is not None else "native"
        if kv_dtype in ("native", "bf16", "bfloat16", "float32", "fp32"):
            kv_dtype = "native"
        elif kv_dtype != "int8":
            raise ValueError(f"kv_dtype must be None/'native' or 'int8', "
                             f"got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.weight_dtype = str(weight_dtype).lower() \
            if weight_dtype is not None else "native"
        if self.weight_dtype not in ("native", "int8"):
            raise ValueError(f"weight_dtype must be None/'native' or "
                             f"'int8', got {weight_dtype!r}")
        # replica identity: stamps every serving.* series with replica=
        # so N engines in one process keep distinct series, keys the
        # /statusz and /healthz provider registration, and names the
        # replica-scoped fault sites serving.{scheduler_wedge,step_crash}@
        self.replica = str(replica)
        self._site_wedge = f"serving.scheduler_wedge@{self.replica}"
        self._site_step_crash = f"serving.step_crash@{self.replica}"
        # the cluster's replica-loss drill: a trip kills this replica
        self._site_replica_preempt = f"cluster.replica_preempt@{self.replica}"
        # keys this engine's /statusz and /healthz sections, and names its
        # numerics stream
        self._provider_key = f"serving/{self.replica}"
        # False: the engine still shows on /healthz, but its state does
        # not fold into the 503 answer
        self._health_gating = bool(health_gating)
        # hierarchical KV cache: "radix" reuses the longest shared page run
        # and prefills only the tail; "lru" is the exact-key sharing
        if prefix_cache not in (None, "lru", "radix"):
            raise ValueError(f"prefix_cache must be None, 'lru' or "
                             f"'radix', got {prefix_cache!r}")
        if prefix_sharing and prefix_cache is None:
            prefix_cache = "lru"    # the older spelling of the same mode
        self._prefix_cache = prefix_cache
        self._radix = prefix_cache == "radix"
        self._spill = None
        if kv_spill:
            if not self._radix:
                raise ValueError(
                    "kv_spill=True needs prefix_cache='radix': spilled "
                    "pages are content-addressed through the radix index")
            from .kv_spill import KVSpillTier

            self._spill = KVSpillTier(replica=self.replica,
                                      budget_bytes=kv_spill_budget_bytes)
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        if self.weight_dtype == "int8":
            from .quant.weights import quantize_model_weights

            quantize_model_weights(model)
        if adapter is not None:
            # a caller-built adapter (the multi-tenant engine's LoRA ones);
            # its pools must land on this engine's device
            if (adapter.device.type, adapter.device.index or 0) != \
                    (self.device.type, self.device.index or 0):
                raise ValueError(f"adapter built for {adapter.device}, "
                                 f"engine runs on {self.device}")
            self._adapter = adapter
        elif kv_dtype == "int8":
            from .quant.adapter import QuantizedGPTAdapter

            self._adapter = QuantizedGPTAdapter(model, page_size)
        else:
            self._adapter = GPTAdapter(model, page_size)
        self.page_size = int(page_size)
        self.num_slots = int(num_slots)
        cap = self._adapter.max_model_len
        self.max_model_len = min(int(max_model_len), cap) if max_model_len \
            else cap
        self.table_width = -(-self.max_model_len // self.page_size)  # NP
        if num_pages is None:
            num_pages = self.num_slots * self.table_width  # full residency
        self._num_pages = int(num_pages)
        self._bytes_per_page = int(self._adapter.page_bytes())
        self._pool_dtype = "int8" if kv_dtype == "int8" \
            else str(self._adapter.dtype).removeprefix("torch.")
        self._bm = self._new_block_manager()
        # pool row num_pages is the SCRATCH page: inactive decode slots and
        # padded table tails point at it (every table entry must be a valid
        # pool row; junk written there is never attended)
        self._scratch = int(num_pages)
        self._pools = tuple(self._adapter.init_pools(num_pages + 1))
        if self._spill is not None:
            # the callables read the CURRENT pool tuple, so a rebuild after
            # a crash needs no re-attachment
            self._spill.attach(self._spill_snapshot, self._spill_restore)
        self._sampler = make_batched_sampler(top_k, top_p)
        # NaN-safe serving: off unless asked (or the active tensor-checker
        # config says serving_guard); the guard wraps the SAME sampler
        self._numeric_guard = bool(_numerics.serving_guard_default()
                                   if numeric_guard is None
                                   else numeric_guard)
        self._spec_k = int(speculative_k)
        if self._spec_k < 0:
            raise ValueError(f"speculative_k must be >= 0, got {speculative_k}")
        self._drafter = self._verifier = None
        if self._spec_k:
            from .speculative import NgramDrafter, make_verifier

            self._drafter = NgramDrafter(self._spec_k, draft_max_ngram,
                                         draft_min_ngram)
            self._verifier = make_verifier(top_k, top_p)
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._rid_counter = itertools.count()
        # program keys and families, spelled as the reference spells them:
        # the sampler's static axes; "@int8" with int8 pools; "@flash" on
        # the card, where K3 / K4 bound each row's page sweep by its length
        self._top = (int(top_k), float(top_p))
        self._fam_suffix = "@int8" if kv_dtype == "int8" else ""
        self._flash_tag = "@flash" if self.device.type == "cuda" else ""
        # this engine's programs by key (on the card: its CUDA graphs, over
        # its pools), sharing one graph memory pool
        self._graphs = {}
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._warmed = None

        # QoS tiers: a per-tier queue with weighted head selection, a
        # per-tier SLO accountant where the tier has a policy, brownout
        # sheds at admission, preemption of lower-tier decode slots
        self._qos = None
        self._tier_slo = {}
        self._tier_ema = {}          # per-tier completed-duration EMAs
        self._last_preempt_t = None
        self._bo_cache = (0.0, None)  # throttled brownout snapshot
        if qos:
            from ..observability.slo import SLOAccountant
            from .qos import QoSConfig, TieredQueue

            if qos is True:
                qos = QoSConfig()
            if not isinstance(qos, QoSConfig):
                raise TypeError(f"qos must be a QoSConfig or True, "
                                f"got {qos!r}")
            self._qos = qos
            for t in qos.tiers:
                if t.slo is not None:
                    self._tier_slo[t.name] = SLOAccountant(
                        t.slo, replica=self.replica, tier=t.name)
            self._queue = TieredQueue(qos)
        else:
            self._queue = collections.deque()
        self._slo = None
        ttft_buckets = itl_buckets = None
        if slo is not None:
            from ..observability.slo import (SLOAccountant, SLOPolicy,
                                             slo_histogram_buckets)

            if not isinstance(slo, SLOPolicy):
                raise TypeError(f"slo must be an SLOPolicy, got {slo!r}")
            self._slo = SLOAccountant(slo, replica=self.replica)
            # align the latency histogram edges with the SLO thresholds so
            # "fraction of samples under target" reads straight off the
            # Prometheus _bucket series
            if slo.ttft_s:
                ttft_buckets = slo_histogram_buckets(
                    _metrics._DEFAULT_BUCKETS, slo.ttft_s)
            if slo.itl_s:
                itl_buckets = slo_histogram_buckets(
                    _metrics._DEFAULT_BUCKETS, slo.itl_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._slots = [None] * self.num_slots
        # persistent per-step host buffers: rows change on admit/retire and
        # per-token advances only
        self._h_last = np.zeros((self.num_slots, 1), np.int64)
        self._h_lens = np.zeros((self.num_slots,), np.int32)
        self._h_temps = np.zeros((self.num_slots,), np.float32)
        self._h_table = np.full((self.num_slots, self.table_width),
                                self._scratch, np.int32)
        # speculative verify rows: the last token + k drafts, draft lengths
        self._h_ids = np.zeros((self.num_slots, self._spec_k + 1), np.int64)
        self._h_dlen = np.zeros((self.num_slots,), np.int32)
        self._max_queue = max_queue
        self._stop_evt = threading.Event()
        self._thread = None
        self._started = False
        self._draining = False
        self._modes = None
        self._iteration = 0       # decode steps run
        self._prefills = 0        # prefills run (monolithic, chunked, cached)
        self._cached_prefills = 0  # prefills that started past cached pages
        self._prefill_chunks = 0  # chunked-prefill dispatches
        self._verify_steps = 0    # speculative verify steps (of _iteration)
        self._error = None
        self._admitting = None    # request popped but not yet slotted
        # heartbeat (stamped each loop iteration and after each dispatch)
        # for the watchdog, the health state and deadline shedding
        self._progress_t = None
        self._compiling = False   # a compile window is open (the ledger's)
        self._watchdog_s = watchdog_s
        self._watchdog = None
        self._telemetry_port = telemetry_port
        self._status_provider = None
        self._health_provider = None
        self._owns_server = False
        self._gauges_t = 0.0      # last _update_gauges stamp (throttled)
        self._npoll_t = 0.0       # last numerics-stream resolve
        self._drift_t = 0.0       # last quant-drift sample
        self._drift_idx = 0
        # restart on transient failures: the budget heals after a cooldown
        self._max_engine_restarts = int(max_engine_restarts)
        self._degraded_stall_s = float(degraded_stall_s)
        self._restart_cooldown_s = float(restart_cooldown_s)
        self._engine_restarts = 0
        self._restarts_total = 0
        self._last_restart_t = None
        self._ema_request_s = None   # EMA of completed request durations
        # lifetime counts behind stats(); each moves with its serving.*
        # series below
        self._requeued = 0
        self._numeric_faults = 0
        self._shed_counts = collections.Counter()     # (reason, tier)
        self._preempt_counts = collections.Counter()  # (reason, tier)
        self._register_families(ttft_buckets, itl_buckets)
        self._set_pool_gauges()
        # memory observability: the engine's device allocations register
        # with the process ledger, and admission pre-flight projects new
        # requests against PADDLE_HBM_BUDGET_BYTES — fixed bytes (weights)
        # plus pages committed to admitted-but-unfinished requests
        self._weights_bytes = self._weight_bytes()
        self._committed_pages = 0
        self._commit_lock = threading.Lock()
        self._register_memory()

    def _register_families(self, ttft_buckets, itl_buckets):
        """Every serving.* family of the reference engine, bound to
        ``replica=`` once here; per-call labels (status=, reason=, tier=)
        merge on top (metrics.bind)."""
        def _h(name, help, buckets=None):
            return _metrics.bind(_metrics.histogram(name, help,
                                                    buckets=buckets),
                                 replica=self.replica)

        def _g(name, help):
            return _metrics.bind(_metrics.gauge(name, help),
                                 replica=self.replica)

        def _c(name, help):
            return _metrics.bind(_metrics.counter(name, help),
                                 replica=self.replica)

        self._m_ttft = _h("serving.ttft_seconds", "submit -> first token",
                          buckets=ttft_buckets)
        self._m_ttft_cold = _h(
            "serving.ttft_cold_seconds",
            "submit -> first token for requests that paid a compile stall "
            "(subset of serving.ttft_seconds)", buckets=ttft_buckets)
        self._m_itl = _h(
            "serving.inter_token_seconds", "per-sequence inter-token latency",
            buckets=itl_buckets)
        self._m_step_seconds = _h(
            "serving.step_seconds", "one batched decode iteration")
        self._m_prefill_seconds = _h(
            "serving.prefill_seconds", "admit-time prefill")
        self._m_queue_depth = _g(
            "serving.queue_depth", "requests waiting for a slot")
        self._m_active = _g(
            "serving.active_slots", "slots decoding this iteration")
        self._m_occupancy = _g(
            "serving.slot_occupancy", "active_slots / num_slots")
        self._m_page_util = _g(
            "serving.page_utilization", "KV pages in use / pool size")
        self._m_pages_used = _g(
            "serving.pages_in_use", "KV pages held by live sequences")
        self._m_tokens = _c(
            "serving.tokens_generated", "tokens emitted to callers")
        self._m_requests = _c(
            "serving.requests", "requests by terminal status")
        self._m_blocked = _c(
            "serving.admissions_blocked",
            "admissions deferred: page pool exhausted")
        self._m_preempt = _c(
            "serving.preemptions",
            "sequences evicted from their decode slot (reason=deadline: "
            "retired expired; reason=qos: requeued for a higher tier)")
        # per-tier pressure gauges (QoS engines set them; registered
        # unconditionally so the metric families are stable)
        self._m_tier_depth = _g(
            "serving.tier.queue_depth", "queued requests per QoS tier")
        self._m_tier_active = _g(
            "serving.tier.active_slots", "decoding slots held per QoS tier")
        # program mints per kind (a key's first dispatch for the model's
        # program store; a second engine's capture is not a mint)
        self._m_step_traces = _c(
            "serving.step_traces", "decode-step program traces")
        self._m_prefill_traces = _c(
            "serving.prefill_traces", "prefill program traces")
        self._m_prefill_chunk_seconds = _h(
            "serving.prefill_chunk_seconds",
            "one chunked-prefill dispatch (prefill_chunk_tokens tokens)")
        self._m_prefill_chunk_traces = _c(
            "serving.prefill_chunk_traces",
            "chunked-prefill program traces")
        self._m_shed = _c(
            "serving.load_shed", "requests shed at submit, by reason")
        self._m_engine_restarts = _c(
            "serving.engine_restarts",
            "scheduler auto-restarts after transient failures")
        self._m_requeued = _c(
            "serving.requests_requeued",
            "in-flight requests transparently re-queued across a restart")
        self._m_health = _g(
            "serving.health_state",
            "0 healthy, 1 degraded, 2 draining, 3 stopped, 4 error")
        self._m_spec_proposed = _c(
            "serving.spec_proposed", "draft tokens submitted to verification")
        self._m_spec_accepted = _c(
            "serving.spec_accepted", "draft tokens accepted by verification")
        self._m_accept_rate = _g(
            "serving.acceptance_rate",
            "speculative acceptance: spec_accepted / spec_proposed")
        self._m_verify_traces = _c(
            "serving.verify_traces", "verify-step program traces")
        self._m_numeric_faults = _c(
            "serving.numeric_faults",
            "requests failed on non-finite logits (guarded programs)")
        self._m_quant_drift = _g(
            "serving.quant_drift",
            "sampled int8 weight dequant->requant roundtrip error "
            "(relative, one layer per tick)")
        self._m_kv_bytes_tok = _g(
            "serving.kv_bytes_per_token",
            "KV-cache HBM bytes per token position (all layers, K+V, "
            "scale pools included)")
        self._m_pool_bytes = _g(
            "serving.pool_bytes",
            "allocated KV page-pool HBM bytes (scratch page included)")

    def _set_pool_gauges(self):
        self._m_kv_bytes_tok.set(self._bytes_per_page / self.page_size)
        # one series per pool dtype: the int8 engine's float32 scale pools
        # are real device residency
        for dt, b in self.pool_bytes_by_dtype().items():
            self._m_pool_bytes.set(float(b), dtype=dt)

    def pool_bytes_by_dtype(self):
        """Actual pool-tuple device bytes, keyed by dtype (payload AND
        scale pools — what /statusz reconciles against the ledger)."""
        out = {}
        for p in self._pools:
            dt = str(p.dtype).removeprefix("torch.")
            out[dt] = out.get(dt, 0) + p.numel() * p.element_size()
        return out

    def _params_and_buffers(self):
        """``({name: parameter}, {name: buffer})``: the model's
        device-resident weights.  Non-persistent buffers are left out —
        ``Int8Linear``'s float32 scale scalars, which the reference keeps
        as plain attributes."""
        params = dict(self._model.named_parameters())
        bufs = {}
        for mname, m in self._model.named_modules():
            skip = m._non_persistent_buffers_set
            for bname, b in m.named_buffers(recurse=False):
                if b is not None and bname not in skip:
                    bufs[f"{mname}.{bname}" if mname else bname] = b
        return params, bufs

    def _weight_bytes(self):
        params, bufs = self._params_and_buffers()
        return sum(t.numel() * t.element_size()
                   for t in (*params.values(), *bufs.values()))

    def graph_pool_bytes(self):
        """Device bytes the captures of this engine's programs reserved in
        their shared memory pool (0 on the CPU, and before a capture)."""
        return sum(p.pool_bytes or 0 for p in self._graphs.values())

    @property
    def _fixed_bytes(self):
        """What the HBM pre-flight holds fixed: the weights and the graph
        pool (its largest capture — the widest prefill bucket's
        activations — sets its size)."""
        return self._weights_bytes + self.graph_pool_bytes()

    def _register_memory(self):
        """Register this engine's device allocations with the process
        MemoryLedger.  Sources close over a weakref — the ledger never
        pins the engine, and every read resolves the CURRENT pool tuple,
        so a post-crash ``_recover()`` rebuild needs no re-registration."""
        led = _obs_memory.ledger()
        ref = weakref.ref(self)

        def _pools_src(idx):
            def src():
                eng = ref()
                if eng is None or eng._pools is None:
                    return None
                return [eng._pools[i] for i in idx]
            return src

        for owner, idx in self._adapter.pool_owners():
            meta = None
            if owner == "kv.pages":
                meta = {
                    "kind": "kv",
                    "bytes_per_page": self._bytes_per_page,
                    "page_size": self.page_size,
                    "num_pages": self._num_pages,
                    "max_model_len": self.max_model_len,
                    "max_resident_slots":
                        self._bm.max_resident_sequences(self.max_model_len),
                }
            elif owner == "kv.scales":
                meta = {"kind": "kv_scales"}
            led.register(owner, _pools_src(idx), replica=self.replica,
                         meta=meta)

        def _named_src(which, pred):
            def src():
                eng = ref()
                if eng is None:
                    return None
                d = eng._params_and_buffers()[which == "bufs"]
                return [v for k, v in d.items() if pred(k)]
            return src

        # int8-converted weights get their own owner row; everything else
        # (float params, buffers, Int8Linear biases) is model.params.
        # Int8Linear keeps its payload in a buffer named weight_int8.
        is_q = lambda k: k.endswith("weight_int8")  # noqa: E731
        def _graph_pool_src():
            eng = ref()
            return None if eng is None else eng.graph_pool_bytes()

        # the captures' memory pool: reserved by the allocator, not held
        # by live tensors, so a byte count outside the reconciliation with
        # the allocator's live bytes
        led.register("programs.graph_pool", _graph_pool_src,
                     replica=self.replica, device=str(self.device),
                     meta={"kind": "graph_pool"})
        led.register("model.params", _named_src("params", lambda k: True),
                     replica=self.replica, meta={"kind": "weights"})
        led.register("model.params",
                     _named_src("bufs", lambda k: not is_q(k)),
                     replica=self.replica, meta={"kind": "weights"})
        if self.weight_dtype == "int8":
            led.register("model.weights_int8", _named_src("bufs", is_q),
                         replica=self.replica, meta={"kind": "weights_int8"})
        if self._spill is not None:
            sref = weakref.ref(self._spill)

            def _spill_src():
                tier = sref()
                return None if tier is None else tier.nbytes()

            # host tier: device="host" rows are bookkeeping only, outside
            # the allocator reconciliation
            led.register("kv.spilled", _spill_src, replica=self.replica,
                         device="host",
                         meta={"kind": "kv-spill",
                               "budget_bytes": self._spill.budget_bytes})

    def _new_block_manager(self):
        return BlockManager(self._num_pages, self.page_size,
                            prefix_sharing=self._prefix_cache is not None,
                            replica=self.replica,
                            bytes_per_page=self._bytes_per_page,
                            pool_dtype=self._pool_dtype,
                            radix=self._radix, spill=self._spill)

    # ------------------------------------------------- hierarchical KV cache
    def _spill_snapshot(self, page):
        """Copy of ONE page row of EVERY pool to the host — the spill
        tier's snapshot.  Walking the whole tuple keeps an int8 payload
        and its scales together.  A copy even on the CPU (``.cpu()`` of a
        CPU tensor would alias the pool, and the page is about to be
        reused)."""
        return tuple(p[:, page].to("cpu", copy=True) for p in self._pools)

    def _spill_restore(self, page, payload):
        """Copy a resurrected entry back into device page ``page``, in
        place in every pool (the layers' caches are views of the pools)."""
        for p, a in zip(self._pools, payload):
            p[:, page].copy_(a)

    def prefix_index_summary(self):
        """Resident-prefix digests (None outside radix mode)."""
        return self._bm.index_summary()

    # ----------------------------------------------------------- lifecycle
    def start(self):
        if self._error is not None:
            raise RuntimeError("engine previously failed") from self._error
        if self._started:
            return self
        self._modes = [(m, m.training) for m in self._model.modules()]
        self._model.eval()
        self._stop_evt.clear()
        self._draining = False
        self._engine_restarts = 0   # a fresh start() is a fresh budget
        self._progress_t = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"paddle-serving-engine"
                                             f"[{self.replica}]",
                                        daemon=True)
        self._started = True
        self._thread.start()
        self._start_observability()
        return self

    # ------------------------------------------------------------- warmup
    def warmup(self, manifest):
        """Replay a :class:`~..observability.programs.WarmupManifest` ahead
        of admission: every engine-owned key in it gets its first dispatch
        now, as an INERT one (all lanes inactive — scratch table rows,
        zero lengths — so it computes junk lanes nobody reads and writes
        only the scratch page), with the engine's generator restored after
        it.  On the card that first dispatch builds the kernels and
        captures the key's graph over this engine's pools, so the first
        real request mints and captures nothing.

        Accepts a manifest object, a saved path, or its JSON dict.  Keys
        whose static axes (slot count, table width, pool shape / dtype,
        sampler, guard) do not match THIS engine are skipped.  Must run
        before :meth:`start`: the inert dispatches write the live pools,
        which must not race the scheduler thread."""
        if self._started:
            raise RuntimeError(
                "warmup() must run before start(): replay dispatches "
                "write the live page pools")
        if isinstance(manifest, (str, os.PathLike)):
            manifest = _programs.WarmupManifest.load(manifest)
        elif isinstance(manifest, dict):
            manifest = _programs.WarmupManifest.from_json(manifest)
        want = manifest.meta.get("adapter")
        have = self._adapter_signature()
        if want is not None and want != have:
            raise ValueError(
                f"manifest captured for adapter {want}, this engine is "
                f"{have} — replaying would mint useless programs")
        # replay runs in eval mode, exactly like the scheduler
        modes = [(m, m.training) for m in self._model.modules()]
        self._model.eval()
        t0 = time.perf_counter()
        warmed, skipped = 0, []
        try:
            for key in manifest:
                try:
                    ok = self._warm_one(key)
                except Exception as exc:
                    _logger.warning("warmup: replay of %r failed: %r",
                                    key, exc)
                    ok = False
                if ok:
                    warmed += 1
                    ent = _programs.ledger().entry(key, store=self._store())
                    if ent is not None and ent.trace_id is None:
                        ent.trace_id = "warmup"  # provenance: nobody paid
                else:
                    skipped.append(key)
        finally:
            for m, tr in modes:
                m.training = tr
        info = {"warmed": warmed, "skipped": len(skipped),
                "seconds": round(time.perf_counter() - t0, 3)}
        self._warmed = info
        _logger.info("warmup: %(warmed)d programs in %(seconds).2fs "
                     "(%(skipped)d keys skipped)", info)
        return info

    def capture_manifest(self):
        """Snapshot this model's program-store key set, stamped with the
        adapter signature so :meth:`warmup` refuses a mismatched model
        geometry."""
        return _programs.WarmupManifest.capture(
            self._model, meta={"adapter": self._adapter_signature()})

    def _adapter_signature(self):
        sig = getattr(self._adapter, "signature", None)
        return sig() if callable(sig) else None

    def _warm_one(self, key):
        """Give one manifest key its first dispatch if it belongs to this
        engine's static configuration (its own store keys: the
        multi-tenant engine's ``mt_*`` keys too).  Returns True when the
        key is now warm."""
        if not isinstance(key, tuple) or len(key) < 2:
            return False
        if key == self._step_store_key():
            warm = self._warm_step
        elif isinstance(key[1], int) \
                and key == self._prefill_store_key(key[1]):
            warm = functools.partial(self._warm_prefill, key[1])
        elif isinstance(key[1], int) \
                and key == self._prefill_chunk_store_key(key[1]):
            warm = functools.partial(self._warm_prefill_chunk, key[1])
        elif self._spec_k and key == self._verify_store_key(self._spec_k):
            warm = self._warm_verify
        else:
            return False
        # an inert dispatch draws nothing the requests will see: the
        # generator goes back where it was
        pos = rng_position(self._gen)
        try:
            with torch.inference_mode():
                warm()
        finally:
            set_rng_position(self._gen, pos)
        return True

    def _warm_step(self):
        B = self.num_slots
        self._dispatch(
            self._step_store_key(), self._decode_family(),
            self._decode_family(), self._m_step_traces, (), self._step_fn,
            (self._h_last, self._h_table, self._h_lens, self._h_temps,
             *self._step_extra()),
            self._numeric_inject(B) if self._numeric_guard else None)

    def _warm_prefill(self, s_pad):
        table = np.full((1, self.table_width), self._scratch, np.int32)
        fam = self._prefill_family(s_pad)
        # junk K/V of the s_pad pad tokens lands in the scratch page
        self._dispatch(
            self._prefill_store_key(s_pad), fam, fam, self._m_prefill_traces,
            (), self._prefill_fn,
            (np.zeros((1, s_pad), np.int64), table,
             np.asarray([s_pad], np.int32), np.zeros((1,), np.float32),
             *self._warmup_prefill_extra()),
            self._numeric_inject(1) if self._numeric_guard else None)

    def _warm_prefill_chunk(self, c_pad):
        table = np.full((1, self.table_width), self._scratch, np.int32)
        fam = self._prefill_chunk_family(c_pad)
        self._dispatch(
            self._prefill_chunk_store_key(c_pad), fam, fam,
            self._m_prefill_chunk_traces, (), self._chunk_fn,
            (np.zeros((1, c_pad), np.int64), np.asarray([c_pad], np.int32),
             table, np.zeros((1,), np.int32), np.zeros((1,), np.float32),
             *self._warmup_prefill_extra()),
            self._numeric_inject(1) if self._numeric_guard else None)

    def _warm_verify(self):
        fam = self._verify_family()
        self._dispatch(
            self._verify_store_key(self._spec_k), fam, fam,
            self._m_verify_traces, (), self._verify_fn,
            (self._h_ids, self._h_table, self._h_lens, self._h_dlen,
             self._h_temps, *self._verify_extra([])),
            self._numeric_inject(self.num_slots)
            if self._numeric_guard else None)

    def program_traces(self):
        """Total mint count across this model's program store (serving
        entries carry a ``[count]`` box; generate() entries do not).  The
        warmup invariant — a warmed engine's first request mints nothing —
        is asserted as a zero delta of this sum."""
        total = 0
        for ent in self._store().values():
            if isinstance(ent, tuple) and len(ent) == 2 \
                    and isinstance(ent[1], list) and ent[1] \
                    and isinstance(ent[1][0], int):
                total += ent[1][0]
        return total

    def _start_observability(self):
        """Opt-in forensics: the flight recorder from PADDLE_FLIGHT_DIR,
        the /metrics|/healthz|/statusz endpoint from ``telemetry_port``
        (or PADDLE_TELEMETRY_PORT; 0 = ephemeral), the wedged-scheduler
        watchdog from ``watchdog_s`` (None or 0 = off).  All default to
        off."""
        from ..observability import flight_recorder as _flight
        from ..observability import telemetry as _telemetry
        from ..observability.watchdog import ServingWatchdog

        _flight.maybe_enable_from_env()
        try:
            port = self._telemetry_port
            if port is None:
                env = os.environ.get("PADDLE_TELEMETRY_PORT")
                port = int(env) if env else None
            if port is not None:
                self._owns_server = _telemetry.get_server() is None
                _telemetry.serve(port)
                # registration is KEYED by replica id, so a second engine
                # gets its own /statusz section and /healthz component
                self._status_provider = self._statusz
                _telemetry.add_status_provider(self._provider_key,
                                               self._status_provider)
                self._health_provider = self.health_state
                _telemetry.add_health_provider(self._provider_key,
                                               self._health_provider,
                                               gating=self._health_gating)
        except Exception as e:
            # opt-in observability must never take down serving startup
            # (EADDRINUSE on a shared port, a malformed env value, ...)
            self._owns_server = False
            logging.getLogger("paddle_tpu_torch.observability").error(
                "telemetry endpoint not started (%r); serving continues "
                "without /metrics|/statusz", e)
        wd = self._watchdog_s
        if wd and wd > 0 and self._watchdog is None:
            self._watchdog = ServingWatchdog(self, deadline_s=wd)
        if self._watchdog is not None:
            self._watchdog.start()

    def _stop_telemetry(self):
        """Unregister OUR providers only (a newer engine may own the key
        by now) — which also frees this engine for GC — and shut the
        process server down if this engine started it and no other
        engine's section is left on it."""
        from ..observability import telemetry as _telemetry

        if self._status_provider is not None \
                or self._health_provider is not None:
            _telemetry.remove_providers_if_owner(
                self._provider_key, self._status_provider,
                self._health_provider)
            self._status_provider = None
            self._health_provider = None
        if self._owns_server:
            self._owns_server = False
            if not any(k.startswith("serving/")
                       for k in (*_telemetry._PROVIDERS,
                                 *_telemetry._HEALTH_PROVIDERS)):
                _telemetry.shutdown()

    @property
    def telemetry(self):
        """The process telemetry server this engine serves on (None when
        it was not asked for one)."""
        from ..observability import telemetry as _telemetry

        return _telemetry.get_server() \
            if self._status_provider is not None else None

    @property
    def watchdog(self):
        return self._watchdog

    def drain(self, timeout=600):
        """Stop admitting (submits reject with reason ``draining``) and
        wait for the queue and every slot to empty.  Returns True once
        nothing is in flight; raises TimeoutError otherwise."""
        self._draining = True
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if self.quiescent:
                return True
            time.sleep(0.01)
        raise TimeoutError(f"engine did not drain within {timeout}s: "
                           f"{self.stats()}")

    def begin_drain(self):
        """Non-blocking drain: stop admitting (submits shed with reason
        ``draining``) while in-flight work runs to completion; poll
        :attr:`quiescent`."""
        self._draining = True

    @property
    def quiescent(self):
        """True once nothing is queued or in flight."""
        if self._error is not None or not self._started:
            return True
        with self._lock:
            return not self._queue and self._admitting is None \
                and all(s is None for s in self._slots)

    def stop(self, drain=False, drain_timeout=600):
        """Stop the scheduler.  ``drain=True`` first finishes all in-flight
        work; without it, in-flight and queued requests fail fast with
        :class:`EngineStoppedError`."""
        if not self._started:
            return
        if drain:
            self.drain(timeout=drain_timeout)
        self._stop_evt.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=600)
        if self._thread.is_alive():
            raise RuntimeError(
                "serving scheduler thread did not stop within 600s (stuck "
                "in a device call); engine state left untouched")
        for i, s in enumerate(self._slots):
            if s is not None:
                self._bm.free(s.alloc)
                self._release_tenant(s.req)
                self._slots[i] = None
                self._fail_stopped(s.handle)
        self._reset_host_buffers()
        with self._lock:
            while self._queue:
                self._fail_stopped(self._queue.popleft().handle)
        self._draining = False
        if self._modes is not None:
            for m, tr in self._modes:
                m.training = tr
            self._modes = None
        if self._watchdog is not None:
            self._watchdog.stop()
        self._stop_telemetry()
        self._started = False

    def _fail_stopped(self, handle):
        if handle.cancelled:
            self._finish(handle, "cancelled")
            return
        handle._error = EngineStoppedError(
            f"request {handle.request_id} was still in flight when the "
            "engine stopped; use stop(drain=True) to finish in-flight work")
        self._finish(handle, "stopped")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------ api
    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, deadline_s=None, tier=None, adapter=None,
               grammar=None, mode="generate", pooling="mean", sampling=None,
               _fsm_state=None, _autostart=True):
        """Queue one request; returns a :class:`RequestHandle` at once.
        ``deadline_s`` is a wall-clock budget from now — a sequence still
        queued or decoding past it retires with status ``expired``.
        ``tier`` names a QoS tier (``qos=`` engines only; None = the
        config's default tier).  ``sampling`` (a :class:`SamplingParams`)
        overrides ``temperature``.

        ``_autostart=False`` (the cluster's leg path) never starts a
        stopped engine: the submit is rejected instead, atomically with
        the enqueue, so a leg racing ``stop()`` cannot resurrect the
        replica.  ``_fsm_state`` resumes a grammar mid-document (a
        failover leg).

        Multi-tenant parameters (:class:`~.multitenant.MultiTenantEngine`
        only; this engine rejects non-defaults): ``adapter`` names a
        registered LoRA adapter serving this row; ``grammar`` is a
        :class:`~.multitenant.grammar.CompiledGrammar` constraining the
        row's output; ``mode``
        picks generate | embed | score (embed / score run one dispatch and
        retire without a decode slot or pages); ``pooling`` (mean | last)
        shapes the embed vector."""
        if self._qos is not None:
            tier = self._qos.resolve(tier)
        elif tier is not None:
            raise ValueError(
                "tier= needs a QoS-enabled engine (ServingEngine(qos=...))")
        prompt = self._normalize_prompt(prompt_ids)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos_token_id = self._validate_tenant(adapter, grammar, mode, pooling,
                                             eos_token_id)
        if mode != "generate":
            max_new_tokens = 1          # no decode slot is ever occupied
        total = len(prompt) + int(max_new_tokens)
        handle = RequestHandle(next(self._rid_counter), len(prompt))
        handle.tier = tier
        handle.mode = mode
        handle.adapter = adapter
        if grammar is not None:
            handle._fsm_state = _fsm_state if _fsm_state is not None \
                else grammar.start
        if sampling is None:
            sampling = SamplingParams(temperature=float(temperature))
        if mode != "generate":
            # embed / score: the prompt runs against the scratch page — no
            # pages, no decode positions
            if len(prompt) > self.max_model_len:
                self._m_requests.inc(status="rejected")
                raise RequestRejectedError(
                    f"{mode} prompt {len(prompt)} exceeds max_model_len "
                    f"{self.max_model_len}", reason="unservable")
        elif total > self.max_model_len \
                or self._bm.pages_for(total) > self._bm.num_pages:
            self._m_requests.inc(status="rejected")
            raise RequestRejectedError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"needs {self._bm.pages_for(total)} pages / {total} "
                f"positions; engine caps are {self._bm.num_pages} pages / "
                f"{self.max_model_len} positions", reason="unservable")
        if _autostart:
            self.start()  # before enqueue: a failed engine rejects loudly
        with _tracing.span("serving.submit", trace_id=handle.trace_id,
                           request_id=handle.request_id,
                           prompt_len=len(prompt)):
            with self._cv:
                # stop() sets _stop_evt before its queue sweep (under this
                # lock): a leg either rejects here or the sweep fails it
                if not _autostart and (not self._started
                                       or self._error is not None
                                       or self._stop_evt.is_set()):
                    raise EngineStoppedError(
                        f"replica {self.replica} is not running")
                if self._draining:
                    self._shed("draining",
                               "engine is draining; not admitting new work",
                               tier=tier)
                if self._qos is not None:
                    self._check_qos_admission(tier)
                if self._max_queue is not None \
                        and len(self._queue) >= self._max_queue:
                    self._shed("queue_full",
                               f"admission queue full ({self._max_queue})",
                               tier=tier)
                if deadline_s is not None:
                    self._check_deadline_meetable(float(deadline_s),
                                                  tier=tier)
                self._preflight_hbm(handle, total, mode)
                deadline = time.time() + deadline_s \
                    if deadline_s is not None else None
                self._queue.append(Request(
                    prompt, int(max_new_tokens), sampling,
                    eos_token_id, deadline, handle, adapter=adapter,
                    grammar=grammar, mode=mode, pooling=pooling, tier=tier))
                self._m_requests.inc(status="submitted")
                self._m_queue_depth.set(len(self._queue))
                self._cv.notify_all()
        return handle

    def _validate_tenant(self, adapter, grammar, mode, pooling,
                         eos_token_id):
        """Submit-time check of the multi-tenant parameters: this engine
        serves one tenant in one mode, so anything non-default is
        rejected (the multi-tenant engine overrides).  Returns the
        effective ``eos_token_id``."""
        if adapter is not None or grammar is not None \
                or mode != "generate" or pooling != "mean":
            raise ValueError(
                "adapter=/grammar=/mode=/pooling= need a multi-tenant "
                "engine (paddle_tpu_torch.serving.multitenant."
                "MultiTenantEngine)")
        return eos_token_id

    def _shed(self, reason, message, tier=None):
        """Reject at admission with a distinct, machine-readable reason
        (shedding under pressure beats timing out after queueing).  The
        ``tier=`` label is only attached on QoS engines, as in the
        reference."""
        self._shed_counts[(reason, tier)] += 1
        if tier is not None:
            self._m_shed.inc(reason=reason, tier=tier)
        else:
            self._m_shed.inc(reason=reason)
        self._m_requests.inc(status="rejected")
        raise RequestRejectedError(message, reason=reason)

    def _preflight_hbm(self, handle, total, mode="generate"):
        """With ``PADDLE_HBM_BUDGET_BYTES`` set, project this request's
        worst-case page need against what the budget leaves after the
        fixed allocations (the weights; the page pools are resident
        already, so what grows with admission is the COMMITTED page count
        across admitted-but-unfinished requests).  Shedding here with
        reason ``hbm_budget`` never changes what admitted requests
        compute: pages either fit or the request never runs.  Embed /
        score requests commit no pages."""
        if mode != "generate":
            return
        budget = _obs_memory.hbm_budget_bytes()
        if budget is None:
            return
        need = self._bm.pages_for(total)
        headroom = int(budget) - self._fixed_bytes
        page_budget = headroom // self._bytes_per_page if headroom > 0 else 0
        # the pool caps the committed total too: never promise pages past P
        page_budget = min(page_budget, self._num_pages)
        with self._commit_lock:
            if self._committed_pages + need > page_budget:
                self._shed(
                    "hbm_budget",
                    f"request needs {need} pages "
                    f"({need * self._bytes_per_page} B) but "
                    f"{self._committed_pages}/{page_budget} budgeted pages "
                    f"are committed (PADDLE_HBM_BUDGET_BYTES={budget}, "
                    f"fixed {self._fixed_bytes} B)")
            self._committed_pages += need
            handle._hbm_pages = need

    def _release_hbm(self, handle):
        """Idempotent un-commit of a handle's pre-flight reservation
        (every terminal path goes through ``_finish``)."""
        n = handle._hbm_pages
        if n:
            handle._hbm_pages = 0
            with self._commit_lock:
                self._committed_pages -= n

    def _check_qos_admission(self, tier):
        """QoS admission (under the cv lock): shed whole tiers by the
        brownout ladder and enforce per-tier queue caps."""
        bo = self._brownout()
        if tier in bo["shed"]:
            self._shed(
                "brownout",
                f"tier {tier!r} shed at brownout level {bo['level']} "
                f"({bo['state']}): protected-tier burn rate "
                f"{bo['burn_rate']:.2f}", tier=tier)
        pol = self._qos.tier(tier)
        if pol.max_queue is not None \
                and self._queue.depth(tier) >= pol.max_queue:
            self._shed("queue_full",
                       f"tier {tier!r} queue full ({pol.max_queue})",
                       tier=tier)

    def _check_deadline_meetable(self, deadline_s, tier=None):
        """Deadline-aware admission (under the cv lock): shed NOW if the
        scheduler has been stalled longer than the whole deadline budget,
        or if the queue-position estimate (queue depth over slots times
        the completed-request duration EMA) already exceeds it.  QoS
        engines estimate per tier: the submitting tier's own EMA, and only
        the queued requests at the same or higher priority."""
        stamp = self._progress_t
        if stamp is not None and not self._compiling:
            stall = time.monotonic() - stamp
            if stall > max(self._degraded_stall_s, deadline_s):
                self._shed("deadline_unmeetable",
                           f"scheduler stalled for {stall:.2f}s, longer "
                           f"than the {deadline_s:.2f}s deadline",
                           tier=tier)
        if self._qos is not None and tier is not None:
            ema = self._tier_ema.get(tier, self._ema_request_s)
            ahead = self._queue.depth_at_or_above(
                self._qos.tier(tier).priority)
        else:
            ema = self._ema_request_s
            ahead = len(self._queue)
        if ema is not None and ahead:
            est = (ahead / max(self.num_slots, 1) + 1.0) * ema
            if est > deadline_s:
                self._shed(
                    "deadline_unmeetable",
                    f"estimated completion in {est:.2f}s (queue-ahead "
                    f"{ahead}, typical request {ema:.2f}s"
                    + (f" for tier {tier!r}" if tier is not None else "")
                    + f") exceeds the {deadline_s:.2f}s deadline",
                    tier=tier)

    def generate(self, prompt_ids, max_new_tokens=32, timeout=None, **kw):
        """Blocking convenience: submit + wait; returns generated ids."""
        return self.submit(prompt_ids, max_new_tokens, **kw).result(timeout)

    def stream(self, prompt_ids, max_new_tokens=32, **kw):
        """Token-at-a-time iterator (see :meth:`RequestHandle.stream`)."""
        return self.submit(prompt_ids, max_new_tokens, **kw).stream()

    @staticmethod
    def _normalize_prompt(prompt_ids):
        arr = prompt_ids
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr)
        if arr.ndim == 2 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.ndim != 1:
            raise ValueError(f"prompt must be 1-D (or [1, S]), "
                             f"got shape {arr.shape}")
        return [int(t) for t in arr]

    # ---------------------------------------------------------- loop thread
    def _maybe_replica_preempt(self):
        """The ``cluster.replica_preempt@<replica>`` drill: when the site
        trips, this replica dies fatally.  The message avoids every
        transient pattern (the site's own word included), so
        ``classify_failure`` aborts instead of restarting in place: the
        loss is the cluster's to handle."""
        before = _faults.trip_count(self._site_replica_preempt)
        _faults.maybe(self._site_replica_preempt)
        if _faults.trip_count(self._site_replica_preempt) > before:
            raise RuntimeError(
                f"replica {self.replica} lost: host reclaimed by the "
                "cluster scheduler (injected replica loss)")

    def _loop(self):
        with torch.inference_mode():
            while not self._stop_evt.is_set():
                try:
                    # heartbeat FIRST, fault hook second: a wedge injected
                    # here leaves the stamp stale like a stuck iteration
                    self._progress_t = time.monotonic()
                    _faults.maybe("serving.scheduler_wedge")
                    _faults.maybe(self._site_wedge)
                    if _faults.armed(self._site_replica_preempt):
                        self._maybe_replica_preempt()
                    self._admit()
                    # chunked prefill rides the same iteration as the
                    # decode step: one budget of chunk work, then one step
                    # over the lanes that finished ingesting
                    self._advance_prefills()
                    self._update_gauges()
                    if not any(s is not None and s.prefilled is None
                               for s in self._slots):
                        if any(s is not None for s in self._slots):
                            continue    # chunked prefills still advancing
                        with self._cv:
                            if not self._queue and not self._stop_evt.is_set():
                                self._cv.wait(timeout=0.02)
                        continue
                    self._step_once()
                except Exception as e:
                    # OOM forensics FIRST, while the allocation state that
                    # produced the failure is still live: one flight dump
                    # carrying the ledger's owner table
                    if _obs_memory.is_oom_error(e):
                        _obs_memory.oom_dump(e, replica=self.replica)
                    # the restart budget is a burst limit: a cooldown of
                    # healthy operation since the last restart heals it
                    if self._engine_restarts \
                            and self._last_restart_t is not None \
                            and time.monotonic() - self._last_restart_t \
                            > self._restart_cooldown_s:
                        self._engine_restarts = 0
                    # the traceback's finished frames (the dispatch, the
                    # sampler) hold the old pools and logits: drop their
                    # locals, or a rebuild would hold two pool sets
                    traceback.clear_frames(e.__traceback__)
                    if classify_failure(e) == "transient" \
                            and self._engine_restarts \
                            < self._max_engine_restarts:
                        try:
                            self._recover(e)
                            continue
                        except Exception as e2:  # recovery itself died
                            e = e2
                    # fatal (or budget burned): fail every waiter
                    _logger.exception("serving scheduler failed")
                    self._error = e
                    self._abort_all(e)
                    return

    def _recover(self, exc):
        """Transient scheduler failure: rebuild the device state and
        re-queue every in-flight request instead of failing it.  Tokens
        already emitted stay emitted — each request is re-admitted as
        prompt + tokens-so-far with the remaining budget, so a greedy
        request's final ids are those of an uninterrupted run."""
        self._engine_restarts += 1
        self._restarts_total += 1
        self._last_restart_t = time.monotonic()
        self._m_engine_restarts.inc()
        _logger.error(
            "serving engine auto-restart %d/%d after transient failure %r; "
            "re-queueing in-flight requests", self._engine_restarts,
            self._max_engine_restarts, exc)
        inflight = []
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                self._release_tenant(s.req)
                inflight.append((s.req, s.produced))
        pending, self._admitting = self._admitting, None
        if pending is not None:
            self._release_tenant(pending)
        if pending is not None and \
                all(req.handle is not pending.handle for req, _ in inflight):
            inflight.append((pending, 0))
        # re-queue BEFORE touching device state: if the rebuild below
        # raises (recovery itself died), _abort_all fails these handles
        # with the queue instead of leaving them waiting forever
        with self._lock:
            for req, produced in reversed(inflight):
                h = req.handle
                if h.done:
                    continue
                if h.cancelled:
                    self._finish(h, "cancelled")
                    continue
                remaining = req.max_new_tokens - produced
                if remaining <= 0:  # had finished, crash beat the retire
                    self._finish(h, "completed")
                    continue
                self._requeue(req, h, produced, remaining)
            self._m_queue_depth.set(len(self._queue))
        del inflight, pending
        # fresh device state: re-admission prefills rewrite every
        # sequence's K/V, and the host tier resets with the radix index.
        # On the card the captured programs hold the pools' addresses, so
        # the pools are zeroed in place and every program stays valid (the
        # reference's keys are shapes: its restart retraces nothing
        # either).  On the CPU (no graphs) they are rebuilt: the old pools
        # go first, so two sets never coexist, and the new ones are made
        # outside inference mode, like the first
        if self._spill is not None:
            self._spill.clear()
        self._bm = self._new_block_manager()
        self._reset_host_buffers()
        if self.device.type == "cuda":
            for p in self._pools:
                p.zero_()
        else:
            self._pools = None
            with torch.inference_mode(False):
                self._pools = tuple(
                    self._adapter.init_pools(self._num_pages + 1))
        self._set_pool_gauges()

    def _requeue(self, req, h, produced, remaining):
        """Put ``req`` back at the FRONT of its queue as prompt +
        tokens-so-far with the remaining budget (under the lock)."""
        prompt = list(req.prompt) + \
            ([int(t) for t in h.token_ids[-produced:]] if produced else [])
        h.status = "queued"
        # the multi-tenant fields ride along; the LEASE is dropped (the
        # re-admission acquires again), and the grammar state lives on the
        # handle, already advanced through every emitted token
        self._queue.appendleft(dataclasses.replace(
            req, prompt=prompt, max_new_tokens=remaining, lease=None))
        self._requeued += 1
        self._m_requeued.inc()

    def _abort_all(self, exc):
        pending, self._admitting = self._admitting, None
        if pending is not None:
            self._release_tenant(pending)
        if pending is not None and not pending.handle.done:
            pending.handle._error = exc
            self._finish(pending.handle, "error")
        for i, s in enumerate(self._slots):
            if s is not None:
                self._bm.free(s.alloc)
                self._release_tenant(s.req)
                self._slots[i] = None
                s.handle._error = exc
                self._finish(s.handle, "error")
        self._reset_host_buffers()
        with self._lock:
            while self._queue:
                req = self._queue.popleft()
                req.handle._error = exc
                self._finish(req.handle, "error")

    # --------------------------------------------------- QoS preemption
    def _queue_pop(self, req):
        """Pop the already-peeked head ``req`` (under the lock).  QoS
        engines pop by identity: preemption may have requeued victims into
        lower tiers between the peek and this pop."""
        if self._qos is not None:
            self._queue.pop_exact(req)
        else:
            self._queue.popleft()

    def _count_preemption(self, req, reason):
        """serving.preemptions: label-less on non-tiered requests (as in
        the reference, whose deadline-expiry series predates QoS),
        ``{tier=,reason=}`` on QoS ones."""
        self._preempt_counts[(reason, req.tier)] += 1
        if req.tier is not None:
            self._m_preempt.inc(tier=req.tier, reason=reason)
        else:
            self._m_preempt.inc()

    def _preempt_victims(self, req):
        """Decode slots ``req`` may evict, cheapest first: strictly
        lower-priority preemptible tiers, lowest priority then least
        produced.  Slots that already hit EOS / budget are skipped."""
        pri = self._qos.tier(req.tier).priority
        out = []
        for i, s in enumerate(self._slots):
            if s is None or s.req.tier is None:
                continue
            pol = self._qos.tier(s.req.tier)
            if not pol.preemptible or pol.priority >= pri:
                continue
            if (s.eos is not None and s.last == s.eos) \
                    or s.produced >= s.max_new:
                continue
            out.append((pol.priority, s.produced, i))
        out.sort()
        return [i for _, _, i in out]

    def _preempt_for_slot(self, req):
        """All slots busy: evict one lower-tier victim so ``req`` admits
        now.  Returns the freed slot index, or None."""
        if self._qos is None or req.tier is None:
            return None
        victims = self._preempt_victims(req)
        if not victims:
            return None
        i = victims[0]
        self._preempt_slot(i)
        return i

    def _preempt_for_pages(self, req):
        """Page pool exhausted: evict lower-tier victims until ``req``'s
        allocation fits — or none at all, if evicting every eligible
        victim still could not cover the need (no thrash)."""
        if self._qos is None or req.tier is None:
            return None
        victims = self._preempt_victims(req)
        if not victims:
            return None
        need = self._bm.pages_for(len(req.prompt) + req.max_new_tokens)
        free = self._bm.num_pages - self._bm.used_pages
        gain = sum(len(self._slots[i].alloc.pages) for i in victims)
        if free + gain < need:
            return None
        for i in victims:
            self._preempt_slot(i)
            alloc = self._bm.allocate(
                req.prompt, len(req.prompt) + req.max_new_tokens)
            if alloc is not None:
                return alloc
        return None

    def _preempt_slot(self, i):
        """Evict slot ``i`` for QoS (under the lock): free its pages, clear
        its lane and requeue it at the FRONT of its tier — the restart
        requeue, scheduled on purpose."""
        s = self._slots[i]
        h = s.handle
        produced = s.produced
        self._bm.free(s.alloc)
        self._release_tenant(s.req)
        self._slots[i] = None
        self._clear_slot_row(i, s)
        if h.cancelled:
            self._finish(h, "cancelled")
            return
        remaining = s.req.max_new_tokens - produced
        if remaining <= 0:      # had finished; eviction beat the retire
            self._finish(h, "completed")
            return
        h.preemptions += 1
        self._requeue(s.req, h, produced, remaining)
        self._count_preemption(s.req, "qos")
        self._last_preempt_t = time.monotonic()
        self._bo_cache = (0.0, None)    # ladder rung changed: drop cache

    def _brownout(self):
        """Current brownout rung (cached ~50 ms)."""
        from .qos import brownout

        now = time.monotonic()
        cached_t, cached = self._bo_cache
        if cached is not None and now - cached_t < 0.05:
            return cached
        preempting = self._last_preempt_t is not None \
            and now - self._last_preempt_t < 1.0
        bo = brownout(self._qos, self.qos_burn_rate(), preempting=preempting)
        self._bo_cache = (now, bo)
        return bo

    def qos_burn_rate(self):
        """The protected (highest-priority) tier's error-budget burn rate;
        0.0 until that tier has completed requests (or on non-QoS
        engines)."""
        if self._qos is None:
            return 0.0
        acct = self._tier_slo.get(self._qos.protected.name)
        if acct is None:
            return 0.0
        cur = acct.current()
        if not cur or cur.get("burn_rate") is None:
            return 0.0
        return float(cur["burn_rate"])

    # ------------------------------------------------------------ admission
    def _admit(self):
        while True:
            with self._lock:
                req = None
                while self._queue:
                    cand = self._queue[0]
                    if cand.handle.cancelled:
                        self._queue.popleft()
                        self._finish(cand.handle, "cancelled")
                        continue
                    if cand.deadline is not None \
                            and time.time() > cand.deadline:
                        self._queue.popleft()
                        self._finish(cand.handle, "expired")
                        continue
                    req = cand
                    break
                if req is None:
                    return
                if req.mode != "generate":
                    # embed / score: no decode slot, no pages — one
                    # dispatch against the scratch page, retired at once
                    # (multi-tenant engine only: this engine's submit
                    # never queues them)
                    if not self._acquire_tenant(req):
                        return          # adapter slots pinned: stay queued
                    self._queue_pop(req)
                    self._m_queue_depth.set(len(self._queue))
                    self._admitting = req
                    alloc = free_slot = None
                else:
                    free_slot = next((i for i, s in enumerate(self._slots)
                                      if s is None), None)
                    if free_slot is None:
                        # QoS: a full batch must not gate high-tier work
                        free_slot = self._preempt_for_slot(req)
                    if free_slot is None:
                        return
                    alloc = self._bm.allocate(
                        req.prompt, len(req.prompt) + req.max_new_tokens)
                    if alloc is None:
                        alloc = self._preempt_for_pages(req)
                    if alloc is None:
                        # FIFO: park until a retirement frees pages
                        self._m_blocked.inc()
                        return
                    if not self._acquire_tenant(req):
                        # the adapter pool is pinned solid: the adapter
                        # analog of page exhaustion — stay queued
                        self._bm.free(alloc)
                        self._m_blocked.inc()
                        return
                    self._queue_pop(req)
                    self._m_queue_depth.set(len(self._queue))
                    # between dequeue and slot assignment the request lives
                    # in _admitting, so a failure mid-prefill still reaches
                    # it
                    self._admitting = req
            if req.mode != "generate":
                self._run_passthrough(req)
            elif self._chunk_tokens \
                    and len(req.prompt) > self._chunk_tokens:
                self._admit_chunked(req, alloc, free_slot)
            else:
                self._prefill(req, alloc, free_slot)

    def _acquire_tenant(self, req):
        """Pin the request's tenant resources (its LoRA adapter slot) for
        its lifetime; False parks it in the queue.  This engine has no
        tenants: always True (the multi-tenant engine overrides)."""
        return True

    def _release_tenant(self, req):
        """Counterpart of :meth:`_acquire_tenant` at retirement."""

    def _run_passthrough(self, req):
        """Run an embed / score request.  Unreachable here: submit
        rejects those modes."""
        raise RuntimeError(
            f"mode={req.mode!r} request reached the base engine scheduler")

    # extension hooks of the multi-tenant engine; this engine's are empty
    def _prefill_extra(self, req):
        """Host arrays appended to a prefill / chunk dispatch's inputs (a
        grammar mask, adapter ids)."""
        return ()

    def _warmup_prefill_extra(self):
        """Request-independent stand-in for :meth:`_prefill_extra` in a
        warmup replay."""
        return self._prefill_extra(None)

    def _step_extra(self):
        """Host arrays appended to the decode dispatch's inputs."""
        return ()

    def _verify_extra(self, active):
        """Host arrays appended to the verify dispatch's inputs (reads the
        draft rows ``_h_ids`` / ``_h_dlen`` the caller just filled)."""
        return ()

    def _filter_draft(self, i, draft):
        """Trim a slot's n-gram draft before verification (a constrained
        row stops at its first grammar-illegal token)."""
        return draft

    def _on_admitted(self, slot, i):
        """A request went live in decode lane ``i`` (its host rows are
        filled)."""

    def _budget_status(self, slot):
        """Terminal status when ``max_new_tokens`` runs out: completion
        here; a grammar row cut off mid-document reports ``truncated`` on
        the multi-tenant engine."""
        return "completed"

    def _prefill_bucket(self, S0):
        """Padded prefill width for a prompt of ``S0`` tokens: multiples of
        page_size up to ``_PREFILL_POW2_PAGES`` pages, then the next
        power-of-two page count (clamped to the table width).  The pad
        region is causally invisible to the logits gather at ``lens-1``."""
        ps = self.page_size
        pages = max(1, -(-int(S0) // ps))
        if pages > _PREFILL_POW2_PAGES:
            pages = 1 << (pages - 1).bit_length()
        return min(pages, self.table_width) * ps

    # ------------------------------------------------------------ programs
    def _store(self):
        from ..text.models._decode import program_store

        return program_store(self._model)

    def _device_label(self):
        return str(self.device)

    def _guard_key(self):
        """Program-store key component of the numeric-guard variant: empty
        when the guard is off, so the unguarded keys stay the reference's
        byte for byte."""
        return ("nguard",) if self._numeric_guard else ()

    def _pool_key(self):
        """The pools' static axes in a key: shape and dtype as the
        reference spells them (``(L, P, ps, h, d)``, ``"bfloat16"``)."""
        p = self._pools[0]
        return tuple(int(n) for n in p.shape), \
            str(p.dtype).removeprefix("torch.")

    # program-store key builders — shared by the mint sites, the dispatch
    # sites' compile windows and warmup() replay
    def _step_store_key(self):
        return ("serve_step", self.num_slots, self.table_width,
                *self._pool_key(), self._top) + self._guard_key()

    def _verify_store_key(self, k_pad):
        return ("verify", k_pad, self.num_slots, self.table_width,
                *self._pool_key(), self._top) + self._guard_key()

    def _prefill_store_key(self, s_pad):
        return ("serve_prefill", s_pad, self.table_width,
                *self._pool_key(), self._top) + self._guard_key()

    def _prefill_chunk_store_key(self, c_pad):
        return ("serve_prefill_chunk", c_pad, self.table_width,
                *self._pool_key(), self._top) + self._guard_key()

    def _prefill_family(self, s_pad):
        return f"prefill/{s_pad}{self._fam_suffix}"

    def _prefill_chunk_family(self, c):
        return f"prefill_chunk/{c}{self._fam_suffix}"

    def _prefill_cached_family(self, c, cached_pages):
        """A radix cached-tail dispatch: the chunk program at width ``c``,
        attributed to its own family (tail-only compute)."""
        return f"prefill/{c}@cached{cached_pages}{self._fam_suffix}"

    def _decode_family(self):
        return f"decode{self._flash_tag}{self._fam_suffix}"

    def _verify_family(self):
        return f"verify/k{self._spec_k}{self._fam_suffix}"

    def _program(self, key, family):
        """The store entry of ``key`` — ``(kind, [mints])`` — minting it
        (and its ledger row) when the model's store has none."""
        store = self._store()
        ent = store.get(key)
        if ent is None:
            t0 = time.perf_counter()
            ent = store[key] = (key[0], [0])
            _programs.ledger().record_mint(
                key, family=family, replica=self.replica,
                device=self._device_label(), store=store,
                owner=self._model, build_s=time.perf_counter() - t0)
        return ent

    @property
    def step_traces(self):
        """Mint count of this engine's decode-step key (the continuous
        batching invariant: 1 for the model's lifetime)."""
        try:
            return self._program(self._step_store_key(),
                                 self._decode_family())[1][0]
        except Exception:
            return 0

    def _dispatch(self, key, mint_family, family, counter, handles, fn,
                  host, inject):
        """Run the program of ``key`` on host inputs ``host`` (and the
        guard's ``inject`` vector, or None): fill its static buffers, run
        it (on this engine's first dispatch of the key the eager step and,
        on the card, its capture; a replay after that), and bring its
        packed outputs to the host — the dispatch's one sync.  Returns
        ``(packed host array, stats row or None)``.

        The key's first dispatch for the model's store is its mint: a
        compile window bills the stall to ``handles``, the ledger records
        it and ``counter`` counts it.  A first dispatch by this engine of
        a key another engine minted (a capture over this engine's pools)
        is billed to ``handles`` too, and counted nowhere.  Warm
        dispatches record their wall in the perf table."""
        _, traces = self._program(key, mint_family)
        n0 = traces[0]
        prog = self._graphs.get(key)
        if prog is None:
            arrays = (*host, inject) if inject is not None else host
            # the program reaches this engine by weak reference: the engine
            # and its graphs go with the last strong reference to it, not
            # at the next garbage collection
            fn, ref = weakref.WeakMethod(fn), weakref.ref(self)
            prog = self._graphs[key] = Program(
                lambda *a, **kw: fn()(*a, **kw),
                [(a.shape, torch.from_numpy(np.asarray(a)).dtype)
                 for a in arrays], self.device, pool=self._graph_pool,
                generator=self._gen,
                cost_fn=lambda: ref()._program_cost(key))
        first = prog.runs == 0
        # this engine's first dispatch of the key captures it on the card,
        # whoever minted it (on the CPU only a mint is a first dispatch)
        capture = first and prog.device.type == "cuda"
        if first and _perf.needs_cost(family):
            _perf.register_cost_thunk(family, _perf.jit_cost_thunk(prog))
        win = _programs.ledger().compile_window(
            key, family=family, replica=self.replica,
            device=self._device_label(), store=self._store(),
            owner=self._model, handles=handles, engine=self,
            cold=n0 == 0 or capture)
        t0 = time.perf_counter()
        try:
            prog.feed(*host, *(() if inject is None else (inject,)))
            packed, stats = prog()
            out = packed.cpu().numpy()
            if stats is not None:
                stats = stats.clone()   # a replay rewrites the static row
            if n0 == 0:
                traces[0] = 1
            win.attach(prog, None)
        finally:
            win.close(traced=traces[0] > n0)
            self._progress_t = time.monotonic()
        elapsed = time.perf_counter() - t0
        if traces[0] > n0:
            counter.inc(traces[0] - n0)
        elif capture:
            # this engine's capture of a key minted elsewhere: the waiting
            # requests paid it, as they pay a mint (not counted as one)
            for h in handles:
                if h is not None and h.first_token_at is None:
                    h.compile_s += elapsed
        elif n0:
            _perf.record(family, elapsed)
        return out, stats

    def _program_cost(self, key):
        """(flops, bytes) of one dispatch of the program of ``key``: its
        function on a copy of the static inputs, over the live pools, which
        the count reads and never writes; it draws nothing from the
        engine's generator (:func:`~..observability.perf.count_cost`).
        No pool is copied: a server's pools may fill the card."""
        prog = self._graphs[key]
        inputs = [t.clone() for t in prog.inputs]
        return _perf.count_cost(lambda: prog.fn(*inputs),
                                protect=self._pools)

    def _sample(self, logits, temps):
        """Tokens ``[B]`` for ``logits [B, V]`` at device ``temps [B]``:
        the Gumbel-max draw of :func:`make_batched_sampler` from this
        engine's generator (greedy rows exact argmax), inside the program
        (no host branch on the temperatures)."""
        return self._sampler(logits, temps, self._gen)

    def _tail(self, logits, temps, inject):
        """A program's outputs from its logits ``[B, V]``: ``(packed,
        stats)`` — ``[1 or 2, B]`` int64 (the tokens, then the numeric
        guard's non-finite row flags) and the guard's logits stats row.
        With the guard, the ``inject`` vector (zeros, or NaN in one lane
        when ``numerics.nan_inject`` tripped) is added first: it is always
        an argument of a guarded program."""
        if inject is None:
            return self._sample(logits, temps)[None], None
        logits = logits + inject[:, None]
        bad = nonfinite_rows(logits)
        stats = _numerics.stats_row(logits, _numerics.low_dtype())[None]
        return torch.stack([self._sample(logits, temps), bad.long()]), stats

    def _step_fn(self, last, table, lens, temps, inject=None):
        logits, *_ = self._adapter.step(last, *self._pools, table, lens)
        return self._tail(logits, temps, inject)

    def _prefill_fn(self, ids, table, lens, temps, inject=None):
        logits, *_ = self._adapter.prefill(ids, *self._pools, table, lens)
        return self._tail(logits, temps, inject)

    def _chunk_fn(self, ids, nvalid, table, lens, temps, inject=None):
        logits, *_ = self._adapter.prefill_chunk(ids, nvalid, *self._pools,
                                                 table, lens)
        return self._tail(logits, temps, inject)

    def _verify_fn(self, ids, table, lens, dlen, temps, inject=None):
        logits, *_ = self._adapter.verify(ids, *self._pools, table, lens)
        parts = []
        stats = None
        if inject is not None:
            logits = logits + inject[:, None, None]
            parts.append(nonfinite_rows(logits).long()[:, None])
            stats = _numerics.stats_row(logits, _numerics.low_dtype())[None]
        targets, accept = self._verifier(logits, ids[:, 1:], dlen, temps,
                                         self._gen)
        return torch.cat([targets, accept.long()] + parts, dim=1), stats

    def _guard_stats(self, stats, step):
        """Numeric guard: park a dispatch's logits stats row on this
        engine's numerics stream at ``step`` (the iteration its tokens
        belong to, as the reference numbers it) — a device row, resolved
        by ``numerics.poll`` off the step, never here."""
        _numerics.submit(self._provider_key, ("logits",), stats, step=step)

    def _prefill(self, req, alloc, slot_idx):
        if req.handle.admitted_at is None:   # TTFT decomposition: queue_s
            req.handle.admitted_at = time.time()
        S0 = len(req.prompt)
        # hierarchical KV cache: leading pages the radix index matched (or
        # the spill tier resurrected) already hold their K/V — run only the
        # divergent tail, clamped so at least the last prompt position is
        # computed (its logits seed the first token)
        cached = min(alloc.cached_pages * self.page_size, S0 - 1) \
            if alloc.cached_pages else 0
        table_row = np.asarray(alloc.pages, np.int32)
        table = np.full((1, self.table_width), self._scratch, np.int32)
        table[0, :len(table_row)] = table_row
        temps = np.asarray([req.sampling.temperature], np.float32)
        h = req.handle
        extra = self._prefill_extra(req)
        inject = self._numeric_inject(1) if self._numeric_guard else None
        t0 = time.perf_counter()
        if cached > 0:
            # ONE dispatch of the chunk program over the tail at positions
            # cached..S0-1 (K3 / K4 through paged_chunk_attend on the
            # card), at the tail's prefill bucket
            tail = S0 - cached
            C = self._prefill_bucket(tail)
            ids = np.zeros((1, C), np.int64)
            ids[0, :tail] = req.prompt[cached:]
            with _tracing.span("serving.prefill_cached", trace_id=h.trace_id,
                               request_id=h.request_id, slot=slot_idx,
                               prompt_len=S0, cached_tokens=cached):
                out, stats = self._dispatch(
                    self._prefill_chunk_store_key(C),
                    self._prefill_chunk_family(C),
                    self._prefill_cached_family(C, alloc.cached_pages),
                    self._m_prefill_traces, (h,), self._chunk_fn,
                    (ids, np.asarray([tail], np.int32), table,
                     np.asarray([cached], np.int32), temps, *extra), inject)
        else:
            s_pad = self._prefill_bucket(S0)
            ids = np.zeros((1, s_pad), np.int64)
            ids[0, :S0] = req.prompt
            fam = self._prefill_family(s_pad)
            with _tracing.span("serving.prefill", trace_id=h.trace_id,
                               request_id=h.request_id, slot=slot_idx,
                               prompt_len=S0):
                out, stats = self._dispatch(
                    self._prefill_store_key(s_pad), fam, fam,
                    self._m_prefill_traces, (h,), self._prefill_fn,
                    (ids, table, np.asarray([S0], np.int32), temps, *extra),
                    inject)
        self._m_prefill_seconds.observe(time.perf_counter() - t0)
        tok, bad = out[0], (out[1].astype(bool) if inject is not None
                            else None)
        if stats is not None:
            self._guard_stats(stats, self._iteration)
        self._prefills += 1
        self._cached_prefills += cached > 0
        if bad is not None and bad[0]:
            # non-finite first-token logits: fail THIS request before it
            # ever occupies a decode lane
            h._error = NumericFault(
                "non-finite logits at prefill", site="logits",
                stream=f"serving/{self.replica}", step=self._iteration)
            self._numeric_faults += 1
            self._m_numeric_faults.inc()
            self._bm.free(alloc)
            self._release_tenant(req)
            self._admitting = None
            self._finish(h, "error")
            return
        slot = _Slot(req, alloc, table_row)
        req.handle.status = "running"
        self._slots[slot_idx] = slot
        self._admitting = None
        self._go_live(slot_idx, slot, int(tok[0]))

    def _go_live(self, i, slot, tok):
        """Slot ``i``'s prompt is in the pools and ``tok`` is its first
        token: fill its host row for the decode steps, seed the drafter,
        emit the token."""
        slot.last = tok
        slot.produced = 1
        slot.idx = i
        self._h_table[i, :len(slot.table_row)] = slot.table_row
        self._h_lens[i] = slot.length
        self._h_temps[i] = slot.temp
        self._h_last[i, 0] = tok
        self._on_admitted(slot, i)
        if self._drafter is not None:
            self._drafter.register(i, slot.req.prompt)
            self._drafter.extend(i, [tok])
        self._emit_token(slot, tok)
        self._retire_if_done(i)

    # ------------------------------------------------- chunked prefill
    def _admit_chunked(self, req, alloc, slot_idx):
        """Admit a long prompt without running its prefill: the slot goes
        live at once and ingests chunk by chunk in
        :meth:`_advance_prefills`, interleaved with decode, starting past
        the cached pages of a radix hit (clamped so the final chunk
        computes at least the last prompt position).  Its host row stays
        inert until the final chunk seeds decode."""
        if req.handle.admitted_at is None:   # TTFT decomposition: queue_s
            req.handle.admitted_at = time.time()
        slot = _Slot(req, alloc, np.asarray(alloc.pages, np.int32))
        slot.idx = slot_idx
        slot.prefilled = min(alloc.cached_pages * self.page_size,
                             max(len(req.prompt) - 1, 0))
        req.handle.status = "running"
        self._slots[slot_idx] = slot
        self._admitting = None

    def _advance_prefills(self):
        """One iteration's chunked-prefill work: up to
        ``prefill_chunk_tokens`` prompt tokens across the slots mid-prefill,
        round-robin so concurrent long prompts share the budget.  Cancelled
        and expired slots retire here: they never reach a decode lane."""
        if not self._chunk_tokens:
            return
        prefilling = [i for i, s in enumerate(self._slots)
                      if s is not None and s.prefilled is not None]
        start = self._prefill_rr
        budget = self._chunk_tokens
        for i in sorted(prefilling, key=lambda i: (i - start) % self.num_slots):
            if budget <= 0:
                return
            s = self._slots[i]
            if s is None or s.prefilled is None:
                continue
            h = s.handle
            if h.cancelled or (s.deadline is not None
                               and time.time() > s.deadline):
                status = "cancelled" if h.cancelled else "expired"
                if status == "expired":
                    self._count_preemption(s.req, "deadline")
                self._bm.free(s.alloc)
                self._release_tenant(s.req)
                self._slots[i] = None
                self._clear_slot_row(i, s)
                self._finish(h, status)
                continue
            budget -= self._prefill_chunk_step(i, s)
            self._prefill_rr = (i + 1) % self.num_slots

    def _prefill_chunk_step(self, i, slot):
        """Run ONE chunk of slot ``i``'s prompt: tokens ``prefilled ..
        prefilled + C - 1`` (right-padded on the last chunk) at those
        positions.  Pad-lane K/V lands past the valid length (or is dropped
        past the table) and the first decode write overwrites it.  The
        final chunk's token (sampled only there) seeds decode.  Returns the
        prompt tokens ingested (the budget unit)."""
        req = slot.req
        C = self._chunk_tokens
        S0 = len(req.prompt)
        c0 = slot.prefilled
        nval = min(C, S0 - c0)
        ids = np.zeros((1, C), np.int64)
        ids[0, :nval] = req.prompt[c0:c0 + nval]
        table = np.full((1, self.table_width), self._scratch, np.int32)
        table[0, :len(slot.table_row)] = slot.table_row
        h = slot.handle
        extra = self._prefill_extra(req)
        inject = self._numeric_inject(1) if self._numeric_guard else None
        fam = self._prefill_chunk_family(C)
        t0 = time.perf_counter()
        # every chunk runs the same program (it samples; only the final
        # chunk's token is used) and is guarded all the same
        with _tracing.span("serving.prefill_chunk", trace_id=h.trace_id,
                           request_id=h.request_id, slot=i, chunk_start=c0,
                           chunk_tokens=nval):
            out, stats = self._dispatch(
                self._prefill_chunk_store_key(C), fam, fam,
                self._m_prefill_chunk_traces, (h,), self._chunk_fn,
                (ids, np.asarray([nval], np.int32), table,
                 np.asarray([c0], np.int32),
                 np.asarray([slot.temp], np.float32), *extra), inject)
        self._m_prefill_chunk_seconds.observe(time.perf_counter() - t0)
        self._prefill_chunks += 1
        final = c0 + nval >= S0
        tok, bad = out[0], (out[1].astype(bool) if inject is not None
                            else None)
        if stats is not None:
            self._guard_stats(stats, self._iteration)
        if bad is not None and bad[0]:
            self._fail_numeric(i)
            return nval
        slot.prefilled = c0 + nval
        if not final:
            return nval
        self._prefills += 1
        slot.prefilled = None
        self._go_live(i, slot, int(tok[0]))
        return nval

    # ------------------------------------------------------------ decode
    def _step_once(self):
        """One decode iteration over the lanes that finished ingesting
        (mid-prefill lanes stay inert in the dispatch).  The fault sites
        sit before the dispatch, plain or verify."""
        _faults.maybe("serving.step_crash")
        _faults.maybe(self._site_step_crash)
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefilled is None]
        if self._spec_k:
            return self._verify_once(active)
        return self._plain_step(active)

    def _numeric_inject(self, B):
        """The ``[B]`` f32 vector a guarded dispatch adds to its logits:
        zeros disarmed, NaN in lane :func:`~..observability.numerics.
        nan_inject_row` when the ``numerics.nan_inject`` fault tripped
        since the last call."""
        inj = np.zeros((B,), np.float32)
        v = _numerics.consume_nan_inject()
        if not np.isfinite(v):
            inj[_numerics.nan_inject_row() % B] = v
        return inj

    def _fail_numeric(self, i):
        """Retire lane ``i`` with a numeric fault: exactly this request
        errors (``status="error"``, :class:`NumericFault`), its pages free
        and the lane backfills at the next admit."""
        slot = self._slots[i]
        h = slot.handle
        h._error = NumericFault(
            f"non-finite logits in decode lane {i}", site="logits",
            stream=f"serving/{self.replica}", step=self._iteration)
        self._numeric_faults += 1
        self._m_numeric_faults.inc()
        self._bm.free(slot.alloc)
        self._release_tenant(slot.req)
        self._slots[i] = None
        self._clear_slot_row(i, slot)
        self._finish(h, "error")

    def _plain_step(self, active):
        """One decode step for every lane; inactive lanes (length 0,
        all-scratch table row) compute junk nobody reads."""
        handles = [self._slots[i].handle for i in active]
        if _tracing._ACTIVE:
            # one span per batched iteration, LINKING every active
            # request's trace id (a decode step serves many traces at once)
            cm = _tracing.span(
                "serving.decode_step", iteration=self._iteration,
                batch=len(active), links=[h.trace_id for h in handles])
        else:  # hot path: one flag read, no span or link list built
            cm = _tracing.NOOP
        extra = self._step_extra()
        inject = self._numeric_inject(self.num_slots) \
            if self._numeric_guard else None
        fam = self._decode_family()
        t0 = time.perf_counter()
        with cm:
            out, stats = self._dispatch(
                self._step_store_key(), fam, fam, self._m_step_traces,
                handles, self._step_fn,
                (self._h_last, self._h_table, self._h_lens, self._h_temps,
                 *extra), inject)
        self._m_step_seconds.observe(time.perf_counter() - t0)
        tok, bad = out[0], (out[1].astype(bool) if inject is not None
                            else None)
        if stats is not None:
            self._guard_stats(stats, self._iteration + 1)
        self._iteration += 1
        for i in active:
            if bad is not None and bad[i]:
                # this lane's logits went non-finite: fail exactly it
                self._fail_numeric(i)
                continue
            s = self._slots[i]
            s.length += 1
            s.produced += 1
            s.last = int(tok[i])
            self._h_lens[i] = s.length
            self._h_last[i, 0] = s.last
            self._emit_token(s, s.last)
            if not self._retire_if_done(i) and self._drafter is not None:
                # a speculative engine steps plainly when nothing was
                # drafted: the drafter's context must keep growing
                self._drafter.extend(i, [s.last])

    def _verify_once(self, active):
        """One speculative iteration: draft up to k tokens per slot, verify
        them with the pending last token in ONE multi-token step, then emit
        the longest accepted prefix plus the bonus / resample token per
        slot, with the retire checks after every emitted token.  When no
        slot drafted anything, the plain step gives the same tokens for
        less work."""
        K = self._spec_k
        drafts = {}
        for i in active:
            s = self._slots[i]
            self._h_ids[i, 0] = s.last
            self._h_ids[i, 1:] = 0
            # never draft past the budget or the position cap: the bonus
            # token always lands, so at most remaining - 1 drafts fit
            cap = min(K, s.max_new - s.produced - 1,
                      self.max_model_len - s.length - 1)
            d = self._drafter.propose(i, cap) if cap > 0 else []
            d = self._filter_draft(i, d)
            self._h_ids[i, 1:1 + len(d)] = d
            self._h_dlen[i] = len(d)
            drafts[i] = d
        if not any(drafts.values()):
            return self._plain_step(active)
        handles = [self._slots[i].handle for i in active]
        if _tracing._ACTIVE:
            cm = _tracing.span(
                "serving.verify_step", iteration=self._iteration,
                batch=len(active), k=K,
                drafted=int(sum(len(drafts[i]) for i in active)),
                links=[h.trace_id for h in handles])
        else:
            cm = _tracing.NOOP
        extra = self._verify_extra(active)
        inject = self._numeric_inject(self.num_slots) \
            if self._numeric_guard else None
        fam = self._verify_family()
        t0 = time.perf_counter()
        with cm:
            # the (k+1)-wide verify program (k_pad = speculative_k, as the
            # reference pads it); one transfer to the host: the step's sync
            out, stats = self._dispatch(
                self._verify_store_key(K), fam, fam, self._m_verify_traces,
                handles, self._verify_fn,
                (self._h_ids, self._h_table, self._h_lens, self._h_dlen,
                 self._h_temps, *extra), inject)
        self._m_step_seconds.observe(time.perf_counter() - t0)
        if stats is not None:
            self._guard_stats(stats, self._iteration + 1)
        targets, accept = out[:, :K + 1], out[:, K + 1:2 * K + 1].astype(bool)
        bad = out[:, -1].astype(bool) if self._numeric_guard else None
        self._iteration += 1
        self._verify_steps += 1
        proposed = accepted = 0
        for i in active:
            if bad is not None and bad[i]:
                self._fail_numeric(i)
                continue
            s = self._slots[i]
            d = drafts[i]
            a = 0
            while a < len(d) and accept[i, a]:
                a += 1
            proposed += len(d)
            emitted = [int(t) for t in d[:a]] + [int(targets[i, a])]
            # positions length .. length + a now hold the old last token
            # and the accepted drafts; the rejected tail sits past the new
            # length (rollback = the length does not advance over it)
            done = False
            n = 0
            for tok in emitted:
                s.length += 1
                s.produced += 1
                s.last = tok
                self._h_lens[i] = s.length
                self._h_last[i, 0] = tok
                self._emit_token(s, tok)
                n += 1
                if self._retire_if_done(i):
                    done = True
                    break
            # accepted = drafts that became output tokens (an early
            # retirement discards the rest)
            accepted += min(n, a)
            if not done:
                self._drafter.extend(i, emitted)
        if proposed:
            self._m_spec_proposed.inc(proposed)
            self._spec_proposed_total += proposed
        if accepted:
            self._m_spec_accepted.inc(accepted)
            self._spec_accepted_total += accepted
        if self._spec_proposed_total:
            self._m_accept_rate.set(
                self._spec_accepted_total / self._spec_proposed_total)

    def _emit_token(self, slot, tok):
        h = slot.handle
        now = time.time()
        # QoS engines label the latency histograms per tier; non-tiered
        # requests keep the label-less children
        tier = slot.req.tier
        if h.first_token_at is None:
            h.first_token_at = now
            if tier is not None:
                self._m_ttft.observe(now - h.submitted_at, tier=tier)
            else:
                self._m_ttft.observe(now - h.submitted_at)
            if h.compile_s > 0.0:
                # waited out a kernel build: the cold subset, a parallel
                # family so serving.ttft_seconds stays whole
                self._m_ttft_cold.observe(now - h.submitted_at)
        elif slot.last_token_t is not None:
            if tier is not None:
                self._m_itl.observe(now - slot.last_token_t, tier=tier)
            else:
                self._m_itl.observe(now - slot.last_token_t)
        slot.last_token_t = now
        h.token_ids.append(tok)
        h.token_times.append(now)
        h._events.put(("token", tok))
        self._m_tokens.inc()

    def _retire_if_done(self, i):
        slot = self._slots[i]
        h = slot.handle
        status = None
        if h.cancelled:
            status = "cancelled"
        elif slot.eos is not None and slot.last == slot.eos:
            status = "completed"
        elif slot.produced >= slot.max_new:
            status = self._budget_status(slot)
        elif slot.deadline is not None and time.time() > slot.deadline:
            status = "expired"
            self._count_preemption(slot.req, "deadline")
        if status is None:
            return False
        self._bm.free(slot.alloc)
        self._release_tenant(slot.req)
        self._slots[i] = None
        self._clear_slot_row(i, slot)
        self._finish(h, status)
        return True

    def _clear_slot_row(self, i, slot):
        """Point slot ``i``'s host row at scratch again, so the next
        dispatch treats the lane as inactive (``slot`` is the request that
        held it)."""
        self._h_table[i, :] = self._scratch
        self._h_lens[i] = 0
        self._h_temps[i] = 0.0
        self._h_last[i, 0] = 0
        if self._drafter is not None:
            self._drafter.release(i)

    def _reset_host_buffers(self):
        self._h_table[:] = self._scratch
        self._h_lens[:] = 0
        self._h_temps[:] = 0.0
        self._h_last[:] = 0
        if self._drafter is not None:
            self._drafter.reset()

    def _finish(self, handle, status):
        self._release_hbm(handle)
        handle.status = status
        handle.finished_at = time.time()
        if status == "completed":
            # completed-request duration EMAs feed deadline-aware shedding
            # (per tier too: a slow batch request must not inflate the
            # realtime estimate)
            dur = handle.finished_at - handle.submitted_at
            self._ema_request_s = dur if self._ema_request_s is None \
                else 0.8 * self._ema_request_s + 0.2 * dur
            if handle.tier is not None:
                prev = self._tier_ema.get(handle.tier)
                self._tier_ema[handle.tier] = dur if prev is None \
                    else 0.8 * prev + 0.2 * dur
        if status in ("completed", "expired") \
                and handle.mode == "generate":
            # expired = the deadline preempted it: an SLO miss by
            # definition; cancelled / stopped / error requests measure the
            # caller or the engine, not the latency promise
            miss = False if status == "expired" else None
            for acct in (self._slo, self._tier_slo.get(handle.tier)):
                if acct is not None:
                    acct.observe(handle, met_override=miss)
        self._m_requests.inc(status=status)
        handle._events.put(("done", status))
        handle._done.set()

    def _update_gauges(self):
        """Refresh the occupancy / pool / health / tier gauges (throttled:
        gauges are dashboards, not control flow; queue_depth is also set
        where it changes), sample the quant-drift gauge, and resolve this
        engine's numerics stream (the one small sync, off the step)."""
        now = time.monotonic()
        if now - self._gauges_t < 0.05:
            return
        self._gauges_t = now
        n = sum(1 for s in self._slots if s is not None)
        self._m_queue_depth.set(len(self._queue))
        self._m_active.set(n)
        self._m_occupancy.set(n / self.num_slots)
        self._m_page_util.set(self._bm.utilization())
        self._m_pages_used.set(self._bm.used_pages)
        self._m_health.set(_HEALTH_CODE.get(self.health, 1))
        if self._qos is not None:
            for tname, depth in self._queue.depths().items():
                self._m_tier_depth.set(depth, tier=tname)
            for tname, cnt in self._active_by_tier().items():
                self._m_tier_active.set(cnt, tier=tname)
        if self.weight_dtype == "int8" and now - self._drift_t > 5.0:
            # a slow dashboard (a host-side weight walk): one sampled
            # layer every few seconds, never per step
            self._drift_t = now
            self._quant_drift_tick()
        if self._numeric_guard and now - self._npoll_t > 0.5:
            # never raising: per-row failure is the guard's job, and an
            # abort-level checker must not kill the scheduler thread
            self._npoll_t = now
            _numerics.poll(self._provider_key, raise_on_fault=False)

    def _quant_drift_tick(self):
        """Sampled quantization-drift gauge (int8-weight engines): one
        ``Int8Linear`` per tick, dequantize its stored payload and measure
        the requantize-on-fresh-absmax roundtrip error — drift above the
        rounding floor means the frozen ``w_scale`` no longer matches the
        weights it quantized."""
        from ..quantization import Int8Linear

        layers = [m for m in self._model.modules()
                  if isinstance(m, Int8Linear)]
        if not layers:
            return
        m = layers[self._drift_idx % len(layers)]
        self._drift_idx += 1
        q = m.weight_int8.detach().to("cpu", torch.float32).numpy()
        w = q * np.float32(m.w_scale)
        amax = float(np.abs(w).max())
        if amax <= 0.0:
            self._m_quant_drift.set(0.0)
            return
        s2 = amax / m._qmax
        q2 = np.clip(np.rint(w / s2), -m._qmax, m._qmax)
        drift = float(np.mean(np.abs(q2 * s2 - w))) / amax
        self._m_quant_drift.set(drift)

    def _active_by_tier(self):
        active = dict.fromkeys(self._qos.names, 0)
        for s in self._slots:
            if s is not None and s.req.tier in active:
                active[s.req.tier] += 1
        return active

    # --------------------------------------------------------------- health
    def health_state(self):
        """The health state machine:

        - ``healthy`` — scheduler progressing, queue under pressure limits;
        - ``degraded`` — serving, but queue pressure, a stalled scheduler,
          a recent auto-restart or a QoS brownout says trouble (``reasons``
          lists which);
        - ``draining`` — graceful rundown, no new admissions;
        - ``stopped`` / ``error`` — not serving.
        """
        if self._error is not None:
            return {"state": "error", "reasons": [repr(self._error)]}
        if self._draining:
            return {"state": "draining", "reasons": ["drain requested"]}
        if not self._started:
            return {"state": "stopped", "reasons": []}
        reasons = []
        qd = len(self._queue)
        if self._max_queue and qd >= max(1, int(0.8 * self._max_queue)):
            reasons.append(f"queue_pressure:{qd}/{self._max_queue}")
        stamp = self._progress_t
        busy = qd or any(s is not None for s in self._slots)
        if busy and stamp is not None and not self._compiling:
            age = time.monotonic() - stamp
            if age > self._degraded_stall_s:
                reasons.append(f"scheduler_stalled:{age:.2f}s")
        if self._last_restart_t is not None and \
                time.monotonic() - self._last_restart_t \
                < self._restart_cooldown_s:
            reasons.append(f"recent_restart:{self._engine_restarts}")
        if self._qos is not None:
            bo = self._brownout()
            if bo["level"]:
                reasons.append(f"brownout:L{bo['level']}:{bo['state']}")
        return {"state": "degraded" if reasons else "healthy",
                "reasons": reasons}

    @property
    def health(self):
        return self.health_state()["state"]

    # -------------------------------------------------------------- insight
    @property
    def block_manager(self):
        return self._bm

    @property
    def slo_accountant(self):
        """The engine's SLO accountant (None unless ``slo=`` was set)."""
        return self._slo

    def stats(self):
        def by_reason(counts):
            out = {}
            for (reason, _), n in counts.items():
                out[reason] = out.get(reason, 0) + n
            return out

        st = {
            "device": str(self.device),
            "replica": self.replica,
            "iteration": self._iteration,
            "prefills": self._prefills,
            "cached_prefills": self._cached_prefills,
            "prefill_chunks": self._prefill_chunks,
            "verify_steps": self._verify_steps,
            "queue_depth": len(self._queue),
            "active_slots": sum(1 for s in self._slots if s is not None),
            "prefilling_slots": sum(
                1 for s in self._slots
                if s is not None and s.prefilled is not None),
            "num_slots": self.num_slots,
            "pages_in_use": self._bm.used_pages,
            "free_pages": self._bm.free_pages,
            "num_pages": self._bm.num_pages,
            "page_utilization": self._bm.utilization(),
            "step_traces": self.step_traces,
            "bytes_per_page": self._bytes_per_page,
            # what the pools are made of and what a token costs in them
            # (scale pools included)
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "pool_dtype": self._pool_dtype,
            "kv_bytes_per_token": self._bytes_per_page / self.page_size,
            # speculative decoding: drafts verified / drafts emitted
            "spec_proposed": self._spec_proposed_total,
            "spec_accepted": self._spec_accepted_total,
            "prefill_chunk_tokens": self._chunk_tokens,
            "numeric_guard": self._numeric_guard,
            # resilience: lifetime counts
            "health": self.health,
            "health_gating": self._health_gating,
            "engine_restarts": self._restarts_total,
            "requests_requeued": self._requeued,
            "load_shed": by_reason(self._shed_counts),
            "preemptions": by_reason(self._preempt_counts),
            "numeric_faults": self._numeric_faults,
            "typical_request_s": self._ema_request_s,
            "watchdog_fires": len(self._watchdog.fired)
            if self._watchdog is not None else 0,
            "error": repr(self._error) if self._error is not None else None,
        }
        if self._prefix_cache is not None:
            st["prefix_cache"] = self._bm.stats()["prefix_cache"]
            summ = self.prefix_index_summary()
            if summ is not None:
                st["prefix_index"] = summ
        if self._slo is not None:
            st["slo"] = self._slo.summary()
        if self._qos is not None:
            st["qos"] = {
                "config": self._qos.to_dict(),
                "brownout": self._brownout(),
                "queue_by_tier": self._queue.depths(),
                "active_by_tier": self._active_by_tier(),
                "typical_request_s_by_tier": dict(self._tier_ema),
                "slo_by_tier": {name: acct.summary()
                                for name, acct in self._tier_slo.items()},
                "load_shed_by_tier": {
                    f"{reason}@{tier}": n
                    for (reason, tier), n in self._shed_counts.items()
                    if tier is not None},
                "preemptions_by_tier": {
                    f"{reason}@{tier}": n
                    for (reason, tier), n in self._preempt_counts.items()
                    if tier is not None},
            }
        return st

    def _statusz(self):
        """/statusz provider: stats + the live slot table (a diagnostic
        snapshot — reads race the scheduler thread benignly; no engine
        lock is taken)."""
        st = self.stats()
        st["kv_cache"] = self._bm.stats()
        # this replica's ledger owner rows, the pool tuple's per-dtype
        # residency and the admission pre-flight state.  (The reference
        # also reports pool_shard_bytes_by_dtype, the per-chip share under
        # a tensor-parallel mesh; the port has no mesh=, so every pool is
        # whole on one card.)
        st["memory"] = {
            "owners": _obs_memory.ledger().owner_rows(replica=self.replica),
            "pool_bytes_by_dtype": self.pool_bytes_by_dtype(),
            "fixed_bytes": self._fixed_bytes,
            "committed_pages": self._committed_pages,
            "hbm_budget_bytes": _obs_memory.hbm_budget_bytes(),
        }
        st["started"] = self._started
        st["health"] = self.health_state()
        st["draining"] = self._draining
        if self._progress_t is not None:
            st["last_progress_age_s"] = time.monotonic() - self._progress_t
        slots = []
        for i, s in enumerate(self._slots):
            if s is None:
                slots.append(None)
                continue
            slots.append({"slot": i, "request_id": s.handle.request_id,
                          "trace_id": s.handle.trace_id,
                          "status": s.handle.status, "length": s.length,
                          "produced": s.produced, "max_new": s.max_new,
                          "pages": len(s.table_row),
                          "prefilled": s.prefilled})
        st["slots"] = slots
        return st
