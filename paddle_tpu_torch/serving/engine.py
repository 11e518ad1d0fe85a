"""Continuous-batching LLM serving engine (counterpart of
``paddle_tpu/serving/engine.py``, its core scheduler).

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
thread runs under ``torch.inference_mode`` (grad mode is per thread).  A
failure in the scheduler — a CUDA fault surfaces at the next sync, when
the sampled tokens come to the host — fails every in-flight and queued
request with that error and leaves the engine stopped; the TPU package's
transient-restart path waits for a later slice.

The engine runs on the card unless ``device="cpu"``; it moves the model
to its device (``nn.Module.to`` moves in place).

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

Quantized serving: ``kv_dtype="int8"`` stores the page pools as int8 with
parallel float32 scale pools (:class:`~.quant.QuantizedGPTAdapter`; the
writes quantize and decode runs the dequantizing kernel K4), about 1.9x
the resident sequences per pool byte at head_dim 64;
``weight_dtype="int8"`` converts the model's Linears to ``Int8Linear`` in
place (:func:`~.quant.quantize_model_weights`, idempotent).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.retry import EngineStoppedError
from ..text.models._decode import make_batched_sampler
from .adapter import GPTAdapter
from .block_manager import BlockManager

_logger = logging.getLogger("paddle_tpu_torch.serving")

# prefill bucketing: prompts up to this many pages pad to their own page
# count; above it, page counts round up to the next power of two
_PREFILL_POW2_PAGES = 4


class RequestRejectedError(RuntimeError):
    """Raised by submit() for requests the engine can never serve
    (``reason="unservable"``: too long for the model or the page pool), or
    turns away while it drains (``reason="draining"``)."""

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


class RequestHandle:
    """Caller-side view of a submitted request.

    ``result(timeout)`` blocks for the generated ids; ``stream()`` yields
    tokens as the engine produces them (abandoning the iterator cancels
    the request and frees its pages); ``cancel()`` retires it at the next
    iteration."""

    def __init__(self, request_id, prompt_len):
        self.request_id = request_id
        self.prompt_len = prompt_len
        self.token_ids = []            # generated ids (appended by the engine)
        self.status = "queued"
        self.submitted_at = time.time()
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

    def _raise_error(self):
        if isinstance(self._error, EngineStoppedError):
            raise self._error
        raise RuntimeError("serving engine failed") from self._error

    def result(self, timeout=None):
        """Generated token ids (blocks until the request finishes)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished after {timeout}s")
        if self._error is not None:
            self._raise_error()
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
                 "prefilled")

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
                 seed=0, device=None, kv_dtype=None, weight_dtype=None,
                 speculative_k=0, draft_max_ngram=3, draft_min_ngram=1,
                 prefill_chunk_tokens=None):
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
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        if self.weight_dtype == "int8":
            from .quant.weights import quantize_model_weights

            quantize_model_weights(model)
        if kv_dtype == "int8":
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
        self._bm = BlockManager(self._num_pages, self.page_size,
                                prefix_sharing=prefix_sharing,
                                bytes_per_page=self._bytes_per_page,
                                pool_dtype=self._pool_dtype)
        # pool row num_pages is the SCRATCH page: inactive decode slots and
        # padded table tails point at it (every table entry must be a valid
        # pool row; junk written there is never attended)
        self._scratch = int(num_pages)
        self._pools = tuple(self._adapter.init_pools(num_pages + 1))
        self._sampler = make_batched_sampler(top_k, top_p)
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
        self._rid = 0

        self._queue = collections.deque()
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
        self._stop_evt = threading.Event()
        self._thread = None
        self._started = False
        self._draining = False
        self._modes = None
        self._iteration = 0       # decode steps run
        self._prefills = 0        # prefills run (monolithic or chunked)
        self._prefill_chunks = 0  # chunked-prefill dispatches
        self._verify_steps = 0    # speculative verify steps (of _iteration)
        self._error = None
        self._admitting = None    # request popped but not yet slotted

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
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-serving-engine",
                                        daemon=True)
        self._started = True
        self._thread.start()
        return self

    def drain(self, timeout=600):
        """Stop admitting (submits reject with reason ``draining``) and
        wait for the queue and every slot to empty.  Returns True once
        nothing is in flight; raises TimeoutError otherwise."""
        self._draining = True
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if self._error is not None or not self._started:
                return True
            with self._lock:
                empty = not self._queue and self._admitting is None \
                    and all(s is None for s in self._slots)
            if empty:
                return True
            time.sleep(0.01)
        raise TimeoutError(f"engine did not drain within {timeout}s: "
                           f"{self.stats()}")

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
               eos_token_id=None, deadline_s=None):
        """Queue one request; returns a :class:`RequestHandle` at once.
        ``deadline_s`` is a wall-clock budget from now — a sequence still
        queued or decoding past it retires with status ``expired``."""
        prompt = self._normalize_prompt(prompt_ids)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_model_len \
                or self._bm.pages_for(total) > self._bm.num_pages:
            raise RequestRejectedError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"needs {self._bm.pages_for(total)} pages / {total} "
                f"positions; engine caps are {self._bm.num_pages} pages / "
                f"{self.max_model_len} positions", reason="unservable")
        self.start()  # before enqueue: a failed engine rejects loudly
        with self._cv:
            if self._draining:
                raise RequestRejectedError(
                    "engine is draining; not admitting new work",
                    reason="draining")
            handle = RequestHandle(self._rid, len(prompt))
            self._rid += 1
            deadline = time.time() + deadline_s \
                if deadline_s is not None else None
            self._queue.append(Request(
                prompt, int(max_new_tokens),
                SamplingParams(temperature=float(temperature)), eos_token_id,
                deadline, handle))
            self._cv.notify_all()
        return handle

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
    def _loop(self):
        with torch.inference_mode():
            while not self._stop_evt.is_set():
                try:
                    self._admit()
                    # chunked prefill rides the same iteration as the
                    # decode step: one budget of chunk work, then one step
                    # over the lanes that finished ingesting
                    self._advance_prefills()
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
                    # the thread's boundary: fail every waiter, don't hang
                    _logger.exception("serving scheduler failed")
                    self._error = e
                    self._abort_all(e)
                    return

    def _abort_all(self, exc):
        pending, self._admitting = self._admitting, None
        if pending is not None and not pending.handle.done:
            pending.handle._error = exc
            self._finish(pending.handle, "error")
        for i, s in enumerate(self._slots):
            if s is not None:
                self._bm.free(s.alloc)
                self._slots[i] = None
                s.handle._error = exc
                self._finish(s.handle, "error")
        self._reset_host_buffers()
        with self._lock:
            while self._queue:
                req = self._queue.popleft()
                req.handle._error = exc
                self._finish(req.handle, "error")

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
                free_slot = next((i for i, s in enumerate(self._slots)
                                  if s is None), None)
                if free_slot is None:
                    return
                alloc = self._bm.allocate(
                    req.prompt, len(req.prompt) + req.max_new_tokens)
                if alloc is None:
                    return      # FIFO: park until a retirement frees pages
                self._queue.popleft()
                # between dequeue and slot assignment the request lives in
                # _admitting, so a failure mid-prefill still fails its handle
                self._admitting = req
            if self._chunk_tokens and len(req.prompt) > self._chunk_tokens:
                self._admit_chunked(req, alloc, free_slot)
            else:
                self._prefill(req, alloc, free_slot)

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

    def _to_device(self, arr):
        return torch.tensor(arr, device=self.device)

    def _sample(self, logits, temps):
        """Tokens for ``logits [B, V]`` at host ``temps [B]``, on the host
        (this is the step's device sync).  All-greedy batches skip the
        random draw."""
        if (temps > 0).any():
            tok = self._sampler(logits, self._to_device(temps), self._gen)
        else:
            tok = torch.argmax(logits, dim=-1)
        return tok.cpu().numpy()

    def _prefill(self, req, alloc, slot_idx):
        S0 = len(req.prompt)
        s_pad = self._prefill_bucket(S0)
        ids = np.zeros((1, s_pad), np.int64)
        ids[0, :S0] = req.prompt
        table_row = np.asarray(alloc.pages, np.int32)
        table = np.full((1, self.table_width), self._scratch, np.int32)
        table[0, :len(table_row)] = table_row
        lens = np.asarray([S0], np.int32)
        temps = np.asarray([req.sampling.temperature], np.float32)
        logits, *pools = self._adapter.prefill(
            self._to_device(ids), *self._pools, self._to_device(table),
            self._to_device(lens))
        self._pools = tuple(pools)
        tok = int(self._sample(logits, temps)[0])
        self._prefills += 1
        slot = _Slot(req, alloc, table_row)
        req.handle.status = "running"
        self._slots[slot_idx] = slot
        self._admitting = None
        self._go_live(slot_idx, slot, tok)

    def _go_live(self, i, slot, tok):
        """Slot ``i``'s prompt is in the pools and ``tok`` is its first
        token: fill its host row for the decode steps, seed the drafter,
        emit the token."""
        slot.last = tok
        slot.produced = 1
        self._h_table[i, :len(slot.table_row)] = slot.table_row
        self._h_lens[i] = slot.length
        self._h_temps[i] = slot.temp
        self._h_last[i, 0] = tok
        if self._drafter is not None:
            self._drafter.register(i, slot.req.prompt)
            self._drafter.extend(i, [tok])
        self._emit_token(slot, tok)
        self._retire_if_done(i)

    # ------------------------------------------------- chunked prefill
    def _admit_chunked(self, req, alloc, slot_idx):
        """Admit a long prompt without running its prefill: the slot goes
        live at once with ``prefilled=0`` and ingests chunk by chunk in
        :meth:`_advance_prefills`, interleaved with decode.  Its host row
        stays inert until the final chunk seeds decode."""
        slot = _Slot(req, alloc, np.asarray(alloc.pages, np.int32))
        slot.prefilled = 0
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
            h = s.handle
            if h.cancelled or (s.deadline is not None
                               and time.time() > s.deadline):
                self._bm.free(s.alloc)
                self._slots[i] = None
                self._clear_slot_row(i)
                self._finish(h, "cancelled" if h.cancelled else "expired")
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
        logits, *pools = self._adapter.prefill_chunk(
            self._to_device(ids), self._to_device(np.asarray([nval], np.int32)),
            *self._pools, self._to_device(table),
            self._to_device(np.asarray([c0], np.int32)))
        self._pools = tuple(pools)
        self._prefill_chunks += 1
        slot.prefilled = c0 + nval
        if slot.prefilled < S0:
            return nval
        tok = int(self._sample(logits, np.asarray([slot.temp], np.float32))[0])
        self._prefills += 1
        slot.prefilled = None
        self._go_live(i, slot, tok)
        return nval

    # ------------------------------------------------------------ decode
    def _step_once(self):
        """One decode iteration over the lanes that finished ingesting
        (mid-prefill lanes stay inert in the dispatch)."""
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefilled is None]
        if self._spec_k:
            return self._verify_once(active)
        return self._plain_step(active)

    def _plain_step(self, active):
        """One decode step for every lane; inactive lanes (length 0,
        all-scratch table row) compute junk nobody reads."""
        logits, *pools = self._adapter.step(
            self._to_device(self._h_last), *self._pools,
            self._to_device(self._h_table), self._to_device(self._h_lens))
        self._pools = tuple(pools)
        tok = self._sample(logits, self._h_temps)
        self._iteration += 1
        for i in active:
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
            self._h_ids[i, 1:1 + len(d)] = d
            self._h_dlen[i] = len(d)
            drafts[i] = d
        if not any(drafts.values()):
            return self._plain_step(active)
        ids = self._to_device(self._h_ids)
        logits, *pools = self._adapter.verify(
            ids, *self._pools, self._to_device(self._h_table),
            self._to_device(self._h_lens))
        self._pools = tuple(pools)
        targets, accept = self._verifier(
            logits, ids[:, 1:], self._to_device(self._h_dlen),
            self._to_device(self._h_temps), self._gen)
        # one transfer to the host: this is the step's device sync
        out = torch.cat([targets, accept.long()], dim=1).cpu().numpy()
        targets, accept = out[:, :K + 1], out[:, K + 1:].astype(bool)
        self._iteration += 1
        self._verify_steps += 1
        proposed = accepted = 0
        for i in active:
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
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted

    def _emit_token(self, slot, tok):
        h = slot.handle
        if h.first_token_at is None:
            h.first_token_at = time.time()
        h.token_ids.append(tok)
        h._events.put(("token", tok))

    def _retire_if_done(self, i):
        slot = self._slots[i]
        h = slot.handle
        status = None
        if h.cancelled:
            status = "cancelled"
        elif slot.eos is not None and slot.last == slot.eos:
            status = "completed"
        elif slot.produced >= slot.max_new:
            status = "completed"
        elif slot.deadline is not None and time.time() > slot.deadline:
            status = "expired"
        if status is None:
            return False
        self._bm.free(slot.alloc)
        self._slots[i] = None
        self._clear_slot_row(i)
        self._finish(h, status)
        return True

    def _clear_slot_row(self, i):
        """Point slot ``i``'s host row at scratch again, so the next
        dispatch treats the lane as inactive."""
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
        handle.status = status
        handle.finished_at = time.time()
        handle._events.put(("done", status))
        handle._done.set()

    # -------------------------------------------------------------- insight
    @property
    def block_manager(self):
        return self._bm

    def stats(self):
        return {
            "device": str(self.device),
            "iteration": self._iteration,
            "prefills": self._prefills,
            "prefill_chunks": self._prefill_chunks,
            "verify_steps": self._verify_steps,
            "queue_depth": len(self._queue),
            "active_slots": sum(1 for s in self._slots if s is not None),
            "num_slots": self.num_slots,
            "pages_in_use": self._bm.used_pages,
            "free_pages": self._bm.free_pages,
            "num_pages": self._bm.num_pages,
            "page_utilization": self._bm.utilization(),
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
            "error": repr(self._error) if self._error is not None else None,
        }
