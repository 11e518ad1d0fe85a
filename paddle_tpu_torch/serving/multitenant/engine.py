"""MultiTenantEngine — one continuous-batching engine, many tenants
(counterpart of ``paddle_tpu/serving/multitenant/engine.py``).

Extends :class:`~paddle_tpu_torch.serving.engine.ServingEngine` with three
multi-tenant workload classes, all riding the SAME iteration-level
scheduler and program families:

- **paged multi-LoRA** (``lora_store=``): each batch row gathers its
  tenant's low-rank pairs by slot id inside the prefill / decode / verify
  steps (:mod:`.lora`); program keys carry the store's RANK BUCKETS and
  signature (families ``decode@lora-r<r>``), never an adapter name, so
  registering, evicting or hot-swapping an adapter mints and recaptures
  nothing;
- **grammar-constrained decoding** (``submit(grammar=...)``): per-row
  token-FSM masks (:mod:`.grammar`) computed on the host each step and
  applied in the batched sampler before greedy / temperature sampling;
  composes with speculative verification — drafts are pre-trimmed at the
  first grammar-illegal token and the verifier's distribution is masked
  per position, so a draft that exits the grammar is rejected and the
  bonus / resample token is always legal;
- **embed / score requests** (``submit(mode="embed"|"score")``): the
  prompt runs one prefill-family dispatch against the scratch page — no
  decode slot, no KV pages — returning the pooled hidden state
  (``pooling="mean"|"last"``) or the per-token prompt logprobs through
  ``handle.result()``; under ``prefix_cache="radix"`` a score / last-pool
  embed attends a resident shared run and dispatches only the tail (with
  a memo of score values per page boundary).

On the card every ``mt_*`` program is a CUDA graph like the base
engine's.  The per-bucket adapter ids and the grammar masks reach it
through its static input buffers (pinned host rows, copied
``non_blocking``); the step's mask buffer (``[num_slots, V]`` bool) is
copied only while a constrained row is live — otherwise it keeps the
all-True rows it last received, the reference's device-resident all-True
twin — so a decode step keeps its single host sync.  A retiring row's
mask goes back to all-True.

Per-tenant observability: ``serving.tenant.requests{adapter=}`` /
``serving.tenant.tokens{adapter=}`` (label ``base`` = no adapter),
``serving.lora_blocked`` and a ``tenants`` section on /statusz; the
families attribute in the perf table as ``decode@lora-r<r>``,
``prefill/<bucket>@embed`` and the like.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ...device import resolve_device
from ...jit.graphs import KEEP
from ...observability import numerics as _numerics
from ...observability import tracing as _tracing
from ...text.models._decode import nonfinite_rows
from ..engine import ServingEngine
from .lora import LoRAGPTAdapter, LoRAQuantizedGPTAdapter, LoRAStore


class MultiTenantEngine(ServingEngine):
    """See module docstring.  Typical use::

        store = LoRAStore(model, capacity=8, ranks=(8,))
        store.register(LoRAAdapter.random(model, "tenant-a", rank=4))
        engine = MultiTenantEngine(model, lora_store=store, num_slots=4)
        with engine:
            ha = engine.submit(p, adapter="tenant-a")     # LoRA row
            hb = engine.submit(p, grammar=g)              # schema row
            hc = engine.submit(p, mode="embed")           # embedding row
    """

    def __init__(self, model, lora_store: LoRAStore | None = None, **kw):
        if lora_store is not None and kw.get("adapter") is None:
            device = resolve_device(kw.get("device"))
            model.to(device)
            if (lora_store.device.type, lora_store.device.index or 0) != \
                    (device.type, device.index or 0):
                raise ValueError(
                    f"lora_store pools live on {lora_store.device}, the "
                    f"engine runs on {device}: build the store over the "
                    "model on the engine's device")
            kvd = str(kw.get("kv_dtype") or "native").lower()
            cls = LoRAQuantizedGPTAdapter if kvd == "int8" \
                else LoRAGPTAdapter
            kw["adapter"] = cls(model, kw.get("page_size", 16), lora_store)
        self._lora = lora_store
        super().__init__(model, **kw)
        from ...profiler import metrics as _metrics
        from ...text.models._decode import make_masked_batched_sampler

        self._vsize = int(model.gpt.word_embeddings.weight.shape[0])
        self._nb = len(lora_store.ranks) if lora_store is not None else 0
        self._lora_fam = lora_store.family_suffix() \
            if lora_store is not None else ""
        self._mt_sig = ("mt", lora_store.signature()
                        if lora_store is not None else None)
        self._masked_sampler = make_masked_batched_sampler(*self._top)
        self._masked_verifier = None
        if self._spec_k:
            from ..speculative import make_masked_verifier

            self._masked_verifier = make_masked_verifier(*self._top)
        # persistent per-lane host rows, extending the base set: the
        # grammar masks (all-True = unconstrained, bit-identical to the
        # unmasked sampler) and the per-bucket adapter slot ids (0 = null)
        self._h_allowed = np.ones((self.num_slots, self._vsize), np.bool_)
        self._h_aid = np.zeros((max(self._nb, 1), self.num_slots), np.int32)
        self._constrained = set()    # live lanes carrying a grammar
        # what each step / verify program's static mask buffer holds:
        # "true" (all-True rows) or "mask" (a constrained row's mask)
        self._mask_fed = {}
        if self._spec_k:
            self._h_allowed3 = np.ones(
                (self.num_slots, self._spec_k + 1, self._vsize), np.bool_)
        self._tenant_live = {}       # adapter name -> live request count
        # score-value memo for prefix-cached scoring: value[j] (the
        # logprob of prompt[j+1] given prompt[:j+1]) depends on
        # prompt[:j+2] only, so entries up to a page boundary c serve ANY
        # prompt sharing those c tokens — keyed by the boundary prefix
        self._score_memo = collections.OrderedDict()
        self._score_memo_cap = 128
        self._m_tenant_req = _metrics.bind(_metrics.counter(
            "serving.tenant.requests",
            "submitted requests by tenant (adapter name, or 'base')"),
            replica=self.replica)
        self._m_tenant_tok = _metrics.bind(_metrics.counter(
            "serving.tenant.tokens",
            "tokens emitted by tenant (adapter name, or 'base')"),
            replica=self.replica)
        self._m_lora_blocked = _metrics.bind(_metrics.counter(
            "serving.lora_blocked",
            "admissions deferred: every adapter slot pinned by live "
            "requests"), replica=self.replica)

    # ------------------------------------------------------------ tenancy
    @property
    def lora_store(self):
        return self._lora

    def register_adapter(self, adapter):
        """Hot-swap path: register a LoRA adapter on the live engine; it is
        paged into the device pools (in place) at first use.  No restart,
        no new program."""
        if self._lora is None:
            raise ValueError("engine built without a lora_store")
        return self._lora.register(adapter)

    @property
    def _fixed_bytes(self):
        """The HBM pre-flight's fixed bytes: the base engine's plus the
        adapter pools (resident for the store's life)."""
        extra = self._lora.pool_bytes() if self._lora is not None else 0
        return super()._fixed_bytes + extra

    def _validate_tenant(self, adapter, grammar, mode, pooling,
                         eos_token_id):
        if mode not in ("generate", "embed", "score"):
            raise ValueError(f"mode must be generate|embed|score, "
                             f"got {mode!r}")
        if pooling not in ("mean", "last"):
            raise ValueError(f"pooling must be mean|last, got {pooling!r}")
        if adapter is not None:
            if self._lora is None:
                raise ValueError(f"adapter {adapter!r}: engine built "
                                 "without a lora_store")
            if not self._lora.registered(adapter):
                raise KeyError(f"adapter {adapter!r} is not registered "
                               f"(have {self._lora.names})")
        if grammar is not None:
            if mode != "generate":
                raise ValueError("grammar= only applies to mode='generate'")
            if grammar.vocab_size != self._vsize:
                raise ValueError(
                    f"grammar compiled over {grammar.vocab_size} tokens, "
                    f"model vocabulary is {self._vsize}")
            if eos_token_id is None:
                eos_token_id = grammar.eos_token_id
            elif int(eos_token_id) != grammar.eos_token_id:
                raise ValueError(
                    f"eos_token_id {eos_token_id} != the grammar's "
                    f"{grammar.eos_token_id}")
        return eos_token_id

    def submit(self, prompt_ids, *args, **kw):
        h = super().submit(prompt_ids, *args, **kw)
        # counted AFTER a successful enqueue: rejected submissions must
        # not inflate the per-tenant request series
        self._m_tenant_req.inc(adapter=h.adapter or "base")
        return h

    def _acquire_tenant(self, req):
        if req.adapter is None or req.lease is not None:
            return True
        lease = self._lora.acquire(req.adapter)
        if lease is None:
            self._m_lora_blocked.inc()
            return False
        req.lease = lease
        self._tenant_live[req.adapter] = \
            self._tenant_live.get(req.adapter, 0) + 1
        return True

    def _release_tenant(self, req):
        if req.lease is not None:
            self._lora.release(req.lease)
            req.lease = None
            n = self._tenant_live.get(req.adapter, 0) - 1
            if n > 0:
                self._tenant_live[req.adapter] = n
            else:
                self._tenant_live.pop(req.adapter, None)

    # --------------------------------------------------- dispatch plumbing
    def _mt_args(self, aid):
        """The trailing host ``(aid,)`` of a dispatch — empty without a
        store (the adapter pools are read in the step, not fed)."""
        return () if self._lora is None else (aid,)

    def _aid_row(self, req):
        aid = np.zeros((max(self._nb, 1), 1), np.int32)
        if req is not None and req.lease is not None:
            aid[req.lease.bucket, 0] = req.lease.row
        return aid

    def _lora_args(self, mt):
        """What the adapter closures take after ``lens``: the aid buffer
        and the store's pools (nothing without a store)."""
        return (*mt, *self._lora.device_args()) if self._lora is not None \
            else ()

    def _split_mt(self, rest):
        """``(mt, inject)`` from a step function's trailing inputs."""
        k = 0 if self._lora is None else 1
        return rest[:k], (rest[k] if len(rest) > k else None)

    def _mask_arg(self, key, host):
        """The mask input of the step / verify program of ``key``: the
        host rows while a constrained row is live (and once more after the
        last one retires, to put the buffer back to all-True), else
        :data:`~...jit.graphs.KEEP` — the buffer already holds all-True
        rows, and nothing is copied."""
        live = bool(self._constrained)
        if not live and key in self._graphs \
                and self._mask_fed.get(key) == "true":
            return KEEP
        self._mask_fed[key] = "mask" if live else "true"
        return host

    # program keys (the reference's spelling, with the guard component)
    def _step_store_key(self):
        return ("mt_step", self.num_slots, self.table_width,
                *self._pool_key(), self._top, self._mt_sig) \
            + self._guard_key()

    def _prefill_store_key(self, s_pad):
        return ("mt_prefill", s_pad, self.table_width, *self._pool_key(),
                self._top, self._mt_sig) + self._guard_key()

    def _prefill_chunk_store_key(self, c_pad):
        return ("mt_prefill_chunk", c_pad, self.table_width,
                *self._pool_key(), self._top, self._mt_sig) \
            + self._guard_key()

    def _verify_store_key(self, k_pad):
        return ("mt_verify", k_pad, self.num_slots, self.table_width,
                *self._pool_key(), self._top, self._mt_sig) \
            + self._guard_key()

    def _encode_store_key(self, kind, mode, pooling, width):
        return (kind, mode, pooling, width, self.table_width,
                *self._pool_key(), self._mt_sig)

    def _prefill_family(self, s_pad):
        return f"prefill/{s_pad}{self._fam_suffix}{self._lora_fam}"

    def _decode_family(self):
        return f"decode{self._flash_tag}{self._fam_suffix}{self._lora_fam}"

    def _prefill_chunk_family(self, c):
        return f"prefill_chunk/{c}{self._fam_suffix}{self._lora_fam}"

    def _verify_family(self):
        return f"verify/k{self._spec_k}{self._fam_suffix}{self._lora_fam}"

    def _mask_or_fail(self, handle, g, state):
        """One row's grammar mask, containing pathological failures (a
        mid-document state no vocab token can tile, or a state-count
        blowup) to THE REQUEST: the handle records the error and cancels,
        retiring at the next scheduler check, and the returned all-True
        mask only feeds the dying row's final dispatch."""
        try:
            return g.allowed(state)
        except ValueError as e:
            if handle._error is None:
                handle._error = e
            handle.cancel()
            return np.ones((self._vsize,), np.bool_)

    def _prefill_extra(self, req):
        allowed = np.ones((1, self._vsize), np.bool_)
        if req is not None and req.grammar is not None:
            allowed[0] = self._mask_or_fail(req.handle, req.grammar,
                                            req.handle._fsm_state)
        return (allowed,) + self._mt_args(self._aid_row(req))

    def _step_extra(self):
        return (self._mask_arg(self._step_store_key(), self._h_allowed),) \
            + self._mt_args(self._h_aid)

    def _verify_extra(self, active):
        for i in active:
            if i not in self._constrained:
                continue
            s = self._slots[i]
            g = s.req.grammar
            # per-position masks along the (grammar-filtered) draft chain:
            # position t's mask is the state after accepting drafts < t,
            # so an accepted prefix is legal by construction and the bonus
            # / resample at the first rejection samples a legal token
            st = s.handle._fsm_state
            try:
                self._h_allowed3[i, 0] = g.allowed(st)
                dlen = int(self._h_dlen[i])
                for t in range(dlen):
                    tok = int(self._h_ids[i, 1 + t])
                    if tok == g.eos_token_id:
                        # an accepted EOS draft retires the row mid-chain;
                        # later positions are discarded, so their masks
                        # are unconstrained (EOS has no next state)
                        self._h_allowed3[i, t + 1:] = True
                        break
                    st = g.advance(st, tok)
                    self._h_allowed3[i, t + 1] = g.allowed(st)
                else:
                    self._h_allowed3[i, dlen + 1:] = True
            except ValueError as e:     # same containment as _mask_or_fail
                if s.handle._error is None:
                    s.handle._error = e
                s.handle.cancel()
                self._h_allowed3[i] = True
        key = self._verify_store_key(self._spec_k)
        return (self._mask_arg(key, self._h_allowed3),) \
            + self._mt_args(self._h_aid)

    def _filter_draft(self, i, draft):
        s = self._slots[i]
        g = s.req.grammar
        if g is None or not draft:
            return draft
        st = s.handle._fsm_state
        out = []
        for t in draft:
            if not self._mask_or_fail(s.handle, g, st)[int(t)]:
                break
            if s.handle.cancelled:      # grammar failure: the row is dying
                return []
            out.append(t)
            if int(t) == g.eos_token_id:
                break
            st = g.advance(st, t)
        return out

    def _budget_status(self, slot):
        """A constrained row whose token budget ran out mid-document (its
        FSM is not in an accepting state) finishes as ``truncated``: the
        schema-validity promise covers only rows that reached a complete
        document."""
        g = slot.req.grammar
        if g is not None:
            st = slot.handle._fsm_state
            if st is None or not g.is_final(st):
                return "truncated"
        return "completed"

    def _on_admitted(self, slot, i):
        self._h_aid[:, i] = 0
        if slot.req.lease is not None:
            self._h_aid[slot.req.lease.bucket, i] = slot.req.lease.row
        g = slot.req.grammar
        if g is not None:
            self._constrained.add(i)
            self._h_allowed[i] = self._mask_or_fail(
                slot.handle, g, slot.handle._fsm_state)
        else:
            self._h_allowed[i] = True

    def _emit_token(self, slot, tok):
        super()._emit_token(slot, tok)
        g = slot.req.grammar
        h = slot.handle
        if g is not None and int(tok) != g.eos_token_id \
                and not h.cancelled:
            try:
                h._fsm_state = g.advance(h._fsm_state, tok)
                if h._fsm_state is None:  # unreachable under masking
                    raise RuntimeError(
                        f"constrained request {h.request_id} emitted "
                        f"token {int(tok)} outside its grammar")
                self._h_allowed[slot.idx] = self._mask_or_fail(
                    h, g, h._fsm_state)
            except ValueError as e:     # state blowup: contain to the row
                if h._error is None:
                    h._error = e
                h.cancel()
                self._h_allowed[slot.idx] = True
        self._m_tenant_tok.inc(adapter=slot.req.adapter or "base")

    def _clear_slot_row(self, i, slot):
        super()._clear_slot_row(i, slot)
        self._h_allowed[i] = True
        self._h_aid[:, i] = 0
        self._constrained.discard(i)
        if self._spec_k:
            self._h_allowed3[i] = True

    def _reset_host_buffers(self):
        super()._reset_host_buffers()
        self._h_allowed[:] = True
        self._h_aid[:] = 0
        self._constrained.clear()
        if self._spec_k:
            self._h_allowed3[:] = True

    # ------------------------------------------------------------ programs
    def _mt_tail(self, logits, allowed, temps, inject):
        """The base ``_tail`` with the masked sampler."""
        if inject is None:
            return self._masked_sampler(logits, allowed, temps,
                                        self._gen)[None], None
        logits = logits + inject[:, None]
        bad = nonfinite_rows(logits)
        stats = _numerics.stats_row(logits, _numerics.low_dtype())[None]
        tok = self._masked_sampler(logits, allowed, temps, self._gen)
        return torch.stack([tok, bad.long()]), stats

    def _step_fn(self, last, table, lens, temps, allowed, *rest):
        mt, inject = self._split_mt(rest)
        logits, *_ = self._adapter.step(last, *self._pools, table, lens,
                                        *self._lora_args(mt))
        return self._mt_tail(logits, allowed, temps, inject)

    def _prefill_fn(self, ids, table, lens, temps, allowed, *rest):
        mt, inject = self._split_mt(rest)
        logits, *_ = self._adapter.prefill(ids, *self._pools, table, lens,
                                           *self._lora_args(mt))
        return self._mt_tail(logits, allowed, temps, inject)

    def _chunk_fn(self, ids, nvalid, table, lens, temps, allowed, *rest):
        mt, inject = self._split_mt(rest)
        logits, *_ = self._adapter.prefill_chunk(
            ids, nvalid, *self._pools, table, lens, *self._lora_args(mt))
        return self._mt_tail(logits, allowed, temps, inject)

    def _verify_fn(self, ids, table, lens, dlen, temps, allowed3, *rest):
        mt, inject = self._split_mt(rest)
        logits, *_ = self._adapter.verify(ids, *self._pools, table, lens,
                                          *self._lora_args(mt))
        parts = []
        stats = None
        if inject is not None:
            logits = logits + inject[:, None, None]
            parts.append(nonfinite_rows(logits).long()[:, None])
            stats = _numerics.stats_row(logits, _numerics.low_dtype())[None]
        targets, accept = self._masked_verifier(
            logits, allowed3, ids[:, 1:], dlen, temps, self._gen)
        return torch.cat([targets, accept.long()] + parts, dim=1), stats

    # embed / score: one bound method per (mode, pooling), as the programs
    # hold their step function by weak reference
    def _encode(self, ids, table, lens, mt):
        x, w, *_ = self._adapter.encode(ids, *self._pools, table, lens,
                                        *self._lora_args(mt))
        return x, w

    def _encode_chunk(self, ids, table, lens, mt):
        x, w, *_ = self._adapter.encode_chunk(ids, *self._pools, table,
                                              lens, *self._lora_args(mt))
        return x, w

    @staticmethod
    def _score_of(x, w, ids):
        """Logprob of each token of ``ids`` given its prefix: ``[B, S-1]``."""
        lp = torch.log_softmax(x @ w.T, dim=-1)
        tgt = ids[:, 1:].long()
        return torch.gather(lp[:, :-1], -1, tgt[..., None])[..., 0]

    def _embed_mean_fn(self, ids, table, lens, *mt):
        x, _ = self._encode(ids, table, lens, mt)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        m = (pos < lens[:, None]).float()
        out = (x * m[..., None]).sum(dim=1) \
            / torch.clamp(lens[:, None].float(), min=1.0)
        return out, None

    def _embed_last_fn(self, ids, table, lens, *mt):
        x, _ = self._encode(ids, table, lens, mt)
        idx = (lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        return torch.gather(x, 1, idx)[:, 0], None

    def _score_fn(self, ids, table, lens, *mt):
        x, w = self._encode(ids, table, lens, mt)
        return self._score_of(x, w, ids), None

    def _embed_last_chunk_fn(self, ids, nvalid, table, lens, *mt):
        x, _ = self._encode_chunk(ids, table, lens, mt)
        idx = torch.clamp(nvalid.long() - 1, min=0)[:, None, None] \
            .expand(-1, 1, x.shape[-1])
        return torch.gather(x, 1, idx)[:, 0], None

    def _score_chunk_fn(self, ids, nvalid, table, lens, *mt):
        x, w = self._encode_chunk(ids, table, lens, mt)
        return self._score_of(x, w, ids), None

    # --------------------------------------------------------- passthrough
    def _run_passthrough(self, req):
        """One embed / score request: a single prefill-family dispatch
        with every table row pointed at the scratch page — the
        BlockManager is never touched and no decode slot is occupied; the
        request retires at once.

        Under ``prefix_cache="radix"``, embed (``pooling="last"``) and
        score requests first pin the longest resident shared run
        (``BlockManager.acquire_run``) and dispatch only the unshared tail
        (:meth:`_run_passthrough_cached`); the run is released — parked
        idle, resident for the next sharer — when the dispatch returns.
        ``pooling="mean"`` reduces over every position, so it stays on
        the full dispatch."""
        h = req.handle
        S0 = len(req.prompt)
        if self._radix and (req.mode == "score" or (
                req.mode == "embed" and req.pooling == "last")):
            run = self._bm.acquire_run(req.prompt)
            if run is not None and run[0]:
                pages, cached = run
                try:
                    return self._run_passthrough_cached(req, pages, cached)
                finally:
                    self._bm.release_run(req.prompt, len(pages))
        s_pad = self._prefill_bucket(S0)
        ids = np.zeros((1, s_pad), np.int64)
        ids[0, :S0] = req.prompt
        table = np.full((1, self.table_width), self._scratch, np.int32)
        lens = np.asarray([S0], np.int32)
        fn = {("embed", "mean"): self._embed_mean_fn,
              ("embed", "last"): self._embed_last_fn}.get(
            (req.mode, req.pooling), self._score_fn)
        fam = (f"prefill/{s_pad}@{req.mode}"
               f"{self._fam_suffix}{self._lora_fam}")
        t0 = time.perf_counter()
        with _tracing.span(f"serving.{req.mode}", trace_id=h.trace_id,
                           request_id=h.request_id, prompt_len=S0):
            out, _ = self._dispatch(
                self._encode_store_key("mt_encode", req.mode, req.pooling,
                                       s_pad),
                fam, fam, self._m_prefill_traces, (h,), fn,
                (ids, table, lens, *self._mt_args(self._aid_row(req))),
                None)
        self._m_prefill_seconds.observe(time.perf_counter() - t0)
        if req.mode == "embed":
            h.value = out[0]                        # [H] f32
        else:
            h.value = [float(v) for v in out[0][:max(S0 - 1, 0)]]
        self._release_tenant(req)
        self._admitting = None
        self._finish(h, "cancelled" if h.cancelled else "completed")

    def _run_passthrough_cached(self, req, pages, cached):
        """The prefix-cached half of :meth:`_run_passthrough`: dispatch
        the tail from offset ``l0`` against the pinned run.

        - embed / last: ``l0 = min(cached * ps, S0 - 1)`` — only the lanes
          needed to reach the last real position (at least one).
        - score: value entry j needs the logits at position j, so the
          dispatch starts at ``l0 = c' - 1`` where ``c'`` is the deepest
          page boundary with a score-memo hit (entries ``[:c' - 1]`` come
          from the memo); no hit means a full-tail dispatch (``l0 = 0``)
          that warms the memo.

        Fresh pages ``acquire_run`` registered start at ``cached * ps``,
        past every possible ``l0``, so the dispatch's pool writes cover
        them with real K/V before the run is released."""
        h = req.handle
        S0 = len(req.prompt)
        ps = self.page_size
        prefix_vals = None
        if req.mode == "score":
            l0 = 0
            for k in range(min(cached, S0 // ps), 0, -1):
                mkey = tuple(int(t) for t in req.prompt[:k * ps])
                got = self._score_memo.get(mkey)
                if got is not None:
                    self._score_memo.move_to_end(mkey)
                    prefix_vals = list(got)
                    l0 = k * ps - 1
                    break
        else:
            l0 = min(cached * ps, S0 - 1)
        tail = S0 - l0
        c_pad = self._prefill_bucket(tail)
        ids = np.zeros((1, c_pad), np.int64)
        ids[0, :tail] = req.prompt[l0:]
        table = np.full((1, self.table_width), self._scratch, np.int32)
        table[0, :len(pages)] = pages
        lens = np.asarray([l0], np.int32)
        nvalid = np.asarray([tail], np.int32)
        fn = self._embed_last_chunk_fn if req.mode == "embed" \
            else self._score_chunk_fn
        fam = (f"prefill/{c_pad}@{req.mode}@cached{cached}"
               f"{self._fam_suffix}{self._lora_fam}")
        t0 = time.perf_counter()
        with _tracing.span(f"serving.{req.mode}_cached",
                           trace_id=h.trace_id, request_id=h.request_id,
                           prompt_len=S0, cached_tokens=l0):
            out, _ = self._dispatch(
                self._encode_store_key("mt_encode_chunk", req.mode,
                                       req.pooling, c_pad),
                fam, fam, self._m_prefill_traces, (h,), fn,
                (ids, nvalid, table, lens,
                 *self._mt_args(self._aid_row(req))), None)
        self._m_prefill_seconds.observe(time.perf_counter() - t0)
        if req.mode == "embed":
            h.value = out[0]                    # [H] f32, last position
        else:
            vals = [float(v) for v in out[0][:max(tail - 1, 0)]]
            if prefix_vals is not None:
                vals = prefix_vals + vals       # the memo covers [:l0]
            h.value = vals
            for k in range(1, S0 // ps + 1):    # warm every boundary
                mkey = tuple(int(t) for t in req.prompt[:k * ps])
                self._score_memo[mkey] = tuple(vals[:k * ps - 1])
                self._score_memo.move_to_end(mkey)
            while len(self._score_memo) > self._score_memo_cap:
                self._score_memo.popitem(last=False)
        self._release_tenant(req)
        self._admitting = None
        self._finish(h, "cancelled" if h.cancelled else "completed")

    # -------------------------------------------------------------- insight
    def stats(self):
        st = super().stats()
        st["multitenant"] = {
            "vocab_size": self._vsize,
            "lora": self._lora.stats() if self._lora is not None else None,
        }
        return st

    def _statusz(self):
        st = super()._statusz()
        tenants = {}
        if self._lora is not None:
            lstats = self._lora.stats()
            for name, info in lstats["adapters"].items():
                tenants[name] = dict(info,
                                     live_requests=self._tenant_live.get(
                                         name, 0))
            st["lora_pools"] = {k: lstats[k] for k in
                                ("ranks", "capacity", "targets", "dtype",
                                 "pool_bytes")}
        st["tenants"] = tenants
        return st
