"""Model adapter: what the serving engine runs (counterpart of
``paddle_tpu/serving/adapter.py``).

:class:`GPTAdapter` reduces a causal LM to two calls over explicit KV
state — the pool tuple, ``(kp, vp)`` each ``[L, P, ps, h, d]`` here
(:class:`~.quant.QuantizedGPTAdapter` adds two scale pools):

- ``prefill(ids, *pools, table, lens)`` runs the (right-padded) prompts
  ``ids [B, S]``, writes their K/V into the pools through ``table [B, NP]``
  and returns the next-token logits at each row's true last position
  ``lens[b] - 1``;
- ``step(last, *pools, table, lens)`` runs one decode token per slot at
  each slot's OWN position ``lens[b]`` (iteration-level batching),
  attention through the paged kernel;
- ``verify(ids, *pools, table, lens)`` (speculative decoding) runs ``ids
  [B, C]`` — each slot's last token and C - 1 drafts — at positions
  ``lens[b] ..`` through the chunk cache variant and returns the logits
  of every position, ``[B, C, V]``;
- ``prefill_chunk(ids, nvalid, *pools, table, lens)`` (chunked prefill)
  runs the next C prompt tokens per slot the same way and returns the
  logits at each row's last real lane ``nvalid[b] - 1``.

- ``encode(ids, *pools, table, lens)`` / ``encode_chunk(...)``
  (multi-tenant embed / score requests) run a prefill / chunk and return
  the full hidden states and the tied LM-head weights instead of logits.

Every closure reads its trailing arguments through ONE hook,
:meth:`GPTAdapter._split_extra`: an adapter that takes extra dispatch
arguments (the multi-tenant LoRA adapters: per-row adapter ids and the
rank-bucketed pools) overrides that method, and the closure bodies stay
single-copy.

The logit closures return ``(logits f32, *pools)``.  Chunk positions are clamped at
``max_model_len - 1``: lanes past the cap are junk nobody reads.  The TPU package donated the
pools into each compiled call and got new arrays back; here the layers
write the per-layer views ``kp[i]`` IN PLACE, so the returned pools are
the same tensors (there is no re-stacking step).  Both run under
``torch.inference_mode``.
"""

from __future__ import annotations

import torch


class GPTAdapter:
    """Adapter for :class:`paddle_tpu_torch.text.models.GPTForCausalLM`
    (any model with the same ``.gpt`` decoder and the "served" cache)."""

    #: GPTDecoderLayer cache-variant tags this adapter drives
    tag = "served"
    chunk_tag = "served_chunk"
    #: pool tensors per layer stack, and what they hold
    n_pools = 2
    kv_dtype = "native"

    def __init__(self, model, page_size=16):
        self.model = model
        self.gpt = model.gpt
        blk = self.gpt.layers[0]
        self.num_layers = len(self.gpt.layers)
        self.head_dim = blk.head_dim
        # an Int8Linear (weight_dtype="int8") keeps its weight as weight_int8
        qkv_w = getattr(blk.qkv, "weight", None)
        if qkv_w is None:
            qkv_w = blk.qkv.weight_int8
        self.num_kv_heads = qkv_w.shape[0] // (3 * blk.head_dim)
        wte = self.gpt.word_embeddings.weight
        self.dtype = wte.dtype
        self.device = wte.device
        self.max_model_len = self.gpt.position_embeddings.weight.shape[0]
        self.page_size = int(page_size)

    def signature(self):
        """The static geometry a program is specialized on, as a JSON-plain
        dict — the reference's fields and spellings (dtype ``"bfloat16"``,
        not ``"torch.bfloat16"``), so a warmup manifest stamped by either
        package's engine is accepted, or refused, by the other's."""
        return {"adapter": type(self).__name__,
                "kv_dtype": self.kv_dtype,
                "n_pools": int(self.n_pools),
                "num_layers": int(self.num_layers),
                "num_kv_heads": int(self.num_kv_heads),
                "head_dim": int(self.head_dim),
                "page_size": int(self.page_size),
                "max_model_len": int(self.max_model_len),
                "dtype": str(self.dtype).removeprefix("torch.")}

    # ----------------------------------------------------------- pool hooks
    def init_pools(self, num_pages):
        """Zeroed per-layer K/V pools ``(kp, vp)``, each [L, P, ps, h, d]."""
        shape = (self.num_layers, int(num_pages), self.page_size,
                 self.num_kv_heads, self.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def page_bytes(self):
        """Device bytes ONE page costs across all layers, K and V."""
        return (2 * self.num_layers * self.page_size * self.num_kv_heads
                * self.head_dim * torch.empty((), dtype=self.dtype).element_size())

    def pool_owners(self):
        """Memory-ledger owner labels over the pool tuple: ``(owner,
        pool-index tuple)`` pairs covering every pool tensor."""
        return (("kv.pages", (0, 1)),)

    def _layer_caches(self, tag, pools, table, lens):
        """Per-layer GPTDecoderLayer cache tuples: views into the pools."""
        kp, vp = pools
        return [(tag, kp[i], vp[i], table, lens)
                for i in range(self.num_layers)]

    def _run(self, ids, pools, table, lens, pos_ids, tag=None, lora=None):
        """Hidden states ``[B, S, H]`` and the tied LM-head weights; the
        pools are written in place."""
        cache = self._layer_caches(tag or self.tag, pools, table, lens)
        x, _ = self.gpt(ids, position_ids=pos_ids, cache=cache, lora=lora)
        return x, self.gpt.word_embeddings.weight

    def _split(self, args):
        """``(*pools, table, lens)`` -> (pools tuple, table, lens)."""
        if len(args) != self.n_pools + 2:
            raise TypeError(
                f"{type(self).__name__} closures take {self.n_pools} pool "
                f"tensors + table + lens; got {len(args)} trailing args")
        return tuple(args[:self.n_pools]), args[-2], args[-1]

    def _split_extra(self, args):
        """``(pools, table, lens, lora)`` — THE extension hook: an adapter
        carrying extra trailing dispatch arguments (multi-tenant LoRA:
        per-row adapter ids and the rank-bucketed pools) overrides this
        one method; the closure bodies below stay single-copy."""
        pools, table, lens = self._split(args)
        return pools, table, lens, None

    def _chunk_positions(self, lens, C):
        pos = lens[:, None].long() + torch.arange(C, device=lens.device)[None]
        return torch.clamp(pos, max=self.max_model_len - 1)

    # ------------------------------------------------------------- closures
    @torch.inference_mode()
    def prefill(self, ids, *args):
        pools, table, lens, lora = self._split_extra(args)
        S = ids.shape[1]
        pos_ids = torch.arange(S, dtype=torch.int64, device=ids.device)[None, :]
        x, w = self._run(ids, pools, table, lens, pos_ids, lora=lora)
        # logits at each row's LAST REAL position (rows are right-padded)
        idx = (lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        h = torch.gather(x, 1, idx)[:, 0]
        logits = h.float() @ w.float().T
        return (logits, *pools)

    @torch.inference_mode()
    def encode(self, ids, *args):
        """Embedding / scoring forward (multi-tenant ``mode="embed" |
        "score"`` requests): the (right-padded) prompts run like
        :meth:`prefill`, returning the FULL hidden states and the tied
        LM-head weights.  K/V still flows through the pool writes (the
        caller points every table row at the scratch page, so nothing is
        allocated and the junk is never attended).  Returns ``(hidden
        [B, S, H] f32, w [V, H] f32, *pools)``."""
        pools, table, lens, lora = self._split_extra(args)
        S = ids.shape[1]
        pos_ids = torch.arange(S, dtype=torch.int64, device=ids.device)[None, :]
        x, w = self._run(ids, pools, table, lens, pos_ids, lora=lora)
        return (x.float(), w.float(), *pools)

    @torch.inference_mode()
    def encode_chunk(self, ids, *args):
        """Prefix-cached embed / score forward: ``ids [B, C]``, the
        UNSHARED tail of each prompt, at positions ``lens[b] ..`` through
        the chunk cache variant, attending the resident shared-run pages
        the table points at (K/V at position p depends on tokens 0..p
        only, so the tail's hiddens equal a full :meth:`encode`'s).
        Returns ``(hidden [B, C, H] f32, w [V, H] f32, *pools)``."""
        pools, table, lens, lora = self._split_extra(args)
        pos_ids = self._chunk_positions(lens, ids.shape[1])
        x, w = self._run(ids, pools, table, lens, pos_ids, self.chunk_tag,
                         lora=lora)
        return (x.float(), w.float(), *pools)

    @torch.inference_mode()
    def step(self, last, *args):
        pools, table, lens, lora = self._split_extra(args)
        pos_ids = lens[:, None].long()
        x, w = self._run(last, pools, table, lens, pos_ids, lora=lora)
        logits = x[:, -1].float() @ w.float().T
        return (logits, *pools)

    @torch.inference_mode()
    def verify(self, ids, *args):
        """Speculative verify: ``logits[b, t]`` is the next-token
        distribution after ``ids[b, :t + 1]``; all C K/V per slot land in
        the pools in one chunk write."""
        pools, table, lens, lora = self._split_extra(args)
        pos_ids = self._chunk_positions(lens, ids.shape[1])
        x, w = self._run(ids, pools, table, lens, pos_ids, self.chunk_tag,
                         lora=lora)
        logits = x.float() @ w.float().T
        return (logits, *pools)

    @torch.inference_mode()
    def prefill_chunk(self, ids, nvalid, *args):
        """One chunk of a long prompt (right-padded past ``nvalid[b]``) at
        positions ``lens[b] ..``; only the final chunk's logits seed
        decode.  Pad lanes write past the valid length (or are dropped
        past the table), where the next write overwrites them."""
        pools, table, lens, lora = self._split_extra(args)
        pos_ids = self._chunk_positions(lens, ids.shape[1])
        x, w = self._run(ids, pools, table, lens, pos_ids, self.chunk_tag,
                         lora=lora)
        idx = torch.clamp(nvalid.long() - 1, min=0)[:, None, None] \
            .expand(-1, 1, x.shape[-1])
        h = torch.gather(x, 1, idx)[:, 0]
        logits = h.float() @ w.float().T
        return (logits, *pools)
