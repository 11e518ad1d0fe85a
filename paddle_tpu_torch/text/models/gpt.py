"""GPT decoder LM (counterpart of ``paddle_tpu/text/models/gpt.py``).

The pre-LN decoder block with its no-cache path (full causal attention,
which training takes; on the card it runs the flash kernels forward and
backward) and its cache variants (:meth:`GPTDecoderLayer.forward`): the
static dense cache and the per-sequence ``"paged"`` pools of
:meth:`GPTForCausalLM.generate`, and the serving engine's global-pool
variants ``"served"`` / ``"served_chunk"`` and their int8 twins
``"served_q"`` / ``"served_chunk_q"``.  Every cache is updated in place.

The qkv projection's output is HEAD-MAJOR, ``[B, S, heads, 3, head_dim]``,
as in the TPU package (a column split over heads hands each shard whole
(q, k, v) heads), so weights converted from it line up: conversion only
transposes a weight, it never reorders output columns, so a LoRA ``B``
of the qkv target carries the reference's column order too.

Every branch takes ``lora=``: the multi-tenant engine's per-layer adapter
slice (:meth:`GPTDecoderLayer._lin`), None for the base model.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import amp
from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers.common import Embedding, Linear
from ...nn.layers.norm import LayerNorm
from ...ops.paged_attention import (paged_attention, paged_attention_quantized,
                                    paged_chunk_attend,
                                    paged_chunk_attend_quant,
                                    paged_decode_attend, paged_prefill_write,
                                    paged_table_chunk_write,
                                    paged_table_chunk_write_quant,
                                    paged_table_prefill_write,
                                    paged_table_prefill_write_quant,
                                    paged_table_token_write,
                                    paged_table_token_write_quant,
                                    paged_token_write)


class GPTDecoderLayer(torch.nn.Module):
    """Pre-LN causal block: ln1 -> attn -> +res -> ln2 -> mlp -> +res."""

    def __init__(self, hidden_size, num_heads, intermediate_size, dropout=0.0,
                 attn_dropout=0.0, act="gelu"):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.ln1 = LayerNorm(hidden_size, 1e-5)
        self.qkv = Linear(hidden_size, 3 * hidden_size)
        self.out_proj = Linear(hidden_size, hidden_size)
        self.ln2 = LayerNorm(hidden_size, 1e-5)
        self.ffn1 = Linear(hidden_size, intermediate_size)
        self.ffn2 = Linear(intermediate_size, hidden_size)
        self.dropout = torch.nn.Dropout(dropout)
        self.attn_dropout = attn_dropout
        self.act = getattr(F, act)

    def _lin(self, name, x, lora):
        """One decoder Linear call with an optional per-row LoRA bypass.

        ``lora`` is this layer's multi-tenant adapter slice (or None): a
        dict mapping target name -> flat tuple of per-row gathered
        ``(A [B, d_in, r], B [B, r, d_out])`` pairs, one pair per rank
        bucket (``serving.multitenant``; ``ops.lora``).  The base
        projection may be an ``Int8Linear`` (``weight_dtype="int8"``): the
        bypass rides on its output either way."""
        y = getattr(self, name)(x)
        if lora is not None and name in lora:
            from ...ops.lora import apply_lora

            y = apply_lora(x, y, *lora[name])
        return y

    def forward(self, x, cache=None, lora=None):
        """``cache`` is None (full causal attention over ``x``) or one of
        the cache tuples below; returns ``x``, or ``(x, cache)`` with the
        same tuple (its buffers and pools updated in place):

        - ``(k_buf, v_buf, pos)`` — the static dense cache of
          ``generate()``: ``[B, T, heads, head_dim]`` buffers written at
          ``pos`` (a Python int, or a 0-d device tensor in a captured
          step), attended under an additive float32 mask
          (the plain attention, on the card too, as in the TPU package);
        - ``("paged", kp, vp, pos)`` — ``generate(cache_impl="paged")``:
          per-sequence pools ``[B, PP, ps, heads, head_dim]``; prefill
          attends with the flash kernel, decode through
          ``paged_decode_attend`` (K3);
        - ``("served", kp, vp, table, lens)`` — the serving engine: this
          layer's global pools ``[P, ps, heads, head_dim]``, the page table
          ``[B, NP]`` int32 and the per-slot lengths ``[B]`` int32;
          prefill (S > 1) attends with the flash kernel, decode (S == 1)
          writes the token and attends with K3 over ``lens + 1``;
        - ``("served_chunk", kp, vp, table, lens)`` — S tokens per slot at
          positions ``lens[b] ..`` (speculative verify, chunked prefill):
          one chunk write, then ``paged_chunk_attend`` (K3 over the
          ``[B*S]``-row expansion);
        - ``("served_q" | "served_chunk_q", kp, vp, ks, vs, table, lens)``
          — the same over int8 pools with float32 scale pools
          ``[P, ps, heads]``: the writes quantize, decode and chunks run
          K4."""
        residual = x
        h = self.ln1(x)
        qkv = self._lin("qkv", h, lora)
        B, S = h.shape[0], h.shape[1]
        heads = qkv.shape[-1] // (3 * self.head_dim)
        q, k, v = qkv.reshape(B, S, heads, 3, self.head_dim).unbind(3)
        if cache is None:
            attn = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout,
                training=self.training)
        else:
            attn = self._attend_cached(q, k, v, cache)
        attn = attn.reshape(B, S, heads * self.head_dim)
        x = residual + self.dropout(self._lin("out_proj", attn, lora))
        residual = x
        h = self._lin("ffn2", self.act(self._lin("ffn1", self.ln2(x), lora)),
                      lora)
        x = residual + self.dropout(h)
        return x if cache is None else (x, cache)

    @staticmethod
    def _prefill_attend(q, k, v):
        # prompt attention of the cache variants; pad positions of a
        # right-padded prompt write junk that lengths keep invisible
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              dropout_p=0.0, training=False)

    def _attend_cached(self, q, k, v, cache):
        S = q.shape[1]
        if len(cache) == 3 and not isinstance(cache[0], str):
            k_buf, v_buf, pos = cache
            # pos: a Python int, or a 0-d device tensor (a captured step)
            i = torch.arange(S, device=q.device)
            k_buf.index_copy_(1, pos + i, k.to(k_buf.dtype))
            v_buf.index_copy_(1, pos + i, v.to(v_buf.dtype))
            T = k_buf.shape[1]
            i = i[:, None]
            j = torch.arange(T, device=q.device)[None, :]
            mask = torch.zeros((S, T), dtype=torch.float32, device=q.device) \
                .masked_fill_(j > pos + i, -1e30)[None, None]
            return F.scaled_dot_product_attention(
                q, k_buf, v_buf, attn_mask=mask, dropout_p=0.0,
                training=False)
        tag = cache[0]
        if tag == "paged":
            _, kp, vp, pos = cache
            if S > 1:
                paged_prefill_write(kp, k)
                paged_prefill_write(vp, v)
                return self._prefill_attend(q, k, v)
            paged_token_write(kp, k[:, 0], pos)
            paged_token_write(vp, v[:, 0], pos)
            return paged_decode_attend(q[:, 0], kp, vp, pos)[:, None]
        if tag == "served":
            _, kp, vp, table, lens = cache
            if S > 1:
                paged_table_prefill_write(kp, k, table)
                paged_table_prefill_write(vp, v, table)
                return self._prefill_attend(q, k, v)
            paged_table_token_write(kp, k[:, 0], table, lens)
            paged_table_token_write(vp, v[:, 0], table, lens)
            return paged_attention(q[:, 0], kp, vp, table, lens + 1)[:, None]
        if tag == "served_chunk":
            _, kp, vp, table, lens = cache
            paged_table_chunk_write(kp, k, table, lens)
            paged_table_chunk_write(vp, v, table, lens)
            return paged_chunk_attend(q, kp, vp, table, lens)
        if tag == "served_chunk_q":
            _, kp, vp, ks, vs, table, lens = cache
            paged_table_chunk_write_quant(kp, ks, k, table, lens)
            paged_table_chunk_write_quant(vp, vs, v, table, lens)
            return paged_chunk_attend_quant(q, kp, vp, ks, vs, table, lens)
        if tag == "served_q":
            # quantized pools: prefill attends the full-precision prompt
            # (only the cache is quantized); decode dequantizes in K4
            _, kp, vp, ks, vs, table, lens = cache
            if S > 1:
                paged_table_prefill_write_quant(kp, ks, k, table)
                paged_table_prefill_write_quant(vp, vs, v, table)
                return self._prefill_attend(q, k, v)
            paged_table_token_write_quant(kp, ks, k[:, 0], table, lens)
            paged_table_token_write_quant(vp, vs, v[:, 0], table, lens)
            return paged_attention_quantized(q[:, 0], kp, vp, ks, vs, table,
                                             lens + 1)[:, None]
        raise ValueError(f"unknown cache variant {tag!r}")


class GPTModel(torch.nn.Module):
    def __init__(self, vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 max_position_embeddings=1024, hidden_act="gelu"):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_size = hidden_size
        self.word_embeddings = Embedding(vocab_size, hidden_size)
        self.position_embeddings = Embedding(max_position_embeddings,
                                             hidden_size)
        self.drop = torch.nn.Dropout(hidden_dropout_prob)
        self.layers = torch.nn.ModuleList([
            GPTDecoderLayer(hidden_size, num_attention_heads, intermediate_size,
                            hidden_dropout_prob, attention_probs_dropout_prob,
                            hidden_act)
            for _ in range(num_hidden_layers)])
        self.final_ln = LayerNorm(hidden_size, 1e-5)

    def embed(self, input_ids, position_ids=None):
        if position_ids is None:
            S = input_ids.shape[1]
            position_ids = torch.arange(S, device=input_ids.device)[None, :]
        return self.drop(self.word_embeddings(input_ids)
                         + self.position_embeddings(position_ids))

    def forward(self, input_ids, position_ids=None, cache=None, lora=None):
        """``cache``: None, or one served cache tuple per layer; ``lora``:
        None, or the per-layer multi-tenant adapter slices; returns the
        final hidden states (and the per-layer caches when given)."""
        x = self.embed(input_ids, position_ids)
        new_cache = []
        for i, layer in enumerate(self.layers):
            li = lora[i] if lora is not None else None
            if cache is not None:
                x, c = layer(x, cache[i], lora=li)
                new_cache.append(c)
            else:
                x = layer(x, lora=li)
        x = self.final_ln(x)
        return (x, new_cache) if cache is not None else x


class GPTForCausalLM(torch.nn.Module):
    """LM head tied to the vocab embedding.

    ``device`` places the model: None means the card (an error without
    one), ``"cpu"`` the CPU.  The weights are drawn on the CPU from torch's
    default generator and then moved, so one ``torch.manual_seed`` gives
    the same model on every device.  ``dtype`` casts them (e.g. bf16)."""

    def __init__(self, gpt=None, device=None, dtype=None, **kwargs):
        super().__init__()
        target = resolve_device(device)
        self.gpt = gpt if gpt is not None else GPTModel(**kwargs)
        self.to(device=target, dtype=dtype)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """Logits ``[B, S, vocab]``; with ``labels`` the mean next-token
        cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``
        instead.  ``attention_mask`` is accepted for the TPU package's
        signature and, as there, not read: attention is causal."""
        hidden = self.gpt(input_ids, position_ids)
        h, w = amp.cast("matmul", hidden, self.gpt.word_embeddings.weight)
        logits = h @ w.T
        if labels is None:
            return logits
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1), reduction="mean")

    # ------------------------------------------------------------ generation
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
                 top_p=1.0, seed=None, use_cache=True,
                 decode_strategy="sampling", num_beams=4, length_penalty=0.0,
                 eos_token_id=None, cache_impl="dense", page_size=16,
                 max_len=None):
        """Autoregressive generation; ``input_ids`` ``[B, S0]`` (a tensor
        or an array), returns ``[B, S0 + max_new_tokens]`` int64 on the
        model's device.

        ``use_cache=True``: one prefill writes the prompt's K/V into
        preallocated caches, then one single-token step per new token
        (``_decode.decode_loop``); the caches are updated in place.
        ``cache_impl="dense"`` keeps ``[L, B, T, h, d]`` buffers attended
        under a mask (the plain attention, as in the TPU package);
        ``"paged"`` keeps per-sequence page pools, prefill through the
        flash kernel (K1) and decode through ``paged_decode_attend`` (K3).
        ``max_len`` pre-sizes the caches beyond ``S0 + max_new_tokens``.
        Greedy (``temperature=0``) ids are the same either way; sampling
        draws by Gumbel-max from a ``torch.Generator`` seeded with
        ``seed``.  ``use_cache=False``: the eager full-prefix loop, sampled
        on the host from ``np.random.RandomState(seed)``.
        ``decode_strategy="beam_search"``: :func:`_decode.beam_search`."""
        if decode_strategy == "beam_search":
            from ._decode import beam_search

            return beam_search(self, input_ids, max_new_tokens,
                               num_beams=num_beams,
                               length_penalty=length_penalty,
                               eos_token_id=eos_token_id)
        if not use_cache:
            return self._generate_eager(input_ids, max_new_tokens, temperature,
                                        top_k, top_p, seed)
        if max_new_tokens <= 0:
            return input_ids
        from ._decode import cached_decode, host_ids

        ids0 = host_ids(input_ids)
        B, S0 = ids0.shape
        T = max(S0 + max_new_tokens, max_len or 0)
        max_pos = self.gpt.position_embeddings.weight.shape[0]
        if T > max_pos:
            raise ValueError(
                f"generate: prompt {S0} + max_new_tokens {max_new_tokens} "
                f"(cache {T}) exceeds max_position_embeddings {max_pos}")
        gpt = self.gpt
        blk = gpt.layers[0]
        w = gpt.word_embeddings.weight

        def run(ids, cache, pos):
            S = ids.shape[1]
            pos_ids = pos + torch.arange(S, device=ids.device)[None, :]
            x, _ = gpt(ids, position_ids=pos_ids, cache=cache)
            return x[:, -1].float() @ w.float().T

        return cached_decode(
            self, run, ids0, max_new_tokens,
            (len(gpt.layers), B, T, blk.num_heads, blk.head_dim), w.dtype,
            cache_impl, page_size, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed)

    def _generate_eager(self, input_ids, max_new_tokens=32, temperature=1.0,
                        top_k=0, top_p=1.0, seed=None):
        """Full-prefix loop: every step runs the no-cache forward (K1 on
        the card) over the whole sequence so far, and picks the next token
        on the host with numpy, from ``np.random.RandomState(seed)`` when
        sampling, as the TPU package does."""
        from ._decode import host_ids

        ids = host_ids(input_ids)
        max_pos = self.gpt.position_embeddings.weight.shape[0]
        if ids.shape[1] + max_new_tokens > max_pos:
            raise ValueError(
                f"generate: prompt {ids.shape[1]} + max_new_tokens "
                f"{max_new_tokens} exceeds max_position_embeddings {max_pos}")
        dev = self.gpt.word_embeddings.weight.device
        rng = np.random.RandomState(seed)
        for _ in range(max_new_tokens):
            with torch.inference_mode():
                logits = self.forward(torch.as_tensor(ids, device=dev))
            step = logits[:, -1].float().cpu().numpy()
            if temperature != 1.0:
                step = step / max(temperature, 1e-6)
            if top_k:
                kk = min(int(top_k), step.shape[-1])
                kth = np.sort(step, axis=-1)[:, -kk][:, None]
                step = np.where(step < kth, -np.inf, step)
            if temperature == 0.0:
                nxt = step.argmax(-1)
            else:
                p = np.exp(step - step.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                if top_p < 1.0:  # nucleus: smallest prefix >= top_p
                    srt = np.argsort(-p, axis=-1)
                    ps = np.take_along_axis(p, srt, -1)
                    keep = np.cumsum(ps, -1) - ps < top_p
                    ps = np.where(keep, ps, 0.0)
                    ps = ps / ps.sum(-1, keepdims=True)
                    pick = np.stack([rng.choice(ps.shape[-1], p=ps[i])
                                     for i in range(ps.shape[0])])
                    nxt = np.take_along_axis(srt, pick[:, None], -1)[:, 0]
                else:
                    nxt = np.array([rng.choice(p.shape[-1], p=p[i])
                                    for i in range(p.shape[0])])
            ids = np.concatenate([ids, nxt[:, None]], axis=1)
        return torch.as_tensor(ids, device=dev)
