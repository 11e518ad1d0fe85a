"""GPT decoder LM (counterpart of ``paddle_tpu/text/models/gpt.py``).

Ported for the serving and training slices: the pre-LN decoder block with
its no-cache path (full causal attention, which training takes; on the
card it runs the flash kernels forward and backward) and its ``"served"``
cache variant — ONE
global page pool per layer for K and V, shared by every slot through a
page table, with per-slot lengths.  Prefill (S > 1) attends the prompt
with the flash kernel and writes its K/V into the pool; decode (S == 1)
writes the token first, then attends with the paged flash-decode kernel
over ``lens + 1`` positions.  The ``"served_q"`` variant does the same
over int8 pools with parallel float32 scale pools: the writes quantize,
decode runs the dequantizing kernel.  The pools are updated in place.

The qkv projection's output is HEAD-MAJOR, ``[B, S, heads, 3, head_dim]``,
as in the TPU package (a column split over heads hands each shard whole
(q, k, v) heads), so weights converted from it line up.
"""

from __future__ import annotations

import torch

from ... import amp
from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers.common import Linear
from ...nn.layers.norm import LayerNorm
from ...ops.paged_attention import (paged_attention, paged_attention_quantized,
                                    paged_table_prefill_write,
                                    paged_table_prefill_write_quant,
                                    paged_table_token_write,
                                    paged_table_token_write_quant)


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

    def forward(self, x, cache=None):
        """``cache`` is None (full causal attention over ``x``), the
        served tuple ``("served", kp, vp, table, lens)`` — this layer's
        pools ``[P, ps, heads, head_dim]``, the page table ``[B, NP]``
        int32 and the per-slot lengths ``[B]`` int32 — or the quantized
        ``("served_q", kp, vp, ks, vs, table, lens)`` with int8 pools and
        float32 scale pools ``[P, ps, heads]``.  Returns ``x``, or ``(x,
        cache)`` with the same (updated in place) pools."""
        residual = x
        h = self.ln1(x)
        qkv = self.qkv(h)
        B, S = h.shape[0], h.shape[1]
        heads = qkv.shape[-1] // (3 * self.head_dim)
        q, k, v = qkv.reshape(B, S, heads, 3, self.head_dim).unbind(3)
        if cache is None:
            attn = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout,
                training=self.training)
        elif cache[0] == "served":
            _, kp, vp, table, lens = cache
            if S > 1:
                # admit-time prefill over the right-padded prompt; pad
                # positions write junk into pages that per-slot lengths
                # (or the engine's scratch page) keep invisible
                attn = F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, dropout_p=0.0, training=False)
                paged_table_prefill_write(kp, k, table)
                paged_table_prefill_write(vp, v, table)
            else:
                paged_table_token_write(kp, k[:, 0], table, lens)
                paged_table_token_write(vp, v[:, 0], table, lens)
                attn = paged_attention(q[:, 0], kp, vp, table, lens + 1)[:, None]
        elif cache[0] == "served_q":
            # quantized pools: prefill attends the full-precision prompt
            # (only the cache is quantized); the writes round K/V onto the
            # int8 grid; decode dequantizes inside the kernel
            _, kp, vp, ks, vs, table, lens = cache
            if S > 1:
                attn = F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, dropout_p=0.0, training=False)
                paged_table_prefill_write_quant(kp, ks, k, table)
                paged_table_prefill_write_quant(vp, vs, v, table)
            else:
                paged_table_token_write_quant(kp, ks, k[:, 0], table, lens)
                paged_table_token_write_quant(vp, vs, v[:, 0], table, lens)
                attn = paged_attention_quantized(q[:, 0], kp, vp, ks, vs,
                                                 table, lens + 1)[:, None]
        else:
            raise NotImplementedError(
                f"cache variant {cache[0]!r} is not ported yet (only "
                f"'served' and 'served_q')")
        attn = attn.reshape(B, S, heads * self.head_dim)
        x = residual + self.dropout(self.out_proj(attn))
        residual = x
        h = self.ffn2(self.act(self.ffn1(self.ln2(x))))
        x = residual + self.dropout(h)
        return x if cache is None else (x, cache)


class GPTModel(torch.nn.Module):
    def __init__(self, vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 max_position_embeddings=1024, hidden_act="gelu"):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_size = hidden_size
        self.word_embeddings = torch.nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = torch.nn.Embedding(max_position_embeddings,
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
        wte, wpe = amp.cast("embedding", self.word_embeddings.weight,
                            self.position_embeddings.weight)
        return self.drop(torch.nn.functional.embedding(input_ids, wte)
                         + torch.nn.functional.embedding(position_ids, wpe))

    def forward(self, input_ids, position_ids=None, cache=None):
        """``cache``: None, or one served cache tuple per layer; returns
        the final hidden states (and the per-layer caches when given)."""
        x = self.embed(input_ids, position_ids)
        new_cache = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x, c = layer(x, cache[i])
                new_cache.append(c)
            else:
                x = layer(x)
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
