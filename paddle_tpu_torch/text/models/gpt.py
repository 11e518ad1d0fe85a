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


def _mp_degree():
    from ...distributed.topology import model_parallel_group

    g = model_parallel_group()
    return g.nranks if g is not None else 1


def _col_linear(d_in, d_out, bias=True):
    if _mp_degree() > 1:
        from ...distributed.fleet.meta_parallel import ColumnParallelLinear

        return ColumnParallelLinear(d_in, d_out, gather_output=False,
                                    has_bias=bias)
    return Linear(d_in, d_out, bias_attr=None if bias else False)


def _row_linear(d_in, d_out, bias=True):
    if _mp_degree() > 1:
        from ...distributed.fleet.meta_parallel import RowParallelLinear

        return RowParallelLinear(d_in, d_out, input_is_parallel=True,
                                 has_bias=bias)
    return Linear(d_in, d_out, bias_attr=None if bias else False)


def _vocab_embedding(vocab, hidden):
    if _mp_degree() > 1:
        from ...distributed.fleet.meta_parallel import VocabParallelEmbedding

        return VocabParallelEmbedding(vocab, hidden)
    return Embedding(vocab, hidden)


class GPTDecoderLayer(torch.nn.Module):
    """Pre-LN causal block: ln1 -> attn -> +res -> ln2 -> mlp -> +res."""

    def __init__(self, hidden_size, num_heads, intermediate_size, dropout=0.0,
                 attn_dropout=0.0, act="gelu"):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.ln1 = LayerNorm(hidden_size, 1e-5)
        self.qkv = _col_linear(hidden_size, 3 * hidden_size)
        self.out_proj = _row_linear(hidden_size, hidden_size)
        self.ln2 = LayerNorm(hidden_size, 1e-5)
        self.ffn1 = _col_linear(hidden_size, intermediate_size)
        self.ffn2 = _row_linear(intermediate_size, hidden_size)
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
                 max_position_embeddings=1024, type_vocab_size=1,
                 initializer_range=0.02, pad_token_id=0, hidden_act="gelu"):
        # type_vocab_size, initializer_range and pad_token_id are the
        # reference's parameters, accepted and not read, as there
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_size = hidden_size
        self.word_embeddings = _vocab_embedding(vocab_size, hidden_size)
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

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                use_cache=False, cache=None, lora=None):
        """``cache``: None, or one served cache tuple per layer; ``lora``:
        None, or the per-layer multi-tenant adapter slices; returns the
        final hidden states (and the per-layer caches when given).
        ``attention_mask`` and ``use_cache`` are the reference's
        parameters, accepted and not read (attention is causal; ``cache``
        decides)."""
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
        signature and, as there, not read: attention is causal.

        Under tensor parallelism (mp > 1) each rank computes its vocab
        slice of the logits against its embedding shard: the loss goes
        through ``parallel_softmax_cross_entropy`` (the full logits never
        exist), and without ``labels`` the slices are gathered, because
        the reference returns the logits whole."""
        hidden = self.gpt(input_ids, position_ids)
        group = getattr(self.gpt.word_embeddings, "group", None)
        if group is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import copy_to_mp

            hidden = copy_to_mp(hidden, group)
        h, w = amp.cast("matmul", hidden, self.gpt.word_embeddings.weight)
        logits = h @ w.T
        if group is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import (
                gather_from_mp, parallel_softmax_cross_entropy)

            if labels is None:
                return gather_from_mp(logits, group)
            y = labels[:, 1:]
            # the mean over the labels that count, as cross_entropy's
            return (parallel_softmax_cross_entropy(logits[:, :-1], y, group)
                    .sum() / (y != -100).sum())
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
        ``decode_strategy="beam_search"``: :func:`_decode.beam_search`.

        Under tensor parallelism (``fleet`` with mp > 1) every rank of the
        mp group calls it with the same ids: the caches hold the rank's
        heads (K1 / K3 on them), the vocab-parallel head's logits are
        gathered, so each rank samples the same tokens from its generator
        seeded alike; the decode step runs eagerly (a collective cannot be
        captured in a CUDA graph)."""
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
        group = getattr(gpt.word_embeddings, "group", None)

        def run(ids, cache, pos):
            S = ids.shape[1]
            pos_ids = pos + torch.arange(S, device=ids.device)[None, :]
            x, _ = gpt(ids, position_ids=pos_ids, cache=cache)
            logits = x[:, -1].float() @ w.float().T
            if group is not None:
                from ...distributed.fleet.meta_parallel.mp_layers import \
                    gather_from_mp

                logits = gather_from_mp(logits, group)
            return logits

        return cached_decode(
            self, run, ids0, max_new_tokens,
            (len(gpt.layers), B, T, local_heads(blk), blk.head_dim), w.dtype,
            cache_impl, page_size, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, eager=group is not None)

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


def local_heads(blk):
    """The heads a decoder block computes: all of them, or this rank's
    under tensor parallelism (its qkv holds whole head triples)."""
    w = getattr(blk.qkv, "weight", None)
    if w is None:
        w = blk.qkv.weight_int8
    return w.shape[0] // (3 * blk.head_dim)


# ------------------------------------------------------- the serving mesh
# Megatron placement of each block parameter: which dim of the RAW weight
# is split over the model axis, in the reference's paddle [in, out] layout
# (None = replicated).  The port's Linear stores torch's [out, in], so
# mp_param_specs flips every weight's dim.
_TP_DIM = {
    "qkv.weight": 1, "qkv.bias": 0,
    "ffn1.weight": 1, "ffn1.bias": 0,
    "out_proj.weight": 0, "ffn2.weight": 0,
}


def mp_param_specs(axis="model"):
    """Suffix -> per-dim spec (a tuple naming ``axis`` at the split dim,
    None elsewhere: the reference's ``PartitionSpec`` as a plain tuple) for
    Megatron tensor parallelism of a decoder block, in torch's layout:
    qkv / ffn1 column-parallel (``[out, in]`` split on dim 0, bias on 0),
    out_proj / ffn2 row-parallel (split on dim 1).  The qkv projection is
    head-major, so a contiguous split hands each shard whole (q, k, v)
    head triples, which the per-shard KV pools line up with.
    ``weight_int8`` buffers (``Int8Linear``) split like the weights they
    replace; anything unmatched (embeddings, LayerNorms, the row-parallel
    biases, the tied head) is replicated."""
    specs = {}
    for name, dim in _TP_DIM.items():
        if name.endswith(".weight"):
            entries = [None, None]
            entries[1 - dim] = axis
            specs["." + name] = specs["." + name + "_int8"] = tuple(entries)
        else:
            specs["." + name] = (axis,)
    return specs


class RowParallelShard(torch.nn.Module):
    """A row-parallel projection of a serving shard: this rank's input
    columns (``inner``, a ``Linear`` or ``Int8Linear`` without its bias),
    the partial products summed over the mesh's group, then the
    replicated ``bias``.  ``group`` (a :class:`~...serving.mesh.MeshGroup`)
    is attached in each rank's process; without one the layer is its
    shard's plain product."""

    def __init__(self, inner, bias):
        super().__init__()
        self.inner = inner
        self.bias = bias
        self.group = None

    def forward(self, x):
        y = self.inner(x)
        if self.group is not None:
            y = self.group.all_reduce(y)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def mp_shard(model, mp, rank, device=None, axis="model"):
    """Shard ``rank`` of ``mp`` of a :class:`GPTForCausalLM`, for the
    serving mesh: a copy of the model holding only its slice of every
    split tensor (:func:`mp_param_specs`) and the replicated rest, made on
    ``device`` (default: the model's), the row-parallel projections in
    :class:`RowParallelShard`.  An ``Int8Linear``'s payload is sliced, its
    per-tensor scale kept: the full weight is quantized once, never a
    shard on its own.  The full model is read, never changed."""
    import copy
    import itertools

    specs = mp_param_specs(axis)
    memo = {}
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if id(t) in memo:
            continue
        spec = next((sp for suf, sp in specs.items() if name.endswith(suf)),
                    None)
        part = t.detach()
        if spec is not None:
            part = part.chunk(mp, dim=spec.index(axis))[rank]
        part = part.to(device).clone() if device is not None \
            else part.clone()
        if isinstance(t, torch.nn.Parameter):
            part = type(t)(part, requires_grad=t.requires_grad)
        memo[id(t)] = part
    shard = copy.deepcopy(model, memo)
    for blk in shard.gpt.layers:
        for name in ("out_proj", "ffn2"):
            lin = getattr(blk, name)
            bias = lin.bias
            lin.bias = None
            setattr(blk, name, RowParallelShard(lin, bias))
    return shard


def attach_mesh_group(shard, group):
    """Give a shard's row-parallel projections (and their ``Int8Linear``'s
    dynamic activation absmax) the rank's mesh group."""
    for m in shard.modules():
        if isinstance(m, RowParallelShard):
            m.group = group
            if hasattr(m.inner, "absmax_group"):
                m.inner.absmax_group = group


# ---------------------------------------------------------------- pipeline
def _hcg_of(hcg=None):
    if hcg is None:
        from ...distributed.topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    return hcg


def _pp_of(hcg):
    return (hcg.get_pipe_parallel_world_size(), hcg.get_stage_id()) \
        if hcg is not None else (1, 0)


def _stage_layer_ids(n, pp, stage, order="stage"):
    """The global indices of the blocks stage ``stage`` runs, in its
    order: ``'stage'`` a contiguous chunk (gpipe, 1f1b), ``'lap'`` layer
    ``j`` on stage ``j % pp``, lap-major (interleaved)."""
    if n % pp:
        raise ValueError(f"{n} layers not divisible by pp={pp}")
    per = n // pp
    if order == "lap":
        return [lap * pp + stage for lap in range(per)]
    return [stage * per + i for i in range(per)]


def _held_blocks(model: GPTModel, pp, order, hcg=None):
    """This rank's blocks of ``model`` in schedule order: those a pipe
    model holds (``layers`` keyed by global index), else its stage's
    slice of a whole model's."""
    stage = _pp_of(_hcg_of(hcg))[1] if pp > 1 else 0
    if isinstance(model.layers, torch.nn.ModuleDict):
        n = int(getattr(model, "_pp_num_layers"))
        return [model.layers[str(j)]
                for j in _stage_layer_ids(n, pp, stage, order)]
    return [model.layers[j]
            for j in _stage_layer_ids(len(model.layers), pp, stage, order)]


def _attr(module, name):
    for part in name.split("."):
        module = getattr(module, part)
    return module


def _block_params(model: GPTModel, pp: int, order="stage", hcg=None):
    """This rank's blocks' parameters in schedule ``order``, one dict
    ``{name: tensor}`` a block.  They are read by attribute, so under
    ``TrainStep``'s O2 binding they are the bf16 copies."""
    blocks = _held_blocks(model, pp, order, hcg)
    names = [k for k, _ in blocks[0].named_parameters()]
    return [{k: _attr(b, k) for k in names} for b in blocks]


def stack_block_params(model: GPTModel, pp: int, order="stage", hcg=None):
    """This rank's stage slice of the (structurally identical) decoder
    blocks' parameters, stacked: ``{name: [layers_per_stage, ...]}``, the
    form ``spmd_pipeline`` takes from the reference's callers.
    ``order='stage'`` stacks the stage's contiguous chunk (the gpipe and
    1f1b schedules); ``order='lap'`` stacks layers ``stage, stage + pp,
    ...`` (the virtual stages the interleaved schedule runs lap-major).
    The stack is a differentiable copy; :func:`pipeline_forward` passes
    the blocks' own parameters instead."""
    layers = _block_params(model, pp, order, hcg)
    return {k: torch.stack([d[k] for d in layers]) for k in layers[0]}


def block_fn_for(model: GPTModel):
    """``(stage_params, x) -> x`` for ``spmd_pipeline``: runs the
    stage's ``layers_per_stage`` blocks in turn, binding each slice of
    the stacked ``stage_params`` into one held block's structure."""
    one = single_block_fn_for(model)

    def block_fn(stage_params, x):
        per = next(iter(stage_params.values())).shape[0]
        for i in range(per):
            x = one({k: v[i] for k, v in stage_params.items()}, x)
        return x

    return block_fn


def single_block_fn_for(model: GPTModel):
    """``(one layer's params, x) -> x`` — the per-virtual-stage body the
    interleaved schedule calls once per lap, binding the params into the
    structure of a block this rank holds (the blocks are alike)."""
    layers = model.layers
    block = next(iter(layers.values())) \
        if isinstance(layers, torch.nn.ModuleDict) else layers[0]

    def block_fn(stage_params, x):
        return torch.func.functional_call(block, stage_params, (x,))

    return block_fn


def _dp_rows(t, n_micro, batch_axis, hcg):
    """The rows of ``t`` (``[B, ...]``) this dp rank runs: the reference
    reshapes ``[B] -> [n_micro, micro]`` and shards ``micro`` over dp,
    so dp rank ``r`` takes block ``r`` of every micro-batch."""
    dp = hcg.get_data_parallel_world_size() if hcg is not None else 1
    if batch_axis is None or dp == 1:
        return t
    B = t.shape[0]
    micro = B // n_micro
    if B % n_micro or micro % dp:
        raise ValueError(f"batch {B} in {n_micro} micro-batches does not "
                         f"split over dp={dp}")
    r, ml = hcg.get_data_parallel_rank(), micro // dp
    t = t.reshape((n_micro, micro) + tuple(t.shape[1:]))[:, r * ml:(r + 1) * ml]
    return t.reshape((n_micro * ml,) + tuple(t.shape[2:]))


def pipeline_forward(model: GPTModel, input_ids, hcg=None, n_micro=1,
                     batch_axis=None, schedule="gpipe"):
    """GPT forward with the decoder stack pipelined over the pp group:
    embed (every stage, a replica) -> ``spmd_pipeline`` over this rank's
    blocks -> final LayerNorm (every stage).  ``input_ids``: ``[B, S]``,
    the whole batch; ``B`` splits into ``n_micro`` micro-batches, and
    with ``batch_axis='dp'`` each dp rank runs its block of every
    micro-batch (returned: its rows).  ``schedule='interleaved'`` runs the
    circular virtual-stage schedule (layer ``j`` on stage ``j % pp``)."""
    from ...distributed.fleet.meta_parallel.pipeline_schedule import (
        _run_pipeline)

    hcg = _hcg_of(hcg)
    pp = _pp_of(hcg)[0]
    interleaved = schedule == "interleaved"
    # the held blocks' own parameters, one dict a block: a stage call
    # runs its list in turn, an interleaved lap its one entry
    layers = _block_params(model, pp, "lap" if interleaved else "stage", hcg)
    one = single_block_fn_for(model)

    def stage_fn(stage_layers, h):
        for p in stage_layers:
            h = one(p, h)
        return h

    x = model.embed(_dp_rows(input_ids, n_micro, batch_axis, hcg))
    xm = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    out = _run_pipeline(one if interleaved else stage_fn, layers, xm, hcg,
                        schedule=schedule, per_lap=interleaved)
    return model.final_ln(out.reshape(x.shape))


_SCHEDULE_MODES = {"1f1b": "1f1b", "interleave": "interleaved",
                   "interleaved": "interleaved", "f-then-b": "gpipe",
                   "gpipe": "gpipe"}


def _schedule_from_strategy():
    """The reference's contract: with ``strategy.pipeline`` enabled,
    ``pipeline_configs['schedule_mode']`` selects the schedule
    (``'F-then-B'`` / ``'1F1B'`` / ``'Interleave'``); otherwise gpipe."""
    from ...distributed import fleet as _fleet

    st = _fleet.get_strategy()
    if st is None or not getattr(st, "pipeline", False):
        return "gpipe"
    mode = str(st.pipeline_configs.get("schedule_mode", "1F1B")).strip().lower()
    if mode not in _SCHEDULE_MODES:
        import warnings

        warnings.warn(f"unknown pipeline schedule_mode {mode!r}; "
                      "falling back to gpipe (F-then-B)")
    return _SCHEDULE_MODES.get(mode, "gpipe")


class GPTForCausalLMPipe(torch.nn.Module):
    """GPTForCausalLM with the decoder stack run through the pipeline
    schedules (reference analog: PaddleNLP's ``GPTForCausalLMPipe`` built
    on ``PipelineLayer``), one process per pp rank.

    It takes over ``lm`` (``GPTForCausalLM(**kwargs)`` when None):
    a rank keeps the embeddings, the final LayerNorm and the tied head as
    replicas, and only its stage's blocks (``lm.gpt.layers`` becomes a
    ``ModuleDict`` keyed by global layer index, so the state dict keys
    are the reference's).  The schedule comes from
    ``strategy.pipeline_configs['schedule_mode']`` when not given.  With
    labels it returns the mean next-token loss (the vocab-sharded head
    when mp > 1: no rank holds ``[B, S, V]`` logits); with
    ``batch_axis='dp'`` each dp rank runs its rows, the loss is the mean
    over dp and the gradients are averaged over the dp group after each
    backward, as ``DataParallel`` averages them (no ``DataParallel``
    needed)."""

    def __init__(self, lm: "GPTForCausalLM" = None, hcg=None, n_micro=1,
                 batch_axis=None, schedule=None, **kwargs):
        super().__init__()
        hcg = _hcg_of(hcg)
        if hcg is None:
            raise ValueError("GPTForCausalLMPipe needs a hybrid topology "
                             "(fleet.init first)")
        if schedule is None:
            schedule = _schedule_from_strategy()
        self.lm = lm if lm is not None else GPTForCausalLM(**kwargs)
        self._hcg = hcg
        self._n_micro = n_micro
        self._batch_axis = batch_axis
        self._schedule = schedule
        gpt = self.lm.gpt
        pp, stage = _pp_of(hcg)
        n = len(gpt.layers)
        order = "lap" if schedule == "interleaved" else "stage"
        self._held = _stage_layer_ids(n, pp, stage, order)
        gpt.layers = torch.nn.ModuleDict(
            {str(j): gpt.layers[j] for j in self._held})
        gpt._pp_num_layers = n
        if pp > 1:
            for p in gpt.layers.parameters():
                p.pp_holders = 1
        dp = hcg.get_data_parallel_world_size()
        self._dp_group = hcg.get_data_parallel_group() \
            if batch_axis is not None and dp > 1 else None
        if self._dp_group is not None:
            from ...distributed.parallel import GradReducer, broadcast_

            broadcast_(list(self.parameters()), self._dp_group.ranks[0],
                       self._dp_group)
            # each dp rank's gradient is its own rows' loss's
            self._reducer = GradReducer(self.parameters(), self._dp_group)

    def _pp_prefixes(self):
        """(this rank's block key prefixes, the other stages')."""
        n = self.lm.gpt._pp_num_layers
        own = [f"lm.gpt.layers.{j}." for j in self._held]
        other = [f"lm.gpt.layers.{j}." for j in range(n)
                 if j not in self._held]
        return own, other

    def _pp_group(self):
        return self._hcg.get_pipe_parallel_group() \
            if _pp_of(self._hcg)[0] > 1 else None

    def forward(self, input_ids, labels=None):
        gpt = self.lm.gpt
        hidden = pipeline_forward(gpt, input_ids, self._hcg, self._n_micro,
                                  batch_axis=self._batch_axis,
                                  schedule=self._schedule)
        w = gpt.word_embeddings.weight
        group = getattr(gpt.word_embeddings, "group", None)
        if labels is not None:
            labels = _dp_rows(labels, self._n_micro, self._batch_axis,
                              self._hcg)
        if labels is not None and group is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import (
                sharded_vocab_head_loss)

            return sharded_vocab_head_loss(hidden, w, labels, group,
                                           self._dp_group)
        if group is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import (
                copy_to_mp, gather_from_mp)

            h, wc = amp.cast("matmul", copy_to_mp(hidden, group), w)
            return gather_from_mp(h @ wc.T, group)
        h, wc = amp.cast("matmul", hidden, w)
        logits = h @ wc.T
        if labels is None:
            return logits
        from ...distributed.fleet.meta_parallel.mp_layers import mean_over

        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1), reduction="mean")
        return mean_over(loss, self._dp_group)
