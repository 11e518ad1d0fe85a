"""Llama family (counterpart of ``paddle_tpu/text/models/llama.py``): RMSNorm
pre-norm, rotary position embeddings, grouped-query attention, SwiGLU MLP,
no biases.

- RoPE is the HF half-split rotation, its cos / sin tables in f32.
- GQA repeats the K / V heads up to the query head count before
  ``scaled_dot_product_attention`` (``repeat_interleave``, the
  ``jnp.repeat`` convention: query head h reads kv head h // g), so the
  flash kernels (K1 forward, K2a / K2b backward) always see equal head
  counts; the backward of the repeat sums each group's dK / dV.  Only the
  paged decode groups heads inside its kernel (K3 through
  ``paged_decode_attend``).
- dtypes follow jnp's promotion, as in the TPU package: a bf16-weight model
  computes its activations in f32.  The f32 rope tables promote the
  rotated q / k of layer 0 to f32, the f32 attention output promotes the
  residual stream, and every later projection multiplies an f32 input by
  its bf16 weight in f32 (``nn.Linear``'s promotion).  So the paged prefill
  and the no-cache path run K1's f32 body, and the paged decode runs K3 with
  an f32 query over the bf16 pools; hidden states and logits are f32.
  Under ``amp.auto_cast`` the op lists cast as in the TPU package, through
  the same op names (``llama_rope``, ``gqa_repeat``, ``paged_write``,
  ``paged_attention``, ``cache_write``, ``cache_expand``, ``llama_mask``,
  ``llama_key_pad``, ``rope_tables``, ``matmul``, ``rms_norm``, ``swish``,
  ``embedding``, ``linear``): at O2 the kernels see bf16.
- Parameter names are the TPU package's (``llama.layers.{i}.self_attn.
  q_proj.weight``, ...), so ``convert.load_paddle_tpu_state_dict`` carries
  its weights across.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import amp
from ...device import resolve_device
from ...nn import functional as F
from ...nn.layers.common import Linear, promote
from ...nn.layers.norm import RMSNorm
from ...ops.paged_attention import (paged_decode_attend, paged_prefill_write,
                                    paged_token_write)

__all__ = ["LlamaModel", "LlamaForCausalLM", "LlamaConfig"]


class LlamaConfig(dict):
    """Config bag (attribute and dict access), the TPU package's defaults
    (Llama-2-7B).  Keys are read as attributes through ``__getattr__``, so
    a copy (``copy.deepcopy`` of a model) keeps them."""

    def __init__(self, **kw):
        defaults = dict(vocab_size=32000, hidden_size=4096,
                        intermediate_size=11008, num_hidden_layers=32,
                        num_attention_heads=32, num_key_value_heads=None,
                        max_position_embeddings=4096, rms_norm_eps=1e-6,
                        rope_theta=10000.0, tie_word_embeddings=False)
        defaults.update(kw)
        if defaults["num_key_value_heads"] is None:
            defaults["num_key_value_heads"] = defaults["num_attention_heads"]
        super().__init__(**defaults)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def _rope_cos_sin(positions, head_dim, theta):
    """``[S]`` or ``[B, S]`` int positions -> f32 cos / sin ``[..., S,
    head_dim]`` in the HF half-split layout (frequencies repeated over the
    two halves)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv                    # [..., S, d/2]
    ang = torch.cat([ang, ang], dim=-1)                         # [..., S, d]
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_rope(q, k, cos, sin):
    """q / k ``[B, S, h, d]``; cos / sin ``[S, d]`` or ``[B, S, d]``,
    broadcast over heads."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s


def _gqa_repeat(t, rep):
    """``[B, S, hkv, d]`` -> ``[B, S, hkv * rep, d]``, each kv head ``rep``
    times in a row (``jnp.repeat(t, rep, axis=2)``)."""
    t, = amp.cast("gqa_repeat", t)
    return torch.repeat_interleave(t, rep, dim=2)


@torch.no_grad()
def _reference_init(module, generator=None):
    """The HF init: every weight of two or more dims N(0, 0.02), drawn in
    f32 on the weight's device from ``generator`` (the device's default
    generator when None) and cast to the weight's dtype; every RMSNorm
    weight ones."""
    for _, p in module.named_parameters():
        if p.ndim >= 2:
            new = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            new.normal_(0.0, 0.02, generator=generator)
            p.copy_(new)
    for m in module.modules():
        if isinstance(m, RMSNorm):
            m.weight.fill_(1.0)


def _materialize(module, device, dtype, generator):
    """``module``, built on the meta device, given storage on ``device`` in
    ``dtype`` and :func:`_reference_init`'s weights (no other init runs, so
    a full-size bf16 model never exists in f32)."""
    if dtype is not None:
        module.to(dtype)
    module.to_empty(device=device)
    _reference_init(module, generator)


class LlamaMLP(torch.nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.gate_proj = Linear(hidden_size, intermediate_size, bias=False)
        self.up_proj = Linear(hidden_size, intermediate_size, bias=False)
        self.down_proj = Linear(intermediate_size, hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(torch.nn.Module):
    def __init__(self, config):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        self.q_proj = Linear(h, self.num_heads * self.head_dim, bias=False)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, bias=False)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, bias=False)

    def forward(self, x, rope, attn_bias=None, cache=None):
        """``cache`` is None (full causal attention over ``x``, or under the
        additive ``attn_bias [B, 1, S, S]``), or one of these, updated in
        place and returned beside the output:

        - ``(k_buf, v_buf, pos)`` — the static dense cache of
          ``generate()``: ``[B, T, hkv, d]`` buffers written at ``pos`` (a
          Python int, or a 0-d device tensor in a captured step) with the
          rotated keys, attended under an additive
          f32 mask (the plain attention, on the card too); ``attn_bias``,
          when given, is a key-padding bias ``[B, 1, 1, T]``;
        - ``("paged", kp, vp, pos)`` — ``generate(cache_impl="paged")``:
          per-sequence pools ``[B, PP, ps, hkv, d]``; the prefill attends
          with K1 over the repeated heads, a decode step through
          ``paged_decode_attend`` (K3, GQA grouped in the kernel)."""
        B, S = x.shape[0], x.shape[1]
        hd = self.head_dim
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        hq, hkv = q.shape[-1] // hd, k.shape[-1] // hd
        rep = hq // hkv
        q, k, v, cos, sin = amp.cast("llama_rope", q, k, v, *rope)
        qh, kh = _apply_rope(q.reshape(B, S, hq, hd), k.reshape(B, S, hkv, hd),
                             cos, sin)
        vh = v.reshape(B, S, hkv, hd)
        if cache is not None and len(cache) == 4 and cache[0] == "paged":
            _, kp, vp, pos = cache
            if attn_bias is not None:
                raise NotImplementedError(
                    "paged cache + attention_mask: per-sequence padding masks "
                    "belong in seq_lens (PagedKVCache); the uniform generate() "
                    "paged path takes no mask")
            # the pools are written in place: the new K / V are cast (to the
            # pool's dtype in the end, as the TPU package's .at[].set does)
            kw, vw = amp.cast("paged_write", kh, vh)
            if S > 1:           # prefill: causal attention + page write
                kf, vf = kh, vh
                if rep > 1:
                    kf, vf = _gqa_repeat(kh, rep), _gqa_repeat(vh, rep)
                att = F.scaled_dot_product_attention(qh, kf, vf, is_causal=True,
                                                     training=False)
                paged_prefill_write(kp, kw)
                paged_prefill_write(vp, vw)
            else:
                paged_token_write(kp, kw[:, 0], pos)
                paged_token_write(vp, vw[:, 0], pos)
                qq, kps, vps = amp.cast("paged_attention", qh, kp, vp)
                att = paged_decode_attend(qq[:, 0], kps, vps, pos)[:, None]
            return self.o_proj(att.reshape(B, S, hq * hd)), cache
        if cache is not None:
            k_buf, v_buf, pos = cache
            kw, vw = amp.cast("cache_write", kh, vh)
            # the rope math runs in f32; the buffers keep their dtype
            # pos: a Python int, or a 0-d device tensor (a captured step)
            idx = pos + torch.arange(S, device=k_buf.device)
            k_buf.index_copy_(1, idx, kw.to(k_buf.dtype))
            v_buf.index_copy_(1, idx, vw.to(v_buf.dtype))
            kf, vf, mask = self._expand_and_mask(k_buf, v_buf, pos, S, rep,
                                                 attn_bias)
            att = F.scaled_dot_product_attention(qh, kf, vf, attn_mask=mask,
                                                 dropout_p=0.0, training=False)
            return self.o_proj(att.reshape(B, S, hq * hd)), cache
        if rep > 1:             # GQA: the kv heads repeated to the q heads
            kh, vh = _gqa_repeat(kh, rep), _gqa_repeat(vh, rep)
        if attn_bias is not None:
            att = F.scaled_dot_product_attention(qh, kh, vh,
                                                 attn_mask=attn_bias,
                                                 training=self.training)
        else:
            att = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                 training=self.training)
        return self.o_proj(att.reshape(B, S, hq * hd))

    @staticmethod
    def _expand_and_mask(k_buf, v_buf, pos, S, rep, bias):
        """The dense cache's K / V, each kv head repeated ``rep`` times, and
        its additive f32 mask ``[1 or B, 1, S, T]``: query i sees slots
        ``<= pos + i``, plus the key-padding ``bias`` over all T slots."""
        kk, vv, bias = amp.cast("cache_expand", k_buf, v_buf, bias)
        if rep > 1:
            kk = torch.repeat_interleave(kk, rep, dim=2)
            vv = torch.repeat_interleave(vv, rep, dim=2)
        T = k_buf.shape[1]
        dev = k_buf.device
        i = torch.arange(S, device=dev)[:, None]
        j = torch.arange(T, device=dev)[None, :]
        m = torch.zeros((S, T), dtype=torch.float32, device=dev) \
            .masked_fill_(j > pos + i, -1e30)[None, None]
        if bias is not None:
            if bias.shape[-1] != T:
                raise ValueError(f"cache-mode attention_mask must cover all "
                                 f"{T} cache slots, got {bias.shape[-1]}")
            m = m + bias
        return kk, vv, m


class LlamaDecoderLayer(torch.nn.Module):
    def __init__(self, config):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=config.rms_norm_eps)
        self.mlp = LlamaMLP(config.hidden_size, config.intermediate_size)

    def forward(self, x, rope, attn_bias=None, cache=None):
        if cache is not None:
            att, new_cache = self.self_attn(self.input_layernorm(x), rope,
                                            attn_bias, cache)
            x = x + att
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, new_cache
        x = x + self.self_attn(self.input_layernorm(x), rope, attn_bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(torch.nn.Module):
    """Embedding, decoder layers and final norm.  Built on ``device`` (the
    card when None, the CPU when asked) in ``dtype``, its weights drawn
    there by :func:`_reference_init` from ``generator``."""

    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kw):
        super().__init__()
        self.config = config if isinstance(config, LlamaConfig) \
            else LlamaConfig(**(config or {}), **kw)
        cfg = self.config
        with torch.device("meta"):
            self.embed_tokens = torch.nn.Embedding(cfg.vocab_size,
                                                   cfg.hidden_size)
            self.layers = torch.nn.ModuleList(
                [LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
            self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps)
        # the reference init: Embedding's N(0, 1) would start the loss far
        # above ln(vocab)
        _materialize(self, resolve_device(device), dtype, generator)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                cache=None):
        w, = amp.cast("embedding", self.embed_tokens.weight)
        x = torch.nn.functional.embedding(input_ids, w)
        S = x.shape[1]
        if position_ids is None:
            position_ids = torch.arange(S, device=x.device)
        cfg = self.config
        hd = cfg.hidden_size // cfg.num_attention_heads
        # the rope tables and the padding bias, built once for all layers
        position_ids, = amp.cast("rope_tables", position_ids)
        rope = _rope_cos_sin(position_ids, hd, cfg.rope_theta)
        bias = None
        if attention_mask is not None:
            keep = attention_mask.to(torch.bool)
            pad = torch.zeros(keep.shape, dtype=torch.float32,
                              device=keep.device).masked_fill_(~keep, -1e30)
            if cache is not None:
                # cache mode: the mask covers the KEY SLOTS [B, T]; the
                # causal part comes from the cache's position mask
                bias, = amp.cast("llama_key_pad", pad[:, None, None, :])
            else:
                i = torch.arange(S, device=x.device)[:, None]
                j = torch.arange(S, device=x.device)[None, :]
                causal = torch.zeros((S, S), dtype=torch.float32,
                                     device=x.device).masked_fill_(j > i, -1e30)
                bias, = amp.cast("llama_mask",
                                 pad[:, None, None, :] + causal[None, None])
        if cache is not None:
            new_caches = []
            for layer, c in zip(self.layers, cache):
                x, nc = layer(x, rope, bias, c)
                new_caches.append(nc)
            return self.norm(x), new_caches
        for layer in self.layers:
            x = layer(x, rope, bias)
        return self.norm(x)


class LlamaForCausalLM(torch.nn.Module):
    """Llama with its LM head (tied to the embedding when
    ``tie_word_embeddings``).

    ``device`` places the model: None means the card (an error without
    one), ``"cpu"`` the CPU.  The weights are drawn on that device from
    ``generator`` (its default generator when None), so a seeded card
    generator makes a full-size model on the card with no host copy;
    parity with the TPU package comes through
    ``convert.load_paddle_tpu_state_dict``, not the random stream.
    ``dtype`` (e.g. bf16) is the weights' dtype."""

    def __init__(self, config=None, device=None, dtype=None, generator=None,
                 **kw):
        super().__init__()
        self.llama = LlamaModel(config, device=device, dtype=dtype,
                                generator=generator, **kw)
        cfg = self.llama.config
        self.tie = cfg.tie_word_embeddings
        if not self.tie:
            w = self.llama.embed_tokens.weight
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                  device="meta")
            _materialize(self.lm_head, w.device, w.dtype, generator)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """Logits ``[B, S, vocab]``; with ``labels`` the mean next-token
        cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``
        instead."""
        hidden = self.llama(input_ids, position_ids, attention_mask)
        if self.tie:
            h, w = promote(*amp.cast("matmul", hidden,
                                     self.llama.embed_tokens.weight))
            logits = h @ w.T
        else:
            logits = self.lm_head(hidden)
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
        """Autoregressive generation; ``input_ids`` ``[B, S0]`` (a tensor or
        an array), returns ``[B, S0 + max_new_tokens]`` int64 on the model's
        device.

        ``use_cache=True``: one prefill writes the prompt's rotated keys and
        values into preallocated caches in the weights' dtype, then one
        single-token step per new token (``_decode.decode_loop``).
        ``cache_impl="dense"`` keeps ``[L, B, T, hkv, d]`` buffers attended
        under a mask (the plain attention, as in the TPU package);
        ``"paged"`` keeps per-sequence pools at hkv heads, prefill through
        K1 and decode through ``paged_decode_attend`` (K3, GQA grouped in
        the kernel).  The last position's logits are computed in f32.
        Greedy ids are the same either way; sampling draws by Gumbel-max
        from a ``torch.Generator`` seeded with ``seed``.
        ``use_cache=False``: :meth:`_generate_eager`.
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
        cfg = self.llama.config
        if T > cfg.max_position_embeddings:
            raise ValueError(
                f"generate: prompt {S0} + max_new_tokens {max_new_tokens} "
                f"(cache {T}) exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        # the LM head's [vocab, hidden] weight, in f32 as in the reference
        w = self.llama.embed_tokens.weight if self.tie else self.lm_head.weight

        def run(ids, cache, pos):
            pos_ids = pos + torch.arange(ids.shape[1], device=ids.device)
            hidden, _ = self.llama(ids, position_ids=pos_ids, cache=cache)
            return hidden[:, -1].float() @ w.float().T

        return cached_decode(
            self, run, ids0, max_new_tokens,
            (cfg.num_hidden_layers, B, T, cfg.num_key_value_heads,
             cfg.hidden_size // cfg.num_attention_heads),
            self.llama.embed_tokens.weight.dtype, cache_impl, page_size,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)

    def _generate_eager(self, input_ids, max_new_tokens=32, temperature=1.0,
                        top_k=0, top_p=1.0, seed=None):
        """Full-prefix loop: every step runs the no-cache forward (K1 on
        the card) over the whole sequence so far and picks the next token on
        the host with numpy, from ``np.random.RandomState(seed or 0)`` when
        sampling, as the TPU package does."""
        from ._decode import host_ids

        ids = host_ids(input_ids)
        dev = self.llama.embed_tokens.weight.device
        rs = np.random.RandomState(seed if seed is not None else 0)
        modes = [(m, m.training) for m in self.modules()]
        self.eval()
        try:
            for _ in range(max_new_tokens):
                with torch.inference_mode():
                    logits = self.forward(torch.as_tensor(ids, device=dev))
                step = logits[:, -1].float().cpu().numpy()
                if temperature == 0.0:
                    nxt = step.argmax(-1)
                else:
                    step = step / max(temperature, 1e-6)
                    if top_k:
                        kk = min(int(top_k), step.shape[-1])
                        kth = np.sort(step, -1)[:, -kk][:, None]
                        step = np.where(step < kth, -np.inf, step)
                    p = np.exp(step - step.max(-1, keepdims=True))
                    p = p / p.sum(-1, keepdims=True)
                    if top_p < 1.0:  # nucleus: the smallest top set
                        srt = np.argsort(-p, axis=-1)
                        ps = np.take_along_axis(p, srt, -1)
                        keep = np.cumsum(ps, -1) - ps < top_p
                        ps = np.where(keep, ps, 0.0)
                        ps = ps / ps.sum(-1, keepdims=True)
                        pick = np.stack([rs.choice(ps.shape[-1], p=ps[b])
                                         for b in range(ps.shape[0])])
                        nxt = np.take_along_axis(srt, pick[:, None], -1)[:, 0]
                    else:
                        nxt = np.stack([rs.choice(p.shape[-1], p=p[b])
                                        for b in range(p.shape[0])])
                ids = np.concatenate([ids, nxt[:, None]], axis=1)
        finally:
            for m, tr in modes:
                m.training = tr
        return torch.as_tensor(ids, device=dev)
