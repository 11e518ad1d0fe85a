"""Transformer layers (counterpart of ``paddle_tpu/nn/layers/transformer.py``).

``MultiHeadAttention`` keeps the reference's separate q / k / v / out
projections, its ``Cache`` (incremental, concatenated) and
``StaticCache`` (cross-attention) and its ``need_weights`` path (an
explicit softmax that also returns the weights).  Its attention core is
:func:`..functional.scaled_dot_product_attention`: on the card a call with
no mask and no active dropout runs the flash kernels (K1 forward, K2a /
K2b backward); a masked call, or dropout in training, runs the plain
attention, as the reference sends those to XLA.  ``TransformerEncoder``
and ``TransformerDecoder`` deep-copy their first layer, so every layer
starts from the same weights, as in the reference.  The layers build on
the CPU as ``torch.nn``'s do; ``Transformer``, a whole model, takes
``device=`` (the card unless ``"cpu"`` is asked for) and ``dtype=`` as
the text models do, and ``hapi.Model`` places any network it is given.

``weight_attr`` / ``bias_attr``: None, an object with an ``initializer``
attribute (paddle's ``ParamAttr``; the initializer draws in paddle's
``[in, out]`` layout), or ``bias_attr=False`` for no bias.
"""

from __future__ import annotations

import collections
import copy

import torch

from ... import amp
from ...device import resolve_device
from .. import functional as F
from .common import Dropout, Linear, promote
from .norm import LayerNorm


def _init_of(attr):
    return getattr(attr, "initializer", None)


def _linear(in_f, out_f, weight_attr=None, bias_attr=None):
    lin = Linear(in_f, out_f, bias=bias_attr is not False)
    w_init, b_init = _init_of(weight_attr), _init_of(bias_attr)
    with torch.no_grad():
        if w_init is not None:      # drawn in paddle's [in, out] layout
            lin.weight.copy_(w_init((in_f, out_f), lin.weight.dtype).T)
        if b_init is not None and lin.bias is not None:
            lin.bias.copy_(b_init((out_f,), lin.bias.dtype))
    return lin


class MultiHeadAttention(torch.nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = _linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = _linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = _linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        # (B, S, E) -> (B, S, H, D)
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        z = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=torch.float32, device=key.device)
        return self.Cache(z, z.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        if self.need_weights:
            out, weights = self._attn_with_weights(q, k, v, attn_mask)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
            weights = None
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None and isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def _attn_with_weights(self, q, k, v, mask):
        """Softmax attention returning ``(out [B, S, H, D], weights
        [B, H, Sq, Sk])``: the weights in the logits' dtype (the ``"mha"``
        op of the amp white list), no dropout, as the reference."""
        q, k, v, mask = amp.cast("mha", q, k, v, mask)
        q, k, v = promote(q, k, v)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
            1.0 / (self.head_dim ** 0.5))
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e30) \
                if mask.dtype == torch.bool else logits + mask
        w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v), w


class TransformerEncoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(torch.nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = _linear(d_model, dim_feedforward, weight_attr,
                               bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, weight_attr,
                               bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            inc_cache = None
        else:
            tgt, inc_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                            cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc_cache, cache[1]))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(torch.nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(torch.nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=None):
        """``device``: the card unless ``"cpu"`` is asked for (no card then
        raises); ``dtype``: the parameters' dtype (float32 by default)."""
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """Additive causal mask ``[length, length]``: 0 on and below the
        diagonal, -1e9 above; float32 on ``device`` (the card unless
        ``"cpu"`` is asked for)."""
        m = torch.ones(length, length, dtype=torch.float32,
                       device=resolve_device(device))
        return (torch.tril(m) - 1) * 1e9
