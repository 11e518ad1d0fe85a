"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` takes the paddle layout
``[batch, seq, heads, head_dim]``.  On a CUDA tensor:

- **Dropout inactive** (``dropout_p == 0`` or ``training=False``): a call
  with no mask, 4-D inputs and as many kv heads as query heads goes to the
  hand-written flash kernels (``ops/flash_attention``) at every sequence
  length and head_dim <= 256 -- when it needs a gradient, through their
  autograd ``Function`` (K1 forward, K2 backward).  The TPU package sends
  an eval-mode call with ``dropout_p > 0`` to its plain attention; the
  function is the same (dropout is off), and the port runs K1 there.  A
  masked call runs :func:`_sdpa_ref` on the card, as the TPU package sends
  every masked call to its plain XLA attention (GPT's dense decode cache
  takes this path); an additive float32 mask promotes lower-precision
  logits to float32 there, as in JAX.
- **Dropout active** (``dropout_p > 0`` and ``training``), or head_dim >
  256: :func:`_sdpa_ref` with its inverted dropout, as the TPU package
  sends every call its flash kernel refuses to its plain attention (the
  TPU package has no Pallas dropout).  The keep mask is drawn from
  PyTorch's generator on the card, not the TPU package's key.
- Unequal head counts without a mask (GQA: Llama repeats its K / V heads
  first), and a causal call with more queries than keys, raise
  ``NotImplementedError``.

``flash_attention`` is paddle's public flash call: the same kernels, no
mask, no dropout while training.

Tensors on any other device (``meta``) raise ``NotImplementedError``; CPU
tensors take :func:`_sdpa_ref`.  Under ``amp.auto_cast`` the inputs are
cast to the amp dtype (white list).  q, k and v of different float dtypes
are first promoted to their common dtype, as jnp's einsum promotes them
(Llama's f32 rotated q / k beside a bf16 v run K1's f32 body on the card).
"""

from __future__ import annotations

import torch

from ... import amp
from ...ops import _build
from ...ops.flash_attention import (MAX_HEAD_DIM, flash_attention_bshd,
                                   flash_attention_fn, supported)
from ..layers.common import promote


def _sdpa_ref(q, k, v, mask, dropout_p, causal, scale, training):
    """Plain attention, ``[B, S, H, D]`` in and out: logits in q's dtype,
    softmax in f32, bottom-right causal mask, bool (keep) or additive
    mask, inverted dropout on the probabilities when training."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qT, kT, vT = (x.transpose(1, 2) for x in (q, k, v))     # [B, H, S, D]
    logits = torch.einsum("bhqd,bhkd->bhqk", qT, kT) * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~cm, -1e30)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -1e30)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p and training:
        keep = torch.rand(probs.shape, device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vT)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """paddle layout: (batch, seq, num_heads, head_dim)."""
    query, key, value, attn_mask = amp.cast(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    query, key, value = promote(query, key, value)
    if query.device.type == "cpu":
        return _sdpa_ref(query, key, value, attn_mask, dropout_p, is_causal,
                         scale, training)
    grad = _build.needs_grad(query, key, value)
    dropout = bool(dropout_p) and training
    if query.device.type == "cuda":
        if (attn_mask is None and not dropout and query.ndim == 4
                and supported(query.shape, key.shape, is_causal)):
            return flash_attention_bshd(query, key, value, causal=is_causal,
                                        scale=scale)
        heads_equal = query.ndim != 4 or key.shape[2] == query.shape[2]
        if attn_mask is not None or (heads_equal and (
                dropout or query.shape[-1] > MAX_HEAD_DIM)):
            return _sdpa_ref(query, key, value, attn_mask, dropout_p,
                             is_causal, scale, training)
    raise NotImplementedError(
        f"scaled_dot_product_attention on {query.device}: runs on cuda or "
        f"cpu tensors; on cuda the flash kernel takes 4-D [B, S, H, D] "
        f"inputs with equal q/kv head counts, head_dim <= {MAX_HEAD_DIM} "
        f"and, when causal, no more queries than keys; "
        f"a masked call, an active dropout or a wider head runs the plain "
        f"attention (got q {tuple(query.shape)}, k {tuple(key.shape)}, "
        f"mask={attn_mask is not None}, dropout_p={dropout_p}, "
        f"training={training}, needs_grad={grad})")


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """paddle's ``F.flash_attention``: ``[B, S, H, D]`` in and out, the
    softmax's scale ``1 / sqrt(D)``.  On the card it runs K1 forward and
    K2a / K2b backward (``ops.flash_attention.flash_attention_fn``), on
    CPU tensors their plain versions.  ``return_softmax`` gives ``(out,
    None)``, as in the reference: the softmax matrix never exists.
    Dropout inside the kernel is not taken while training
    (``NotImplementedError``, as there); use
    :func:`scaled_dot_product_attention` for dropout."""
    if dropout and training:
        raise NotImplementedError(
            "flash_attention dropout inside the kernel is not supported; "
            "use nn.functional.scaled_dot_product_attention for dropout")
    out = flash_attention_fn(query, key, value, causal=causal)
    return (out, None) if return_softmax else out
