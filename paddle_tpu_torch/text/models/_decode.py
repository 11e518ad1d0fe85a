"""Sampling shared by the serving engine (counterpart of
``paddle_tpu/text/models/_decode.py``; the jitted generate() loop there
waits for a later slice).

Randomness comes from an explicit ``torch.Generator`` on the logits'
device.  It draws other numbers than ``jax.random`` from the same seed, so
sampled tokens agree with the TPU package in distribution, not in bits;
greedy rows are exact, non-finite rows included.  Like
``jax.random.categorical``, a draw is the Gumbel-max ``argmax(l + g)``:
a row holding NaN or inf gets a token (no check, no host sync) instead of
failing the batch.
"""

from __future__ import annotations

import torch


def apply_top_k_top_p(l, top_k, top_p):
    """Top-k / top-p (nucleus) filtering on ``[N, V]`` logits; filtered
    entries become ``-inf``.  top_k / top_p are engine-level constants."""
    if top_k:
        kk = min(int(top_k), l.shape[-1])
        kth = torch.topk(l, kk, dim=-1).values[:, -1:]
        l = l.masked_fill(l < kth, float("-inf"))
    if top_p < 1.0:  # nucleus: smallest prefix of sorted probs >= top_p
        srt = torch.sort(l, dim=-1, descending=True).values
        p = torch.softmax(srt, dim=-1)
        keep_n = ((torch.cumsum(p, dim=-1) - p) < top_p).sum(-1)
        # a non-finite row keeps nothing (keep_n = 0): index -1 wraps to
        # the row's smallest value, as jnp.take_along_axis does
        kth = srt.gather(-1, ((keep_n - 1) % srt.shape[-1])[:, None])
        l = l.masked_fill(l < kth, float("-inf"))
    return l


def gumbel(shape, dtype, device, generator):
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)`` (``jax.random.gumbel``'s ``minval=tiny``)."""
    u = torch.rand(shape, dtype=dtype, device=device, generator=generator)
    u = torch.clamp_(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def make_batched_sampler(top_k=0, top_p=1.0):
    """Per-slot sampler for the serving engine: ``sample(logits [B, V],
    temps [B], generator) -> [B] int64``.  Rows with ``temps <= 0`` take
    the argmax; the others draw from ``softmax(filter(logits / temp))`` by
    Gumbel-max, as ``jax.random.categorical`` does."""

    def sample(logits, temps, generator):
        greedy = torch.argmax(logits, dim=-1)
        l = logits / torch.clamp(temps, min=1e-6)[:, None]
        l = apply_top_k_top_p(l, top_k, top_p)
        samp = torch.argmax(l + gumbel(l.shape, l.dtype, l.device, generator),
                            dim=-1)
        return torch.where(temps <= 0.0, greedy, samp)

    return sample
