"""Speculative decoding for the serving engine (counterpart of
``paddle_tpu/serving/speculative.py``): n-gram drafting and multi-token
paged verification (Leviathan et al., "Fast Inference from Transformers
via Speculative Decoding"; drafts by prompt lookup, so there is no second
model).

- :class:`NgramDrafter` (host) — per-slot suffix match over the prompt and
  the generated ids.  When the context's n-token suffix occurred earlier,
  the tokens that followed it are the draft (up to ``k``); no match drafts
  nothing and the slot decodes one token that step.
- :func:`make_verifier` (device) — given the verification logits
  ``[B, k+1, V]`` of one multi-token step
  (:meth:`~.adapter.GPTAdapter.verify`), decide per slot how much of the
  draft survives and which token follows the surviving prefix.  Greedy
  rows accept draft t iff it equals the argmax after the t-1 prefix, so
  greedy outputs equal the plain engine's token for token.  Temperature
  rows use rejection sampling against the filtered distribution p̃: the
  n-gram draft is a point mass, so draft d is accepted with probability
  p̃(d) and a rejection resamples from p̃ with d zeroed, which makes the
  emitted marginal p̃ exactly.

Rejected tail tokens need no undo: their K/V lands past the slot's valid
length, invisible to the lengths, and the next chunk write overwrites it.
"""

from __future__ import annotations

import torch

from ..text.models._decode import apply_top_k_top_p, gumbel


class NgramDrafter:
    """Prompt-lookup draft model: a per-slot n-gram suffix index over the
    full context (prompt + generated ids).

    ``propose(sid)`` scans n-gram sizes from ``max_ngram`` down to
    ``min_ngram``: the first size whose current suffix occurred earlier in
    the context yields the tokens that followed its most recent earlier
    occurrence.  Returns up to ``k`` tokens; ``[]`` when nothing matches.
    """

    def __init__(self, k=4, max_ngram=3, min_ngram=1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self._ctx = {}     # sid -> list[int]
        self._index = {}   # sid -> {n -> {ngram tuple -> start pos}}

    def register(self, sid, context_ids):
        """(Re)build slot ``sid``'s index from a full context."""
        self._ctx[sid] = []
        self._index[sid] = {n: {} for n in
                            range(self.min_ngram, self.max_ngram + 1)}
        self.extend(sid, context_ids)

    def extend(self, sid, tokens):
        """Append newly emitted tokens to slot ``sid``'s context and index.

        An n-gram ending at position i is indexed once position i+1
        exists, so a lookup of the context's own suffix finds only a
        genuinely earlier occurrence (overlap with the suffix is fine:
        that makes single-token repetition draftable)."""
        ctx = self._ctx[sid]
        idx = self._index[sid]
        for t in tokens:
            e = len(ctx) - 1      # old last position: now safe to index
            for n in range(self.min_ngram, self.max_ngram + 1):
                if e - n + 1 >= 0:
                    idx[n][tuple(ctx[e - n + 1:e + 1])] = e - n + 1
            ctx.append(int(t))

    def release(self, sid):
        self._ctx.pop(sid, None)
        self._index.pop(sid, None)

    def reset(self):
        self._ctx.clear()
        self._index.clear()

    def propose(self, sid, max_tokens=None):
        """Draft up to ``min(k, max_tokens)`` continuation tokens for slot
        ``sid`` (``[]`` when no suffix matches or the cap is <= 0)."""
        cap = self.k if max_tokens is None else min(self.k, int(max_tokens))
        if cap <= 0:
            return []
        ctx = self._ctx.get(sid)
        if not ctx:
            return []
        idx = self._index[sid]
        L = len(ctx)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if L < n + 1:  # the suffix plus at least one earlier token
                continue
            j = idx[n].get(tuple(ctx[L - n:]))
            if j is not None:
                return ctx[j + n:j + n + cap]
        return []


def make_verifier(top_k=0, top_p=1.0):
    """The acceptance / resample function of the engine's verify step (one
    per engine: top_k / top_p are engine-level, as in
    :func:`~..text.models._decode.make_batched_sampler`).

    ``verify(logits, drafts, dlen, temps, generator)``:

    - ``logits [B, K+1, V]`` f32 — position t is the next-token
      distribution after the last sampled token and ``drafts[:t]``;
    - ``drafts [B, K]`` int — proposed tokens (junk past ``dlen[b]``);
    - ``dlen [B]`` — real draft length per slot (0 = no draft);
    - ``temps [B]`` f32 — per-slot temperature (<= 0 is greedy);

    returns ``(targets [B, K+1], accept [B, K])``: ``accept[b, t]`` says
    draft t+1 survives (always False past ``dlen``), and ``targets[b, a]``
    is the token to emit after accepting ``a`` drafts — the argmax, or the
    residual resample on a rejection, or a draw from the full p̃ where
    every real draft survived.  Random numbers come from ``generator``
    (uniforms for acceptance, Gumbel noise for the draws), in place of
    ``jax.random``'s split key."""

    def verify(logits, drafts, dlen, temps, generator):
        B, K1, V = logits.shape
        K = K1 - 1
        greedy = torch.argmax(logits, dim=-1)                     # [B, K1]
        l = logits / torch.clamp(temps, min=1e-6)[:, None, None]
        l = apply_top_k_top_p(l.reshape(B * K1, V), top_k, top_p)
        l = l.reshape(B, K1, V)
        p = torch.softmax(l, dim=-1)
        real = torch.arange(K, device=logits.device)[None, :] \
            < dlen.long()[:, None]                                # [B, K]
        d = drafts.long()
        pd = torch.gather(p[:, :K], -1, d[..., None])[..., 0]     # [B, K]
        u = torch.rand((B, K), dtype=torch.float32, device=logits.device,
                       generator=generator)
        acc_temp = u < pd                       # point-mass q: P(acc)=p̃(d)
        acc_greedy = d == greedy[:, :K]
        is_greedy = (temps <= 0.0)[:, None]
        accept = torch.where(is_greedy, acc_greedy, acc_temp) & real
        # the residual: where a real draft was verified, zero it out of the
        # distribution; position K (and the bonus positions of a short
        # draft) sample the full filtered p̃
        is_draft = torch.arange(V, device=logits.device)[None, None, :] \
            == d[..., None]                                       # [B, K, V]
        lm = l[:, :K].masked_fill(is_draft & real[..., None], float("-inf"))
        lr = torch.cat([lm, l[:, K:]], dim=1)                     # [B, K1, V]
        samp = torch.argmax(lr + gumbel(lr.shape, lr.dtype, lr.device,
                                        generator), dim=-1)
        targets = torch.where(is_greedy, greedy, samp)
        return targets, accept

    return verify


def make_masked_verifier(top_k=0, top_p=1.0):
    """Constrained-decoding twin of :func:`make_verifier` (multi-tenant
    serving): ``verify(logits, allowed, drafts, dlen, temps, generator)``
    with per-position token-FSM masks ``allowed [B, K+1, V]`` bool applied
    to the verification logits BEFORE acceptance and resampling, so a
    draft that exits the grammar is rejected by construction and the
    bonus / resample token at the first rejection is drawn from the masked
    distribution (always legal).  Disallowed entries get the reference's
    ``-1e30``; all-True rows verify bit-identically to
    :func:`make_verifier`."""
    inner = make_verifier(top_k, top_p)

    def verify(logits, allowed, drafts, dlen, temps, generator):
        return inner(torch.where(allowed, logits, -1e30), drafts, dlen,
                     temps, generator)

    return verify
