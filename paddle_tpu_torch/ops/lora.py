"""Paged LoRA adapter gather — the device side of multi-tenant serving
(counterpart of ``paddle_tpu/ops/lora.py``).

S-LoRA-style layout: adapter weights live in GLOBAL rank-bucketed pools
shared by every request, and each batch row gathers ITS adapter's
low-rank pair by slot id inside the step, so one decode dispatch serves
many fine-tunes and the program count is a function of the rank buckets,
never of the adapter count.

Layout per (decoder Linear target, rank bucket r):

    A_pool [L, C+1, d_in,  r]   down-projections, one row per adapter slot
    B_pool [L, C+1, r, d_out]   up-projections, SCALING PRE-FOLDED into B
    aid    [B] int32            per-batch-row adapter slot (0 = the null
                                slot: all-zero weights, i.e. base model)

Row 0 of every pool is the reserved NULL adapter (zeros), so every gather
index is valid and a base-model row's delta is an exact zero.

The reference computes these in jnp outside any Pallas kernel, so the
port is plain torch: the gather is indexing, the two low-rank products
are batched matmuls over fixed shapes (a row's delta depends on that row
only, whatever the other rows hold).
"""

from __future__ import annotations

import torch


def gather_adapter(pool, aid):
    """Per-row adapter gather: ``pool [C+1, ...]`` indexed by ``aid [B]``
    -> ``[B, ...]``."""
    return pool[aid.long()]


def lora_delta(x, *pairs):
    """Sum of low-rank bypass deltas for one Linear call.

    ``x [B, S, d_in]``; ``pairs`` = alternating per-row gathered
    ``A [B, d_in, r]``, ``B [B, r, d_out]`` (one pair per rank bucket —
    a row's adapter lives in exactly one bucket; its rows in the other
    buckets are the null slot, contributing exact zeros).  Returns
    ``[B, S, d_out]`` accumulated in f32, cast back to ``x.dtype``."""
    if len(pairs) % 2:
        raise ValueError("pairs must be alternating A, B arrays")
    out = None
    xf = x.float()
    for i in range(0, len(pairs), 2):
        a = pairs[i].float()
        b = pairs[i + 1].float()
        d = torch.matmul(torch.matmul(xf, a), b)  # [B,S,i]@[B,i,r]@[B,r,o]
        out = d if out is None else out + d
    return out.to(x.dtype)


def apply_lora(x, y, *pairs):
    """``y + lora_delta(x, *pairs)`` (``x`` the Linear's input, ``y`` its
    base output)."""
    return y + lora_delta(x, *pairs).to(y.dtype)
