"""Activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False,
preserve_rng_state=True)``: the segment's activations are dropped after
the forward and ``fn`` runs again in the backward to rebuild them, so a
kernel inside it launches twice per step (K1 once in the forward and once
in the replay).

RNG: ``preserve_rng_state`` saves and restores only PyTorch's default
generators (the CPU's and each card's).  A segment that draws from an
explicit ``torch.Generator`` would draw a different dropout mask in the
replay than in the forward, and the gradients would be wrong without an
error.  So the generators of ``generators=`` and every
``torch.Generator`` found among the attributes of ``fn``'s modules (when
``fn`` is a ``torch.nn.Module``) are saved at the forward and set back
for the replay, then returned to where they were.

``checkpoint_policy`` (a JAX remat policy in the reference) accepts only
``None``; a policy waits for ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint


def _module_generators(fn):
    """Every ``torch.Generator`` held as an attribute by ``fn``'s modules."""
    if not isinstance(fn, torch.nn.Module):
        return []
    gens = []
    for m in fn.modules():
        for v in vars(m).values():
            if isinstance(v, torch.Generator) \
                    and not any(v is g for g in gens):
                gens.append(v)
    return gens


def _generator_contexts(gens):
    """``context_fn`` for ``checkpoint``: the forward stashes each
    generator's state; the replay runs from those states and then puts the
    generators back where the backward found them."""
    stash = {}

    @contextlib.contextmanager
    def forward_ctx():
        stash["states"] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, stash["states"]):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return lambda: (forward_ctx(), recompute_ctx())


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` with activation checkpointing.

    ``preserve_rng_state`` (default True) and ``use_reentrant`` are
    accepted for paddle's signature (the non-reentrant checkpoint always
    runs); ``generators=`` names explicit generators the segment draws
    from; ``checkpoint_policy`` must be None."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    policy = kwargs.pop("checkpoint_policy", None)
    if policy is not None:
        raise NotImplementedError(
            "checkpoint_policy (a selective remat policy) is not ported: "
            "pass None; policies wait for ROADMAP Queue 1 item 9")
    gens = list(kwargs.pop("generators", None) or ())
    for g in _module_generators(function):
        if not any(g is h for h in gens):
            gens.append(g)
    extra = {"context_fn": _generator_contexts(gens)} if gens else {}
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **extra, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Checkpoint a sequence of layers span-wise: ``ctx["segments"]``
    spans (1 by default), each recomputed as one segment."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    per = max(1, n // max(segments, 1))
    x = args[0] if len(args) == 1 else args
    i = 0
    while i < n:
        span = layers[i:i + per]

        def run(h, _span=span):
            for layer in _span:
                h = layer(h)
            return h

        gens = [g for layer in span for g in _module_generators(layer)]
        x = recompute(run, x, generators=gens, **kwargs)
        i += per
    return x
