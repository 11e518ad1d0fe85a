"""The decode loop and the samplers (counterpart of
``paddle_tpu/text/models/_decode.py``): ``generate()``'s prefill + one
step per token over preallocated caches (:func:`decode_loop`,
:func:`jitted_decode`), beam search, and the samplers the serving engine
and the speculative verifier share.

The TPU package compiles the prefill and a step with donated caches and
keeps the pair in the model's program store; here the store keeps the key,
and each call runs its prefill eagerly and its step as a
:class:`~paddle_tpu_torch.jit.graphs.Program` over a cache of the call's
own, updated in place (on the card a CUDA graph, captured at the first
step and replayed for the rest), with the tokens kept on the device until
the end.

Randomness comes from an explicit ``torch.Generator`` on the logits'
device.  It draws other numbers than ``jax.random`` from the same seed, so
sampled tokens agree with the TPU package in distribution, not in bits;
greedy rows are exact, non-finite rows included.  Like
``jax.random.categorical``, a draw is the Gumbel-max ``argmax(l + g)``:
a row holding NaN or inf gets a token (no check, no host sync) instead of
failing the batch.
"""

from __future__ import annotations

import numpy as np
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


def make_sampler(temperature, top_k, top_p):
    """``generate()``'s sampler: ``sample(logits [B, V], generator) ->
    [B]``; argmax at ``temperature == 0``, else a Gumbel-max draw from
    ``softmax(filter(logits / temperature))``."""

    def sample(logits, generator):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        l = logits / max(temperature, 1e-6)
        l = apply_top_k_top_p(l, top_k, top_p)
        return torch.argmax(l + gumbel(l.shape, l.dtype, l.device, generator),
                            dim=-1)

    return sample


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


def make_guarded_batched_sampler(top_k=0, top_p=1.0):
    """NaN-safe twin of :func:`make_batched_sampler`: ``sample(logits,
    temps, generator) -> (tokens, bad)``, ``bad [B] bool`` flagging rows
    whose logits hold any non-finite value (:func:`nonfinite_rows`, the
    flags the serving engine's numeric guard computes beside its one
    sampler).  The token math is the same sampler's, so every finite
    row's token is unchanged."""
    inner = make_batched_sampler(top_k, top_p)

    def sample(logits, temps, generator):
        return inner(logits, temps, generator), nonfinite_rows(logits)

    return sample


def make_masked_batched_sampler(top_k=0, top_p=1.0):
    """Constrained-decoding twin of :func:`make_batched_sampler`:
    ``sample(logits [B, V], allowed [B, V] bool, temps [B], generator)``.
    The multi-tenant engine's per-row token-FSM masks are applied BEFORE
    greedy / temperature sampling, so a constrained row can only emit
    grammar-legal tokens, while an all-True row samples bit-identically to
    the unmasked sampler (``where`` with an all-True predicate is the
    identity, and the Gumbel draw is the same).  Disallowed entries get
    the reference's large negative constant, not ``-inf``, so a
    temperature row's scores stay NaN-free."""
    inner = make_batched_sampler(top_k, top_p)

    def sample(logits, allowed, temps, generator):
        return inner(torch.where(allowed, logits, -1e30), temps, generator)

    return sample


def nonfinite_rows(logits):
    """``[B]`` bool: rows of ``logits [B, ...]`` holding a NaN or inf."""
    return ~torch.isfinite(logits).flatten(1).all(dim=1)


def host_ids(input_ids):
    """``[B, S]`` prompt ids as an int64 numpy array (from a tensor on any
    device, or an array)."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    return np.asarray(input_ids).astype(np.int64)


def _model_device(model):
    return next(model.parameters()).device


class _ProgramStore(dict):
    """A model's program store.  A copy of the model (``copy.deepcopy``,
    pickling) is another model, whose weights none of these programs has
    seen: it starts with an empty store."""

    def __deepcopy__(self, memo):
        return _ProgramStore()

    def __reduce__(self):
        return (_ProgramStore, ())


def program_store(model):
    """The per-model program store (the TPU package's, by name and key):
    ``decode_loop`` keys it by ``generate()``'s program keys, the serving
    engine by its ``(kind, shapes, sampler)`` keys, so a second engine
    over the same model finds its keys minted.  Stored in the model's
    ``__dict__``, outside ``nn.Module``'s attribute bookkeeping; it goes
    with the model."""
    store = model.__dict__.get("_decode_programs")
    if store is None:
        store = _ProgramStore()
        object.__setattr__(model, "_decode_programs", store)
    return store


class _GenerateKey:
    """What one ``generate()`` program key keeps between calls: how to
    build its decode step (the latest call's ``fwd``, ``init_cache`` and
    sampler, the batch and prompt widths), and the first call's build /
    run / capture walls for the program ledger.  The cache and the
    captured step are each call's own and are freed when it returns, as
    the TPU package's donated cache is: only the key outlives the call."""

    build_s = run_s = capture_s = 0.0
    pool_bytes = None

    def __init__(self, fwd, init_cache, sample, B, S0, device):
        self.fwd, self.init_cache, self.sample = fwd, init_cache, sample
        self.B, self.S0, self.device = B, S0, device

    def step_program(self, cache, gen):
        """The decode step over ``cache`` as a
        :class:`~paddle_tpu_torch.jit.graphs.Program` with inputs ``last
        [B, 1]`` and ``pos`` (a 0-d int64): it writes its token back into
        ``last`` and advances ``pos``, so consecutive runs need no host
        input.  On the card its first run is eager and captures a CUDA
        graph in a pool of its own; the later runs replay it."""
        from ...jit.graphs import Program

        fwd, sample = self.fwd, self.sample

        def step(last, pos):
            logits, _ = fwd(last, cache, pos)
            tok = sample(logits, gen)
            last.copy_(tok[:, None])
            pos.add_(1)
            return (tok,)

        return Program(step, [((self.B, 1), torch.int64), ((), torch.int64)],
                       self.device, generator=gen)

    def cost(self):
        """One decode step's ``(flops, bytes)``, counted over a fresh zero
        cache (one call's working set, freed on return; never a live
        call's state)."""
        from ...observability import perf as _perf

        with torch.inference_mode(False):
            cache = self.init_cache()
        prog = self.step_program(
            cache, torch.Generator(device=self.device))
        prog.inputs[1].fill_(self.S0)
        return _perf.count_cost(lambda: prog.fn(*prog.inputs))


def decode_loop(model, fwd, ids0, max_new_tokens, init_cache,
                temperature=1.0, top_k=0, top_p=1.0, seed=None,
                program_key=None):
    """Prefill + one step per new token over a cache of this call's.

    ``fwd(ids [B, S] int64, cache, pos) -> (last-token logits f32 [B, V],
    cache)``, the cache updated in place; ``pos`` is 0 for the prefill
    and a 0-d int64 device tensor for the steps.  The model runs in eval
    mode (restored after) under ``torch.inference_mode``; the sampled
    tokens stay on the device, and one concatenation at the end gives the
    id matrix ``[B, S0 + max_new_tokens]`` on the model's device.

    The prefill runs eagerly; the step is a
    :class:`~paddle_tpu_torch.jit.graphs.Program` over the cache (on the
    card: the first step eager and captured as a CUDA graph, every later
    step a replay).  Cache, graph and its pool are freed on return.

    ``program_key`` names everything the step is specialized on
    (``generate()``'s ``(cache_impl, B, S0, T, ..., sampling, training)``):
    the key lives in :func:`program_store`, so its first call is its mint
    (a ``generate.decode`` row in the program ledger, billed the prefill
    and the step's build and capture) and later calls are warm (recorded
    in the perf table per emitted token)."""
    from time import perf_counter

    from ...observability import perf as _perf
    from ...observability import programs as _programs
    from ...observability import tracing as _tracing

    B, S0 = ids0.shape
    device = _model_device(model)
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    store = program_store(model) if program_key is not None else None
    warm = store is not None and program_key in store
    ent = _GenerateKey(fwd, init_cache,
                       make_sampler(temperature, top_k, top_p), B, S0, device)
    if store is not None:
        if warm:
            # keep the mint's walls; the closures are this call's
            old = store[program_key]
            ent.build_s, ent.run_s = old.build_s, old.run_s
            ent.capture_s, ent.pool_bytes = old.capture_s, old.pool_bytes
        store[program_key] = ent
        # every store mint lands a ledger row; warm hits record provenance
        _programs.ledger().record_mint(
            program_key, family="generate.decode", kind="generate",
            store=store, owner=model, replica="-", warm=warm)
    try:
        with torch.inference_mode():
            gen = torch.Generator(device=device)
            gen.manual_seed(seed if seed is not None else 0)
            with torch.inference_mode(False):
                cache = init_cache()
            step = ent.step_program(cache, gen)
            t_loop = perf_counter()
            ids = torch.as_tensor(ids0, device=device)
            logits, _ = fwd(ids, cache, 0)
            nxt = ent.sample(logits, gen)
            out = [ids, nxt[:, None].clone()]
            last, pos = step.inputs
            last.copy_(nxt[:, None])
            pos.fill_(S0)
            for t in range(1, max_new_tokens):
                tok, = step()
                out.append(tok[:, None].clone())
                if t == 1 and not warm and store is not None:
                    # the mint's stall: the prefill and the step's first
                    # run (its kernels' build, and on the card its capture)
                    ent.build_s, ent.run_s = step.build_s, step.run_s
                    ent.capture_s, ent.pool_bytes = \
                        step.capture_s, step.pool_bytes
                    _programs.ledger().record_compile(
                        program_key, perf_counter() - t_loop,
                        family="generate.decode", kind="generate",
                        store=store, owner=model, replica="-",
                        trace_id=_tracing.current_trace_id(), program=ent)
            if store is not None and _perf.needs_cost("generate.decode"):
                _perf.register_cost_thunk("generate.decode",
                                          _perf.jit_cost_thunk(ent))
            ids = torch.cat(out, dim=1)
            if warm:
                # the whole loop per emitted token (a cold call's walls are
                # build and capture, not device time)
                ids.cpu()
                _perf.record("generate.decode", perf_counter() - t_loop,
                             calls=max_new_tokens)
            return ids
    finally:
        for m, tr in modes:
            m.training = tr


def jitted_decode(model, fwd, ids0, max_new_tokens, cache_shape, cache_dtype,
                  temperature=1.0, top_k=0, top_p=1.0, seed=None,
                  program_key=None):
    """Dense-cache decode: zeroed K/V buffers ``cache_shape`` ``[L, B, T,
    h, d]`` on the model's device; ``fwd(ids, ks, vs, pos) -> (logits, ks,
    vs)``.  The name is the TPU package's; nothing is compiled here."""
    device = _model_device(model)

    def fwd_cache(ids, cache, pos):
        ks, vs = cache
        logits, ks, vs = fwd(ids, ks, vs, pos)
        return logits, (ks, vs)

    def init_cache():
        ks = torch.zeros(tuple(cache_shape), dtype=cache_dtype, device=device)
        return ks, torch.zeros_like(ks)

    return decode_loop(model, fwd_cache, ids0, max_new_tokens, init_cache,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       seed=seed, program_key=program_key)


def cached_decode(model, run, ids0, max_new_tokens, cache_shape, cache_dtype,
                  cache_impl="dense", page_size=16, **sampling):
    """``generate()``'s cached decode for a decoder whose ``run(ids, caches,
    pos) -> last-token logits f32 [B, V]`` runs its layers over one cache
    tuple per layer.  ``cache_shape`` ``[L, B, T, h, d]``; ``cache_impl=
    "dense"``: zeroed buffers of that shape, layer i's cache ``(ks[i],
    vs[i], pos)`` (:func:`jitted_decode`); ``"paged"``: per-sequence pools
    :func:`paged_pool_shape`, layer i's cache ``("paged", kps[i], vps[i],
    pos)``.  ``sampling``: :func:`decode_loop`'s."""
    L, B, T, h, d = cache_shape
    key = (B, ids0.shape[1], T)
    train = bool(model.training)
    samp = (sampling.get("temperature", 1.0), sampling.get("top_k", 0),
            sampling.get("top_p", 1.0))
    if cache_impl == "paged":
        pool = paged_pool_shape(B, T, h, d, page_size)

        def fwd_paged(ids, cache, pos):
            kps, vps = cache
            return run(ids, [("paged", kps[i], vps[i], pos)
                             for i in range(L)], pos), cache

        def init_cache():
            kp = torch.zeros((L,) + pool, dtype=cache_dtype,
                             device=_model_device(model))
            return kp, torch.zeros_like(kp)

        return decode_loop(model, fwd_paged, ids0, max_new_tokens, init_cache,
                           program_key=("paged", *key, page_size, *samp,
                                        train), **sampling)
    if cache_impl != "dense":
        raise ValueError(f"cache_impl must be 'dense' or 'paged', "
                         f"got {cache_impl!r}")

    def fwd(ids, ks, vs, pos):
        return run(ids, [(ks[i], vs[i], pos) for i in range(L)], pos), ks, vs

    return jitted_decode(model, fwd, ids0, max_new_tokens, cache_shape,
                         cache_dtype, program_key=("dense", *key, *samp, train),
                         **sampling)


def paged_pool_shape(batch, max_len, num_kv_heads, head_dim, page_size=16):
    """``[B, PP, ps, h, d]`` pool shape covering ``max_len`` tokens."""
    pp = -(-max_len // page_size)
    return (batch, pp, page_size, num_kv_heads, head_dim)


def beam_search(model, input_ids, max_new_tokens, num_beams=4,
                length_penalty=0.0, eos_token_id=None):
    """Beam search (PaddleNLP ``decode_strategy='beam_search'``):
    ``num_beams`` hypotheses per batch item, expanded by log-prob, the
    global top beams kept, each hypothesis penalized by its own finished
    length at the end.  The bookkeeping is host numpy; scoring runs the
    no-cache forward (K1 on the card) over prefixes right-padded to
    ``S0 + max_new_tokens``, and takes the logits at ``pos - 1`` (causality
    makes the padding invisible there), so every step has one shape.

    model: a causal LM (``model(ids) -> [N, S, V]`` logits).  Returns
    ``[B, S0 + max_new_tokens]`` int64 on the model's device (best beam
    per item; an early EOS pads with EOS)."""
    if max_new_tokens <= 0:
        return input_ids
    ids0 = host_ids(input_ids)
    B, S0 = ids0.shape
    device = _model_device(model)
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    S_max = S0 + max_new_tokens

    def last_logits(arr, cur_len):
        padded = np.zeros((arr.shape[0], S_max), np.int64)
        padded[:, :cur_len] = arr
        with torch.inference_mode():
            out = model(torch.as_tensor(padded, device=device))
            return out[:, cur_len - 1].double().cpu().numpy()

    def log_softmax(l):
        m = l.max(-1, keepdims=True)
        return l - (np.log(np.exp(l - m).sum(-1, keepdims=True)) + m)

    try:
        # first expansion: top num_beams continuations of each prompt
        logp = log_softmax(last_logits(ids0, S0))
        V = logp.shape[-1]
        top = np.argsort(-logp, axis=-1)[:, :num_beams]        # [B, beams]
        scores = np.take_along_axis(logp, top, -1)             # [B, beams]
        seqs = np.concatenate(
            [np.repeat(ids0[:, None], num_beams, 1), top[..., None]], -1)
        done = np.zeros((B, num_beams), bool)
        # finished-hypothesis pool per item: a beam is recorded the moment
        # it hits EOS, so later eviction from the live set cannot lose it
        pool = [[] for _ in range(B)]  # (penalized score, seq)

        def penalize(sc, ln):
            return sc / (max(ln, 1) ** length_penalty) if length_penalty \
                else sc

        def record(b, k, t):
            pool[b].append((penalize(scores[b, k], t), seqs[b, k].copy()))

        if eos_token_id is not None:
            done |= top == eos_token_id
            for b, k in zip(*np.nonzero(done)):
                record(b, k, 1)

        for t in range(1, max_new_tokens):
            if done.all():
                break
            logp = log_softmax(last_logits(seqs.reshape(B * num_beams, -1),
                                           seqs.shape[-1]))
            logp = logp.reshape(B, num_beams, V)
            if eos_token_id is not None:
                # finished beams only extend with EOS at no cost
                frozen = np.full((V,), -np.inf)
                frozen[eos_token_id] = 0.0
                logp = np.where(done[..., None], frozen, logp)
            cand = scores[..., None] + logp                    # [B, beams, V]
            pick = np.argsort(-cand.reshape(B, num_beams * V),
                              axis=-1)[:, :num_beams]
            beam_idx, tok = pick // V, pick % V
            scores = np.take_along_axis(cand.reshape(B, num_beams * V),
                                        pick, -1)
            seqs = np.concatenate(
                [np.take_along_axis(seqs, beam_idx[..., None], 1),
                 tok[..., None]], -1)
            done = np.take_along_axis(done, beam_idx, 1)
            if eos_token_id is not None:
                just = (~done) & (tok == eos_token_id)
                done |= just
                for b, k in zip(*np.nonzero(just)):
                    record(b, k, t + 1)
    finally:
        for m, tr in modes:
            m.training = tr

    # best hypothesis = max over the finished pool and the live beams.
    # seqs is [B, beams, length]: the TPU package reads seqs.shape[1] (the
    # beam count) here as the length, so a pooled EOS hypothesis is never
    # padded (np.stack raises when rows differ) and live beams are
    # penalized by max(beams - S0, 1); the port uses the length
    out_rows = []
    gen_total = seqs.shape[-1] - S0
    padv = eos_token_id if eos_token_id is not None else 0
    for b in range(B):
        cands = list(pool[b])
        for k in range(num_beams):
            if not done[b, k]:  # live beam: penalized by its full length
                cands.append((penalize(scores[b, k], gen_total), seqs[b, k]))
        best_seq = max(cands, key=lambda x: x[0])[1]
        if len(best_seq) < S_max:  # a pool snapshot from an early step
            best_seq = np.concatenate(
                [best_seq, np.full(S_max - len(best_seq), padv,
                                   best_seq.dtype)])
        out_rows.append(best_seq)
    return torch.as_tensor(np.stack(out_rows), device=device)
