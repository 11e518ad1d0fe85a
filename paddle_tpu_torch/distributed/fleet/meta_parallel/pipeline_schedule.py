"""Pipeline schedules, one process per stage (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_schedule.py``).

The reference is single-controller: every stage lives in one
``shard_map`` program, activations rotate one hop per tick by
``lax.ppermute``, and XLA derives the backward (by AD of the tick scan
for ``gpipe`` and ``interleaved``, by a ``custom_vjp`` for ``1f1b``).
Here each pp rank is a process of its own that holds only its stage's
parameters, so what XLA derives there is written out:

- the forward tick loop: at tick ``t`` stage ``s`` runs the micro-batch
  ``t - s`` reached (``interleaved``: one virtual stage of one lap), then
  the hops of the tick run;
- the backward, as its own tick loop in reverse stage order inside one
  ``torch.autograd.Function`` (the form of the reference's ``pipe``
  ``custom_vjp``): the cotangents hop from stage ``s + 1`` to ``s``;
- the replicated output: the last stage's outputs are broadcast over the
  pp group (the reference's ``all_gather(...)[S - 1]``), so every pp rank
  computes the head and the loss on the same hidden and ``backward()``
  runs unchanged on every rank.  The cotangent of the input reaches stage
  0 only and is broadcast over the pp group, as the reference's ``psum``
  replicates it, so every replica of the embedding gets it.

A hop is a ``broadcast`` from the sender in the two stages' pair group
(:meth:`..topology.HybridCommunicateGroup.get_stage_pair_group`) through
``communication.broadcast``, so it runs under the collective watchdog,
the ``collective.*`` series and the spans, over gloo (the CPU, two ranks
on one card) and NCCL alike.  A hop between bubble ticks carries nothing
and is skipped on both sides; the gpipe wrap hop (stage S - 1 to 0) is
never needed.  Each rank runs its hops of a tick in one global order (by
phase, then pair), so two blocking hops never wait on each other.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils import _pytree as pytree

from .... import amp as _amp
from ...communication import _nbytes, broadcast, record_collective_traffic

_FWD, _BWD = 0, 1
_SCHEDULES = ("gpipe", "interleaved", "1f1b")


def pipeline_tick_stats(n_micro, n_stages, layers_per_stage=1, schedule="gpipe"):
    """Tick counts + bubble fraction, in units of ONE layer-chunk of compute.

    gpipe merges the v chunks of a rank into one stage call, so each of its
    M+S-1 ticks costs v chunk-units; interleaved ticks cost 1 chunk-unit.
    Useful compute is v*M chunk-units per rank either way.
    """
    M, S, v = n_micro, n_stages, layers_per_stage
    if schedule == "interleaved" and v > 1:
        n_chunks = math.ceil(M / S)
        ticks = ((n_chunks - 1) * v * S) + v * S + (S - 1)
        total = ticks  # 1 chunk-unit per tick
    else:
        ticks = M + S - 1
        total = ticks * v
    useful = v * M
    return {"ticks": ticks, "compute_units": total, "useful_units": useful,
            "bubble_fraction": 1.0 - useful / total}


# ------------------------------------------------------------------ the hops
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8, torch.int8)
_HEADER = 12


class _Hops:
    """This rank's view of its pp group: ``S``, its stage ``idx`` and the
    stage-pair groups.  :meth:`exchange` runs one phase's hops; with
    ``header`` each hop is preceded by a small int64 header carrying the
    payload's shape and dtype (a generic ``PipelineLayer``'s activations
    change shape between stages), else the receiver allocates like
    ``like``."""

    def __init__(self, hcg, header=False):
        self.hcg = hcg
        self.S = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        self.idx = hcg.get_stage_id() if hcg is not None else 0
        self.first = hcg is None or hcg.is_first_stage()
        self.last = hcg is None or hcg.is_last_stage()
        self.group = hcg.get_pipe_parallel_group() if self.S > 1 else None
        self.header = header

    def _pair(self, pair):
        g = self.hcg.get_stage_pair_group(pair)
        if g is None:
            raise RuntimeError(f"stage {self.idx} is not in the stage-pair "
                               f"group {pair}")
        return g

    def exchange(self, ops, like=None):
        """``ops``: ``(phase, pair, tensor or None)`` items — a tensor is
        sent to the pair's other stage, None receives from it; run in
        (phase, pair) order.  Returns the received tensors in the order
        of the receiving items."""
        ops = sorted(ops, key=lambda o: (o[0], o[1]))
        if self.S == 1:     # one stage: its wrap hop is to itself
            sent = [t for _, _, t in ops if t is not None]
            return sent[:sum(t is None for _, _, t in ops)]
        got = []
        me = self.hcg.get_global_rank()
        for phase, pair, t in ops:
            g = self._pair(pair)
            # pair p joins stages p and p + 1: this stage is the one
            other = self.hcg.get_next_stage_rank() if pair == self.idx \
                else self.hcg.get_prev_stage_rank()
            if t is not None:
                t = t.contiguous()
                if self.header:
                    broadcast(_header(t), src=me, group=g)
                broadcast(t, src=me, group=g)
            else:
                if self.header:
                    h = broadcast(torch.zeros(_HEADER, dtype=torch.int64,
                                              device=like.device),
                                  src=other, group=g)
                    shape, dtype = _read_header(h)
                    buf = torch.empty(shape, dtype=dtype, device=like.device)
                else:
                    buf = torch.empty_like(like)
                got.append(broadcast(buf, src=other, group=g))
        return got

    def replicate(self, t, src_stage, like=None):
        """``t`` of stage ``src_stage`` onto every stage (in place).  With
        ``header``, the other stages pass ``t=None`` and receive a new
        tensor on ``like``'s device."""
        if self.S == 1:
            return t
        src = self.group.ranks[src_stage]
        if self.header:
            h = _header(t) if self.idx == src_stage else torch.zeros(
                _HEADER, dtype=torch.int64, device=like.device)
            broadcast(h, src=src, group=self.group)
            if self.idx != src_stage:
                shape, dtype = _read_header(h)
                t = torch.empty(shape, dtype=dtype, device=like.device)
        broadcast(t, src=src, group=self.group)
        return t


def _header(t):
    if t.ndim > _HEADER - 2:
        raise ValueError(f"a pipeline hop carries at most {_HEADER - 2} "
                         f"dims; got {t.ndim}")
    h = [t.ndim, _DTYPES.index(t.dtype)] + list(t.shape)
    h += [0] * (_HEADER - len(h))
    return torch.tensor(h, dtype=torch.int64, device=t.device)


def _read_header(h):
    h = h.cpu().tolist()
    return tuple(h[2:2 + h[0]]), _DTYPES[h[1]]


# ----------------------------------------------------------- the tick plans
class _Plan:
    """Where stage ``idx`` is at each tick of the lap-major schedule (the
    reference's interleaved body; ``gpipe`` is its ``v = 1`` case).  At
    tick ``t`` the stage handles stream position ``e = t - idx`` when
    ``0 <= e < v * M``: micro-batch ``chunk * S + pos`` on lap ``lap``,
    i.e. virtual stage ``lap * S + idx``."""

    def __init__(self, S, idx, M, v=1):
        self.S, self.idx, self.M, self.v = S, idx, M, v
        self.T = v * M + S - 1

    def at(self, t):
        e = t - self.idx
        if not 0 <= e < self.v * self.M:
            return None
        S, v = self.S, self.v
        if v == 1:
            return e, 0
        return (e // (v * S)) * S + e % S, (e // S) % v

    def injects(self, lap):
        return self.idx == 0 and lap == 0

    def finishes(self, lap):
        return self.idx == self.S - 1 and lap == self.v - 1

    def src_pair(self):
        """The pair an input arrives over (stage 0 on a later lap: the
        wrap pair)."""
        return self.idx - 1 if self.idx > 0 else self.S - 1

    def dst_pair(self):
        return self.idx if self.idx < self.S - 1 else self.S - 1

    def receives(self, t):
        a = self.at(t)
        return a is not None and not self.injects(a[1])

    def sends(self, t):
        a = self.at(t)
        return a is not None and not self.finishes(a[1])


# ------------------------------------------------------------- stage calls
@contextlib.contextmanager
def _amp_state(state):
    prev = _amp.amp_state()
    _amp._tls.state = state
    try:
        yield
    finally:
        _amp._tls.state = prev


class _Stage:
    """``block_fn`` over this rank's parameters (the leaves of the list of
    per-lap pytrees): the forward under no grad, and the vector-Jacobian
    product that recomputes it (the reference's ``jax.checkpoint`` of a
    stage call), with the amp state and the RNG state of the forward
    call."""

    def __init__(self, block_fn, spec, device):
        self.block_fn = block_fn
        self.spec = spec
        self.device = device
        self.amp = _amp.amp_state()
        self._rng = {}

    def params(self, leaves, lap):
        return pytree.tree_unflatten(list(leaves), self.spec)[lap]

    def _save_rng(self, key):
        st = [torch.get_rng_state()]
        if self.device.type == "cuda":
            st.append(torch.cuda.get_rng_state(self.device))
        self._rng[key] = st

    @contextlib.contextmanager
    def _replay_rng(self, key):
        st = self._rng.get(key)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, enabled=st is not None):
            if st is not None:
                torch.set_rng_state(st[0])
                if len(st) > 1:
                    torch.cuda.set_rng_state(st[1], self.device)
            yield

    def forward(self, leaves, lap, x, key, grad=False):
        """The stage's output; with ``grad``, also the graph
        ``(x leaf, param leaves, out)`` for a later :meth:`vjp`."""
        self._save_rng(key)
        with _amp_state(self.amp):
            if not grad:
                with torch.no_grad():
                    return self.block_fn(self.params(leaves, lap), x), None
            with torch.enable_grad():
                xl = _leaf(x)
                pl = [_leaf(p) for p in leaves]
                out = self.block_fn(self.params(pl, lap), xl)
            return out.detach(), (xl, pl, out)

    def recompute(self, leaves, lap, x, key):
        with self._replay_rng(key), _amp_state(self.amp), torch.no_grad():
            return self.block_fn(self.params(leaves, lap), x)

    def vjp(self, leaves, lap, x, g, key, graph=None):
        """``(dx, [dparam])`` of the stage call at ``x`` for cotangent
        ``g`` (None where a parameter does not reach the output)."""
        if graph is None:
            with self._replay_rng(key), _amp_state(self.amp), \
                    torch.enable_grad():
                xl = _leaf(x)
                pl = [_leaf(p) for p in leaves]
                out = self.block_fn(self.params(pl, lap), xl)
        else:
            xl, pl, out = graph
        want = [t for t in [xl, *pl] if t.requires_grad]
        grads = torch.autograd.grad(out, want, g.to(out.dtype),
                                    allow_unused=True)
        it = iter(grads)
        got = [next(it) if t.requires_grad else None for t in [xl, *pl]]
        return got[0], got[1:]


def _leaf(t):
    return t.detach().requires_grad_(t.is_floating_point())


def _accumulate(acc, grads):
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g.float() if acc[i] is None else acc[i] + g.float()


def _param_grads(acc, leaves):
    return [None if a is None else a.to(p.dtype) for a, p in zip(acc, leaves)]


def _input_grads(hops, gxs):
    """Stage 0's input cotangents onto every stage (the reference's
    ``psum`` of them); None for an integer input (token ids)."""
    if not gxs.is_floating_point():
        return None
    return hops.replicate(gxs, 0)


def _check_out(out, x, idx, hops):
    if not hops.header and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(
            f"stage {idx}: block_fn returned {tuple(out.shape)} "
            f"{out.dtype} for an input {tuple(x.shape)} {x.dtype}; a stage "
            "of spmd_pipeline keeps the activation's shape and dtype")


def _replicate_outs(hops, outs, xs):
    """The last stage's outputs stacked, onto every stage."""
    last = hops.last
    if hops.header:
        return hops.replicate(torch.stack(outs) if last else None,
                              hops.S - 1, like=xs)
    return hops.replicate(torch.stack(outs) if last else torch.empty_like(xs),
                          hops.S - 1)


# --------------------------------------------------------- gpipe / interleaved
class _TickPipe(torch.autograd.Function):
    """The gpipe / interleaved pipeline: forward ticks, then the backward
    ticks in reverse (the transpose of the reference's tick scan)."""

    @staticmethod
    def forward(ctx, run, xs, *leaves):
        hops, plan, stage = run["hops"], run["plan"], run["stage"]
        remat = run["remat"]
        M = plan.M
        saved, graphs, outs = {}, {}, [None] * M
        carry = None
        for t in range(plan.T):
            a = plan.at(t)
            out = None
            if a is not None:
                mb, lap = a
                inp = xs[mb] if plan.injects(lap) else carry
                out, graph = stage.forward(leaves, lap, inp, t,
                                           grad=not remat)
                _check_out(out, xs[0], plan.idx, hops)
                saved[t] = inp
                if graph is not None:
                    graphs[t] = graph
                if plan.finishes(lap):
                    outs[mb] = out
            ops = []
            if plan.sends(t):
                ops.append((_FWD, plan.dst_pair(), out))
            if plan.receives(t + 1):
                ops.append((_FWD, plan.src_pair(), None))
            got = hops.exchange(ops, like=xs[0]) if ops else []
            carry = got[0] if got else None
        y = _replicate_outs(hops, outs, xs)
        ctx.run, ctx.saved, ctx.graphs = run, saved, graphs
        ctx.y_shape, ctx.y_dtype = y.shape, y.dtype
        ctx.save_for_backward(xs, *leaves)
        return y

    @staticmethod
    def backward(ctx, gout):
        run, saved, graphs = ctx.run, ctx.saved, ctx.graphs
        hops, plan, stage = run["hops"], run["plan"], run["stage"]
        xs, *leaves = ctx.saved_tensors
        gout = torch.zeros(ctx.y_shape, dtype=ctx.y_dtype, device=xs.device) \
            if gout is None else gout
        gxs = torch.zeros_like(xs)
        acc = [None] * len(leaves)
        gcarry = None
        for t in reversed(range(plan.T)):
            a = plan.at(t)
            gin = None
            if a is not None:
                mb, lap = a
                g = gout[mb] if plan.finishes(lap) else gcarry
                inp = saved.pop(t)
                gin, gp = stage.vjp(leaves, lap, inp, g, t,
                                    graphs.pop(t, None))
                _accumulate(acc, gp)
                gin = torch.zeros_like(inp) if gin is None else gin
                if plan.injects(lap):
                    gxs[mb] = gin
            ops = []
            if plan.receives(t):
                ops.append((_BWD, plan.src_pair(), gin))
            if t > 0 and plan.sends(t - 1):
                ops.append((_BWD, plan.dst_pair(), None))
            got = hops.exchange(ops, like=xs[0]) if ops else []
            gcarry = got[0] if got else None
        return (None, _input_grads(hops, gxs), *_param_grads(acc, leaves))


# ---------------------------------------------------------------------- 1F1B
class _OneFOneB(torch.autograd.Function):
    """GPipe-order forward saving only the inputs and the parameters; the
    backward runs the recompute-forward pipeline and the cotangent
    pipeline in one tick loop, stage inputs kept in a ring of depth 2S
    (the reference's ``_pipe_bwd``)."""

    @staticmethod
    def forward(ctx, run, xs, *leaves):
        hops, plan, stage = run["hops"], run["plan"], run["stage"]
        outs = [None] * plan.M
        carry = None
        for t in range(plan.T):
            a = plan.at(t)
            out = None
            if a is not None:
                inp = xs[a[0]] if hops.first else carry
                out, _ = stage.forward(leaves, 0, inp, a[0])
                _check_out(out, xs[0], plan.idx, hops)
                if hops.last:
                    outs[a[0]] = out
            ops = []
            if plan.sends(t):
                ops.append((_FWD, plan.idx, out))
            if plan.receives(t + 1):
                ops.append((_FWD, plan.idx - 1, None))
            got = hops.exchange(ops, like=xs[0]) if ops else []
            carry = got[0] if got else None
        y = _replicate_outs(hops, outs, xs)
        ctx.run, ctx.y_shape, ctx.y_dtype = run, y.shape, y.dtype
        ctx.save_for_backward(xs, *leaves)
        return y

    @staticmethod
    def backward(ctx, gout):
        run = ctx.run
        hops, stage = run["hops"], run["stage"]
        S, idx, M = hops.S, hops.idx, run["plan"].M
        xs, *leaves = ctx.saved_tensors
        gout = torch.zeros(ctx.y_shape, dtype=ctx.y_dtype, device=xs.device) \
            if gout is None else gout
        gxs = torch.zeros_like(xs)
        acc = [None] * len(leaves)
        depth = 2 * S
        buf = [None] * depth
        fcarry = bcarry = None

        def f_live(t):
            return 0 <= t - idx < M

        def b_live(t):
            return 0 <= t - 2 * (S - 1) + idx < M

        for t in range(M + 2 * (S - 1)):
            out = gin = None
            # recompute-forward half-tick
            if f_live(t):
                m_f = t - idx
                inp = xs[m_f] if hops.first else fcarry
                buf[t % depth] = inp
                if idx < S - 1:
                    out = stage.recompute(leaves, 0, inp, m_f)
            # cotangent half-tick
            if b_live(t):
                m_b = t - 2 * (S - 1) + idx
                g = gout[m_b] if hops.last else bcarry
                inp = buf[(m_b + idx) % depth]
                gin, gp = stage.vjp(leaves, 0, inp, g, m_b)
                _accumulate(acc, gp)
                gin = torch.zeros_like(inp) if gin is None else gin
                if hops.first:
                    gxs[m_b] = gin
            ops = []
            if out is not None:
                ops.append((_FWD, idx, out))
            if idx > 0 and f_live(t + 1):
                ops.append((_FWD, idx - 1, None))
            if gin is not None and idx > 0:
                ops.append((_BWD, idx - 1, gin))
            if idx < S - 1 and b_live(t + 1):
                ops.append((_BWD, idx, None))
            # received in (phase, pair) order: the activation first
            got = iter(hops.exchange(ops, like=xs[0]) if ops else [])
            fcarry = next(got) if idx > 0 and f_live(t + 1) else None
            bcarry = next(got) if idx < S - 1 and b_live(t + 1) else None
        return (None, _input_grads(hops, gxs), *_param_grads(acc, leaves))


# ------------------------------------------------------------------- entries
def _hcg_of(hcg):
    if hcg is None:
        from ...topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    return hcg


def _check_stages(hops, leaves, M, S):
    """One object exchange per call over the pp group: every stage must
    have the same micro-batch count and the same stage parameter shapes
    (each rank its own slice, the stage dim removed)."""
    mine = (M, [tuple(p.shape) for p in leaves])
    if hops.S == 1:
        return
    from ...communication import all_gather_object

    every = all_gather_object([], mine, group=hops.group)
    for s, other in enumerate(every):
        if other[0] != M:
            raise ValueError(f"stage {s} has {other[0]} micro-batches, "
                             f"stage {hops.idx} {M}")
        if other[1] != mine[1]:
            lead = [sh[0] if sh else None for sh in other[1]]
            raise ValueError(
                f"stage_params leading dims {lead} on stage {s} != "
                f"{[sh[0] if sh else None for sh in mine[1]]} on stage "
                f"{hops.idx}; pass each rank its own stage's slice (stage dim "
                "removed), stack layers-per-stage into a leading dim and loop "
                "in block_fn")


def _record_pp_bytes(x_micro, S, ticks):
    """One ring hop of a micro-batch per tick, the reference's formula
    (the forward's bytes; the backward's reverse rotation is not
    counted)."""
    record_collective_traffic("pp_ppermute", S, _nbytes(x_micro[0]) * ticks)


def _pipeline(block_fn, laps, x_micro, hops, schedule="gpipe", remat=True):
    """The schedule over ``hops``' stages with no API check (any ``M >=
    1`` for gpipe / 1f1b): the entry points' shared body, and the
    generic ``PipelineLayer``'s (its ``_Hops`` carry headers).  ``laps``
    is a list of per-lap parameter pytrees: one for gpipe and 1f1b,
    ``layers_per_stage`` for interleaved."""
    leaves, spec = pytree.tree_flatten(list(laps))
    plan = _Plan(hops.S, hops.idx, x_micro.shape[0], len(laps))
    stage = _Stage(block_fn, spec, x_micro.device)
    _record_pp_bytes(x_micro, hops.S, plan.T)
    run = {"hops": hops, "plan": plan, "stage": stage,
           "remat": remat or schedule == "1f1b"}
    fn = _OneFOneB if schedule == "1f1b" else _TickPipe
    return fn.apply(run, x_micro, *leaves)


def _unstack_laps(stage_params):
    """``[layers_per_stage, ...]`` leaves as a list of per-lap pytrees
    (views; their gradients stack back)."""
    leaves, spec = pytree.tree_flatten(stage_params)
    per_leaf = [torch.unbind(p) for p in leaves]
    return [pytree.tree_unflatten([u[k] for u in per_leaf], spec)
            for k in range(leaves[0].shape[0])]


def _run_pipeline(block_fn, stage_params, x_micro, hcg=None, remat=True,
                  schedule="gpipe", per_lap=False):
    """:func:`spmd_pipeline` with its checks.  With ``per_lap`` the
    interleaved schedule takes ``stage_params`` as a list of per-lap
    pytrees (lap ``k`` is virtual stage ``k * S + stage``) instead of
    leaves stacked over the laps, so a caller whose layers are modules of
    their own passes their parameters as they are."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         "(expected 'gpipe', 'interleaved' or '1f1b')")
    hops = _Hops(_hcg_of(hcg))
    S, M = hops.S, x_micro.shape[0]
    if M < S:
        raise ValueError(f"need micro-batches >= stages ({M} < {S})")
    leaves = pytree.tree_leaves(stage_params)
    _check_stages(hops, leaves, M, S)
    laps = [stage_params]
    if schedule == "interleaved":
        if not per_lap and (not leaves or leaves[0].ndim < 1):
            raise ValueError("interleaved schedule needs stage_params leaves "
                             "of shape [layers_per_stage, ...]")
        if M % S:
            raise ValueError(f"interleaved schedule needs micro-batches "
                             f"divisible by stages ({M} % {S})")
        laps = list(stage_params) if per_lap else _unstack_laps(stage_params)
    return _pipeline(block_fn, laps, x_micro, hops, schedule, remat)


def spmd_pipeline(block_fn, stage_params, x_micro, hcg=None, remat=True,
                  schedule="gpipe"):
    """Run ``x_micro`` through the S pipeline stages of this rank's pp
    group (the hybrid topology's by default; ``hcg`` a
    :class:`~...topology.HybridCommunicateGroup`).

    Args:
        block_fn: ``(params, x) -> x`` — one stage's compute, keeping
            ``x``'s shape and dtype.  For ``'gpipe'`` ``params`` is the
            whole ``stage_params``; for ``'interleaved'`` one virtual
            stage's slice ``p[lap]`` of every leaf.
        stage_params: this rank's stage parameters (a pytree of tensors,
            the reference's stage dim removed; ``'interleaved'``: leaves
            ``[layers_per_stage, ...]``, lap ``k`` of this rank is virtual
            stage ``k * S + stage``).
        x_micro: ``[M, micro_batch, ...]`` micro-batches; only stage 0's
            are read.
        remat: keep only each stage call's input and recompute it in the
            backward (the reference's ``jax.checkpoint``); else keep its
            graph.
        schedule: ``'gpipe'`` | ``'interleaved'`` | ``'1f1b'``
            (:func:`spmd_pipeline_1f1b`, which always recomputes).

    Returns:
        ``[M, micro_batch, ...]`` outputs of the final (virtual) stage,
        the same on every stage.
    """
    return _run_pipeline(block_fn, stage_params, x_micro, hcg, remat,
                         schedule)


def spmd_pipeline_1f1b(block_fn, stage_params, x_micro, hcg=None):
    """GPipe-order forward with an O(S)-memory 1F1B backward.

    Forward: the ``'gpipe'`` schedule, saving ONLY the parameters and the
    inputs.  Backward: one tick loop that runs the recompute-forward
    pipeline and the cotangent pipeline together, tick-aligned the way
    1F1B's steady state interleaves one forward and one backward per rank
    per step; stage inputs are kept in a ring of depth 2S (the 1F1B
    in-flight bound)."""
    return _run_pipeline(block_fn, stage_params, x_micro, hcg,
                         schedule="1f1b")
