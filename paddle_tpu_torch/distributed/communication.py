"""``paddle.distributed.*`` collectives (counterpart of
``paddle_tpu/distributed/communication.py``).

The reference is single-controller: an eager call sees a rank-stacked
array ``[N, *S]`` ("each of the N ranks holds a tensor of shape S") or a
value every rank holds.  Here each rank is a process of its own and
passes its own tensor, as in upstream Paddle, so for a stacked input rank
r's result equals row r of the reference's, and for a replicated input
(every rank passing the same value) every rank's result equals the
reference's: SUM gives ``v * n`` and PROD ``v ** n`` without a special
case.  The reduce ops follow the reference's ``_reduce_traced``: AVG is
the SUM divided by the group size, PROD is ``exp(sum(log(v)))`` in f32,
cast back.

Every op runs through one bracket (:func:`_collective`): the collective
watchdog's entry and exit, the ``collective_hang`` fault site, a
``collective.<op>`` span when tracing is on, and the ``collective.calls``
/ ``collective.bytes`` / ``collective.latency_seconds`` series.  A
tensor goes to ``torch.distributed`` on the device it lives on: where a
backend cannot run an op on a card's tensor (gloo carries only
``all_reduce`` and ``broadcast`` there), the call raises; it never copies
to the host behind the caller's back.  ``send`` / ``recv`` are real
point-to-point transfers between processes.  A rank outside the group
returns its tensor untouched, and a cost count
(:func:`..observability.perf.count_cost`, which runs on one rank alone)
never communicates.
"""

from __future__ import annotations

from time import perf_counter

import torch
import torch.distributed as dist

from ..observability import faults as _faults
from ..observability import perf as _perf
from ..observability import tracing as _tracing
from ..observability import watchdog as _watchdog
from ..profiler import metrics as _metrics
from .collective import Group, ReduceOp, get_default_group

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "all_gather_object", "reduce",
    "reduce_scatter", "broadcast", "scatter", "alltoall", "alltoall_single",
    "send", "recv", "isend", "irecv", "barrier", "stream",
    "record_collective_traffic",
]

_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN}
# the ops gloo runs on a card's tensors (torch.distributed's backend table)
_GLOO_ON_CARD = ("all_reduce", "broadcast")


def _group(group) -> Group:
    return group if group is not None else get_default_group()


def _nbytes(t):
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _check_backend(op_name, g, *tensors):
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors) \
            and op_name not in _GLOO_ON_CARD \
            and dist.get_backend(g.pg) == "gloo":
        raise RuntimeError(
            f"{op_name}: the gloo backend cannot run it on a CUDA tensor "
            f"(it carries only {', '.join(_GLOO_ON_CARD)} there); use NCCL, "
            "or pass CPU tensors")


def record_collective_traffic(op_name, nranks, nbytes, t0=None, phase="eager"):
    """THE per-collective accounting sink (profiler.metrics): op, bytes
    moved, participant count, latency — the reference's schema."""
    reg = _metrics.get_registry()
    labels = {"op": op_name, "phase": phase, "nranks": nranks}
    reg.counter("collective.calls", "collective invocations").inc(**labels)
    if nbytes:
        reg.counter("collective.bytes",
                    "payload bytes through collectives").inc(nbytes, **labels)
    if t0 is not None:
        reg.histogram("collective.latency_seconds",
                      "eager collective dispatch latency").observe(
            perf_counter() - t0, op=op_name)


def _collective(op_name, g, nbytes, fn, sync=None):
    """THE dispatch path: runs ``fn()`` (the ``torch.distributed`` call)
    inside the watchdog bracket, the fault site and the span, then records
    the traffic.  With a watchdog armed, the call waits for the op (and
    for the card, where ``sync`` names a CUDA device) before its exit is
    recorded, so the bracket covers the transfer, not its enqueue.
    Returns ``fn()``'s result; does nothing during a cost count."""
    if _perf.counting_kernels():
        return None
    t0 = perf_counter()
    cm = _tracing.span(f"collective.{op_name}", group=g.id,
                       nranks=g.nranks, bytes=nbytes) \
        if _tracing._ACTIVE else _tracing.NOOP
    token = _watchdog.collective_begin(op_name, g)
    try:
        with cm:
            _faults.maybe("collective_hang")
            out = fn()
            if token is not None:
                if hasattr(out, "wait"):
                    out.wait()
                if sync is not None and sync.type == "cuda":
                    torch.cuda.synchronize(sync)
    finally:
        _watchdog.collective_end(token)
    record_collective_traffic(op_name, g.nranks, nbytes, t0)
    return out


def _global(g, r):
    """The reference's rank rule: a global rank when it is in the group,
    else an index into it."""
    return r if r in g.ranks else g.ranks[r]


def _in_place(tensor, fn):
    """Run ``fn(buf)`` on a contiguous ``buf`` of ``tensor`` and write it
    back when it was a copy."""
    buf = tensor if tensor.is_contiguous() else tensor.contiguous()
    fn(buf)
    if buf is not tensor:
        tensor.copy_(buf)


def _reduce_with(t, op, g, call):
    """``call(buf, torch_op)`` reduces ``buf`` over the group in place;
    AVG and PROD are built on SUM as the reference builds them."""
    if op in _TORCH_OP:
        call(t, _TORCH_OP[op])
    elif op == ReduceOp.AVG:
        call(t, dist.ReduceOp.SUM)
        t.copy_(t / g.nranks)
    elif op == ReduceOp.PROD:
        logs = torch.log(t.float())
        call(logs, dist.ReduceOp.SUM)
        t.copy_(torch.exp(logs).to(t.dtype))
    else:
        raise ValueError(f"bad ReduceOp {op}")


# ------------------------------------------------------------------ public API
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    """Reduce ``tensor`` over the group, in place; returns it."""
    g = _group(group)
    if not g.is_member():
        return tensor
    _check_backend("all_reduce", g, tensor)

    def run():
        _in_place(tensor, lambda t: _reduce_with(
            t, op, g, lambda b, o: dist.all_reduce(b, op=o, group=g.pg)))

    _collective("all_reduce", g, _nbytes(tensor), run, tensor.device)
    return tensor


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce onto ``dst``: its tensor becomes the result, every other
    rank's keeps its value (the reference's rule)."""
    g = _group(group)
    if not g.is_member():
        return tensor
    _check_backend("reduce", g, tensor)
    dst = _global(g, dst)

    def run():
        buf = tensor.clone(memory_format=torch.contiguous_format)
        _reduce_with(buf, op, g, lambda b, o: dist.reduce(
            b, dst=dst, op=o, group=g.pg))
        if dist.get_rank() == dst:
            tensor.copy_(buf)

    _collective("reduce", g, _nbytes(tensor), run, tensor.device)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's ``tensor``, in rank order: appended to ``tensor_list``
    (when given) and returned stacked ``[n, *S]``."""
    g = _group(group)
    if not g.is_member():
        return tensor
    _check_backend("all_gather", g, tensor)
    src = tensor.contiguous()
    outs = [torch.empty_like(src) for _ in range(g.nranks)]
    _collective("all_gather", g, _nbytes(tensor),
                lambda: dist.all_gather(outs, src, group=g.pg),
                tensor.device)
    if tensor_list is not None:
        tensor_list.extend(outs)
    return torch.stack(outs)


def all_gather_object(object_list, obj, group=None):
    """Every rank's picklable ``obj``, in rank order, appended to
    ``object_list`` (returned)."""
    g = _group(group)
    if not g.is_member():
        return object_list
    out = [None] * g.nranks
    _collective("all_gather_object", g, 0,
                lambda: dist.all_gather_object(out, obj, group=g.pg))
    object_list.extend(out)
    return object_list


def _pieces(x, n, what):
    pieces = list(x) if isinstance(x, (list, tuple)) else list(x.unbind(0))
    if len(pieces) != n:
        raise ValueError(f"{what}: {len(pieces)} pieces for a group of {n}")
    return [p.contiguous() for p in pieces]


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Each rank contributes n pieces (a list, or a tensor ``[n, *S]``);
    rank i receives the reduced piece i into ``tensor`` (returned)."""
    g = _group(group)
    if not g.is_member():
        return tensor
    pieces = _pieces(tensor_list, g.nranks, "reduce_scatter")
    _check_backend("reduce_scatter", g, tensor, *pieces)

    def call(buf, o, src=pieces):
        dist.reduce_scatter(buf, src, op=o, group=g.pg)

    def run():
        if op == ReduceOp.PROD:
            logs = torch.empty(tensor.shape, dtype=torch.float32,
                               device=tensor.device)
            call(logs, dist.ReduceOp.SUM,
                 [torch.log(p.float()) for p in pieces])
            tensor.copy_(torch.exp(logs).to(tensor.dtype))
        else:
            _in_place(tensor, lambda t: _reduce_with(t, op, g, call))

    _collective("reduce_scatter", g, sum(map(_nbytes, pieces)), run,
                tensor.device)
    return tensor


def broadcast(tensor, src, group=None, sync_op=True):
    """``src``'s tensor onto every rank, in place; returns it."""
    g = _group(group)
    if not g.is_member():
        return tensor
    _check_backend("broadcast", g, tensor)
    src = _global(g, src)
    _collective("broadcast", g, _nbytes(tensor), lambda: _in_place(
        tensor, lambda t: dist.broadcast(t, src=src, group=g.pg)),
        tensor.device)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``src``'s n pieces (``tensor_list``, read on ``src`` only) one per
    rank: rank r's ``tensor`` receives piece r; returns it."""
    g = _group(group)
    if not g.is_member():
        return tensor
    src = _global(g, src)
    me = dist.get_rank()
    pieces = _pieces(tensor_list, g.nranks, "scatter") if me == src else None
    _check_backend("scatter", g, tensor)
    _collective("scatter", g, _nbytes(tensor), lambda: _in_place(
        tensor, lambda t: dist.scatter(t, pieces, src=src, group=g.pg)),
        tensor.device)
    return tensor


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank j's piece i goes to rank i's slot j.  The received pieces are
    appended to ``out_tensor_list`` (when a list) and returned stacked."""
    g = _group(group)
    if not g.is_member():
        return in_tensor_list
    pieces = _pieces(in_tensor_list, g.nranks, "alltoall")
    _check_backend("alltoall", g, *pieces)
    outs = [torch.empty_like(p) for p in pieces]
    _collective("alltoall", g, sum(map(_nbytes, pieces)),
                lambda: dist.all_to_all(outs, pieces, group=g.pg),
                pieces[0].device)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
    return torch.stack(outs)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Dim 0 of ``in_tensor`` cut into n slices (``in_split_sizes``, equal
    by default), slice i to rank i; the received slices concatenated in
    rank order into ``out_tensor`` (allocated when None; returned)."""
    g = _group(group)
    if not g.is_member():
        return in_tensor
    src = in_tensor.contiguous()
    if out_tensor is None:
        rows = sum(out_split_sizes) if out_split_sizes else src.shape[0]
        out_tensor = torch.empty((rows,) + tuple(src.shape[1:]),
                                 dtype=src.dtype, device=src.device)
    _check_backend("alltoall_single", g, src, out_tensor)
    _collective("alltoall_single", g, _nbytes(src), lambda: _in_place(
        out_tensor, lambda t: dist.all_to_all_single(
            t, src, output_split_sizes=out_split_sizes,
            input_split_sizes=in_split_sizes, group=g.pg)), src.device)
    return out_tensor


# ------------------------------------------------------------------- p2p
def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to rank ``dst`` (a process of its own)."""
    g = _group(group)
    _check_backend("send", g, tensor)
    dst = _global(g, dst)
    src = tensor.contiguous()
    _collective("send", g, _nbytes(src),
                lambda: dist.send(src, dst=dst, group=g.pg), src.device)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from rank ``src``; returns it."""
    g = _group(group)
    _check_backend("recv", g, tensor)
    src = _global(g, src)
    _collective("recv", g, _nbytes(tensor), lambda: _in_place(
        tensor, lambda t: dist.recv(t, src=src, group=g.pg)), tensor.device)
    return tensor


def isend(tensor, dst=0, group=None):
    """Start sending ``tensor`` to ``dst``; returns the request (``wait()``
    before reusing ``tensor``)."""
    g = _group(group)
    _check_backend("send", g, tensor)
    dst = _global(g, dst)
    return _collective("send", g, _nbytes(tensor), lambda: dist.isend(
        tensor.contiguous(), dst=dst, group=g.pg))


def irecv(tensor, src=0, group=None):
    """Start receiving into the contiguous ``tensor`` from ``src``; returns
    the request (``wait()`` before reading ``tensor``)."""
    g = _group(group)
    _check_backend("recv", g, tensor)
    src = _global(g, src)
    return _collective("recv", g, _nbytes(tensor), lambda: dist.irecv(
        tensor, src=src, group=g.pg))


def barrier(group=None):
    """Block until every rank of the group reaches it."""
    g = _group(group)
    if not g.is_member():
        return
    _collective("barrier", g, 0, lambda: dist.barrier(group=g.pg))


class stream:
    """``paddle.distributed.stream`` namespace (the same ops, synchronous)."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce = staticmethod(reduce)
    broadcast = staticmethod(broadcast)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    send = staticmethod(send)
    recv = staticmethod(recv)
