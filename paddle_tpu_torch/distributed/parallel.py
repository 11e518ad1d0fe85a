"""Data parallelism and ``spawn`` (counterpart of
``paddle_tpu/distributed/parallel.py``).

The reference keeps the parameters replicated over a mesh and lets XLA
insert the gradient all-reduce.  Here each rank is a process of its own,
so :class:`DataParallel` does what upstream Paddle's reducer does: when
it wraps a model it broadcasts the parameters and buffers from the dp
group's first rank, and after every backward it mean-reduces every
gradient over the dp group exactly once, bucketed into one flat buffer
per dtype and device (plain torch, not a kernel).  The reduction runs at
the end of the backward pass (an autograd callback queued by the first
gradient to land), so ``loss.backward(); opt.step()`` and
``jit.TrainStep`` alike see reduced gradients, before TrainStep's
unscale, check and clip.

:func:`spawn` starts one process per rank with the env contract of
:mod:`.env` (the reference runs ``func`` once: its mesh covers every
chip).
"""

from __future__ import annotations

import contextlib
import os
import socket

import torch

from .communication import all_reduce, broadcast
from .env import init_parallel_env  # noqa: F401  (re-export, as the reference)


def _dp_group(group=None):
    if group is not None:
        return group
    from .collective import get_default_group
    from .topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.get_data_parallel_group() if hcg is not None \
        else get_default_group()


def _buckets(tensors):
    """The tensors grouped by (dtype, device), in order."""
    out = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return list(out.values())


def mean_reduce_(tensors, group):
    """Mean-reduce ``tensors`` over ``group`` in place: one flat buffer and
    one ``all_reduce`` per dtype and device."""
    n = group.nranks
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def broadcast_(tensors, src, group):
    """Broadcast ``tensors`` from global rank ``src`` over ``group`` in
    place: one flat buffer per dtype and device."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket])
        broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, part in zip(bucket,
                               flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))


class GradReducer:
    """Reduce the gradients of ``params`` over ``group`` once per backward,
    at its end (an autograd callback queued by the first gradient to
    land), averaged; ``reductions`` counts them.  The queued
    reduction is keyed by the backward's graph task, not a flag: a
    backward that raises drops its queued callback, and the next one must
    queue its own."""

    def __init__(self, params, group):
        self.group = group
        self.reductions = 0
        self._queued_task = None   # the backward whose reduction is queued
        self._params = [p for p in params if p.requires_grad]
        for p in self._params:
            p.register_post_accumulate_grad_hook(self._grad_ready)

    def _grad_ready(self, _param):
        from ..observability import perf as _perf

        task = torch._C._current_graph_task_id()
        if task == self._queued_task or _perf.counting_kernels():
            return
        self._queued_task = task
        torch.autograd.Variable._execution_engine.queue_callback(self._reduce)

    def _reduce(self):
        grads = [p.grad for p in self._params if p.grad is not None]
        with torch.no_grad():
            mean_reduce_(grads, self.group)
        self.reductions += 1


class DataParallel(torch.nn.Module):
    """``paddle.DataParallel``: ``model = DataParallel(model)``, then train
    as before (eager or ``TrainStep``) on each rank's part of the batch
    (:meth:`shard_input`).

    ``group``: the dp group (default: the hybrid topology's, else every
    rank).  ``reductions`` counts the gradient reductions made (one per
    backward).  Attributes the wrapper lacks are read from the wrapped
    model, so ``parameters`` / ``named_parameters`` / ``state_dict``
    delegate with no prefix, as in the reference."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = _dp_group(group)
        state = [t for t in list(layers.parameters()) + list(layers.buffers())]
        if state:
            broadcast_(state, self.group.ranks[0], self.group)
        self._reducer = GradReducer(layers.parameters(), self.group)

    @property
    def reductions(self):
        return self._reducer.reductions

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            inner = self.__dict__.get("_modules", {}).get("_layers")
            if inner is None:
                raise
            return getattr(inner, name)

    # ------------------------------------------------------------------ API
    def scale_loss(self, loss):
        return loss

    def no_sync(self):
        return contextlib.nullcontext()

    def shard_input(self, x):
        """This rank's slice of dim 0 of the global batch ``x`` (contiguous
        rows, as the reference lays a batch over ``dp``); returns it."""
        n, r = self.group.nranks, self.group.rank
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by the dp "
                             f"degree {n}")
        return x.chunk(n)[r] if n > 1 else x

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True, **kw):
        return self._layers.named_parameters(prefix, include_sublayers, **kw)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        load = getattr(self._layers, "set_state_dict", None) \
            or self._layers.load_state_dict
        return load(*a, **k)

    load_dict = set_state_dict


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank, nranks, endpoints, local_rank=None):
    """The env contract of one rank (:mod:`.env`)."""
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nranks),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_LOCAL_RANK": str(rank if local_rank is None
                                     else local_rank)}


def _spawn_entry(index, func, args, nranks, endpoints, extra_env):
    os.environ.update(rank_env(index, nranks, endpoints))
    os.environ.update(extra_env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """``paddle.distributed.spawn``: run ``func(*args)`` in ``nprocs`` new
    processes (``-1``: one per visible card), each with the env contract
    of its rank, by the ``spawn`` start method (never ``fork``: a forked
    child cannot use a card its parent touched).  ``backend=`` sets
    ``PADDLE_DISTRI_BACKEND`` for the children; ``ips`` is accepted and
    only ``127.0.0.1`` is used.  With ``join`` it waits and raises if a
    rank failed; otherwise it returns the process context."""
    import torch.multiprocessing as mp

    if nprocs == -1:
        nprocs = torch.cuda.device_count()
        if nprocs < 1:
            raise RuntimeError("spawn(nprocs=-1) found no CUDA device; pass "
                               "nprocs")
    extra = {}
    if options.get("backend"):
        extra["PADDLE_DISTRI_BACKEND"] = options["backend"]
    endpoints = [f"127.0.0.1:{_free_port()}" for _ in range(nprocs)]
    return mp.start_processes(
        _spawn_entry, args=(func, tuple(args), nprocs, endpoints, extra),
        nprocs=nprocs, join=join, daemon=daemon, start_method="spawn")
