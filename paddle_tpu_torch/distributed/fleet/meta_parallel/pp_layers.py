"""Pipeline-parallel layer containers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``):
``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer`` and the runtime
``PipelineParallel``.

The reference is single-controller: one program holds every stage, and
``PipelineLayer`` runs the whole stack.  Here each pp rank is a process
of its own.  At pp > 1 a rank builds every desc in the reference's order
(so one seed gives the same layers at every pp degree) and keeps only its
segment's layers, registered under their global indices, so
``state_dict`` keys are the reference's.  A ``SharedLayerDesc`` held by
several stages is one replica on each of them: its gradient is summed
over the ranks that hold it (:meth:`PipelineLayer.
allreduce_shared_weight_gradients`, a group per shared key built on
every rank), so the replicas stay equal, as the reference's one object
is.  ``PipelineParallel.train_batch`` splits ``accumulate_steps``
micro-batches and steps the optimizer once (the reference's gradient
merge); at pp > 1 it runs the segments through the 1F1B ticks of
:mod:`.pipeline_schedule`, whose hops carry a header with the
activation's shape and dtype (they change between stages).
"""

from __future__ import annotations

import math

import torch

from ...topology import get_hybrid_communicate_group


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, torch.nn.Module)):
            raise TypeError("LayerDesc expects an nn.Layer subclass")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages (reference: tied embeddings in GPT):
    built once, at its first desc; ``forward_func(layer, x)`` runs it at
    the later descs."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _pp_degree(topology):
    if topology is None:
        return None
    if hasattr(topology, "get_pipe_parallel_world_size"):
        return topology.get_pipe_parallel_world_size()
    if hasattr(topology, "get_dim"):
        return topology.get_dim("pp")
    return 1


class _Segment(torch.nn.Module):
    """This rank's run functions as one module (the stage's ``block_fn``
    runs it by ``functional_call``)."""

    def __init__(self, fns):
        super().__init__()
        self.fns = fns
        for i, (layer, _) in fns:
            if isinstance(layer, torch.nn.Module):
                self.add_module(str(i), layer)

    def forward(self, x):
        for _, (layer, ffn) in self.fns:
            x = ffn(layer, x) if ffn is not None else layer(x)
        return x


class PipelineLayer(torch.nn.Module):
    """reference: ``PipelineLayer(layers=[...], num_stages=pp,
    topology=hcg)``.

    ``segment_parts`` is the reference's uniform partition; at pp > 1 this
    rank holds only the layers of its stage (``stage_id``), and
    :meth:`forward` runs the whole stack as a pipeline of one micro-batch
    whose output every stage receives."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None:
            num_stages = _pp_degree(topology)
        self._num_stages = num_stages or 1
        self._recompute_interval = recompute_interval
        hcg = get_hybrid_communicate_group()
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        if pp > 1 and pp != self._num_stages:
            raise ValueError(f"PipelineLayer(num_stages={self._num_stages}) "
                             f"under a hybrid topology of pp_degree {pp}")
        self._hcg = hcg if pp > 1 else None
        self.stage_id = hcg.get_stage_id() if self._hcg is not None else None

        n = len(layers)
        per = int(math.ceil(n / self._num_stages))
        self.segment_parts = [min(i * per, n) for i in range(self._num_stages + 1)]
        self.segment_parts[-1] = n

        # every desc is built, in order, on every rank (one init stream);
        # a rank keeps its segment's
        self._shared = {}
        shared_at = {}
        self._module_idx = []
        self.run_function = []
        for i, desc in enumerate(layers):
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name not in self._shared:
                    self._shared[desc.layer_name] = desc.build_layer()
                layer, ffn = self._shared[desc.layer_name], desc.forward_func
                shared_at.setdefault(desc.layer_name, []).append(i)
            elif isinstance(desc, LayerDesc):
                layer, ffn = desc.build_layer(), None
            elif isinstance(desc, torch.nn.Module) or callable(desc):
                layer, ffn = desc, None
            else:
                raise TypeError(f"bad pipeline entry {desc!r}")
            if isinstance(layer, torch.nn.Module):
                self._module_idx.append(i)
            if not self._holds(i):
                layer, ffn = None, None
            elif isinstance(layer, torch.nn.Module):
                self.add_module(str(i), layer)
            self.run_function.append((layer, ffn))
        self._shared = {k: layer for k, layer in self._shared.items()
                        if any(self._holds(i) for i in shared_at[k])}
        self._shared_groups = self._make_shared_groups(shared_at)
        self._mark_holders(shared_at)

    def _holds(self, i):
        return self.stage_id is None or \
            self.get_stage_from_index(i) == self.stage_id

    def _make_shared_groups(self, shared_at):
        """key -> the group of the pp ranks that hold the shared layer
        (None when one stage holds it).  Collective: every rank creates
        every group, in one order."""
        from ... import collective

        out = {}
        if self._hcg is None:
            return out
        for key, idxs in shared_at.items():
            stages = sorted({self.get_stage_from_index(i) for i in idxs})
            if len(stages) < 2:
                continue
            for ranks in self._hcg.topology().get_comm_list("pp"):
                g = collective.new_group([ranks[s] for s in stages],
                                         axis_name="pp_shared")
                self._hcg._group_ids.append(g.id)
                if g.is_member():
                    out[key] = g
        return out

    def _mark_holders(self, shared_at):
        """``pp_holders`` on each held parameter: the number of stages
        holding a copy (the global-norm clip counts each parameter
        once)."""
        if self._hcg is None:
            return
        shared = {id(layer): key for key, layer in self._shared.items()}
        for i, (layer, _) in enumerate(self.run_function):
            if not isinstance(layer, torch.nn.Module):
                continue
            key = shared.get(id(layer))
            k = 1 if key is None else len(
                {self.get_stage_from_index(j) for j in shared_at[key]})
            for p in layer.parameters():
                p.pp_holders = k

    def _pp_prefixes(self):
        """(this rank's layer key prefixes, the other stages')."""
        own = [f"{i}." for i in self._module_idx if self._holds(i)]
        other = [f"{i}." for i in self._module_idx if not self._holds(i)]
        return own, other

    def _pp_group(self):
        return self._hcg.get_pipe_parallel_group() \
            if self._hcg is not None else None

    def get_stage_from_index(self, idx):
        for s in range(self._num_stages):
            if self.segment_parts[s] <= idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def stage_layers(self, stage):
        if self.stage_id is not None and stage != self.stage_id:
            raise ValueError(f"stage {stage}'s layers live on its own rank "
                             f"(this rank holds stage {self.stage_id})")
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return [l for l, _ in self.run_function[lo:hi]]

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's gradients over the stages that hold
        it."""
        from ...communication import all_reduce

        for key, g in self._shared_groups.items():
            for p in self._shared[key].parameters():
                if p.grad is not None:
                    all_reduce(p.grad, group=g)

    def _local_fns(self):
        if self.stage_id is None:
            return list(enumerate(self.run_function))
        lo, hi = (self.segment_parts[self.stage_id],
                  self.segment_parts[self.stage_id + 1])
        return [(i, self.run_function[i]) for i in range(lo, hi)]

    def _run(self, fns, x):
        if self._recompute_interval:
            from ..utils import recompute as _rc

            i = 0
            while i < len(fns):
                j = min(i + self._recompute_interval, len(fns))

                def run_span(h, _fns=fns[i:j]):
                    for _, (layer, ffn) in _fns:
                        h = ffn(layer, h) if ffn is not None else layer(h)
                    return h
                x = _rc.recompute(run_span, x)
                i = j
            return x
        for _, (layer, ffn) in fns:
            x = ffn(layer, x) if ffn is not None else layer(x)
        return x

    def pipeline(self, x_micro, schedule="1f1b"):
        """``x_micro`` ``[M, ...]`` through the stages (any ``M >= 1``):
        the last stage's outputs ``[M, ...]`` on every stage."""
        from .pipeline_schedule import _Hops, _pipeline

        seg = _Segment(self._local_fns())
        names = [k for k, _ in seg.named_parameters()]

        def block_fn(params, x):
            return torch.func.functional_call(
                seg, dict(zip(names, params)), (x,))

        params = [p for _, p in seg.named_parameters()]
        return _pipeline(block_fn, [params], x_micro,
                         _Hops(self._hcg, header=True), schedule)

    def forward(self, x):
        if self._hcg is None:
            return self._run(self._local_fns(), x)
        return self.pipeline(x[None])[0]


class PipelineParallel(torch.nn.Module):
    """reference: ``fleet/meta_parallel/pipeline_parallel.py`` — the
    runtime that owns the micro-batch schedule.  ``train_batch(data,
    optimizer[, lr_scheduler, scaler, loss_fn])`` splits the batch into
    ``accumulate_steps`` micro-batches, averages their gradients and steps
    once; returns the mean loss (on every stage)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg if hcg is not None else get_hybrid_communicate_group()
        self._strategy = strategy
        cfg = (strategy.pipeline_configs if strategy is not None else {}) or {}
        self._micro_batches = int(cfg.get("accumulate_steps", 1))
        self._train_step = None
        self._reducer = None
        if self._hcg is not None \
                and self._hcg.get_data_parallel_world_size() > 1:
            from ...parallel import GradReducer

            self._reducer = GradReducer(layers.parameters(),
                                        self._hcg.get_data_parallel_group())

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kw):
        return self._layers.named_parameters(prefix, recurse, **kw)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None,
                    loss_fn=None):
        x, y = data
        loss_fn = loss_fn or self._layers._loss_fn or (lambda out, lbl: out.mean())
        m = self._micro_batches
        bsz = x.shape[0]
        if bsz % m:
            raise ValueError(f"batch {bsz} not divisible by accumulate_steps {m}")
        if self._layers._hcg is None:
            from ....jit.train_step import TrainStep

            if self._train_step is None \
                    or self._train_step.optimizer is not optimizer:
                self._train_step = TrainStep(self._layers, optimizer,
                                             loss_fn=loss_fn,
                                             accumulate_steps=m,
                                             scaler=scaler)
            loss = self._train_step(x, y)
        else:
            optimizer.clear_grad()
            out = self._layers.pipeline(x.reshape((m, bsz // m)
                                                  + tuple(x.shape[1:])))
            ys = y.reshape((m, bsz // m) + tuple(y.shape[1:]))
            loss = sum(loss_fn(out[i], ys[i]) for i in range(m)) / m
            (scaler.scale(loss) if scaler is not None else loss).backward()
            self._layers.allreduce_shared_weight_gradients()
            if scaler is not None:
                scaler.step(optimizer)
                scaler.update()
            else:
                optimizer.step()
            optimizer.clear_grad()
            loss = loss.detach()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
