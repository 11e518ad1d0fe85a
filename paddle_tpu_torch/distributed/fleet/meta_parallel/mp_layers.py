"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``).

The reference holds each FULL logical weight under a ``NamedSharding``
and lets XLA insert the collectives.  Here each rank is a process of its
own, so each layer holds the rank's shard (in paddle's layout ``[in,
out/mp]`` for :class:`ColumnParallelLinear`, ``[in/mp, out]`` for
:class:`RowParallelLinear`, ``[vocab/mp, hidden]`` for
:class:`VocabParallelEmbedding`; a Linear weight is kept ``[out, in]`` as
the port's ``Linear`` keeps it) and writes its collectives out, as
upstream Paddle and the reference's own manual region do:

- before a column layer, identity forward and an mp ``all_reduce`` of the
  input's gradient (:class:`_CopyToMP`);
- after a row layer, an mp ``all_reduce`` forward and identity backward
  (:class:`_ReduceFromMP`), then the replicated bias;
- an ``all_gather`` only with ``gather_output=True``.

A sharded parameter carries ``is_distributed = True`` (upstream Paddle's
attribute; read it with :func:`is_sharded`, since every torch tensor has
an ``is_distributed`` method): the global-norm clip sums its squares
over the mp group.
Each layer draws the full logical weight from torch's default generator
and keeps its rows or columns, so one seed gives the same logical layer
at every mp degree.  Without a hybrid topology of mp > 1 (and no
``mp_group``) a layer is its plain counterpart.
"""

from __future__ import annotations

import torch

from .... import amp
from ....nn import initializer as I
from ....nn.functional.common import embedding as _embedding
from ....nn.layers.common import TransposedParameter, promote
from ...communication import ReduceOp, all_gather, all_reduce
from ...topology import model_parallel_group


def _mp_group(mp_group=None):
    """``mp_group``, else the hybrid topology's mp group when its degree
    is > 1, else None (no tensor parallelism)."""
    if mp_group is not None:
        return mp_group if mp_group.nranks > 1 else None
    return model_parallel_group()


def is_sharded(p):
    """Whether ``p`` is a tensor-parallel shard (its own
    ``is_distributed`` attribute, not torch's method of that name)."""
    return vars(p).get("is_distributed") is True


def _degree(group):
    return (group.nranks, group.rank) if group is not None else (1, 0)


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient summed over the mp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    """Sum over the mp group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    if x.is_cuda and torch.distributed.get_backend(group.pg) == "gloo":
        # gloo carries no all_gather on a card's tensors: each rank writes
        # its slice into zeros and the ranks sum them (exact: x + 0 == x)
        n, r = _degree(group)
        w = x.shape[-1]
        full = x.new_zeros(*x.shape[:-1], n * w)
        full[..., r * w:(r + 1) * w] = x
        return all_reduce(full, group=group)
    return torch.cat(all_gather(None, x.contiguous(), group=group).unbind(0),
                     dim=-1)


class _GatherFromMP(torch.autograd.Function):
    """Concatenate the ranks' last-dim slices forward; keep this rank's
    slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        n, r = _degree(ctx.group)
        return g.chunk(n, dim=-1)[r].contiguous(), None


class _ScatterToMP(torch.autograd.Function):
    """This rank's last-dim slice forward; the slices' gradients gathered
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = _degree(group)
        return x.chunk(n, dim=-1)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_to_mp(x, group):
    return _CopyToMP.apply(x, group) if group is not None else x


def reduce_from_mp(x, group):
    return _ReduceFromMP.apply(x, group) if group is not None else x


def gather_from_mp(x, group):
    return _GatherFromMP.apply(x, group) if group is not None else x


def _shard_param(full, dim, n, r, sharded, cls=torch.nn.Parameter):
    part = full.chunk(n, dim=dim)[r].contiguous() if n > 1 else full
    p = cls(part.detach().clone())
    p.is_distributed = bool(sharded and n > 1)
    return p


def _linear(x, w, b=None):
    return torch.nn.functional.linear(*promote(*amp.cast("linear", x, w, b)))


def _full_linear_weight(d_in, d_out, weight_attr):
    """The logical weight in the port's ``[out, in]`` layout, drawn in
    paddle's ``[in, out]`` by ``weight_attr``'s initializer (Xavier
    uniform by default)."""
    init = getattr(weight_attr, "initializer", None) or I.XavierUniform()
    return init((d_in, d_out), torch.float32).T


class ColumnParallelLinear(torch.nn.Module):
    """``Y = X W``, ``W`` split on the output (column) dim over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        n, r = _degree(self.group)
        if out_features % n:
            raise ValueError(f"out_features {out_features} not divisible by "
                             f"mp degree {n}")
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = _shard_param(
            _full_linear_weight(in_features, out_features, weight_attr), 0,
            n, r, True, TransposedParameter)
        self.bias = _shard_param(torch.zeros(out_features), 0, n, r, True) \
            if has_bias is None or has_bias else None

    def forward(self, x):
        y = _linear(copy_to_mp(x, self.group), self.weight, self.bias)
        return gather_from_mp(y, self.group) if self.gather_output else y


class RowParallelLinear(torch.nn.Module):
    """``Y = X W``, ``W`` split on the input (row) dim over mp: the partial
    products are summed over mp, then the replicated bias is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        n, r = _degree(self.group)
        if in_features % n:
            raise ValueError(f"in_features {in_features} not divisible by "
                             f"mp degree {n}")
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _shard_param(
            _full_linear_weight(in_features, out_features, weight_attr), 1,
            n, r, True, TransposedParameter)
        self.bias = _shard_param(torch.zeros(out_features), 0, 1, 0, False) \
            if has_bias else None

    def forward(self, x):
        if self.group is not None and not self.input_is_parallel:
            x = _ScatterToMP.apply(x, self.group)
        if self.group is None:
            return _linear(x, self.weight, self.bias)
        y = reduce_from_mp(_linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class VocabParallelEmbedding(torch.nn.Module):
    """Embedding table split on the vocab dim over mp: each rank looks up
    the ids it owns (zeros elsewhere) and the rows are summed over mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        n, r = _degree(self.group)
        if num_embeddings % n:
            raise ValueError(f"num_embeddings {num_embeddings} not divisible "
                             f"by mp degree {n}")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        init = getattr(weight_attr, "initializer", None) or I.XavierNormal()
        self.weight = _shard_param(
            init((num_embeddings, embedding_dim), torch.float32), 0, n, r,
            True)

    def forward(self, x):
        if self.group is None:
            return _embedding(x, self.weight)
        n_local = self.weight.shape[0]
        local = x.long() - self.group.rank * n_local
        ok = (local >= 0) & (local < n_local)
        out = _embedding(torch.where(ok, local, 0), self.weight)
        out = out.masked_fill(~ok.unsqueeze(-1), 0.0)
        return reduce_from_mp(out, self.group)


def parallel_softmax_cross_entropy(local_logits, labels, group=None,
                                   ignore_index=-100):
    """Softmax cross-entropy over logits split on the vocab dim over the mp
    ``group`` (the hybrid topology's by default): ``local_logits`` is this
    rank's ``[..., V/mp]`` slice, so the full logits never exist.  The
    stopped local max is max-reduced, the sum of exps summed, the label's
    logit taken by the rank that owns it and summed; returns the per-token
    loss in f32 (0 at ``ignore_index``).  The gradient is the exact
    sharded ``softmax - onehot``."""
    group = _mp_group(group)
    n, r = _degree(group)
    v_loc = local_logits.shape[-1]
    lf = local_logits.float()
    m = lf.detach().amax(dim=-1)
    if group is not None:
        all_reduce(m, op=ReduceOp.MAX, group=group)
    e = torch.exp(lf - m.unsqueeze(-1))
    lse = m + torch.log(reduce_from_mp(e.sum(dim=-1), group))
    loc = labels.long() - r * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    picked = lf.gather(-1, loc.clamp(0, v_loc - 1).unsqueeze(-1)).squeeze(-1)
    logit_y = reduce_from_mp(torch.where(ok, picked, 0.0), group)
    loss = lse - logit_y
    if ignore_index is not None:
        loss = torch.where(labels != ignore_index, loss, 0.0)
    return loss


class _MeanOver(torch.autograd.Function):
    """The mean over a group forward (every rank's value the same); ``g``
    backward, so each rank's gradient is its own value's, and averaging
    the gradients over the group afterwards (as ``DataParallel`` does)
    gives the mean's (the reference's ``pmean``)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group) / group.nranks

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean_over(x, group):
    """``x`` averaged over ``group`` (None: ``x``), differentiable."""
    return _MeanOver.apply(x, group) if group is not None \
        and group.nranks > 1 else x


def sharded_vocab_head_loss(hidden, weight, labels, group=None, dp_group=None,
                            shift=True):
    """Tied-embedding LM head + cross-entropy with the vocab rows sharded
    over the mp ``group`` (the hybrid topology's by default): each rank
    computes only its ``[*, V/mp]`` slab of f32 logits and the loss comes
    out of :func:`parallel_softmax_cross_entropy`, so no rank ever holds
    the full ``[B, S, V]`` logits (reference: the GPT pipe head built on
    ``c_softmax_with_cross_entropy``).

    hidden: ``[B, S, H]`` (this rank's rows); weight: this rank's
    ``[V/mp, H]`` rows; labels: ``[B, S]``.  Returns the scalar mean
    next-token loss, then its mean over ``dp_group`` when given (the
    reference's ``pmean``; each dp rank's gradient is its own rows'
    loss's, to be averaged over dp)."""
    group = _mp_group(group)
    if shift:
        hidden, labels = hidden[:, :-1], labels[:, 1:]
    h = copy_to_mp(hidden, group).float()
    logits = h @ weight.float().T
    loss = parallel_softmax_cross_entropy(logits, labels, group).mean()
    return mean_over(loss, dp_group)


class ParallelCrossEntropy(torch.nn.Module):
    """Cross-entropy over mp-split logits (reference:
    ``c_softmax_with_cross_entropy``); the per-token loss.  Without tensor
    parallelism, the plain ``cross_entropy(reduction="none")``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if self.group is not None:
            return parallel_softmax_cross_entropy(
                input, label, self.group, ignore_index=self.ignore_index)
        from ....nn.functional import cross_entropy

        return cross_entropy(input, label, reduction="none",
                             ignore_index=self.ignore_index)
