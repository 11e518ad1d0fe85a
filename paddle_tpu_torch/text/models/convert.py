"""Weights carried across from and back to the TPU package.

:func:`load_paddle_tpu_state_dict` takes ``paddle_tpu``'s
``model.state_dict()`` as numpy arrays under paddle's names
(``gpt.word_embeddings.weight``, ``gpt.layers.0.qkv.weight``, ...) — the
caller converts them, so this module never imports the JAX package — and
loads them into the port's model of the same structure.  Paddle's
``Linear`` stores ``[in, out]``; torch's ``[out, in]``, so those weights
are transposed, and so are ``Int8Linear``'s ``weight_int8`` buffers and
a Linear's reparameterized weights (``weight_v`` / ``weight_orig`` and
the computed ``weight`` of ``nn.utils.weight_norm`` / ``spectral_norm``;
``weight_g`` and the spectral ``weight_u`` / ``weight_v`` vectors pass as
they are).  A convolution's weight keeps paddle's layout (``[out, in /
groups, *k]``, PyTorch's too) and passes as it is, as do the batch
norms' ``_mean`` / ``_variance`` buffers and a vision model's
``cls_token`` / ``pos_embed``; a vision net's ``fc`` / ``head`` / ViT
``qkv`` Linears are transposed like any other.  The detectors carry
across the same way: their convolutions and batch norms pass, Faster
R-CNN's ``roi_head`` / ``cls_score`` / ``bbox_delta`` Linears are
transposed, and a ``RepVggBlock`` holds the keys ``conv.weight`` /
``conv.bias`` only after ``convert_to_deploy`` (in both packages).
(``Int8Linear.w_scale`` is an attribute, not state: a converted model is
made by converting the float model with
``serving.quant.quantize_model_weights``.)  :func:`export_paddle_tpu_state_dict` is the inverse, so
trained weights can be held against the JAX model's.  Every key and shape
is checked both ways.

A model wrapped by ``quantization.QAT`` / ``PTQ`` carries the TPU
package's names: ``<layer>.inner.weight`` is a Linear weight like any
other (transposed), and the quanters' 0-d float32 buffers
(``<layer>.act_quanter.scale``, ``.weight_quanter.scale``, an observer's
``.absmax``) pass as scalars.

Tensor-parallel models (``distributed.fleet`` with ``mp_degree > 1``)
carry their weights by shard: loading slices each of the reference's
full arrays to this rank's part (a column-parallel weight and bias on
the output dim, a row-parallel weight on the input dim, a vocab-parallel
table on its rows; the reference's GPT ``_TP_DIM``), and the export
gathers the shards of the mp group back into the full arrays (a
collective: every rank of the group calls it).

Pipeline models (``GPTForCausalLMPipe``, ``PipelineLayer`` at pp > 1)
carry their weights by stage: loading takes the reference's full state
dict and keeps this rank's blocks (with their TP shard where mp > 1) and
the replicas, skipping the keys of the layers other stages hold; the
export gathers every stage's blocks over the pp group back into the
reference's full dict (a collective: every pp rank calls it).
"""

from __future__ import annotations

import numpy as np
import torch


def load_paddle_tpu_state_dict(model: torch.nn.Module, state: dict,
                              mp_rank=None, mp_degree=None) -> None:
    """Copy ``state`` (name -> numpy array, or torch tensor in paddle's
    layout, e.g. a bfloat16 one read by ``framework.io.load``) into
    ``model`` in place, cast to each parameter's dtype and device.  A
    tensor-parallel layer's weights are sliced to shard ``mp_rank`` of
    ``mp_degree`` (by default the layer's own mp group's rank and size).
    Raises ``KeyError`` on a missing or extra key and ``ValueError`` on a
    shape mismatch."""
    own = model.state_dict()
    foreign = tuple(_pp_parts(model)[1])
    if foreign:
        state = {k: v for k, v in state.items() if not k.startswith(foreign)}
    _check_keys(own, state)
    linear_weights = _linear_weights(model)
    shards = _tp_shards(model)
    with torch.no_grad():
        for key, dst in own.items():
            src = state[key]
            src = src.detach() if isinstance(src, torch.Tensor) \
                else torch.tensor(np.asarray(src))
            if key in linear_weights:
                src = src.T
            if key in shards:
                dim, group = shards[key]
                n = mp_degree if mp_degree is not None else group.nranks
                r = mp_rank if mp_rank is not None else group.rank
                src = src.chunk(n, dim=dim)[r]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} (after "
                                 f"layout conversion) != {tuple(dst.shape)}")
            dst.copy_(src)


def export_paddle_tpu_tensors(model: torch.nn.Module) -> dict:
    """``model``'s state as ``{paddle name: CPU tensor}`` in paddle's layout
    (``Linear`` weights ``[in, out]``) and each tensor's own dtype
    (bfloat16 stays bfloat16), every one a copy; parameters as
    ``torch.nn.Parameter`` (``framework.io.save`` records which are)."""
    linear_weights = _linear_weights(model)
    shards = _tp_shards(model)
    params = {k for k, _ in model.named_parameters()}
    out = {}
    for key, t in model.state_dict().items():
        if key in shards:
            from ...distributed.communication import all_gather

            dim, group = shards[key]
            t = torch.cat(all_gather(None, t.detach(), group=group).unbind(0),
                          dim=dim)
        arr = t.detach().cpu()
        arr = (arr.T if key in linear_weights else arr).contiguous()
        # a copy: on the CPU the tensor would alias the live weights
        arr = arr.clone() if arr.data_ptr() == t.data_ptr() else arr
        out[key] = torch.nn.Parameter(arr, requires_grad=False) \
            if key in params else arr
    own, _, group = _pp_parts(model)
    if group is not None:
        from ...distributed.communication import all_gather_object

        mine = {k: v for k, v in out.items() if k.startswith(tuple(own))}
        for stage in all_gather_object([], mine, group=group):
            for k, v in stage.items():
                out.setdefault(k, v)
    return out


def export_paddle_tpu_state_dict(model: torch.nn.Module, expected=None) -> dict:
    """``model``'s weights as ``{paddle name: numpy array}`` in paddle's
    layout (:func:`export_paddle_tpu_tensors`), float32 for floating ones.
    With ``expected`` (name -> array, e.g. the JAX model's state) the keys
    and shapes must match: ``KeyError`` / ``ValueError`` otherwise."""
    out = {k: (t.float() if t.is_floating_point() else t).numpy()
           for k, t in export_paddle_tpu_tensors(model).items()}
    if expected is not None:
        _check_keys(out, expected)
        for key, arr in out.items():
            want = tuple(np.shape(expected[key]))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: exported shape {tuple(arr.shape)} "
                                 f"!= expected {want}")
    return out


def _pp_parts(model):
    """(this rank's stage-held key prefixes, the other stages', the pp
    group) over the pipeline containers in ``model``; the group is None
    without a pipeline of more than one stage."""
    own, other, group = [], [], None
    for name, m in model.named_modules():
        parts = getattr(m, "_pp_prefixes", None)
        if parts is None or m._pp_group() is None:
            continue
        pre = f"{name}." if name else ""
        mine, theirs = parts()
        own += [pre + p for p in mine]
        other += [pre + p for p in theirs]
        group = m._pp_group()
    return own, other, group


def _check_keys(own, other):
    missing = sorted(set(own) - set(other))
    extra = sorted(set(other) - set(own))
    if missing or extra:
        raise KeyError(f"state dict keys differ: missing {missing}, "
                       f"unexpected {extra}")


def _tp_shards(model):
    """State-dict key -> (dim in the port's layout, mp group) of every
    tensor-parallel shard of ``model``."""
    from ...distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                                    RowParallelLinear,
                                                    VocabParallelEmbedding)

    dims = {ColumnParallelLinear: {"weight": 0, "bias": 0},
            RowParallelLinear: {"weight": 1},
            VocabParallelEmbedding: {"weight": 0}}
    out = {}
    for name, m in model.named_modules():
        group = getattr(m, "group", None)
        if group is None or type(m) not in dims:
            continue
        for attr, dim in dims[type(m)].items():
            if getattr(m, attr, None) is not None:
                out[f"{name}.{attr}" if name else attr] = (dim, group)
    return out


def _linear_weights(model):
    """State-dict keys kept ``[out, in]`` here and ``[in, out]`` in paddle:
    a Linear's weight, or under ``nn.utils.weight_norm`` its ``weight_v``
    and computed ``weight``, or under ``spectral_norm`` its
    ``weight_orig`` and computed ``weight``."""
    from ...nn.layers.common import is_transposed
    from ...quantization import Int8Linear

    keys = {k for k, t in model.state_dict(keep_vars=True).items()
            if is_transposed(t)}
    for name, m in model.named_modules():
        if isinstance(m, Int8Linear):
            keys.add(f"{name}.weight_int8" if name else "weight_int8")
    return keys
