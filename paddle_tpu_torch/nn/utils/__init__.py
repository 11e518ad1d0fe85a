"""nn.utils (counterpart of ``paddle_tpu/nn/utils``): parameter-vector
helpers, gradient clipping, weight norm and spectral norm.

Layouts follow the TPU package's.  A port ``Linear`` keeps its weight
``[out, in]`` where paddle keeps ``[in, out]``, so on a ``Linear``:

- ``parameters_to_vector`` / ``vector_to_parameters`` lay the weight out
  row-major in paddle's ``[in, out]`` order;
- ``weight_norm(dim=0)``'s ``dim`` is paddle's (``dim=0`` norms over
  ``out`` for each input row, so ``weight_g`` has ``in`` entries);
- ``spectral_norm``'s ``weight_sn.weight_u`` / ``weight_v`` have paddle's
  lengths (``in`` / ``out``).

The reparameterized names are paddle's: ``weight_g``, ``weight_v`` and
the computed ``weight`` buffer (weight norm); ``weight_orig``, the
computed ``weight`` buffer and the ``weight_sn`` sublayer's ``weight_u``
/ ``weight_v`` buffers (spectral norm), which
``text.models.load_paddle_tpu_state_dict`` carries across.
"""

from __future__ import annotations

import torch

from ..layers.common import TransposedParameter, is_transposed, \
    mark_transposed


def parameters_to_vector(parameters, name=None):
    """The parameters flattened and concatenated, each in paddle's layout."""
    return torch.cat([(p.t() if is_transposed(p) else p).reshape(-1)
                      for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Write ``vec`` (paddle's layout) back into the parameters in place."""
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            chunk = vec[off:off + n]
            if is_transposed(p):
                p.copy_(chunk.view(p.shape[1], p.shape[0]).t())
            else:
                p.copy_(chunk.view_as(p))
            off += n


def _param(t, transposed):
    return (TransposedParameter if transposed else torch.nn.Parameter)(t)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients in place so their global ``norm_type`` norm is
    at most ``max_norm`` (coefficient ``max_norm / (total + 1e-6)``, capped
    at 1); returns the total norm as a 0-d device tensor (no host sync)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros([], dtype=torch.float32)
    norm_type = float(norm_type)
    total = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.reshape(-1), norm_type) for g in grads]),
        norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(coef.to(g.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient to ``[-clip_value, clip_value]`` in place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)


def _port_dim(w, dim):
    """Paddle's ``dim`` of ``w`` in the port's layout."""
    if dim is None or not is_transposed(w):
        return dim
    return 1 - (dim % 2)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize ``layer.<name> = g * v / ||v||`` (norm over every dim
    but paddle's ``dim``; the whole tensor when ``dim`` is None), computed
    by a forward pre-hook into the ``<name>`` buffer."""
    w = getattr(layer, name)
    pdim = _port_dim(w, dim)
    transposed = is_transposed(w)
    v = w.detach().clone()
    with torch.no_grad():
        if pdim is None:
            g0 = torch.linalg.vector_norm(v)
        else:
            axes = tuple(i for i in range(v.ndim) if i != pdim)
            g0 = torch.sqrt(torch.sum(torch.square(v), dim=axes))
    del layer._parameters[name]
    layer.register_parameter(name + "_g", torch.nn.Parameter(g0))
    layer.register_parameter(name + "_v", _param(v, transposed))

    def hook(mod, inputs):
        g, vv = getattr(mod, name + "_g"), getattr(mod, name + "_v")
        if pdim is None:
            new_w = g * vv / torch.linalg.vector_norm(vv)
        else:
            axes = tuple(i for i in range(vv.ndim) if i != pdim)
            norm = torch.sqrt(torch.sum(torch.square(vv), dim=axes,
                                        keepdim=True))
            shape = [1] * vv.ndim
            shape[pdim] = -1
            new_w = g.reshape(shape) * vv / norm
        mod._buffers[name] = mark_transposed(new_w) if transposed else new_w

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold the reparameterization back into a plain ``<name>`` parameter
    (its last computed value)."""
    w = layer._buffers.pop(name)
    for suffix in ("_g", "_v"):
        layer._parameters.pop(name + suffix, None)
    layer.register_parameter(name, _param(w.detach().clone(),
                                          is_transposed(w)))
    layer._forward_pre_hooks.clear()
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value (power
    iteration from the ``<name>_sn`` sublayer's fixed ``weight_u`` /
    ``weight_v``, as the reference) in a forward pre-hook; the raw weight
    moves to ``<name>_orig`` at the first call."""
    from ..layers.norm import SpectralNorm

    w = getattr(layer, name)
    pdim = _port_dim(w, dim or 0)
    sn = SpectralNorm(tuple(w.shape), dim=pdim,
                      power_iters=n_power_iterations, eps=eps,
                      dtype=w.dtype).to(w.device)
    layer.add_module(name + "_sn", sn)

    def hook(mod, inputs):
        if name + "_orig" not in mod._parameters:
            mod._parameters[name + "_orig"] = mod._parameters.pop(name)
        orig = mod._parameters[name + "_orig"]
        new_w = getattr(mod, name + "_sn")(orig)
        mod._buffers[name] = mark_transposed(new_w) if is_transposed(orig) \
            else new_w

    layer.register_forward_pre_hook(hook)
    hook(layer, None)
    return layer
