"""Custom-operator plugin surface (counterpart of
``paddle_tpu/framework/custom_op.py``).

A custom op is a function over torch tensors (typically the wrapper of a
hand-written CUDA kernel, with its plain version for CPU tensors).  Its
gradient rule becomes a ``torch.autograd.Function`` built for the op, so
the op trains like a built-in, inside ``jit.TrainStep`` too::

    def swish_fwd(x, beta): ...          # the kernel's wrapper, or torch
    def swish_vjp_fwd(x, beta): ...      # -> (out, residuals)
    def swish_vjp_bwd(res, g): ...       # -> one gradient per input

    op = paddle_tpu_torch.register_op("fused_swish", swish_fwd,
                                      vjp=(swish_vjp_fwd, swish_vjp_bwd))
    y = op(x, 1.0)                       # or paddle_tpu_torch.ops.fused_swish

``load_op_library(path)`` loads a Python plugin file whose top level
registers ops, as in the TPU package.
"""

from __future__ import annotations

import functools
import runpy
from typing import Callable, Sequence

import torch

_REGISTRY: dict[str, "CustomOp"] = {}


class CustomOp:
    """A registered custom op: callable on tensors, differentiable."""

    def __init__(self, name: str, fn: Callable, raw_fn: Callable):
        self.name = name
        self.fn = fn          # grad-aware (the op's autograd Function applied)
        self.raw_fn = raw_fn  # the user's original function
        self.__name__ = name

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return f"<CustomOp {self.name}>"


def register_op(name: str, fn: Callable | None = None, *,
                vjp: Sequence[Callable] | Callable | None = None,
                method: bool = False, override: bool = False):
    """Install ``fn`` (tensors in, tensors out) as a first-class op named
    ``name``.

    Args:
        fn: function over torch tensors.  Omit to use as a decorator.
        vjp: gradient rule.  Either a ``(fwd, bwd)`` pair with
            ``jax.custom_vjp`` semantics (``fwd(*args) -> (out,
            residuals)``, ``bwd(residuals, g) -> one gradient per
            positional argument``), or a single ``bwd(res, g)`` whose
            residuals are the op's positional arguments.  None lets torch
            autograd differentiate ``fn`` itself.
        method: attach as a ``Tensor`` method.  The port has no paddle
            ``Tensor`` yet, so this raises ``NotImplementedError``.
        override: allow replacing an existing registration.

    Returns the :class:`CustomOp` (also reachable as
    ``paddle_tpu_torch.ops.<name>``).
    """
    if fn is None:
        return lambda f: register_op(name, f, vjp=vjp, method=method,
                                     override=override)
    if not name.isidentifier():
        raise ValueError(f"op name {name!r} is not a valid identifier")
    if method:
        raise NotImplementedError(
            "register_op(method=True) attaches the op to paddle's Tensor, "
            "which the port does not have yet; call the op as a function")
    if name in _REGISTRY and not override:
        raise ValueError(f"op {name!r} already registered "
                         "(pass override=True to replace)")
    from .. import ops as ops_ns
    if hasattr(ops_ns, name) and name not in _REGISTRY and not override:
        raise ValueError(f"op name {name!r} collides with a built-in op")

    grad_fn = fn
    if vjp is not None:
        if callable(vjp):
            def fwd_rule(*args, **kwargs):
                return fn(*args, **kwargs), args

            bwd_rule = vjp
        else:
            fwd_rule, bwd_rule = vjp
        grad_fn = _with_vjp(name, fwd_rule, bwd_rule)

    op = CustomOp(name, grad_fn, fn)
    _REGISTRY[name] = op
    setattr(ops_ns, name, op)
    return op


def _with_vjp(name, fwd_rule, bwd_rule):
    """``fn(*args, **kwargs)`` whose forward is ``fwd_rule`` and whose
    backward is ``bwd_rule``, through a ``torch.autograd.Function`` made for
    this op.  Keyword arguments are bound before the call (``apply`` takes
    none) and get no gradient; neither do non-tensor arguments."""

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, fwd, *args):
            out, res = fwd(*args)
            ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            if isinstance(res, (tuple, list)):
                # tensors through save_for_backward, the rest on ctx
                ctx.res_kind = type(res)
                ctx.res_slots = [isinstance(r, torch.Tensor) for r in res]
                ctx.res_other = [None if s else r
                                 for r, s in zip(res, ctx.res_slots)]
                ctx.save_for_backward(*(r for r in res
                                        if isinstance(r, torch.Tensor)))
            else:
                ctx.res_kind = None
                ctx.res_other = res
            return out

        @staticmethod
        def backward(ctx, *gs):
            g = gs[0] if len(gs) == 1 else gs
            if ctx.res_kind is None:
                res = ctx.res_other
            else:
                saved = iter(ctx.saved_tensors)
                res = ctx.res_kind(next(saved) if s else o for s, o in
                                   zip(ctx.res_slots, ctx.res_other))
            grads = bwd_rule(res, g)
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            if len(grads) != len(ctx.is_tensor):
                raise ValueError(
                    f"custom op {name!r}: the vjp gave {len(grads)} gradients "
                    f"for {len(ctx.is_tensor)} arguments")
            return (None, *(gr if t else None
                            for gr, t in zip(grads, ctx.is_tensor)))

    Op.__name__ = Op.__qualname__ = f"CustomOp_{name}"

    def call(*args, **kwargs):
        fwd = functools.partial(fwd_rule, **kwargs) if kwargs else fwd_rule
        return Op.apply(fwd, *args)

    return call


def get_op(name: str) -> CustomOp | None:
    return _REGISTRY.get(name)


def deregister_op(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    op = _REGISTRY.pop(name, None)
    if op is not None:
        from .. import ops as ops_ns

        if getattr(ops_ns, name, None) is op:
            delattr(ops_ns, name)


def load_op_library(path: str) -> list[str]:
    """Load a plugin file whose top level calls :func:`register_op`;
    returns the names the plugin registered."""
    before = set(_REGISTRY)
    runpy.run_path(path, run_name="paddle_tpu_torch_plugin")
    return sorted(set(_REGISTRY) - before)
