"""Optimizer wrappers (counterpart of ``paddle_tpu/incubate/optimizer.py``):
:class:`LookAhead`, and the weight averagers
:class:`ExponentialMovingAverage` and :class:`ModelAverage`.

Everything stays on the parameters' device with no host sync: LookAhead's
step counter is a 0-d device tensor and its every-``k``-steps sync is a
``torch.where`` on it (the reference's traced ``jnp.where``), so the
wrapper runs unchanged under :class:`~..jit.TrainStep`; the averagers'
shadow weights update with one multi-tensor pass per step.  A parameter
with an f32 master (``amp.decorate`` at O2) is read and written through
the master, its low-precision working copy re-derived from it.
"""

from __future__ import annotations

import contextlib

import torch


def _master_or_self(p):
    m = getattr(p, "_master", None)
    return p if m is None else m


def _write(p, value):
    """Write ``value`` into ``p`` (and its master) in place: a CUDA graph
    holding the weights' addresses reads the new values."""
    m = getattr(p, "_master", None)
    if m is not None:
        m.copy_(value)
    p.copy_(value)


class LookAhead:
    """Lookahead (k steps forward, 1 step back): the fast weights follow
    the inner optimizer; every ``k`` steps the slow weights move ``alpha``
    of the way toward them and the fast weights reset to the slow ones.

    Wraps any optimizer of :mod:`paddle_tpu_torch.optimizer`; usable
    eagerly (``step()``) and under ``jit.TrainStep``, which calls
    ``_update(clip=False)`` and reads (and restores, on a skipped fp16
    step) ``_state_of(p)``: the inner optimizer's state of ``p`` plus its
    slow weight and the shared step counter.  The slow weights start at
    the parameters' values before the first update.
    """

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0,1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = {}         # id(param) -> slow weight (f32 at O2)
        self._count = None      # 0-d int32 device tensor: updates so far

    # delegate everything else a trainer reads off an optimizer
    def __getattr__(self, name):
        if name == "inner_optimizer":
            raise AttributeError(name)
        return getattr(self.inner_optimizer, name)

    def _ensure_slow(self):
        if self._count is not None:
            return
        params = self.inner_optimizer._parameter_list
        with torch.no_grad():
            for p in params:
                self._slow[id(p)] = _master_or_self(p).detach().clone()
        dev = params[0].device if params else torch.device("cpu")
        self._count = torch.zeros((), dtype=torch.int32, device=dev)

    def _update(self, clip):
        self._ensure_slow()
        self.inner_optimizer._update(clip)
        with torch.no_grad():
            self._count.add_(1)
            sync = torch.remainder(self._count, self.k) == 0
            for p in self.inner_optimizer._parameter_list:
                pv = _master_or_self(p)
                slow = self._slow[id(p)]
                slow.copy_(torch.where(
                    sync, slow + self.alpha * (pv.to(slow.dtype) - slow),
                    slow))
                _write(p, torch.where(sync, slow.to(pv.dtype), pv))

    def step(self):
        self._update(clip=True)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def _state_of(self, p):
        self._ensure_slow()
        st = dict(self.inner_optimizer._state_of(p))
        st["slow"] = self._slow[id(p)]
        st["count"] = self._count
        return st

    def _live_state(self, p):
        st = dict(self.inner_optimizer._live_state(p))
        if id(p) in self._slow:
            st["slow"] = self._slow[id(p)]
            st["count"] = self._count
        return st

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        # slow weights by parameter order (ids do not survive a restart)
        plist = self.inner_optimizer._parameter_list
        sd["lookahead"] = {
            "alpha": self.alpha, "k": self.k,
            "count": int(self._count) if self._count is not None else 0,
            "slow": [self._slow.get(id(p)) for p in plist]}
        return sd

    def set_state_dict(self, sd):
        la = sd.get("lookahead")
        self.inner_optimizer.set_state_dict(
            {k: v for k, v in sd.items() if k != "lookahead"})
        if la:
            self._ensure_slow()
            self._count.fill_(int(la.get("count", 0)))
            for p, s in zip(self.inner_optimizer._parameter_list,
                            la.get("slow") or ()):
                if s is not None:
                    self._slow[id(p)].copy_(torch.as_tensor(s))


class _AveragerBase:
    """Shadow weights over a module's (or a parameter list's) trainable
    parameters, kept in each parameter's (master's) dtype on its device;
    ``apply()`` swaps the averaged values in, in place, and restores the
    live ones on exit."""

    def __init__(self, params_or_model):
        if hasattr(params_or_model, "named_parameters"):
            named = [(k, p) for k, p in params_or_model.named_parameters()
                     if p.requires_grad]
        else:
            named = [(f"param_{i}", p) for i, p in enumerate(params_or_model)
                     if p.requires_grad]
        self._params = named
        # zero-init: both averagers accumulate from zero (EMA debiases,
        # the mean divides by t)
        self._shadow = {k: torch.zeros_like(_master_or_self(p).detach())
                        for k, p in named}
        self._backup = None
        self._t = 0

    def _current(self):
        return [_master_or_self(p).detach() for _, p in self._params]

    def _shadows(self):
        return [self._shadow[k] for k, _ in self._params]

    def _swap_in(self, tree):
        with torch.no_grad():
            self._backup = [(p.detach().clone(),
                             None if getattr(p, "_master", None) is None
                             else p._master.detach().clone())
                            for _, p in self._params]
            for k, p in self._params:
                _write(p, tree[k])

    def restore(self, executor=None):
        if self._backup is None:
            return
        with torch.no_grad():
            for (_, p), (v, m) in zip(self._params, self._backup):
                p.copy_(v)
                if m is not None:
                    p._master.copy_(m)
        self._backup = None

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        self._swap_in(self._averaged_tree())
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def state_dict(self):
        return {"shadow": dict(self._shadow), "t": self._t}

    def set_state_dict(self, sd):
        with torch.no_grad():
            for k, v in sd.get("shadow", {}).items():
                self._shadow[k].copy_(torch.as_tensor(v))
        self._t = sd.get("t", self._t)


class ExponentialMovingAverage(_AveragerBase):
    """EMA of the weights: ``shadow = decay * shadow + (1 - decay) *
    param``, debiased at :meth:`apply` time by ``1 - decay ** t``.  Call
    :meth:`update` once per train step (after ``opt.step()`` or a
    ``TrainStep`` call).  ``thres_steps`` is accepted for paddle's
    signature; the debiasing is the reference's ``1 - decay ** t``."""

    def __init__(self, params_or_model, decay=0.999, thres_steps=None,
                 name=None):
        super().__init__(params_or_model)
        self.decay = float(decay)

    def update(self):
        self._t += 1
        with torch.no_grad():
            shadows = self._shadows()
            cur = [c.to(s.dtype) for s, c in zip(shadows, self._current())]
            torch._foreach_mul_(shadows, self.decay)
            torch._foreach_add_(shadows,
                                torch._foreach_mul(cur, 1.0 - self.decay))

    def _averaged_tree(self):
        if self._t == 0:  # no update yet: apply() is the identity
            return dict(zip((k for k, _ in self._params), self._current()))
        debias = 1.0 - self.decay ** self._t
        return {k: v / debias for k, v in self._shadow.items()}

    def state_dict(self):
        return {"shadow": dict(self._shadow), "t": self._t,
                "decay": self.decay}

    def set_state_dict(self, sd):
        super().set_state_dict(sd)
        self.decay = float(sd.get("decay", self.decay))


class ModelAverage(_AveragerBase):
    """Running mean of the parameters: at :meth:`apply` the weights are
    ``sum_t(param_t) / t`` (the reference's exact mean; its window
    arguments are accepted for paddle's signature)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None, model=None):
        super().__init__(model if model is not None else (parameters or []))

    def update(self):
        self._t += 1
        with torch.no_grad():
            shadows = self._shadows()
            torch._foreach_add_(shadows, [c.to(s.dtype) for s, c in
                                          zip(shadows, self._current())])

    def _averaged_tree(self):
        if self._t == 0:
            return dict(zip((k for k, _ in self._params), self._current()))
        return {k: v / self._t for k, v in self._shadow.items()}
