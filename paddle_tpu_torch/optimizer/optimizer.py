"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Paddle's formulas, not ``torch.optim``'s defaults: each optimizer defines
one update rule ``_rule(p, g, state, lr, hyper, wd)`` that updates the
parameter and its state tensors in place.  ``step()`` reads each
parameter's ``.grad`` (set by ``loss.backward()``), clips per parameter
group, then applies the rule with the group's ``learning_rate`` scale and
weight decay, under ``torch.no_grad()``.  A parameter with an f32 master
(``amp.decorate`` at O2) has the rule run on the master in f32 and its
low-precision working copy re-derived from it.  ``jit.TrainStep`` drives
the same ``step`` after its own backward, so the optimizer math exists
once.

Ported: SGD, Momentum, Adam (coupled L2) and AdamW (decoupled decay,
``apply_decay_param_fun``).  The remaining optimizers of the TPU package
(Adamax ... LBFGS) are not ported yet.
"""

from __future__ import annotations

import torch

from .lr import LRScheduler


class Optimizer:
    _hyper_defaults: dict = {}

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **hyper):
        self._lr = learning_rate
        self._names: dict[int, str] = {}
        self._groups = self._build_groups(parameters, weight_decay, hyper)
        self._grad_clip = grad_clip
        self._states: dict[int, dict] = {}
        self._step_count = 0

    # ------------------------------------------------------------- groups
    def _build_groups(self, parameters, weight_decay, hyper):
        base = dict(self._hyper_defaults)
        base.update(hyper)
        wd = 0.0 if weight_decay is None else weight_decay
        if hasattr(wd, "coeff"):  # L2Decay / L1Decay object
            wd = wd.coeff
        plist = list(parameters) if parameters is not None else []
        if plist and isinstance(plist[0], dict):
            groups = []
            for g in plist:
                gwd = g.get("weight_decay", wd)
                if hasattr(gwd, "coeff"):
                    gwd = gwd.coeff
                groups.append({"params": self._unname(g["params"]),
                               "weight_decay": gwd,
                               "lr_scale": g.get("learning_rate", 1.0),
                               "hyper": dict(base)})
            return groups
        return [{"params": self._unname(plist), "weight_decay": wd,
                 "lr_scale": 1.0, "hyper": base}]

    def _unname(self, params):
        """Parameters, given bare or as ``(name, param)`` pairs (torch's
        ``named_parameters()``); the names are kept for
        ``AdamW(apply_decay_param_fun=...)``."""
        out = []
        for p in params:
            if isinstance(p, tuple):
                self._names[id(p[1])] = p[0]
                p = p[1]
            out.append(p)
        return out

    @property
    def _parameter_list(self):
        return [p for g in self._groups for p in g["params"]]

    # ----------------------------------------------------------------- lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # --------------------------------------------------------------- step
    def step(self):
        """Clip each group's gradients, then apply the rule."""
        self._update(clip=True)

    def _update(self, clip):
        with torch.no_grad():
            lr = self.get_lr()
            for group in self._groups:
                pg = [(p, p.grad) for p in group["params"]
                      if p.grad is not None and p.requires_grad]
                if not pg:
                    continue
                if clip and self._grad_clip is not None:
                    pg = self._grad_clip(pg)
                for p, g in pg:
                    master = getattr(p, "_master", None)
                    pv = master if master is not None else p
                    self._rule(pv, g.to(pv.dtype), self._state_of(p),
                               lr * group["lr_scale"], group["hyper"],
                               self._param_weight_decay(p, group))
                    if master is not None:
                        p.copy_(master)
            self._step_count += 1

    def _state_of(self, p):
        """``p``'s state tensors, created on first use (on its master when
        it has one)."""
        state = self._states.get(id(p))
        if state is None:
            master = getattr(p, "_master", None)
            state = self._states[id(p)] = self.init_state(
                (master if master is not None else p).detach())
        return state

    def _param_weight_decay(self, p, group):
        return group["weight_decay"]

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        raise NotImplementedError

    def init_state(self, p):
        return {}

    # ------------------------------------------------------------- utils
    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        flat = {}
        for i, p in enumerate(self._parameter_list):
            st = self._states.get(id(p))
            if st:
                flat[str(i)] = dict(st)
        out = {"states": flat, "step": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, sd):
        params = self._parameter_list
        for k, st in sd.get("states", {}).items():
            p = params[int(k)]
            self._states[id(p)] = {kk: (vv.clone() if isinstance(vv, torch.Tensor)
                                        else vv) for kk, vv in st.items()}
        self._step_count = sd.get("step", 0)
        if "LR_Scheduler" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["LR_Scheduler"])

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, None


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        p.sub_(lr * g)


class Momentum(Optimizer):
    _hyper_defaults = {"momentum": 0.9, "use_nesterov": False}

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         momentum=momentum, use_nesterov=use_nesterov)

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        mu = hyper["momentum"]
        v = state["velocity"].mul_(mu).add_(g)
        if hyper["use_nesterov"]:
            p.sub_(lr * (g + mu * v))
        else:
            p.sub_(lr * v)


def _adam_moments(g, state, hyper):
    """Advance ``t``, ``m`` and ``v`` in place; return the bias-corrected
    ``mhat / (sqrt(vhat) + eps)`` in f32."""
    b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]
    t = state["t"].add_(1)
    m = state["m"].mul_(b1).add_((1 - b1) * g)
    v = state["v"].mul_(b2).add_((1 - b2) * torch.square(g))
    mhat = m.float() / (1 - torch.pow(b1, t))
    vhat = v.float() / (1 - torch.pow(b2, t))
    if hyper.get("amsgrad"):
        vhat = torch.maximum(state["vmax"], vhat)
        state["vmax"].copy_(vhat)
    return mhat / (torch.sqrt(vhat) + eps)


class Adam(Optimizer):
    _hyper_defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "lazy_mode": False,
                       "amsgrad": False}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None, amsgrad=False, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         beta1=beta1, beta2=beta2, epsilon=epsilon, lazy_mode=lazy_mode,
                         amsgrad=amsgrad)

    def init_state(self, p):
        s = {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
             "t": torch.zeros([], dtype=torch.float32, device=p.device)}
        if self._groups[0]["hyper"].get("amsgrad"):
            s["vmax"] = torch.zeros_like(p, dtype=torch.float32)
        return s

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:  # Adam applies coupled L2 (weight_decay as a regularizer)
            g = g + wd * p
        p.copy_(p.float() - lr * _adam_moments(g, state, hyper))


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * wd) - lr * mhat / (sqrt(vhat)
    + eps)``.  ``apply_decay_param_fun(name)`` picks the parameters that
    decay, by the name each was given with (``parameters=
    model.named_parameters()``; ``""`` for a bare parameter)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        upd = _adam_moments(g, state, hyper)
        p.copy_(p.float() * (1 - lr * wd) - lr * upd)

    def _param_weight_decay(self, p, group):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._names.get(id(p), ""))):
            return 0.0
        return group["weight_decay"]
