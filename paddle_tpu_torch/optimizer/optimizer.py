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

All fifteen of the TPU package: SGD, Momentum, Adam (coupled L2), AdamW
(decoupled decay, ``apply_decay_param_fun``), Adamax, Adagrad, RMSProp,
Adadelta, Lamb, Rprop, NAdam, RAdam, ASGD and Lars as rules; their
scalar state (``t``, NAdam's ``mu_prod``) is a 0-d f32 tensor on the
parameter's device, and Lamb's and Lars's trust ratios, RAdam's
rectification switch and ASGD's ring slot are computed there too, so a
step never syncs with the host.  LBFGS keeps the reference's closure
contract (``step(closure)`` re-evaluates the loss, eagerly only) and
its flat history vectors on the parameters' device; its line search and
stopping tests read scalars on the host, as the reference's do.
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

    def _live_state(self, p):
        """``p``'s state tensors if they exist yet (none are created)."""
        return self._states.get(id(p), {})

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


def _bias_step(state, beta1, beta2, g):
    """Advance ``t``, ``m`` and ``v`` in place (Adam's moments); returns
    them."""
    t = state["t"].add_(1)
    m = state["m"].mul_(beta1).add_((1 - beta1) * g)
    v = state["v"].mul_(beta2).add_((1 - beta2) * torch.square(g))
    return t, m, v


def _moments_state(p):
    return {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
            "t": torch.zeros([], dtype=torch.float32, device=p.device)}


class Adamax(Optimizer):
    _hyper_defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         beta1=beta1, beta2=beta2, epsilon=epsilon)

    def init_state(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p),
                "t": torch.zeros([], dtype=torch.float32, device=p.device)}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]
        t = state["t"].add_(1)
        m = state["m"].mul_(b1).add_((1 - b1) * g)
        u = state["u"]
        u.copy_(torch.maximum(b2 * u, torch.abs(g)))
        p.copy_(p - lr / (1 - torch.pow(b1, t)) * m / (u + eps))


class Adagrad(Optimizer):
    _hyper_defaults = {"epsilon": 1e-6, "initial_accumulator_value": 0.0}

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         epsilon=epsilon,
                         initial_accumulator_value=initial_accumulator_value)

    def init_state(self, p):
        return {"moment": torch.full_like(
            p, self._groups[0]["hyper"]["initial_accumulator_value"])}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        mom = state["moment"].add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(mom) + hyper["epsilon"]))


class RMSProp(Optimizer):
    _hyper_defaults = {"rho": 0.95, "epsilon": 1e-6, "momentum": 0.0, "centered": False}

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         rho=rho, epsilon=epsilon, momentum=momentum, centered=centered)

    def init_state(self, p):
        return {"mean_square": torch.zeros_like(p), "mean_grad": torch.zeros_like(p),
                "momentum": torch.zeros_like(p)}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        rho, eps = hyper["rho"], hyper["epsilon"]
        ms = state["mean_square"].mul_(rho).add_((1 - rho) * torch.square(g))
        if hyper["centered"]:
            mg = state["mean_grad"].mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - torch.square(mg) + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = state["momentum"].mul_(hyper["momentum"]).add_(lr * g / denom)
        p.sub_(mom)


class Adadelta(Optimizer):
    _hyper_defaults = {"rho": 0.95, "epsilon": 1e-6}

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name,
                         rho=rho, epsilon=epsilon)

    def init_state(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        rho, eps = hyper["rho"], hyper["epsilon"]
        asg = state["avg_sq_grad"].mul_(rho).add_((1 - rho) * torch.square(g))
        asu = state["avg_sq_update"]
        update = torch.sqrt(asu + eps) / torch.sqrt(asg + eps) * g
        asu.mul_(rho).add_((1 - rho) * torch.square(update))
        p.sub_(lr * update)


class Lamb(Optimizer):
    """Layer-wise trust ratio ``||w|| / ||r||`` (1 where either is 0) over
    Adam's update plus ``lamb_weight_decay * w``; both norms per parameter,
    on its device."""

    _hyper_defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                       "lamb_weight_decay": 0.01}

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         beta1=beta1, beta2=beta2, epsilon=epsilon,
                         lamb_weight_decay=lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, p):
        return _moments_state(p)

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]
        t, m, v = _bias_step(state, b1, b2, g)
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        r = mhat / (torch.sqrt(vhat) + eps) + hyper["lamb_weight_decay"] * p
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        p.copy_(p - lr * trust * r)


class Rprop(Optimizer):
    _hyper_defaults = {"etas": (0.5, 1.2), "sizes": (1e-6, 50.0)}

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         etas=etas, sizes=learning_rate_range)

    def init_state(self, p):
        return {"prev": torch.zeros_like(p),
                "step_size": torch.full_like(p, self.get_lr())}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        em, ep = hyper["etas"]
        smin, smax = hyper["sizes"]
        sign = torch.sign(g * state["prev"])
        factor = torch.where(sign > 0, ep, torch.where(sign < 0, em, 1.0))
        step = state["step_size"].mul_(factor).clamp_(smin, smax)
        g_eff = torch.where(sign < 0, 0.0, g)
        state["prev"].copy_(g_eff)
        p.sub_(torch.sign(g_eff) * step)


class NAdam(Optimizer):
    """Nesterov-momentum Adam (paddle's NAdam: momentum decay ``psi``)."""

    _hyper_defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                       "momentum_decay": 0.004}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, beta1=beta1, beta2=beta2, epsilon=epsilon,
                         momentum_decay=momentum_decay)

    def init_state(self, p):
        s = _moments_state(p)
        s["mu_prod"] = torch.ones([], dtype=torch.float32, device=p.device)
        return s

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]
        psi = hyper["momentum_decay"]
        t, m, v = _bias_step(state, b1, b2, g)
        mu_t = b1 * (1 - 0.5 * torch.pow(0.96, t * psi))
        mu_next = b1 * (1 - 0.5 * torch.pow(0.96, (t + 1) * psi))
        mu_prod = state["mu_prod"].mul_(mu_t)
        mhat = mu_next * m / (1 - mu_prod * mu_next) \
            + (1 - mu_t) * g / (1 - mu_prod)
        vhat = v / (1 - torch.pow(b2, t))
        p.copy_(p - lr * mhat / (torch.sqrt(vhat) + eps))


class RAdam(Optimizer):
    """Rectified Adam: SGD with momentum while the variance estimate is not
    rectifiable (``rho_t <= 5``), chosen on the device."""

    _hyper_defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, beta1=beta1, beta2=beta2, epsilon=epsilon)

    def init_state(self, p):
        return _moments_state(p)

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]
        t, m, v = _bias_step(state, b1, b2, g)
        mhat = m / (1 - torch.pow(b1, t))
        b2t = torch.pow(b2, t)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2.0 * t * b2t / (1 - b2t)
        r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
        r_den = (rho_inf - 4) * (rho_inf - 2) * rho_t
        rect = torch.sqrt(torch.clamp(r_num / torch.clamp(r_den, min=1e-12),
                                      min=0.0))
        vhat = torch.sqrt(v / (1 - b2t)) + eps
        adaptive = p - lr * rect * mhat / vhat
        plain = p - lr * mhat
        p.copy_(torch.where(rho_t > 5.0, adaptive, plain))


class ASGD(Optimizer):
    """Averaged SGD: steps with the mean of the last ``batch_num`` gradients
    (a ring per parameter, its slot picked on the device) and keeps the
    running average of the iterates in ``state["avg"]``."""

    _hyper_defaults = {"batch_num": 1}

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        if batch_num < 1:
            raise ValueError("batch_num must be >= 1")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, batch_num=batch_num)
        self._batch_num = int(batch_num)

    def init_state(self, p):
        s = {"avg": p.clone(),
             "t": torch.zeros([], dtype=torch.float32, device=p.device)}
        if self._batch_num > 1:
            s["grad_buf"] = torch.zeros((self._batch_num,) + tuple(p.shape),
                                        dtype=p.dtype, device=p.device)
            s["grad_sum"] = torch.zeros_like(p)
        return s

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        if wd:
            g = g + wd * p
        t = state["t"].add_(1)
        n = int(hyper["batch_num"])
        if n > 1:
            slot = ((t.to(torch.int64) - 1) % n).view(1)
            buf = state["grad_buf"]
            old = buf.index_select(0, slot)[0]
            grad_sum = state["grad_sum"].sub_(old).add_(g)
            buf.index_copy_(0, slot, g.unsqueeze(0))
            g = grad_sum / torch.clamp(t, max=float(n))
        p.sub_(lr * g)
        avg = state["avg"]
        avg.add_((p - avg) / t)


class Lars(Optimizer):
    """Layer-wise adaptive rate scaling: the trust ratio ``coeff * ||w|| /
    (||g|| + wd * ||w|| + eps)`` (1 where either norm is 0) scales each
    parameter's rate, computed on its device."""

    _hyper_defaults = {"momentum": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005, "epsilon": 1e-9}

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=1e-9, parameters=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         momentum=momentum, lars_coeff=lars_coeff,
                         lars_weight_decay=lars_weight_decay, epsilon=epsilon)

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    @staticmethod
    def _rule(p, g, state, lr, hyper, wd):
        mu, coeff = hyper["momentum"], hyper["lars_coeff"]
        lwd, eps = hyper["lars_weight_decay"], hyper["epsilon"]
        w_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                               coeff * w_norm / (g_norm + lwd * w_norm + eps),
                               1.0)
        vel = state["velocity"].mul_(mu).add_(local_lr * lr * (g + lwd * p))
        p.sub_(vel)


class LBFGS(Optimizer):
    """Limited-memory BFGS with a backtracking line search on the closure.
    ``step(closure)`` re-evaluates the loss (the reference contract; the
    closure clears the gradients, computes the loss and calls
    ``backward()``), so it runs eagerly only."""

    def __init__(self, learning_rate=1.0, max_iter=20, history_size=10,
                 tolerance_grad=1e-7, tolerance_change=1e-9, parameters=None,
                 line_search_fn=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        # step() does not run the per-parameter rule, so accepting these
        # would run other dynamics than asked for
        if weight_decay:
            raise ValueError("LBFGS does not support weight_decay; add an "
                             "L2 term to the closure's loss instead")
        if grad_clip is not None:
            raise ValueError("LBFGS does not support grad_clip")
        if line_search_fn not in (None, "backtracking"):
            raise ValueError(f"unsupported line_search_fn "
                             f"{line_search_fn!r} (only backtracking)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.max_iter = max_iter
        self.history_size = history_size
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self._hist = []  # [(s, y, rho)], newest last

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._parameter_list])

    def _set_flat(self, flat):
        ofs = 0
        with torch.no_grad():
            for p in self._parameter_list:
                n = p.numel()
                p.copy_(flat[ofs:ofs + n].view_as(p))
                ofs += n

    def _flat_grad(self):
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in self._parameter_list])

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the "
                             "loss (reference contract)")
        loss = closure()
        g = self._flat_grad()
        x = self._flat_params()
        for _ in range(self.max_iter):
            if float(torch.max(torch.abs(g))) <= self.tol_grad:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y, rho in reversed(self._hist):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if self._hist:
                s, y, _ = self._hist[-1]
                q = q * (torch.dot(s, y)
                         / torch.clamp(torch.dot(y, y), min=1e-12))
            for (s, y, rho), a in zip(self._hist, reversed(alphas)):
                b = rho * torch.dot(y, q)
                q = q + s * (a - b)
            d = -q
            # backtracking line search on the closure
            t = float(self.get_lr())
            f0 = float(loss)
            gtd = float(torch.dot(g, d))
            x_new = x
            for _ls in range(10):
                x_new = x + t * d
                self._set_flat(x_new)
                self.clear_grad()
                loss = closure()
                if float(loss) <= f0 + 1e-4 * t * gtd:
                    break
                t *= 0.5
            g_new = self._flat_grad()
            s_vec = x_new - x
            y_vec = g_new - g
            ys = float(torch.dot(s_vec, y_vec))
            if ys > 1e-10:
                self._hist.append((s_vec, y_vec, 1.0 / ys))
                if len(self._hist) > self.history_size:
                    self._hist.pop(0)
            x, g = x_new, g_new
            if float(torch.max(torch.abs(s_vec))) < self.tol_change:
                break
        self._step_count += 1
        return loss
