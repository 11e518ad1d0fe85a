"""TrainStep — one training step per call (counterpart of
``paddle_tpu/jit/train_step.py``).

The TPU package traces forward, backward, clip and update into one donated
XLA program.  PyTorch runs eagerly, so here each call runs, in order: the
forward (under ``amp.auto_cast`` when asked), the backward, the global
clip over every gradient, and the optimizer's own update rule, in place.
The model's parameters are updated where they live.  Typical use::

    step = paddle_tpu_torch.jit.TrainStep(model, opt, loss_fn=None)
    loss = step({"input_ids": ids, "labels": ids})   # 0-d device tensor

Kept from the TPU package:

- the batch calling convention: one dict calls the model with it as
  keyword arguments; otherwise ``loss_fn(model(*x), *labels)`` (or
  ``model(*batch)`` when ``loss_fn`` is None);
- ``amp_level`` / ``amp_dtype``: at O2 the forward runs on amp-dtype
  copies of the f32 parameters (``torch.func.functional_call``), so the
  gradients land on the f32 masters;
- ``accumulate_steps``: the batch is cut into micro-slices along its first
  dim, gradients are averaged, and one update is made;
- ``scaler`` (a ``GradScaler``): the loss is scaled, the gradients
  unscaled, the update is skipped when any gradient is not finite, and the
  scale is adjusted — all on the device, with no host sync;
- ``return_outputs``, ``sync()``, ``found_inf``, ``loss_scale``,
  ``state_dict`` / ``set_state_dict`` and :func:`train_step`.

The loss comes back as a 0-d device tensor, with no host sync.  The TPU
package's metrics registry, tracing, perf-table and numerics-probe hooks
are not ported yet; neither is a CUDA-graph step (``donate`` is accepted
and has no effect: updates are in place already).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import amp as _amp


def _master_or_self(p):
    m = getattr(p, "_master", None)
    return p if m is None else m


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class TrainStep:
    """Forward + backward + clip + optimizer update of ``model`` per call.

    Args:
        model: ``torch.nn.Module``; its parameters that require grad are
            trained.
        optimizer: a ``paddle_tpu_torch.optimizer`` optimizer over them.
        loss_fn: ``callable(outputs, *labels) -> scalar``; None when the
            model's forward returns the loss itself.
        amp_level: None / ``"O0"``, ``"O1"`` or ``"O2"``.
        amp_dtype: ``"bfloat16"`` (default) or ``"float16"``.
        return_outputs: also return the model outputs (detached).
        accumulate_steps: micro-slices per call, one update.
        scaler: a ``paddle_tpu_torch.amp.GradScaler`` (fp16 loss scaling).
    """

    def __init__(self, model, optimizer, loss_fn=None, amp_level=None,
                 amp_dtype="bfloat16", donate=True, return_outputs=False,
                 accumulate_steps=1, scaler=None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.amp_level = None if amp_level in (None, "O0") else amp_level
        self.amp_dtype = amp_dtype
        self.return_outputs = return_outputs and accumulate_steps == 1
        self.accumulate_steps = int(accumulate_steps)
        named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
        self._names = [k for k, _ in named]
        self._params = [p for _, p in named]
        self._device = self._params[0].device if self._params else torch.device("cpu")
        self._scaler = scaler if (scaler is not None
                                  and getattr(scaler, "_enable", False)) else None
        if self._scaler is not None:
            s = self._scaler
            # (scale, good steps, bad steps, found_inf), kept on the device
            self._scaler_state = (
                torch.tensor(s._scale, dtype=torch.float32, device=self._device),
                torch.tensor(s._good_steps, dtype=torch.int32, device=self._device),
                torch.tensor(s._bad_steps, dtype=torch.int32, device=self._device),
                torch.zeros((), dtype=torch.bool, device=self._device))
        else:
            self._scaler_state = None
        self._step_count = 0

    # ------------------------------------------------------------------ call
    def __call__(self, *batch):
        batch = _tree_map(self._to_device, batch)
        acc = self.accumulate_steps
        scale = self._scaler_state[0] if self._scaler is not None else None
        for p in self._params:
            p.grad = None
        if acc > 1:
            loss = torch.zeros((), dtype=torch.float32, device=self._device)
            for micro in self._micro_batches(batch, acc):
                l_i, _ = self._forward(micro)
                (l_i * scale if scale is not None else l_i).backward()
                loss = loss + l_i.detach()
            loss = loss / acc
            outs = ()
            with torch.no_grad():
                for p in self._params:
                    if p.grad is not None:
                        p.grad.div_(acc)
        else:
            loss, outs = self._forward(batch)
            (loss * scale if scale is not None else loss).backward()
            loss = loss.detach()
        self._update()
        self._step_count += 1
        if self.return_outputs:
            return loss, _tree_map(
                lambda o: o.detach() if isinstance(o, torch.Tensor) else o, outs)
        return loss

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=self._device)
        if isinstance(x, torch.Tensor) and x.device != self._device:
            return x.to(self._device)
        return x

    @staticmethod
    def _micro_batches(batch, acc):
        def check(x):
            if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] % acc:
                raise ValueError(
                    f"accumulate_steps={acc} needs every batch input's leading "
                    f"dim divisible by it; got "
                    f"{tuple(x.shape) if isinstance(x, torch.Tensor) else x!r}")
            return x
        _tree_map(check, batch)
        return [_tree_map(lambda x: x.chunk(acc)[i], batch) for i in range(acc)]

    def _forward(self, batch):
        """The f32 loss and the model outputs of one (micro-)batch."""
        model, loss_fn = self.model, self.loss_fn
        if self.amp_level == "O2":
            # compute on amp-dtype copies of the (f32 master) parameters:
            # the casts are differentiable, so the grads land on the masters
            tgt = _amp.to_dtype(self.amp_dtype)
            bind = {k: (p.to(tgt) if p.is_floating_point() else p)
                    for k, p in zip(self._names, self._params)}

            def call(*a, **kw):
                return torch.func.functional_call(model, bind, a, kw)
        else:
            call = model
        with _amp.auto_cast(enable=self.amp_level is not None,
                            level=self.amp_level or "O1", dtype=self.amp_dtype):
            if loss_fn is None:
                if len(batch) == 1 and isinstance(batch[0], dict):
                    loss = call(**batch[0])
                else:
                    loss = call(*batch)
                outs = ()
            else:
                x = batch[0]
                xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
                outs = call(*xs)
                loss = loss_fn(outs, *batch[1:])
        if isinstance(loss, dict):
            loss = loss["loss"]
        return loss.float(), outs

    def _update(self):
        """Unscale / check (scaler), clip over every gradient, apply the
        rule, then drop the gradients."""
        opt = self.optimizer
        pg = [(p, p.grad) for p in self._params if p.grad is not None]
        with torch.no_grad():
            if self._scaler is not None:
                scale, good, bad, _ = self._scaler_state
                inv = 1.0 / scale
                for _, g in pg:
                    g.mul_(inv)
                found = torch.zeros((), dtype=torch.bool, device=self._device)
                for _, g in pg:
                    found = found | ~torch.isfinite(g).all()
                # skip-step: snapshot what the update writes, restore it
                # where any gradient was non-finite
                keep = [p for p, _ in pg]
                keep += [p._master for p in keep if getattr(p, "_master", None) is not None]
                keep += [t for p, _ in pg for t in opt._state_of(p).values()
                         if isinstance(t, torch.Tensor)]
                before = [t.clone() for t in keep]
            if opt._grad_clip is not None and pg:
                for p, g in opt._grad_clip(pg):
                    p.grad = g
            opt._update(clip=False)
            if self._scaler is not None:
                for t, old in zip(keep, before):
                    t.copy_(torch.where(found, old, t))
                self._scaler_state = self._next_scale(scale, good, bad, found)
        for p in self._params:
            p.grad = None

    def _next_scale(self, scale, good, bad, found):
        sc = self._scaler
        if not sc._dynamic:
            return scale, good, bad, found
        zero = torch.zeros_like(good)
        bad_n = torch.where(found, bad + 1, zero)
        good_n = torch.where(found, zero, good + 1)
        dec = found & (bad_n >= sc._decr_every)
        inc = (~found) & (good_n >= sc._incr_every)
        scale_n = torch.where(dec, torch.clamp(scale * sc._decr_ratio, min=1.0),
                              torch.where(inc, scale * sc._incr_ratio, scale))
        return (scale_n, torch.where(inc, zero, good_n),
                torch.where(dec, zero, bad_n), found)

    # ------------------------------------------------------------ state sync
    def sync(self):
        """Write the device-side loss-scale state back into the
        ``GradScaler`` (the optimizer's state is updated in place already)."""
        if self._scaler is not None:
            s, g, b, _ = self._scaler_state
            self._scaler._scale = float(s)
            self._scaler._good_steps = int(g)
            self._scaler._bad_steps = int(b)
        return self

    @property
    def found_inf(self):
        """Whether the LAST step skipped its update (scaler only)."""
        return (bool(self._scaler_state[3])
                if self._scaler_state is not None else False)

    @property
    def loss_scale(self):
        return (float(self._scaler_state[0])
                if self._scaler_state is not None else 1.0)

    def state_dict(self):
        """``params`` (the f32 masters where there are any), ``buffers``,
        ``opt_state`` (per parameter name), ``step`` and, with a scaler,
        ``scaler_state``."""
        sd = {"params": {k: _master_or_self(p).detach()
                         for k, p in zip(self._names, self._params)},
              "buffers": dict(self.model.named_buffers()),
              "opt_state": {k: self.optimizer._state_of(p)
                            for k, p in zip(self._names, self._params)},
              "step": self._step_count}
        if self._scaler_state is not None:
            sd["scaler_state"] = self._scaler_state
        return sd

    def set_state_dict(self, sd):
        with torch.no_grad():
            params = dict(zip(self._names, self._params))
            for k, v in sd["params"].items():
                _master_or_self(params[k]).copy_(v)
                params[k].copy_(v)
            buffers = dict(self.model.named_buffers())
            for k, v in sd["buffers"].items():
                buffers[k].copy_(v)
            for k, st in sd["opt_state"].items():
                mine = self.optimizer._state_of(params[k])
                for kk, vv in st.items():
                    mine[kk].copy_(vv)
        self._step_count = sd.get("step", 0)
        if "scaler_state" in sd and self._scaler is not None:
            self._scaler_state = tuple(torch.as_tensor(v, device=self._device).clone()
                                       for v in sd["scaler_state"])


def train_step(model, optimizer, loss_fn=None, **kwargs):
    """Functional spelling: ``step = jit.train_step(model, opt, loss)``."""
    return TrainStep(model, optimizer, loss_fn, **kwargs)
