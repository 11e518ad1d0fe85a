"""``paddle.Model``, the high-level train / eval / predict engine
(counterpart of ``paddle_tpu/hapi/model.py``).

``fit`` drives :class:`..jit.TrainStep` (forward, backward, clip and the
optimizer's update per batch, under AMP and with gradient accumulation
when asked); metrics update from the step's outputs.  ``evaluate`` and
``predict`` run an eager ``no_grad`` forward in eval mode (the reference
jits it; here there is nothing to compile).  Each batch goes to the
network's device once: the card unless ``Model(..., device="cpu")``
asks for the CPU.  ``save`` writes ``.pdparams`` in the reference's
pickle schema and layout (``framework.io``; ``[in, out]`` Linear weights),
so either package loads the other's, and ``.pdopt`` in the port's own
optimizer format.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..framework import io as _fio
from ..metric import Metric
from .callbacks import config_callbacks


def _host(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        """``device``: where the network runs, which it is moved to; the
        card unless ``"cpu"`` is asked for (no card then raises).  With
        ``device=None`` a network already on a card stays on its card."""
        p = next(network.parameters(), None)
        if device is None and p is not None and p.device.type == "cuda":
            device = p.device
        self._placed = resolve_device(device)
        self.network = network.to(self._placed)
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._amp_level = None
        self._amp_dtype = "bfloat16"
        self._scaler = None
        self.stop_training = False

    @property
    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else self._placed

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """``amp_configs``: ``"O1"`` / ``"O2"``, or a dict with ``level``,
        ``dtype`` and, for float16 (or when any is given), the loss
        scaler's ``init_loss_scaling``, ``incr_every_n_steps``,
        ``incr_ratio``, ``decr_ratio``, ``decr_every_n_nan_or_inf`` and
        ``use_dynamic_loss_scaling``."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
            for m in metrics:
                if not isinstance(m, Metric):
                    raise TypeError(f"metric {m!r} is not a "
                                    "paddle_tpu_torch.metric.Metric")
            self._metrics = list(metrics)
        # fresh AMP state each prepare(): re-preparing replaces any earlier
        # fp16 / scaler configuration
        self._amp_level = None
        self._amp_dtype = "bfloat16"
        self._scaler = None
        if amp_configs:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
                self._amp_dtype = amp_configs.get("dtype", "bfloat16")
                scaler_keys = ("init_loss_scaling", "incr_every_n_steps",
                               "incr_ratio", "decr_ratio",
                               "decr_every_n_nan_or_inf",
                               "use_dynamic_loss_scaling")
                if self._amp_dtype == "float16" or any(
                        k in amp_configs for k in scaler_keys):
                    from ..amp import GradScaler

                    self._scaler = GradScaler(
                        init_loss_scaling=amp_configs.get(
                            "init_loss_scaling", 2.0 ** 15),
                        incr_ratio=amp_configs.get("incr_ratio", 2.0),
                        decr_ratio=amp_configs.get("decr_ratio", 0.5),
                        incr_every_n_steps=amp_configs.get(
                            "incr_every_n_steps", 1000),
                        decr_every_n_nan_or_inf=amp_configs.get(
                            "decr_every_n_nan_or_inf", 1),
                        use_dynamic_loss_scaling=amp_configs.get(
                            "use_dynamic_loss_scaling", True))
        self._train_step = None
        return self

    def _ensure_train_step(self, accumulate=None):
        """The step, built lazily; ``accumulate=None`` keeps the one that
        exists (``train_batch`` must not undo ``fit``'s accumulation)."""
        from ..jit.train_step import TrainStep

        rebuild = (self._train_step is None
                   or (accumulate is not None
                       and self._train_step.accumulate_steps != accumulate))
        if rebuild:
            if self._optimizer is None or self._loss is None:
                raise RuntimeError(
                    "call prepare(optimizer=..., loss=...) before fit()")
            self._train_step = TrainStep(
                self.network, self._optimizer, loss_fn=self._loss,
                amp_level=self._amp_level, amp_dtype=self._amp_dtype,
                scaler=self._scaler, return_outputs=bool(self._metrics),
                accumulate_steps=accumulate or 1)
        return self._train_step

    # ------------------------------------------------------------- batches
    def train_batch(self, inputs, labels=None, update=True):
        step = self._ensure_train_step()
        inputs = self._to_tensors(inputs)
        labels = self._to_tensors(labels) if labels is not None else ()
        args = (inputs if len(inputs) > 1 else inputs[0],) + tuple(labels)
        out = step(*args)
        if step.return_outputs:
            loss, outs = out
            self._update_metrics(outs, labels)
        else:
            loss = out
        return [float(loss)]

    def _forward_eval(self, inputs):
        """The network's eval-mode forward under ``no_grad`` (its training
        flag put back after)."""
        net = self.network
        was = net.training
        net.eval()
        try:
            with torch.no_grad():
                return net(*inputs)
        finally:
            net.train(was)

    def eval_batch(self, inputs, labels=None):
        inputs = self._to_tensors(inputs)
        labels = self._to_tensors(labels) if labels is not None else ()
        outs = self._forward_eval(inputs)
        losses = []
        if self._loss is not None and labels:
            with torch.no_grad():
                loss = self._loss(outs[0] if isinstance(outs, (tuple, list))
                                  else outs, *labels)
            losses = [float(loss)]
        self._update_metrics(outs, labels)
        return losses

    def predict_batch(self, inputs):
        outs = self._forward_eval(self._to_tensors(inputs))
        if isinstance(outs, (tuple, list)):
            return [_host(o) for o in outs]
        return [_host(outs)]

    def _update_metrics(self, outs, labels):
        outs_t = outs if isinstance(outs, (tuple, list)) else (outs,)
        for m in self._metrics:
            res = m.compute(*outs_t, *labels)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            m.update(*res)

    def _to_tensors(self, data):
        """``data`` (a tensor, an array, or a list / tuple of them) as a
        tuple of tensors on the network's device: one copy per batch."""
        if data is None:
            return ()
        items = data if isinstance(data, (list, tuple)) else (data,)
        dev = self._device
        return tuple((d if isinstance(d, torch.Tensor)
                      else torch.as_tensor(np.asarray(d))).to(dev)
                     for d in items)

    # ----------------------------------------------------------------- fit
    def _to_loader(self, data, batch_size, shuffle, num_workers,
                   drop_last=False):
        from ..io import DataLoader, Dataset

        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._to_loader(train_data, batch_size, shuffle, num_workers,
                                 drop_last)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                save_freq=save_freq, save_dir=save_dir,
                                metrics=self._metric_names())
        self._ensure_train_step(accumulate_grad_batches)
        self.stop_training = False
        cbks.on_train_begin()
        it_count = 0
        logs = {}
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            self.network.train()
            for m in self._metrics:
                m.reset()
            logs = {}
            for step_i, batch in enumerate(loader):
                cbks.on_train_batch_begin(step_i)
                inputs, labels = self._split_batch(batch)
                losses = self.train_batch(inputs, labels)
                logs = {"loss": losses[0]}
                for m in self._metrics:
                    logs[_first_name(m)] = m.accumulate()
                cbks.on_train_batch_end(step_i, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=verbose,
                              callbacks=cbks.callbacks)
        cbks.on_train_end(logs)
        return self

    def _metric_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1]
        if isinstance(batch, (list, tuple)):
            return batch[0], None
        return batch, None

    # ------------------------------------------------------ evaluate/predict
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._to_loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=0,
                                metrics=self._metric_names())
        for m in self._metrics:
            m.reset()
        self.network.eval()
        cbks.on_eval_begin()
        logs = {}
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            loss = self.eval_batch(inputs, labels)
            if loss:
                losses.append(loss[0])
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[_first_name(m)] = m.accumulate()
        cbks.on_eval_end(logs)
        self.network.train()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, num_workers)
        self.network.eval()
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        self.network.train()
        if not outputs:
            return []
        grouped = [[b[i] for b in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # ------------------------------------------------------------ save/load
    def save(self, path, training=True):
        """``path + ".pdparams"`` (the network's state in the reference's
        schema and layout) and, with an optimizer, ``path + ".pdopt"``.
        ``training=False`` is the reference's inference export
        (``jit.save``), which the port does not have yet: it raises."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False) is the inference export "
                "(jit.save / paddle.inference), which is not ported yet "
                "(ROADMAP Queue 1 item 8); save(path) writes the training "
                "checkpoint")
        from ..text.models.convert import export_paddle_tpu_tensors

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _fio.save(export_paddle_tpu_tensors(self.network), path + ".pdparams")
        if self._optimizer is not None:
            if self._train_step is not None:
                self._train_step.sync()
            _fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load ``path + ".pdparams"`` (written by either package) into the
        network, and ``.pdopt`` into the optimizer unless
        ``reset_optimizer``; the optimizer's tensors land on their
        parameters' devices."""
        from ..text.models.convert import load_paddle_tpu_state_dict

        load_paddle_tpu_state_dict(self.network,
                                   _fio.load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if self._optimizer is not None and not reset_optimizer \
                and os.path.exists(opt_path):
            sd = _fio.load(opt_path)
            params = self._optimizer._parameter_list
            for k, st in sd.get("states", {}).items():
                dev = params[int(k)].device
                sd["states"][k] = {
                    kk: (vv.detach().to(dev) if isinstance(vv, torch.Tensor)
                         else vv) for kk, vv in st.items()}
            self._optimizer.set_state_dict(sd)
        self._train_step = None
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary

        if input_size is None and self._inputs:
            input_size = [tuple(s.shape) for s in self._inputs]
        return summary(self.network, input_size, dtypes=dtype)


def _first_name(m):
    n = m.name()
    return n if not isinstance(n, (list, tuple)) else n[0]
