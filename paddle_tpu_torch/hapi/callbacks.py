"""``hapi`` callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``,
copied: pure Python over the port's optimizer, metrics registry and
summary writer).

ProgBarLogger / ModelCheckpoint / EarlyStopping / LRScheduler / VisualDL /
ReduceLROnPlateau / MetricsLoggerCallback / WandbCallback, the
training-loop observer API of ``hapi.Model``.  ``VisualDL`` writes through
``utils.summary_writer`` (``scalars.jsonl`` and TensorBoard event files).
"""

from __future__ import annotations

import numbers
import os
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Prints per-epoch progress with smoothed metrics."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        out = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                out.append(f"{k}: {v:.4f}")
            elif hasattr(v, "__len__") and len(v) and isinstance(v[0], numbers.Number):
                out.append(f"{k}: " + "/".join(f"{x:.4f}" for x in v))
        return " - ".join(out)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step}{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if hasattr(cur, "__len__"):
            cur = cur[0]
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} plateaued at {self.best}")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference default: by epoch)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch and not by_step

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class VisualDL(Callback):
    """Scalar logging (VisualDL analog backed by utils.summary)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None

    def _get_writer(self):
        if self._writer is None:
            from ..utils.summary_writer import SummaryWriter

            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def on_train_batch_end(self, step, logs=None):
        w = self._get_writer()
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                w.add_scalar(f"train/{k}", v, step)

    def on_eval_end(self, logs=None):
        w = self._get_writer()
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                w.add_scalar(f"eval/{k}", v, 0)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose=2, save_freq=1, save_dir=None, metrics=None,
                     mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst


class ReduceLROnPlateau(Callback):
    """Callback spelling of the plateau schedule (reference:
    paddle.callbacks.ReduceLROnPlateau): scales the optimizer LR when the
    monitored metric stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self._best = None
        self._wait = 0
        self._cooling = 0
        self._use_eval = False

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    def on_eval_end(self, logs=None):
        # once an eval stream exists it owns the monitor: train-epoch logs
        # would otherwise double-count patience with mixed train/eval values
        if not self._use_eval:
            self._use_eval = True
            self._best, self._wait, self._cooling = None, 0, 0
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        if not self._use_eval:
            self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooling > 0:
            self._cooling -= 1
            if self._better(cur):
                self._best = cur
                self._wait = 0
            return
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                new_lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
            self._wait = 0
            self._cooling = self.cooldown


class MetricsLoggerCallback(Callback):
    """Observability surface for ``Model.fit``: per-epoch summary table of
    throughput + the port's process-wide metrics registry (TrainStep
    variants / retraces / MFU, dataloader stall split, collective bytes),
    plus a JSONL record per epoch.

    Counters are reported as per-epoch DELTAS (the registry is process-
    wide and monotonic); gauges as their current value.  Files written
    under ``log_dir`` (default: PADDLE_METRICS_DIR or ./log):

    - ``train_metrics.jsonl``: one line per epoch (this callback's rows)
    - ``metrics.prom``: latest full registry snapshot, Prometheus text

    Usage::

        model.fit(data, callbacks=[paddle.callbacks.MetricsLoggerCallback()])
    """

    # counters whose per-epoch delta is worth a table row
    _COUNTERS = ("train_step.compiles", "train_step.retraces",
                 "dataloader.host_wait_seconds", "dataloader.consumer_seconds",
                 "dataloader.batches", "collective.bytes", "collective.calls")
    _GAUGES = ("train_step.compile_seconds", "train_step.donated_bytes",
               "train_step.flops_per_step", "train_step.achieved_tflops",
               "train_step.mfu")

    def __init__(self, log_dir=None, registry=None, verbose=1):
        super().__init__()
        self.log_dir = log_dir or os.environ.get("PADDLE_METRICS_DIR", "./log")
        self._registry_override = registry
        self.verbose = verbose
        self._baseline = {}
        self._epoch_steps = 0
        self._t0 = None

    def _registry(self):
        if self._registry_override is not None:
            return self._registry_override
        from ..profiler import metrics as _metrics

        return _metrics.get_registry()

    def _counter_total(self, name):
        m = self._registry().get(name)
        return m.total() if m is not None else 0.0

    def _gauge_value(self, name):
        m = self._registry().get(name)
        return m.get() if m is not None else None

    # ------------------------------------------------------------ lifecycle
    def on_epoch_begin(self, epoch, logs=None):
        self._t0 = time.time()
        self._epoch_steps = 0
        self._baseline = {n: self._counter_total(n) for n in self._COUNTERS}

    def on_train_batch_end(self, step, logs=None):
        self._epoch_steps += 1

    def on_epoch_end(self, epoch, logs=None):
        dt = time.time() - (self._t0 or time.time())
        row = {"epoch": epoch, "steps": self._epoch_steps,
               "epoch_time_s": round(dt, 4)}
        if self._epoch_steps:
            row["avg_step_ms"] = round(1e3 * dt / self._epoch_steps, 3)
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                row[k] = float(v)
        for n in self._COUNTERS:
            row[n] = self._counter_total(n) - self._baseline.get(n, 0.0)
        for n in self._GAUGES:
            v = self._gauge_value(n)
            if v is not None:
                row[n] = v
        self._write(row)
        if self.verbose:
            self._print_table(row)

    def on_train_end(self, logs=None):
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            self._registry().export_prometheus(
                os.path.join(self.log_dir, "metrics.prom"))
        except OSError:
            pass

    # -------------------------------------------------------------- output
    def _write(self, row):
        import json

        try:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "train_metrics.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            pass

    def _print_table(self, row):
        w = max(len(k) for k in row) + 2
        sep = "-" * (w + 14)
        lines = [sep, f"observability | epoch {row['epoch']}", sep]
        for k, v in row.items():
            if k == "epoch":
                continue
            if isinstance(v, float):
                v = f"{v:.6g}"
            lines.append(f"{k.ljust(w)}{v}")
        lines.append(sep)
        print("\n".join(lines))


class WandbCallback(Callback):
    """Weights & Biases logging (``paddle.callbacks.WandbCallback``).
    Requires the wandb package, which the port does not bundle;
    constructing it without the package raises ImportError."""

    def __init__(self, project=None, name=None, **kwargs):
        super().__init__()
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbCallback needs the wandb package, which is not "
                "installed") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, **kwargs)

    def on_train_batch_end(self, step, logs=None):
        self._wandb.log(dict(logs or {}))

    def on_epoch_end(self, epoch, logs=None):
        self._wandb.log({"epoch": epoch, **(logs or {})})

    def on_train_end(self, logs=None):
        self._run.finish()
