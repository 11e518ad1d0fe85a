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
  ``state_dict`` / ``set_state_dict`` and :func:`train_step`;
- wrapper optimizers (``incubate.LookAhead``): the step calls the
  wrapper's ``_update`` and reads its ``_state_of`` / ``_live_state``,
  so the wrapper's own state (LookAhead's slow weights and counter) is
  checkpointed, counted in ``donated_bytes`` and restored with the rest
  on a skipped fp16 step — the reference's ``sync_functional_state``
  route for a wrapper's layout.

The loss comes back as a 0-d device tensor, with no host sync.

Programs, as the reference counts them: each input signature (the batch's
structure, shapes and dtypes, the model's training flag and the numerics
probe token) is a variant with its own roofline family
``train_step/t<n>.v<i>`` (``t<n>`` per TrainStep instance; the family
leaves the process table when the TrainStep is collected).  A variant's
first call is its "compile": ``train_step.compiles`` counts it,
``train_step.compile_seconds`` holds its wall, a ledger row lands
(``record_compile``, kind ``train_step``), ``train_step.donated_bytes``
is refreshed (the parameters, optimizer state, buffers and scaler state
the step updates in place) and a lazy cost thunk is registered (one
forward + backward of the signature's shapes, counted; the update's
elementwise passes are not).  A second input signature also counts
``train_step.retraces`` and warns, as the reference does; a probe toggle
over an existing signature stays quiet.  Every later call observes the
interval since the previous call in ``train_step.step_seconds``, records
it under the previous call's family, and, once the cost is resolved
(:meth:`TrainStep.cost_analysis`, or the perf table's resolve), sets the
``train_step.flops_per_step``, ``train_step.achieved_tflops`` and
``train_step.mfu`` gauges (against
:func:`~..observability.perf.peak_flops`).  With a tracer active each
call is a ``jit.train_step`` span (``step=``, ``new_variant=``); with a
profiler recording, a ``TrainStep`` host event.

Numerics probes (:mod:`..observability.numerics`): with the tensor
checker enabled, every ``probe_cadence()``-th step runs the probed
variant — the layer tap records one stats row per module output of the
forward (not with ``accumulate_steps > 1``, as in the reference), then a
``loss`` row and one ``grad/<name>`` row per trained parameter (sorted
by name, the gradients unscaled and not yet clipped).  The table stays on
the device: it is submitted to the numerics stream under the step's
perf tag and resolved by ``numerics.maybe_poll`` off the step.  The
``numerics.nan_inject`` fault site poisons the first probed site (or
``TensorCheckerConfig.nan_inject_site``).  With the checker off the step
is the unprobed one, unchanged.  The step itself runs eagerly: a
TrainStep CUDA graph is not ported yet (``donate`` is accepted and has no
effect: updates are in place already).
"""

from __future__ import annotations

import itertools
import threading
import warnings
import weakref
from time import perf_counter

import numpy as np
import torch

from .. import amp as _amp
from ..observability import numerics as _numerics
from ..observability import perf as _perf
from ..observability import programs as _programs
from ..observability import tracing as _tracing
from ..profiler import events as _prof_events
from ..profiler import metrics as _metrics

_PERF_INSTANCE_IDS = itertools.count()


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
        # held by a step and by the cost count: a count resolved on another
        # thread never overlaps a step (an O2 forward rebinds the model's
        # parameters for its call)
        self._lock = threading.Lock()
        # roofline attribution: one family per input signature, scoped to
        # this instance (dropped from the process table when it dies)
        self._perf_tag = f"train_step/t{next(_PERF_INSTANCE_IDS)}"
        weakref.finalize(self, _perf.table().drop_prefix, self._perf_tag)
        self._variants = {}            # signature -> perf family
        self._perf_prev_family = None  # the family the last call ran
        self._last_call_t = None
        self._retrace_count = 0
        reg = _metrics.get_registry()
        self._m_compiles = reg.counter(
            "train_step.compiles", "TrainStep XLA program compilations")
        self._m_retraces = reg.counter(
            "train_step.retraces",
            "recompilations after the first variant (input shape/dtype churn)")
        self._m_compile_s = reg.gauge(
            "train_step.compile_seconds",
            "wall time of the last trace+compile (first dispatch of a variant)")
        self._m_step_s = reg.histogram(
            "train_step.step_seconds",
            "wall time between consecutive fused-step dispatches")
        self._m_donated = reg.gauge(
            "train_step.donated_bytes",
            "HBM held by donated params + optimizer state + buffers")
        self._m_flops = reg.gauge(
            "train_step.flops_per_step", "XLA cost_analysis flops of the step")
        self._m_tflops = reg.gauge(
            "train_step.achieved_tflops", "flops_per_step / step wall time")
        self._m_mfu = reg.gauge(
            "train_step.mfu", "achieved FLOP/s over device peak "
            "(PADDLE_PEAK_FLOPS or the chip's bf16 datasheet number)")
        self._m_donated.set(self._donated_bytes())

    # ------------------------------------------------------------------ call
    def __call__(self, *batch):
        batch = _tree_map(self._to_device, batch)
        # the probe token enters the variant key: 0 with the checker off
        # (the unprobed step), else every cadence-th step is the probed one
        ptok = _numerics.probe_token()
        probed = bool(ptok) and \
            self._step_count % _numerics.probe_cadence() == 0
        sig = (_signature(batch), bool(self.model.training),
               ptok if probed else 0)
        family = self._variants.get(sig)
        new_variant = family is None
        if new_variant and self._variants \
                and not any(v[:2] == sig[:2] for v in self._variants):
            # a second input signature: loud, as in the reference (a probe
            # toggle over an existing signature stays quiet)
            self._retrace_count += 1
            self._m_retraces.inc()
            warnings.warn(
                f"TrainStep retrace #{self._retrace_count}: input signature "
                f"changed (training={sig[1]}); {len(self._variants)} "
                "variant(s) already exist.  Each distinct batch shape/dtype "
                "is a new program — pad or bucket batches to avoid it.",
                stacklevel=2)
        t_call = perf_counter()
        if new_variant:
            family = self._variants[sig] = \
                f"{self._perf_tag}.v{len(self._variants)}"
        elif self._last_call_t is not None:
            # the interval since the last call, under the family that RAN
            # in it (alternating variants must not swap their seconds)
            dt = t_call - self._last_call_t
            self._m_step_s.observe(dt)
            _perf.record(self._perf_prev_family, dt)
            flops = _perf.table().flops_per_call(self._perf_prev_family)
            if flops:
                self._m_flops.set(flops)
                self._m_tflops.set(flops / max(dt, 1e-12) / 1e12)
                peak = _perf.peak_flops()
                if peak:
                    self._m_mfu.set(flops / max(dt, 1e-12) / peak)
        self._last_call_t = t_call
        self._perf_prev_family = family
        inject = _numerics.consume_nan_inject() if probed else None
        cm = _tracing.span("jit.train_step", step=self._step_count,
                           new_variant=new_variant) \
            if _tracing._ACTIVE else _tracing.NOOP
        with cm, self._lock:
            if _prof_events._ACTIVE:
                with _prof_events.record("TrainStep"):
                    out, stats = self._step(batch, probed, inject)
            else:
                out, stats = self._step(batch, probed, inject)
        if new_variant:
            # a variant's first call is its mint: a ledger row with the
            # call's wall, and a lazy cost for the roofline table
            compile_s = perf_counter() - t_call
            self._m_compiles.inc()
            self._m_compile_s.set(compile_s)
            self._m_donated.set(self._donated_bytes())
            _programs.ledger().record_compile(
                family, compile_s, family=family,
                kind="train_step", replica="-",
                trace_id=_tracing.current_trace_id())
            if _perf.needs_cost(family):
                _perf.register_cost_thunk(family,
                                          self._cost_thunk(batch))
            # the next interval would include this first call
            self._last_call_t = None
        if stats is not None:
            # the device table, parked for resolution off the step
            _numerics.submit(self._perf_tag, stats[0], stats[1],
                             step=self._step_count)
            _numerics.maybe_poll()
        return out

    def _donated_bytes(self):
        """Bytes the step updates in place: the trained parameters (their
        f32 masters where kept), the optimizer state, the buffers and the
        scaler state — the reference's donated carry."""
        seen, total = set(), 0

        def add(t):
            nonlocal total
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()

        for p in self._params:
            add(_master_or_self(p))
            for t in self.optimizer._live_state(p).values():
                add(t)
        for b in self.model.buffers():
            add(b)
        for t in self._scaler_state or ():
            add(t)
        return total

    def cost_analysis(self):
        """``{"flops", "bytes_accessed"}`` of the last variant's step (its
        lazy cost, resolved now if it was not), also setting
        ``train_step.flops_per_step``; None before the first step."""
        family = self._perf_prev_family
        if family is None:
            return None
        _perf.resolve_costs()
        tab = _perf.table()
        flops = tab.flops_per_call(family)
        if not flops:
            return None
        self._m_flops.set(flops)
        row = next((r for r in tab.snapshot() if r["program"] == family),
                   {})
        return {"flops": float(flops),
                "bytes_accessed": float(row.get("bytes_per_call") or 0.0)}

    def _cost_thunk(self, batch):
        """Lazy ``(flops, bytes)`` of one forward + backward at ``batch``'s
        shapes (zeros), holding only the shapes and a weakref.  The count
        changes nothing the training sees: it holds the step's lock, the
        gradients are put back as they were (``None`` between steps), the
        parameters
        and buffers are read and never written (a quantizer's scale keeps
        its value), and no random number is drawn
        (:func:`~..observability.perf.count_cost`)."""
        shapes = _tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
            if isinstance(x, torch.Tensor) else x, batch)
        ref = weakref.ref(self)

        def thunk():
            ts = ref()
            if ts is None:
                raise RuntimeError("TrainStep was garbage-collected before "
                                   "its cost resolved")
            fake = _tree_map(
                lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                      device=ts._device)
                if isinstance(x, torch.Tensor) else x, shapes)

            def run():
                loss, _ = ts._forward(fake)
                loss.backward()

            state = [*ts.model.parameters(), *ts.model.buffers()]
            state += [p._master for p in state
                      if getattr(p, "_master", None) is not None]
            with ts._lock:
                grads = [p.grad for p in ts._params]
                try:
                    return _perf.count_cost(run, inference=False,
                                            protect=state)
                finally:
                    for p, g in zip(ts._params, grads):
                        p.grad = g

        return thunk

    def _step(self, batch, probed=False, inject=None):
        """One step; returns ``(out, stats)``, ``stats`` the probed
        variant's ``(sites, [n, 6] device table)`` or None."""
        acc = self.accumulate_steps
        scale = self._scaler_state[0] if self._scaler is not None else None
        for p in self._params:
            p.grad = None
        act = None
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
        elif probed:
            # per-layer stats (and the nan_inject poison point) recorded
            # while the forward runs
            cfg = _numerics.config()
            with _numerics.capture(
                    stream=self._perf_tag,
                    names=_numerics.layer_names(self.model), inject=inject,
                    inject_site=getattr(cfg, "nan_inject_site", None)) as act:
                loss, outs = self._forward(batch)
            (loss * scale if scale is not None else loss).backward()
            loss = loss.detach()
        else:
            loss, outs = self._forward(batch)
            (loss * scale if scale is not None else loss).backward()
            loss = loss.detach()
        rows = self._update(probe=probed)
        stats = None
        if probed:
            stats = self._probe_table(act, loss, rows)
        self._step_count += 1
        if self.return_outputs:
            return (loss, _tree_map(
                lambda o: o.detach() if isinstance(o, torch.Tensor) else o,
                outs)), stats
        return loss, stats

    def _probe_table(self, act, loss, grad_rows):
        """The probed variant's stats table: activation rows (capture
        order), the loss, then one row per gradient — "first offending
        layer" falls out of this order."""
        sites, rows = [], []
        if act is not None:
            a_sites, a_stats = act.stack()
            if a_sites:
                sites += a_sites
                rows.append(a_stats)
        if _numerics._match("loss"):
            sites.append("loss")
            rows.append(_numerics.stats_row(loss)[None])
        if grad_rows:
            sites += [k for k, _ in grad_rows]
            rows.append(torch.stack([r for _, r in grad_rows]))
        table = torch.cat(rows) if rows else \
            torch.zeros((0, _numerics.NSTATS), dtype=torch.float32)
        return tuple(sites), table

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

    def _update(self, probe=False):
        """Unscale / check (scaler), clip over every gradient, apply the
        rule, then drop the gradients.  With ``probe``, returns the
        ``("grad/<name>", stats row)`` pairs of the unscaled, unclipped
        gradients, sorted by name (the reference's gradient dict order)."""
        opt = self.optimizer
        pg = [(p, p.grad) for p in self._params if p.grad is not None]
        rows = []
        with torch.no_grad():
            if self._scaler is not None:
                scale, good, bad, _ = self._scaler_state
                inv = 1.0 / scale
                for _, g in pg:
                    g.mul_(inv)
            if probe:
                for k, p in sorted(zip(self._names, self._params),
                                   key=lambda kp: kp[0]):
                    nm = "grad/" + k
                    if p.grad is not None and _numerics._match(nm):
                        rows.append((nm, _numerics.stats_row(p.grad)))
            if self._scaler is not None:
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
        return rows

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
            _amp._m_loss_scale.set(float(s))
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


def _signature(batch):
    """The structure, shapes and dtypes of a batch (a variant's key)."""
    if isinstance(batch, dict):
        return tuple((k, _signature(v)) for k, v in sorted(batch.items()))
    if isinstance(batch, (list, tuple)):
        return (type(batch).__name__, tuple(_signature(v) for v in batch))
    if isinstance(batch, torch.Tensor):
        return (tuple(batch.shape), str(batch.dtype))
    return repr(batch)


def train_step(model, optimizer, loss_fn=None, **kwargs):
    """Functional spelling: ``step = jit.train_step(model, opt, loss)``."""
    return TrainStep(model, optimizer, loss_fn, **kwargs)
