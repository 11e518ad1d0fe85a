"""AMP: ``auto_cast``, ``decorate`` and ``GradScaler`` (counterpart of
``paddle_tpu/amp/__init__.py``).

Paddle's op lists, not ``torch.autocast``'s (which, for one, runs
``layer_norm`` in f32): under O1 only white-list ops (linear, matmul,
einsum, attention) cast their floating inputs to the amp dtype and
black-list ops (softmax, cross_entropy, ...) cast them to f32; under O2
every op but the black list runs in the amp dtype.  The casts are read
through :func:`cast` by the port's own ops — ``Linear``, ``LayerNorm``, the
GPT embedding lookups and LM-head matmul, ``scaled_dot_product_attention``
and ``cross_entropy`` — from a thread-local state that :func:`auto_cast`
sets.  bfloat16 needs no loss scaling, so ``GradScaler`` with bf16 only
checks for inf/nan; float16 keeps full dynamic loss scaling.  The scaler's
state is exported as the reference's ``amp.loss_scale`` gauge and
``amp.found_inf`` / ``amp.scale_decr`` counters, read at ``update()``,
where the deferred inf/nan verdict resolves anyway (and by
``jit.TrainStep.sync()`` for the scale a TrainStep keeps on the device).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..profiler import metrics as _metrics

_m_loss_scale = _metrics.gauge(
    "amp.loss_scale", "current dynamic loss scale")
_m_found_inf = _metrics.counter(
    "amp.found_inf", "scaler update cycles that saw non-finite grads")
_m_scale_decr = _metrics.counter(
    "amp.scale_decr", "dynamic loss-scale decreases")

WHITE_LIST = {
    "matmul", "mm", "bmm", "addmm", "conv1d", "conv2d", "conv3d", "linear",
    "einsum", "mha", "scaled_dot_product_attention", "flash_attention",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss", "l1_loss",
    "bce_with_logits", "binary_cross_entropy", "kl_div", "sum", "mean", "norm",
    "logsumexp", "cumsum", "var", "std",
    "sigmoid_focal_loss", "softmax_with_cross_entropy",
}
# batch_norm / layer_norm / group_norm are not black-listed, as in the TPU
# package: their statistics run in f32 inside the op either way.

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_tls = threading.local()


def to_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float16"`` / ``"float32"`` or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}[str(dtype)]
    except KeyError:
        raise ValueError(f"bad amp dtype {dtype!r}") from None


class AmpState:
    __slots__ = ("level", "dtype", "white", "black", "enable")

    def __init__(self, level, dtype, white, black, enable=True):
        self.level = level
        self.dtype = to_dtype(dtype)
        self.white = white
        self.black = black
        self.enable = enable

    def target(self, op_name):
        """The dtype ``op_name``'s floating inputs are cast to, or None."""
        if not self.enable:
            return None
        if op_name in self.black:
            return torch.float32
        if op_name in self.white or self.level == "O2":
            return self.dtype
        return None


def amp_state():
    """The active :class:`AmpState` of this thread, or None."""
    return getattr(_tls, "state", None)


def cast(op_name, *tensors):
    """The floating ``tensors`` cast for ``op_name`` under the active
    :func:`auto_cast` (unchanged outside one), as a tuple; None and
    non-floating entries pass through."""
    st = amp_state()
    tgt = st.target(op_name) if st is not None else None
    if tgt is None:
        return tensors
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor) and t.dtype in _FLOATS
                 else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"bad amp level {level!r}")
    white = set(WHITE_LIST) | set(custom_white_list or ())
    black = (set(BLACK_LIST) | set(custom_black_list or ())) - set(custom_white_list or ())
    prev = amp_state()
    _tls.state = AmpState(level, dtype, white, black,
                          enable=enable and level != "O0")
    try:
        yield
    finally:
        _tls.state = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: each float32 parameter becomes an amp-dtype working
    copy with its f32 master kept as ``param._master``; the port's
    optimizers run their rule on the master and re-derive the working
    copy."""
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        tgt = to_dtype(dtype)
        with torch.no_grad():
            for m in ms:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p._master = p.detach().clone()
                        p.data = p.data.to(tgt)
    if optimizers is None:
        return models if single else ms
    return (models if single else ms), optimizers


class GradScaler:
    """Loss scaling for the eager path (``scale`` / ``step`` / ``update``);
    ``jit.TrainStep(scaler=...)`` runs the same rule on the card with no
    host sync."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # the non-finite count stays on the device until step()/update()
        # needs the verdict: one host sync per update cycle
        self._found_dev = None
        self._found_cache = False
        self._unscaled = False

    @property
    def _found_inf(self):
        if self._found_dev is not None:
            self._found_cache = bool(self._found_dev > 0)
            self._found_dev = None
        return self._found_cache

    @_found_inf.setter
    def _found_inf(self, v):
        self._found_dev = None
        self._found_cache = bool(v)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        nonfinite = None
        with torch.no_grad():
            for p in optimizer._parameter_list:
                if p.grad is not None:
                    g = p.grad.float() * inv
                    cnt = (~torch.isfinite(g)).sum()
                    nonfinite = cnt if nonfinite is None else nonfinite + cnt
                    p.grad.copy_(g)
        self._found_dev = nonfinite
        self._found_cache = False
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            _m_found_inf.inc()
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                _m_scale_decr.inc()
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        _m_loss_scale.set(self._scale)
        self._unscaled = False
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True
