"""PyTorch port, the breadth of training: paddle_tpu_torch's eleven
remaining optimizers (Adamax ... LBFGS), incubate's LookAhead /
ExponentialMovingAverage / ModelAverage, nn.utils, distributed.fleet
.recompute and the Llama fine-tune recipe, on the CPU against the JAX
package, with weights carried across by ``load_paddle_tpu_state_dict``.

- Each optimizer on the toy of tests/test_optim_r4.py (Linear(8, 16),
  Tanh, Linear(16, 3), cross entropy; 15 steps): per-step losses and
  final weights within 1e-5 of JAX's, LBFGS through its closure; Lamb and
  RAdam at O2 on GPT-tiny ``TrainStep`` (the O2 tolerances of
  test_torch_port_train.py).
- LookAhead eagerly and under ``TrainStep`` (its slow weights through the
  step's ``_state_of``), checkpointed; EMA and ModelAverage (apply,
  restore, debias, the exact mean) as tests/test_amp_scaler.py, and equal
  to JAX's averaged weights.
- Every ``nn.utils`` function against JAX's on a Linear: the paddle
  layout of ``parameters_to_vector``, ``weight_norm`` / ``spectral_norm``
  with their state carried across in both directions.
- ``recompute`` against the plain call (values, gradients), JAX's, and an
  explicit generator's dropout mask replayed in the backward.
- The fine-tune recipe against the JAX example: f32 (AMP off) losses, EMA
  weights and greedy ids at rtol 1e-4; the reference's bf16 default's
  first losses."""

import contextlib
import io
import runpy
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.incubate.optimizer import (ExponentialMovingAverage as JEMA,
                                           LookAhead as JLookAhead,
                                           ModelAverage as JModelAverage)
from paddle_tpu.nn import utils as jutils
from paddle_tpu.text.models import LlamaConfig as JLlamaConfig
from paddle_tpu.text.models import LlamaForCausalLM as JLlama
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.examples import finetune_llama
from paddle_tpu_torch.incubate.optimizer import (ExponentialMovingAverage,
                                                 LookAhead, ModelAverage)
from paddle_tpu_torch.nn import utils as tutils
from paddle_tpu_torch.text.models import (GPTForCausalLM, LlamaForCausalLM,
                                          export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


# =================================================================== toy
def _toy_pair():
    """tests/test_optim_r4.py's net in both packages, one init."""
    paddle.seed(0)
    j = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 3))
    t = torch.nn.Sequential(tnn.Linear(8, 16), torch.nn.Tanh(),
                            tnn.Linear(16, 3))
    load_paddle_tpu_state_dict(t, _state(j))
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype("float32")
    y = rs.randint(0, 3, (32,)).astype("int64")
    return j, t, x, y


def _train_toy(side, make, steps, m, x, y, wrap=None):
    lossf = jnn.CrossEntropyLoss() if side == "jax" else tnn.CrossEntropyLoss()
    o = make(m.parameters())
    if wrap is not None:
        o = wrap(o)
    if side == "jax":
        x, y = paddle.to_tensor(x), paddle.to_tensor(y)
    else:
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(steps):
        loss = lossf(m(x), y)
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.detach() if side == "torch" else loss))
    return losses, o


OPTIMIZERS = {
    "adamax": lambda M, ps: M.Adamax(learning_rate=0.02, parameters=ps),
    "adamax_wd": lambda M, ps: M.Adamax(learning_rate=0.02, parameters=ps,
                                        weight_decay=0.01),
    "adagrad": lambda M, ps: M.Adagrad(learning_rate=0.05, parameters=ps,
                                       initial_accumulator_value=0.1),
    "rmsprop": lambda M, ps: M.RMSProp(learning_rate=0.01, parameters=ps),
    "rmsprop_centered": lambda M, ps: M.RMSProp(
        learning_rate=0.01, momentum=0.5, centered=True, parameters=ps),
    "adadelta": lambda M, ps: M.Adadelta(learning_rate=1.0, parameters=ps),
    "lamb": lambda M, ps: M.Lamb(learning_rate=0.02, parameters=ps),
    "rprop": lambda M, ps: M.Rprop(learning_rate=0.01, parameters=ps),
    "nadam": lambda M, ps: M.NAdam(learning_rate=0.02, parameters=ps),
    "radam": lambda M, ps: M.RAdam(learning_rate=0.02, parameters=ps,
                                   weight_decay=0.01),
    "asgd": lambda M, ps: M.ASGD(learning_rate=0.05, parameters=ps),
    "asgd_ring": lambda M, ps: M.ASGD(learning_rate=0.05, batch_num=3,
                                      parameters=ps),
    "lars": lambda M, ps: M.Lars(learning_rate=0.5, parameters=ps),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    """15 steps from one init: losses and final weights within 1e-5 of
    JAX's, the loss falling."""
    make = OPTIMIZERS[name]
    j, t, x, y = _toy_pair()
    jl, jo = _train_toy("jax", lambda ps: make(jopt, ps), 15, j, x, y)
    tl, to = _train_toy("torch", lambda ps: make(topt, ps), 15, t, x, y)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    want = _state(j)
    got = export_paddle_tpu_state_dict(t, want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    if name.startswith("asgd"):       # the running average of the iterates
        for p, jp in zip(t.parameters(), j.parameters()):
            a = to._states[id(p)]["avg"].numpy()
            b = np.asarray(jo._states[id(jp)]["avg"])
            np.testing.assert_allclose(a.T if a.ndim == 2 else a, b, **TOL)


def test_lbfgs_matches_jax():
    """LBFGS through its closure on least squares: each outer step's loss
    and the final weights equal JAX's; the reference's ValueErrors."""
    paddle.seed(0)
    j = jnn.Linear(6, 1)
    t = tnn.Linear(6, 1)
    load_paddle_tpu_state_dict(t, _state(j))
    rs = np.random.RandomState(0)
    xv, yv = rs.randn(64, 6).astype("float32"), rs.randn(64, 1).astype("float32")
    jo = jopt.LBFGS(parameters=j.parameters(), max_iter=25, learning_rate=1.0)
    to = topt.LBFGS(parameters=t.parameters(), max_iter=25, learning_rate=1.0)
    jx, jy = paddle.to_tensor(xv), paddle.to_tensor(yv)
    tx, ty = torch.from_numpy(xv), torch.from_numpy(yv)

    def jclosure():
        jo.clear_grad()
        loss = ((j(jx) - jy) ** 2).mean()
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = ((t(tx) - ty) ** 2).mean()
        loss.backward()
        return loss

    with pytest.raises(ValueError):
        to.step()
    l0 = float(tclosure())
    jl = [float(jo.step(jclosure)) for _ in range(3)]
    tl = [float(to.step(tclosure)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[0] < l0 * 0.5
    got = export_paddle_tpu_state_dict(t, _state(j))
    for k, v in _state(j).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    for kw in ({"weight_decay": 0.1}, {"grad_clip": topt.ClipGradByNorm(1.0)},
               {"line_search_fn": "strong_wolfe"}):
        with pytest.raises(ValueError):
            topt.LBFGS(parameters=t.parameters(), **kw)


def test_optimizer_state_stays_on_device_tensors():
    """Scalar state is a 0-d tensor (no host value to sync); Rprop's step
    sizes start at the learning rate; the state round-trips."""
    _, t, x, y = _toy_pair()
    o = topt.NAdam(learning_rate=0.01, parameters=t.parameters())
    tnn.CrossEntropyLoss()(t(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    o.step()
    st = o._states[id(next(t.parameters()))]
    assert st["t"].ndim == 0 and st["mu_prod"].ndim == 0
    o2 = topt.NAdam(learning_rate=0.01, parameters=t.parameters())
    o2.set_state_dict(o.state_dict())
    assert float(o2._states[id(next(t.parameters()))]["t"]) == 1.0
    r = topt.Rprop(learning_rate=0.03, parameters=t.parameters())
    assert float(r._state_of(next(t.parameters()))["step_size"][0, 0]) \
        == pytest.approx(0.03)


# ============================================================== GPT O2
GCFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64)


def _gpt_pair():
    paddle.seed(0)
    j = JGPT(**GCFG)
    t = GPTForCausalLM(device="cpu", **GCFG)
    init = _state(j)
    load_paddle_tpu_state_dict(t, init)
    return j, t, init


def _update_diff(jw, tw, init):
    num = np.sqrt(sum(np.sum((tw[k] - jw[k]) ** 2) for k in jw))
    den = np.sqrt(sum(np.sum((jw[k] - init[k]) ** 2) for k in jw))
    return num / den


def _gpt_trainstep(make, amp_level, wrap=None, steps=5):
    j, t, init = _gpt_pair()
    jo, to = make(jopt, j.parameters()), make(topt, t.parameters())
    if wrap is not None:
        jo, to = wrap("jax", jo), wrap("torch", to)
    js = paddle.jit.TrainStep(j, jo, loss_fn=None, amp_level=amp_level)
    ts = tjit.TrainStep(t, to, loss_fn=None, amp_level=amp_level)
    ids = np.random.RandomState(0).randint(0, 128, (2, 32)).astype("int64")
    jl = [float(js({"input_ids": paddle.to_tensor(ids),
                    "labels": paddle.to_tensor(ids)})) for _ in range(steps)]
    tl = [float(ts({"input_ids": torch.from_numpy(ids),
                    "labels": torch.from_numpy(ids)})) for _ in range(steps)]
    js.sync()
    jw = {k: np.asarray(v, np.float32) for k, v in _state(j).items()}
    return np.asarray(jl), np.asarray(tl), jw, \
        export_paddle_tpu_state_dict(t, jw), init, ts, to


@pytest.mark.parametrize("name", ["lamb", "radam"])
def test_optimizer_o2_trainstep_matches_jax(name):
    """Lamb's trust ratio and RAdam's rectification on the f32 masters at
    O2 (bf16): losses rtol 5e-3, the weights' update within 10% of its
    norm, as test_torch_port_train.py's O2 AdamW."""
    make = {"lamb": lambda M, ps: M.Lamb(learning_rate=1e-3, parameters=ps),
            "radam": lambda M, ps: M.RAdam(learning_rate=1e-3,
                                           parameters=ps)}[name]
    jl, tl, jw, tw, init, _, _ = _gpt_trainstep(make, "O2")
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0]
    assert _update_diff(jw, tw, init) < 0.1


# ============================================================= LookAhead
def test_lookahead_eager_matches_jax():
    """Eager LookAhead(SGD) every k=2 steps, JAX's losses and weights."""
    make = lambda M: (lambda ps: M.Momentum(learning_rate=0.1, parameters=ps))
    j, t, x, y = _toy_pair()
    jl, _ = _train_toy("jax", make(jopt), 7, j, x, y,
                       wrap=lambda o: JLookAhead(o, alpha=0.5, k=2))
    tl, la = _train_toy("torch", make(topt), 7, t, x, y,
                        wrap=lambda o: LookAhead(o, alpha=0.5, k=2))
    np.testing.assert_allclose(tl, jl, **TOL)
    got = export_paddle_tpu_state_dict(t, _state(j))
    for k, v in _state(j).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
    assert int(la._count) == 7


def test_lookahead_trainstep_matches_jax_and_eager():
    """Under TrainStep (f32): the losses and weights of JAX's TrainStep and
    of the port's eager wrapper; the slow weights ride the step's
    checkpoint and resume in lockstep."""
    make = lambda M, ps: M.AdamW(learning_rate=1e-3, parameters=ps)
    wrap = lambda side, o: (JLookAhead if side == "jax" else LookAhead)(
        o, alpha=0.5, k=2)
    jl, tl, jw, tw, init, ts, la = _gpt_trainstep(make, None, wrap=wrap)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for k in jw:
        if not k.endswith("qkv.bias"):   # see test_torch_port_train.py
            np.testing.assert_allclose(tw[k], jw[k], atol=1e-4, err_msg=k)
    sd = ts.state_dict()
    some = next(iter(sd["opt_state"].values()))
    assert {"m", "v", "t", "slow", "count"} <= set(some)
    assert int(some["count"]) == 5
    # resume a copy from the checkpoint: the next (k-sync) step agrees
    _, t2, _ = _gpt_pair()
    la2 = LookAhead(topt.AdamW(learning_rate=1e-3,
                               parameters=t2.parameters()), alpha=0.5, k=2)
    ts2 = tjit.TrainStep(t2, la2, loss_fn=None)
    ts2.set_state_dict(sd)
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, 128, (2, 32)).astype("int64"))
    a = ts({"input_ids": ids, "labels": ids})
    b = ts2({"input_ids": ids, "labels": ids})
    assert float(a) == float(b)
    for (k, p), p2 in zip(ts.model.named_parameters(), t2.parameters()):
        torch.testing.assert_close(p, p2, rtol=0, atol=0, msg=k)


def test_lookahead_validation_and_checkpoint():
    for kw in ({"alpha": 1.5}, {"k": 0}):
        with pytest.raises(ValueError):
            LookAhead(topt.SGD(parameters=[]), **kw)
    _, t, x, y = _toy_pair()
    _, t2, _, _ = _toy_pair()
    make = lambda ps: topt.SGD(learning_rate=0.1, parameters=ps)
    _train_toy("torch", make, 3, t, x, y,
               wrap=lambda o: LookAhead(o, alpha=0.5, k=2))
    la1 = LookAhead(make(t.parameters()), alpha=0.5, k=2)
    _train_toy("torch", lambda ps: la1, 3, t, x, y)
    with torch.no_grad():
        for p, q in zip(t.parameters(), t2.parameters()):
            q.copy_(p)
    la2 = LookAhead(make(t2.parameters()), alpha=0.5, k=2)
    la2.set_state_dict(la1.state_dict())
    _train_toy("torch", lambda ps: la1, 1, t, x, y)
    _train_toy("torch", lambda ps: la2, 1, t2, x, y)
    for p, q in zip(t.parameters(), t2.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


# ============================================================= averagers
def _w(m):
    return [p.detach().clone() for p in m.parameters()]


def test_ema_and_model_average_match_jax():
    """After 4 steps of both packages' training with EMA(0.9) and
    ModelAverage updates, the averaged weights inside ``apply()`` equal
    JAX's; ``restore`` brings back the live ones exactly."""
    j, t, x, y = _toy_pair()
    jemas = (JEMA(j, decay=0.9), JModelAverage(model=j))
    temas = (ExponentialMovingAverage(t, decay=0.9), ModelAverage(model=t))
    jo = jopt.SGD(learning_rate=0.1, parameters=j.parameters())
    to = topt.SGD(learning_rate=0.1, parameters=t.parameters())
    for _ in range(4):
        for side, m, o, avs in (("jax", j, jo, jemas), ("torch", t, to, temas)):
            lossf = jnn.CrossEntropyLoss() if side == "jax" \
                else tnn.CrossEntropyLoss()
            xx = paddle.to_tensor(x) if side == "jax" else torch.from_numpy(x)
            yy = paddle.to_tensor(y) if side == "jax" else torch.from_numpy(y)
            lossf(m(xx), yy).backward()
            o.step()
            o.clear_grad()
            for a in avs:
                a.update()
    live = _w(t)
    for ja, ta in zip(jemas, temas):
        with ja.apply():
            want = _state(j)
        with ta.apply():
            got = export_paddle_tpu_state_dict(t, want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        for a, b in zip(live, _w(t)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_averagers_apply_restore_debias_mean():
    """tests/test_amp_scaler.py's averager cases: apply before any update
    is the identity, EMA's first update debiases to the live weights, the
    model average is the exact mean, apply/restore swap in place."""
    _, t, x, y = _toy_pair()
    live = _w(t)
    for av in (ExponentialMovingAverage(t, decay=0.9), ModelAverage(model=t)):
        with av.apply():
            for a, b in zip(live, _w(t)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    ema = ExponentialMovingAverage(t, decay=0.9)
    ema.update()
    with ema.apply():
        for a, b in zip(live, _w(t)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    ma = ModelAverage(model=t)
    o = topt.SGD(learning_rate=0.1, parameters=t.parameters())
    ptrs = [p.data_ptr() for p in t.parameters()]
    snaps = []
    for _ in range(3):
        tnn.CrossEntropyLoss()(t(torch.from_numpy(x)),
                               torch.from_numpy(y)).backward()
        o.step()
        o.clear_grad()
        ma.update()
        snaps.append(_w(t))
    with ma.apply():
        assert [p.data_ptr() for p in t.parameters()] == ptrs  # in place
        for i, p in enumerate(t.parameters()):
            torch.testing.assert_close(
                p.detach(), torch.stack([s[i] for s in snaps]).mean(0),
                rtol=1e-5, atol=1e-6)
    for a, b in zip(snaps[-1], _w(t)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sd = ema.state_dict()
    ema2 = ExponentialMovingAverage(t, decay=0.5)
    ema2.set_state_dict(sd)
    assert ema2.decay == 0.9 and ema2._t == 1


# ============================================================== nn.utils
def _linear_pair(i=4, o=3, seed=0):
    paddle.seed(seed)
    j = jnn.Linear(i, o)
    t = tnn.Linear(i, o)
    load_paddle_tpu_state_dict(t, _state(j))
    return j, t


def test_parameters_to_vector_paddle_order():
    j, t, _, _ = _toy_pair()
    want = np.asarray(jutils.parameters_to_vector(list(j.parameters()))._value)
    got = tutils.parameters_to_vector(t.parameters())
    np.testing.assert_array_equal(got.detach().numpy(), want)
    v = np.random.RandomState(3).randn(want.size).astype("float32")
    jutils.vector_to_parameters(paddle.to_tensor(v), list(j.parameters()))
    tutils.vector_to_parameters(torch.from_numpy(v), list(t.parameters()))
    got = export_paddle_tpu_state_dict(t, _state(j))
    for k, w in _state(j).items():
        np.testing.assert_array_equal(got[k], w)


@pytest.mark.parametrize("how", ["deepcopy", "pickle", "to_empty", "dtype"])
def test_linear_layout_survives_copies(how):
    """The transposed layout is read off the tensors, so a copied,
    unpickled, meta-built or converted model lays its vector out in
    paddle's order as the original does (and its weight-norm ``g`` has
    paddle's length)."""
    import copy
    import pickle

    j, t, _, _ = _toy_pair()
    want = np.asarray(jutils.parameters_to_vector(list(j.parameters()))._value)
    if how == "deepcopy":
        u = copy.deepcopy(t)
    elif how == "pickle":
        u = pickle.loads(pickle.dumps(t))
    elif how == "to_empty":
        with torch.device("meta"):
            u = copy.deepcopy(t).to("meta")
        u.to_empty(device="cpu")
        tutils.vector_to_parameters(torch.from_numpy(want), u.parameters())
    else:
        u = copy.deepcopy(t).double().float()
    got = tutils.parameters_to_vector(u.parameters())
    np.testing.assert_array_equal(got.detach().numpy(), want)
    lin = next(m for m in u.modules() if isinstance(m, torch.nn.Linear))
    tutils.weight_norm(lin, dim=0)
    assert lin.weight_g.shape == (lin.in_features,)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    j, t, x, y = _toy_pair()
    jnn.CrossEntropyLoss()(j(paddle.to_tensor(x)), paddle.to_tensor(y)).backward()
    tnn.CrossEntropyLoss()(t(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    jt = jutils.clip_grad_norm_(list(j.parameters()), 0.05, norm_type)
    tt = tutils.clip_grad_norm_(list(t.parameters()), 0.05, norm_type)
    np.testing.assert_allclose(float(tt), float(jt), **TOL)
    jutils.clip_grad_value_(list(j.parameters()), 0.003)
    tutils.clip_grad_value_(list(t.parameters()), 0.003)
    for (k, tp), jp in zip(t.named_parameters(), j.parameters()):
        g = tp.grad.numpy()
        np.testing.assert_allclose(g.T if g.ndim == 2 else g,
                                   np.asarray(jp.grad._value), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    """``weight_norm`` on a Linear at paddle's ``dim``: the same
    ``weight_g`` / ``weight_v`` / ``weight`` state (carried across both
    ways), output and gradients; ``remove_weight_norm`` folds it back."""
    j, t = _linear_pair()
    jutils.weight_norm(j, dim=dim)
    tutils.weight_norm(t, dim=dim)
    js = _state(j)
    assert list(t.state_dict()) == list(js)
    got = export_paddle_tpu_state_dict(t, js)
    for k in js:
        np.testing.assert_allclose(got[k], js[k], err_msg=k, **TOL)
    js["weight_g"] = js["weight_g"] * 1.5      # carried across, then used
    load_paddle_tpu_state_dict(t, js)
    j.set_state_dict({k: paddle.to_tensor(v) for k, v in js.items()})
    x = np.random.RandomState(1).randn(5, 4).astype("float32")
    jy = j(paddle.to_tensor(x))
    ty = t(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **TOL)
    jy.sum().backward()
    ty.sum().backward()
    for k in ("weight_g", "weight_v"):
        jg = np.asarray(getattr(j, k).grad._value)
        tg = getattr(t, k).grad.numpy()
        np.testing.assert_allclose(tg.T if tg.ndim == 2 else tg, jg,
                                   err_msg=k, **TOL)
    assert [n for n, _ in t.named_parameters()] \
        == [n for n, _ in j.named_parameters()]
    jutils.remove_weight_norm(j)
    tutils.remove_weight_norm(t)
    got = export_paddle_tpu_state_dict(t, _state(j))
    for k, v in _state(j).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


def test_spectral_norm_matches_jax():
    """``spectral_norm`` on a Linear: paddle's ``weight_orig`` /
    ``weight_sn.weight_u`` (in) / ``weight_v`` (out) state carried across
    both ways, and the normalized weight, the output and the gradient equal
    JAX's.  (The reference's hook cannot run a second time: it takes the
    truth value of a tensor, so its layer is driven through its
    ``weight_sn`` sublayer, the operation the hook applies.)"""
    j, t = _linear_pair(5, 3, seed=2)
    jutils.spectral_norm(j, n_power_iterations=2)
    tutils.spectral_norm(t, n_power_iterations=2)
    js = _state(j)
    assert js["weight_sn.weight_u"].shape == (5,)
    assert js["weight_sn.weight_v"].shape == (3,)
    assert list(t.state_dict()) == list(js)
    assert [n for n, _ in t.named_parameters()] \
        == [n for n, _ in j.named_parameters()]
    load_paddle_tpu_state_dict(t, js)
    x = np.random.RandomState(4).randn(6, 5).astype("float32")
    ty = t(torch.from_numpy(x))
    jw = j.weight_sn(j.weight_orig)
    jy = paddle.matmul(paddle.to_tensor(x), jw) + j.bias
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **TOL)
    got = export_paddle_tpu_state_dict(t, js)
    np.testing.assert_allclose(got["weight"], jw.numpy(), **TOL)
    for k in js:
        if k != "weight":
            np.testing.assert_allclose(got[k], js[k], err_msg=k, **TOL)
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(t.weight_orig.grad.numpy().T,
                               np.asarray(j.weight_orig.grad._value), **TOL)


# ============================================================= recompute
def test_recompute_matches_plain_and_jax():
    """tests/test_distributed.py's recompute case: values and gradients of
    ``fleet.recompute(m, x)`` equal the plain call's and JAX's."""
    paddle.seed(9)
    j = jnn.Sequential(jnn.Linear(8, 32), jnn.GELU(), jnn.Linear(32, 8))
    t = torch.nn.Sequential(tnn.Linear(8, 32), torch.nn.GELU(),
                            tnn.Linear(32, 8))
    load_paddle_tpu_state_dict(t, _state(j))
    xv = np.random.RandomState(0).randn(4, 8).astype("float32")
    jx = paddle.to_tensor(xv, stop_gradient=False)
    import paddle_tpu.distributed.fleet as jfleet

    jy = jfleet.recompute(j, jx)
    jy.sum().backward()
    grads = {}
    for mode in ("plain", "recompute"):
        t.zero_grad()
        tx = torch.from_numpy(xv).requires_grad_()
        y = t(tx) if mode == "plain" else fleet.recompute(t, tx)
        y.sum().backward()
        grads[mode] = [tx.grad] + [p.grad.clone() for p in t.parameters()]
        np.testing.assert_allclose(y.detach().numpy(), jy.numpy(), **TOL)
    for a, b in zip(grads["plain"], grads["recompute"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(grads["recompute"][0].numpy(),
                               np.asarray(jx.grad._value), **TOL)
    with pytest.raises(NotImplementedError, match="item 9"):
        fleet.recompute(t, torch.from_numpy(xv), checkpoint_policy="x")
    seq = fleet.recompute_sequential({"segments": 2}, list(t),
                                     torch.from_numpy(xv))
    torch.testing.assert_close(seq, t(torch.from_numpy(xv)), rtol=0, atol=0)


class _GenDropout(torch.nn.Module):
    """Dropout drawing its mask from an explicit generator (not one of
    PyTorch's default generators, which ``preserve_rng_state`` covers)."""

    def __init__(self, p, seed):
        super().__init__()
        self.p = p
        self.gen = torch.Generator().manual_seed(seed)

    def forward(self, x):
        keep = torch.rand(x.shape, generator=self.gen) >= self.p
        return torch.where(keep, x / (1 - self.p), torch.zeros_like(x))


def test_recompute_replays_explicit_generators():
    """A segment drawing dropout masks from an explicit generator: the
    replay uses the forward's mask (gradients equal the plain run's), and
    the generator ends where the plain run leaves it; torch's checkpoint
    alone would draw a fresh mask."""
    torch.manual_seed(0)
    lin = tnn.Linear(16, 16)
    xv = torch.randn(4, 16)

    def run(mode):
        seg = torch.nn.Sequential(lin, _GenDropout(0.5, 123), torch.nn.Tanh())
        lin.zero_grad()
        x = xv.clone().requires_grad_()
        if mode == "plain":
            y = seg(x)
        elif mode == "recompute":
            y = fleet.recompute(seg, x)
        else:   # torch's checkpoint without the port's generator stash
            y = torch.utils.checkpoint.checkpoint(
                seg, x, use_reentrant=False, preserve_rng_state=True)
        (y * torch.arange(16.0)).sum().backward()
        return [x.grad, lin.weight.grad.clone()], seg[1].gen.get_state()

    plain, gstate = run("plain")
    rec, rstate = run("recompute")
    bare, _ = run("bare")
    for a, b in zip(plain, rec):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(gstate, rstate)
    assert not torch.equal(plain[0], bare[0])


def _llama_layer():
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaDecoderLayer,
                                                    _rope_cos_sin)

    cfg = LlamaConfig(hidden_size=32, intermediate_size=64,
                      num_attention_heads=4, num_key_value_heads=2)
    rope = _rope_cos_sin(torch.arange(12), 8, cfg.rope_theta)
    return LlamaDecoderLayer(cfg), (rope,)


def _gpt_dropout_layer():
    from paddle_tpu_torch.text.models.gpt import GPTDecoderLayer

    return GPTDecoderLayer(32, 4, 64, dropout=0.1, attn_dropout=0.1), ()


@pytest.mark.parametrize("make", [_llama_layer, _gpt_dropout_layer],
                         ids=["llama", "gpt_dropout_0.1"])
def test_recompute_layer_equals_plain(make):
    """A recomputed decoder layer gives the plain run's gradients bit for
    bit: a Llama layer, and a GPT layer with dropout 0.1 on its attention
    and residuals under the same seed (the replay draws the forward's
    masks)."""
    torch.manual_seed(0)
    layer, extra = make()
    layer.train()
    x0 = torch.randn(2, 12, 32)
    out = {}
    for mode in ("plain", "recompute"):
        layer.zero_grad()
        x = x0.clone().requires_grad_()
        torch.manual_seed(7)
        y = layer(x, *extra) if mode == "plain" \
            else fleet.recompute(layer, x, *extra)
        y.square().sum().backward()
        out[mode] = [y.detach(), x.grad] + \
            [p.grad.clone() for p in layer.parameters()]
    for a, b in zip(out["plain"], out["recompute"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ============================================================ fine-tune
def _jax_example_losses(argv):
    """The JAX example's printed losses (``step i  loss x``)."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["finetune_llama.py"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path("examples/finetune_llama.py", run_name="__main__")
    finally:
        sys.argv = old
    return [float(line.split("loss")[1].split()[0])
            for line in buf.getvalue().splitlines()
            if line.startswith("step")]


def _converted_llama(cfg_kw):
    paddle.seed(0)
    j = JLlama(JLlamaConfig(**cfg_kw))
    t = LlamaForCausalLM(finetune_llama.tiny_config(**{
        k: cfg_kw[v] for k, v in (("hidden", "hidden_size"),
                                  ("layers", "num_hidden_layers"),
                                  ("heads", "num_attention_heads"),
                                  ("kv_heads", "num_key_value_heads"),
                                  ("vocab", "vocab_size"))},
        seq_len=cfg_kw["max_position_embeddings"] // 4), device="cpu")
    load_paddle_tpu_state_dict(t, _state(j))
    return j, t


SMALL = dict(hidden=64, layers=2, heads=4, kv_heads=2, vocab=256, seq_len=32)


def _small_cfg_kw():
    c = finetune_llama.tiny_config(**SMALL)
    return dict(c)


def test_finetune_recipe_f32_matches_jax():
    """The recipe with AMP off at a narrow width (B=4, S=32, accumulate 2,
    6 steps): per-step losses, the EMA weights and the greedy ids under
    ``ema.apply()`` equal the same recipe in JAX (f32 TrainStep, AdamW +
    global-norm clip, cosine schedule, EMA 0.99) within rtol 1e-4."""
    kw = _small_cfg_kw()
    j, t = _converted_llama(kw)
    steps, B, S = 6, 4, 32
    res = finetune_llama.finetune(t, steps=steps, batch_size=B, seq_len=S,
                                  accum=2, lr=3e-3, amp_dtype="float32",
                                  new_tokens=8, log=None)
    sched = jopt.lr.CosineAnnealingDecay(learning_rate=3e-3, T_max=steps)
    o = jopt.AdamW(learning_rate=sched, parameters=j.parameters(),
                   weight_decay=0.01, grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(j, o, accumulate_steps=2)
    ema = JEMA(j, decay=0.99)
    rs = np.random.RandomState(0)
    jl = []
    for _ in range(steps):
        ids = paddle.to_tensor(rs.randint(1, kw["vocab_size"], (B, S)))
        jl.append(float(step({"input_ids": ids, "labels": ids})))
        ema.update()
        sched.step()
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-4)
    with ema.apply():
        j.eval()
        prompt = paddle.to_tensor(rs.randint(1, kw["vocab_size"], (1, 8)))
        greedy = j.generate(prompt, max_new_tokens=8, temperature=0.0)
        want = _state(j)
    assert res["prompt"] == prompt.numpy().tolist()
    assert res["greedy"] == greedy.numpy()[0, -8:].tolist()
    with res["ema"].apply():
        got = export_paddle_tpu_state_dict(t, want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_finetune_example_default_first_losses():
    """The reference's bf16 O2 default at its tiny width (2 steps of B=8,
    S=128, accumulate 2), from the JAX example's init: the port's first
    losses agree with the JAX example's printed ones (rtol 5e-3, the O2
    tolerance of test_torch_port_train.py); the port's CLI runs too."""
    want = _jax_example_losses(["--steps", "2"])
    paddle.seed(0)
    j = JLlama(JLlamaConfig(**dict(finetune_llama.tiny_config())))
    t = LlamaForCausalLM(finetune_llama.tiny_config(), device="cpu")
    load_paddle_tpu_state_dict(t, _state(j))
    res = finetune_llama.finetune(t, steps=2, new_tokens=4, log=None)
    np.testing.assert_allclose(res["losses"], want, rtol=5e-3)
    assert len(res["greedy"]) == len(res["sampled"]) == 4


def test_lookahead_pulls_back_and_survives_a_skipped_step():
    """After a k-sync the weights differ from the inner optimizer's plain
    run; a GradScaler step with a non-finite gradient leaves the weights,
    the inner state, the slow weights and the counter as they were."""
    from paddle_tpu_torch import amp as tamp

    def run(wrap, steps, poison=None):
        _, t, x, y = _toy_pair()
        o = topt.Adam(learning_rate=0.05, parameters=t.parameters())
        o = LookAhead(o, alpha=0.5, k=2) if wrap else o
        step = tjit.TrainStep(t, o, loss_fn=tnn.CrossEntropyLoss(),
                              scaler=tamp.GradScaler(init_loss_scaling=8.0))
        xx, yy = torch.from_numpy(x), torch.from_numpy(y)
        for i in range(steps):
            step(xx if i != poison else xx * float("inf"), yy)
        return t, o, step

    plain, _, _ = run(False, 2)
    la, _, _ = run(True, 2)
    assert max(float((a - b).detach().abs().max()) for a, b in
               zip(plain.parameters(), la.parameters())) > 1e-4
    ref, ro, _ = run(True, 3)
    got, go, gs = run(True, 4, poison=1)       # step 1 is skipped
    assert gs.found_inf is False and int(go._count) == 3
    for a, b in zip(ref.parameters(), got.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for p, q in zip(ref.parameters(), got.parameters()):
        torch.testing.assert_close(ro._slow[id(p)], go._slow[id(q)],
                                   rtol=0, atol=0)
