"""PyTorch port, training slice: the plain (CPU) paths of the flash backward
(K2a + K2b), the autograd Function around K1 + K2, cross_entropy, the
optimizers, clipping, LR schedulers, AMP and TrainStep, held against the
JAX package on the same numpy inputs.

The K2 plain version is compared with the Pallas backward kernels
themselves, run in interpret mode (the ``pl.pallas_call`` patch of
test_ops_kernels.py), at the float32 tolerance that file uses for the
backward (2e-4).  GPT-tiny is trained 5 steps by ``TrainStep`` on both
sides from one converted init, in f32 and under AMP O1 / O2 (bf16); each
test states its tolerance and why.  Also: the dispatch rule that a
non-CPU call needing a gradient the kernels cannot take raises in the
forward."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.tensor.tensor import Parameter as JParameter
from paddle_tpu.tensor.tensor import Tensor as JTensor
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import CrossEntropyLoss, Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jlr = importlib.import_module("paddle_tpu.optimizer.lr")

KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _pallas_interpret(fn, *args):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _bshd(x):
    """[BH, S, D] numpy -> [B=BH, S, H=1, D] torch (the port's layout)."""
    return torch.from_numpy(np.ascontiguousarray(x))[:, :, None]


# ------------------------------------------------------ K2: flash backward
@pytest.mark.parametrize("with_g_lse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 256)])
def test_bwd_ref_matches_pallas_backward(sq, sk, causal, with_g_lse):
    """flash_attention_bwd_ref == _flash_bwd_pallas (interpret mode), both
    from the Pallas forward's lse, BH=2, D=64; sq < sk uses the
    bottom-right causal offset; r = delta (- g_lse)."""
    BH, D = 2, 64
    q, k, v = _rand(0, BH, sq, D), _rand(1, BH, sk, D), _rand(2, BH, sk, D)
    g = _rand(3, BH, sq, D)
    scale = 0.125
    off = sk - sq
    o, lse = _pallas_interpret(
        functools.partial(jfa._flash_fwd, causal_offset=off, with_lse=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, 128, 128)
    r = jnp.sum(jnp.asarray(g) * o, axis=-1, keepdims=True)
    if with_g_lse:
        r = r - jnp.asarray(_rand(4, BH, sq, 1))
    want = _pallas_interpret(jfa._flash_bwd_pallas, jnp.asarray(q),
                             jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
                             lse, r, scale, causal, off)
    got = tfa.flash_attention_bwd_ref(
        _bshd(q), _bshd(k), _bshd(v), _bshd(g),
        torch.tensor(np.asarray(lse)[..., 0]),
        torch.tensor(np.asarray(r)[..., 0]), scale, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, :, 0].numpy(), np.asarray(b), **KERNEL_TOL)


@pytest.mark.parametrize("causal,sq,sk", [(True, 40, 40), (False, 40, 40),
                                          (True, 24, 40)])
def test_autograd_function_matches_jax_grad(causal, sq, sk):
    """The port's autograd Function (CPU: plain forward and K2 plain
    backward) against jax.grad of _ref_attention, [B=2, S, H=3, D=16],
    float32 (2e-5: the same math in another order)."""
    B, H, D = 2, 3, 16
    q, k, v = _rand(5, B, sq, H, D), _rand(6, B, sk, H, D), _rand(7, B, sk, H, D)
    g = _rand(8, B, sq, H, D)
    scale = 1.0 / np.sqrt(D)

    def to_bh(x):
        return jnp.moveaxis(x, 2, 1).reshape(-1, x.shape[1], D)

    def loss(q, k, v):
        o = jfa._ref_attention(to_bh(q), to_bh(k), to_bh(v), scale, causal)
        return jnp.sum(o * to_bh(jnp.asarray(g)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention_fn(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(g))
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


def test_flash_attention_with_lse_grads_match_jax():
    """(o, lse) differentiable in BOTH outputs: a loss mixing o and lse,
    as test_ops_kernels.py does, against the JAX primitive's grads (Pallas
    in interpret mode); float32, 2e-4 as there."""
    BH, S, D = 2, 128, 32
    q, k, v = _rand(9, BH, S, D), _rand(10, BH, S, D), _rand(11, BH, S, D)
    scale = 1.0 / np.sqrt(D)

    def loss_jax(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, scale, causal=True,
                                              block_q=128, block_k=128)
        return (o.astype(jnp.float32) ** 2).sum() + (lse * 0.3).sum()

    want = _pallas_interpret(jax.grad(loss_jax, argnums=(0, 1, 2)),
                             jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, scale, causal=True)
    assert o.shape == (BH, S, D) and lse.shape == (BH, S, 1)
    ((o ** 2).sum() + (lse * 0.3).sum()).backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **KERNEL_TOL)


def test_supported_backward_rule():
    """One rule for the forward and the backward: head_dim <= 256 (the TPU
    package's limit, with or without a gradient); 257 refused."""
    assert tfa.MAX_HEAD_DIM == 256
    assert tfa.supported((2, 1024, 12, 64), (2, 1024, 12, 64), True)
    assert tfa.supported((1, 17, 2, 128), (1, 17, 2, 128), True)
    assert tfa.supported((1, 17, 2, 256), (1, 17, 2, 256), True)
    assert tfa.supported((1, 17, 2, 192), (1, 17, 2, 192), False)
    assert not tfa.supported((1, 17, 2, 257), (1, 17, 2, 257), True)
    assert not tfa.supported((1, 17, 2, 257), (1, 17, 2, 257), False)
    assert not tfa.supported((1, 64, 4, 64), (1, 64, 2, 64), False)  # GQA


def test_grad_calls_the_kernels_cannot_take_raise_in_forward():
    """Off the CPU (meta tensors here) a call that needs a gradient the
    backward kernels cannot take (head_dim > 256) raises
    NotImplementedError in the forward, naming the rule; K3
    (inference-only) refuses any gradient."""
    q = torch.empty(1, 8, 2, 257, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="needs_grad=True"):
        tfa.flash_attention_fn(q, q, q, causal=True)
    with pytest.raises(NotImplementedError, match="needs_grad=True"):
        TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    q64 = torch.empty(1, 8, 2, 64, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError):          # meta: no kernel
        tfa.flash_attention_fn(q64, q64, q64, causal=True)
    pool = torch.empty(4, 8, 2, 64, device="meta")
    table = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        tpa.paged_attention(q64[0, :2], pool, pool, table,
                            torch.zeros(2, dtype=torch.int32, device="meta"))


# ------------------------------------------------------------ cross_entropy
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("extra", [{}, {"label_smoothing": 0.1}, {"weight": True},
                                   {"use_softmax": False}])
def test_cross_entropy_matches_jax(reduction, extra):
    """Loss and d(loss)/d(logits) against the JAX cross_entropy, with
    ignore_index hits among the labels; float32, 1e-5 (softmax rounding)."""
    N, C = 12, 7
    logits = _rand(12, N, C) * 3
    labels = np.random.RandomState(13).randint(0, C, N).astype("int64")
    labels[[1, 5, 9]] = -100
    kw = dict(extra)
    w = np.random.RandomState(14).rand(C).astype("float32") + 0.5
    jkw = {**kw, "weight": paddle.to_tensor(w)} if "weight" in kw else kw
    tkw = {**kw, "weight": torch.from_numpy(w)} if "weight" in kw else kw

    x = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(x, paddle.to_tensor(labels), reduction=reduction, **jkw)
    (jl.sum() if reduction == "none" else jl).backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tl = TF.cross_entropy(tx, torch.from_numpy(labels), reduction=reduction, **tkw)
    (tl.sum() if reduction == "none" else tl).backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_cross_entropy_loss_layer_and_soft_labels():
    logits = _rand(15, 4, 5)
    soft = np.random.RandomState(16).dirichlet(np.ones(5), 4).astype("float32")
    want = jnn.CrossEntropyLoss(soft_label=True)(paddle.to_tensor(logits),
                                                 paddle.to_tensor(soft)).numpy()
    got = CrossEntropyLoss(soft_label=True)(torch.from_numpy(logits),
                                            torch.from_numpy(soft))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# --------------------------------------------------------------- optimizers
def _jax_params(arrays, names):
    return [JParameter(jnp.asarray(a), name=n) for a, n in zip(arrays, names)]


def _torch_params(arrays, names):
    return [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]


OPTIMIZERS = {
    "adamw": lambda m, ps, **kw: m.AdamW(learning_rate=0.01, parameters=ps,
                                         weight_decay=0.1, **kw),
    "adamw_decay_fun": lambda m, ps, **kw: m.AdamW(
        learning_rate=0.01, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=lambda n: n.endswith("w"), **kw),
    "adam": lambda m, ps, **kw: m.Adam(learning_rate=0.01, parameters=ps,
                                       weight_decay=0.05, **kw),
    "sgd": lambda m, ps, **kw: m.SGD(learning_rate=0.1, parameters=ps,
                                     weight_decay=0.01, **kw),
    "momentum": lambda m, ps, **kw: m.Momentum(learning_rate=0.1, parameters=ps,
                                               momentum=0.9, weight_decay=0.01, **kw),
    "nesterov": lambda m, ps, **kw: m.Momentum(learning_rate=0.1, parameters=ps,
                                               use_nesterov=True, **kw),
    "groups": lambda m, ps, **kw: m.AdamW(
        learning_rate=0.01, weight_decay=0.1,
        parameters=[{"params": ps[:1], "learning_rate": 0.5},
                    {"params": ps[1:], "weight_decay": 0.0}], **kw),
}


@pytest.mark.parametrize("clip", [None, "global", "norm", "value"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name, clip):
    """Three ``step()`` calls over two parameters with fixed grads: the
    port's rule, groups, decay and clip against the JAX optimizer's;
    float32, 1e-6 (one rounding per op)."""
    arrays = [_rand(20, 4, 3), _rand(21, 3)]
    names = ["fc.w", "fc.b"]
    grads = [[_rand(30 + 2 * s + i, *a.shape) * (5 if s == 1 else 1)
              for i, a in enumerate(arrays)] for s in range(3)]
    clips = {"global": lambda m: m.ClipGradByGlobalNorm(1.0),
             "norm": lambda m: m.ClipGradByNorm(0.5),
             "value": lambda m: m.ClipGradByValue(0.8)}
    jp, tp = _jax_params(arrays, names), _torch_params(arrays, names)
    jo = OPTIMIZERS[name](jopt, jp, **({"grad_clip": clips[clip](jopt)} if clip else {}))
    # the port takes names as torch's (name, param) pairs
    to = OPTIMIZERS[name](topt, list(zip(names, tp)),
                          **({"grad_clip": clips[clip](topt)} if clip else {}))
    for gs in grads:
        for p, g in zip(jp, gs):
            p.grad = JTensor(jnp.asarray(g))
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._value),
                                   rtol=1e-6, atol=1e-6)
    assert to._step_count == jo._step_count == 3


def test_optimizer_state_dict_round_trip_and_lr():
    arrays = [_rand(40, 3, 3)]
    tp = _torch_params(arrays, ["w"])
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    o = topt.Adam(learning_rate=sched, parameters=tp)
    tp[0].grad = torch.ones(3, 3)
    o.step()
    sd = o.state_dict()
    assert sd["step"] == 1 and set(sd["states"]["0"]) == {"m", "v", "t"}
    o2 = topt.Adam(learning_rate=tlr.StepDecay(0.1, step_size=1, gamma=0.5),
                   parameters=tp)
    sched.step()
    o2.set_state_dict(o.state_dict())
    assert o2.get_lr() == pytest.approx(0.05)
    torch.testing.assert_close(o2._states[id(tp[0])]["m"], o._states[id(tp[0])]["m"])
    with pytest.raises(RuntimeError):
        o.set_lr(1.0)
    o3 = topt.SGD(learning_rate=0.1, parameters=tp)
    o3.set_lr(0.2)
    assert o3.get_lr() == 0.2


@pytest.mark.parametrize("make", [
    lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    lambda m: m.CosineAnnealingDecay(0.1, T_max=7),
    lambda m: m.LinearWarmup(m.ExponentialDecay(0.1, 0.9), 4, 0.0, 0.1),
    lambda m: m.OneCycleLR(0.1, total_steps=12),
    lambda m: m.PolynomialDecay(0.1, decay_steps=5, cycle=True),
])
def test_lr_schedulers_match_jax(make):
    j, t = make(jlr), make(tlr)
    for _ in range(12):
        assert t() == pytest.approx(j(), rel=1e-12)
        j.step()
        t.step()


# ---------------------------------------------------------------- GPT-tiny
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64)
LR, STEPS = 1e-3, 5


def _gpt_pair():
    paddle.seed(0)
    j = JGPT(**CFG)
    init = {k: np.asarray(v._value) for k, v in j.state_dict().items()}
    t = GPTForCausalLM(device="cpu", **CFG)
    load_paddle_tpu_state_dict(t, init)
    return j, t, init


def _ids(seed=0, b=2, s=32):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (b, s)).astype("int64")


def _train_both(amp_level):
    j, t, init = _gpt_pair()
    jo = jopt.AdamW(learning_rate=LR, parameters=j.parameters(),
                    grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(learning_rate=LR, parameters=t.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    js = paddle.jit.TrainStep(j, jo, loss_fn=None, amp_level=amp_level)
    ts = tjit.TrainStep(t, to, loss_fn=None, amp_level=amp_level)
    ids = _ids()
    jl = [float(js({"input_ids": paddle.to_tensor(ids),
                    "labels": paddle.to_tensor(ids)})) for _ in range(STEPS)]
    tl = []
    for _ in range(STEPS):
        loss = ts({"input_ids": torch.from_numpy(ids),
                   "labels": torch.from_numpy(ids)})
        assert loss.ndim == 0 and loss.dtype == torch.float32
        tl.append(float(loss))
    jw = {k: np.asarray(v._value, dtype=np.float32) for k, v in j.state_dict().items()}
    return np.asarray(jl), np.asarray(tl), jw, export_paddle_tpu_state_dict(t, jw), init


def _key_bias(w, k):
    """The key slice of a head-major qkv bias ([heads, 3, head_dim])."""
    heads = CFG["num_attention_heads"]
    return w[k].reshape(heads, 3, -1)[:, 1]


def test_gpt_tiny_trainstep_matches_jax_f32():
    """5 TrainSteps (AdamW lr 1e-3, ClipGradByGlobalNorm(1.0)) from one
    converted init: per-step losses rtol 1e-4, final weights atol 1e-4.
    The one exception is the key slice of each qkv bias: its gradient is
    zero in exact arithmetic (softmax ignores a per-row constant), so each
    side's is rounding noise that Adam scales to a full step; it is held
    to 2 * lr * steps and the update as a whole to 1e-3 of its norm."""
    jl, tl, jw, tw, init = _train_both(None)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for k in jw:
        if k.endswith("qkv.bias"):
            assert np.abs(_key_bias(tw, k) - _key_bias(jw, k)).max() <= 2 * LR * STEPS
            for s in (0, 2):
                np.testing.assert_allclose(
                    tw[k].reshape(CFG["num_attention_heads"], 3, -1)[:, s],
                    jw[k].reshape(CFG["num_attention_heads"], 3, -1)[:, s], atol=1e-4)
        else:
            np.testing.assert_allclose(tw[k], jw[k], atol=1e-4, err_msg=k)
    assert _update_diff(jw, tw, init) < 1e-3


def _update_diff(jw, tw, init):
    """|w_port - w_jax| over |w_jax - w_init|, over all weights."""
    num = np.sqrt(sum(np.sum((tw[k] - jw[k]) ** 2) for k in jw))
    den = np.sqrt(sum(np.sum((jw[k] - init[k]) ** 2) for k in jw))
    return num / den


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_gpt_tiny_trainstep_matches_jax_amp(level):
    """The same run under amp_level O1 / O2 in bf16.  bf16 keeps 8 bits, and
    the two frameworks round at different places, so the per-step losses
    are held to rtol 5e-3 and the weights' total update to within 10% of
    its norm (Adam turns rounding-sized gradient differences into
    step-sized weight differences)."""
    jl, tl, jw, tw, init = _train_both(level)
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0]
    assert _update_diff(jw, tw, init) < 0.1


def test_eager_training_equals_trainstep():
    """``loss = model(ids, labels=ids); loss.backward(); opt.step();
    opt.clear_grad()`` gives TrainStep's weights (float32, 1e-6)."""
    ids = torch.from_numpy(_ids(1))
    _, a, _ = _gpt_pair()
    _, b, _ = _gpt_pair()
    oa = topt.AdamW(learning_rate=LR, parameters=a.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    ob = topt.AdamW(learning_rate=LR, parameters=b.parameters(),
                    grad_clip=topt.ClipGradByGlobalNorm(1.0))
    step = tjit.train_step(b, ob)
    for _ in range(3):
        loss = a(ids, labels=ids)
        loss.backward()
        oa.step()
        oa.clear_grad()
        lb = step({"input_ids": ids, "labels": ids})
        assert loss.item() == pytest.approx(lb.item(), rel=1e-6)
    for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-6, atol=1e-6, msg=k)


def test_accumulate_steps_equals_full_batch_step():
    """accumulate_steps=2 over a batch of 4 == one step on the whole batch
    (equal token counts, so the mean of the micro means is the batch mean);
    SGD, whose update is lr * grad (Adam would scale the rounding noise of
    zero-gradient entries up to a full step); float32, 1e-6."""
    ids = torch.from_numpy(_ids(2, b=4))
    _, a, _ = _gpt_pair()
    _, b, _ = _gpt_pair()
    sa = tjit.TrainStep(a, topt.SGD(learning_rate=0.1, parameters=a.parameters()))
    sb = tjit.TrainStep(b, topt.SGD(learning_rate=0.1, parameters=b.parameters()),
                        accumulate_steps=2)
    la = sa({"input_ids": ids, "labels": ids})
    lb = sb({"input_ids": ids, "labels": ids})
    torch.testing.assert_close(lb, la, rtol=1e-6, atol=1e-6)
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        sb({"input_ids": ids[:3], "labels": ids[:3]})


def test_trainstep_return_outputs_and_state_dict():
    """The ``loss_fn(model(x), *labels)`` convention, ``return_outputs``,
    and ``state_dict`` / ``set_state_dict`` restoring params and optimizer
    state."""
    ids = torch.from_numpy(_ids(3))
    _, t, _ = _gpt_pair()
    o = topt.AdamW(learning_rate=LR, parameters=t.parameters())
    step = tjit.TrainStep(t, o, loss_fn=lambda logits, y: TF.cross_entropy(
        logits.reshape(-1, CFG["vocab_size"]), y.reshape(-1)),
        return_outputs=True)
    loss, outs = step(ids, ids)
    assert loss.ndim == 0
    assert outs.shape == (2, 32, CFG["vocab_size"]) and not outs.requires_grad
    sd = step.state_dict()
    assert sd["step"] == 1 and set(sd["params"]) == {k for k, _ in t.named_parameters()}
    snap = {k: v.clone() for k, v in sd["params"].items()}
    m_snap = {k: st["m"].clone() for k, st in sd["opt_state"].items()}
    step(ids, ids)
    step.set_state_dict({**sd, "params": snap,
                         "opt_state": {k: {**st, "m": m_snap[k]}
                                       for k, st in sd["opt_state"].items()}})
    for k, p in t.named_parameters():
        torch.testing.assert_close(p.detach(), snap[k])
        torch.testing.assert_close(o._states[id(p)]["m"], m_snap[k])


def _mlp_pair():
    """The tiny MLP of test_amp_scaler.py on both sides, same weights."""
    paddle.seed(11)
    j = jnn.Sequential(jnn.Linear(6, 8), jnn.ReLU(), jnn.Linear(8, 3))
    t = torch.nn.Sequential(Linear(6, 8), torch.nn.ReLU(), Linear(8, 3))
    with torch.no_grad():
        for jl, tl in ((j[0], t[0]), (j[2], t[2])):
            tl.weight.copy_(torch.tensor(np.asarray(jl.weight._value).T))
            tl.bias.copy_(torch.tensor(np.asarray(jl.bias._value)))
    return j, t


def test_grad_scaler_skips_non_finite_steps_like_jax():
    """fp16 (O1) TrainStep with a GradScaler: a batch with inf skips the
    update and halves the scale, two good steps double it back — the same
    found_inf / loss_scale sequence as the JAX TrainStep, and the same
    weights (fp16 matmuls: atol 2e-3)."""
    j, t = _mlp_pair()
    rs = np.random.RandomState(3)
    x, y = rs.randn(8, 6).astype("float32"), rs.randint(0, 3, 8).astype("int64")
    bad = np.full((8, 6), np.inf, dtype="float32")
    kw = dict(init_loss_scaling=256.0, incr_every_n_steps=2, incr_ratio=2.0,
              decr_ratio=0.5)
    js = paddle.jit.TrainStep(j, jopt.SGD(learning_rate=0.05, parameters=j.parameters()),
                              loss_fn=jnn.CrossEntropyLoss(), amp_level="O1",
                              amp_dtype="float16", scaler=paddle.amp.GradScaler(**kw))
    tsc = tamp.GradScaler(**kw)
    ts = tjit.TrainStep(t, topt.SGD(learning_rate=0.05, parameters=t.parameters()),
                        loss_fn=CrossEntropyLoss(), amp_level="O1",
                        amp_dtype="float16", scaler=tsc)
    seq = []
    for xb in (x, bad, x, x):
        js(paddle.to_tensor(xb), paddle.to_tensor(y))
        w_before = [p.detach().clone() for p in t.parameters()]
        ts(torch.from_numpy(xb), torch.from_numpy(y))
        if xb is bad:
            for a, b in zip(w_before, t.parameters()):
                assert torch.equal(a, b)          # the update was skipped
        seq.append((ts.found_inf, ts.loss_scale, js.found_inf, js.loss_scale))
    assert [s[:2] for s in seq] == [s[2:] for s in seq] == \
        [(False, 256.0), (True, 128.0), (False, 128.0), (False, 256.0)]
    ts.sync()
    assert tsc._scale == 256.0
    for tl, jl in ((t[0], j[0]), (t[2], j[2])):
        np.testing.assert_allclose(tl.weight.detach().numpy().T,
                                   np.asarray(jl.weight._value), atol=2e-3)


def test_eager_grad_scaler_matches_jax():
    """Eager ``scale(loss).backward(); step(opt); update()``: a non-finite
    batch skips the step and halves the scale, as the JAX GradScaler does;
    the weights after a good and a bad step match (float32, 1e-6)."""
    j, t = _mlp_pair()
    rs = np.random.RandomState(4)
    x, y = rs.randn(8, 6).astype("float32"), rs.randint(0, 3, 8).astype("int64")
    bad = np.full((8, 6), np.nan, dtype="float32")
    jo = jopt.SGD(learning_rate=0.05, parameters=j.parameters())
    to = topt.SGD(learning_rate=0.05, parameters=t.parameters())
    jsc = paddle.amp.GradScaler(init_loss_scaling=64.0)
    tsc = tamp.GradScaler(init_loss_scaling=64.0)
    for xb in (x, bad):
        jl = jnn.CrossEntropyLoss()(j(paddle.to_tensor(xb)), paddle.to_tensor(y))
        jsc.scale(jl).backward()
        jsc.step(jo)
        jsc.update()
        jo.clear_grad()
        tl = CrossEntropyLoss()(t(torch.from_numpy(xb)), torch.from_numpy(y))
        tsc.scale(tl).backward()
        tsc.step(to)
        tsc.update()
        to.clear_grad()
        assert tsc._scale == jsc._scale
    assert tsc._scale == 32.0 and to._step_count == 1
    for tl_, jl_ in ((t[0], j[0]), (t[2], j[2])):
        np.testing.assert_allclose(tl_.weight.detach().numpy().T,
                                   np.asarray(jl_.weight._value), rtol=1e-6, atol=1e-6)


def test_auto_cast_lists():
    """O1 casts white ops to bf16 and black ops to f32; O2 casts all but
    the black list; outside auto_cast nothing is cast."""
    x = torch.ones(2, dtype=torch.float32)
    assert tamp.cast("linear", x)[0].dtype == torch.float32
    with tamp.auto_cast(level="O1"):
        assert tamp.cast("linear", x)[0].dtype == torch.bfloat16
        assert tamp.cast("layer_norm", x)[0].dtype == torch.float32
        assert tamp.cast("cross_entropy", x.bfloat16())[0].dtype == torch.float32
        with tamp.auto_cast(level="O2", dtype="float16"):
            assert tamp.cast("layer_norm", x)[0].dtype == torch.float16
        assert tamp.cast("layer_norm", x)[0].dtype == torch.float32
    with tamp.auto_cast(level="O1", custom_black_list={"linear"}):
        assert tamp.cast("linear", x.bfloat16())[0].dtype == torch.float32
    assert tamp.cast("linear", None, torch.ones(2, dtype=torch.int64))[1].dtype \
        == torch.int64


def test_decorate_o2_keeps_f32_masters():
    """amp.decorate at O2: bf16 working copies, f32 masters that the
    optimizer updates, re-deriving the working copy."""
    m = torch.nn.Sequential(Linear(4, 3))
    w0 = m[0].weight.detach().clone()
    tamp.decorate(m, level="O2")
    p = m[0].weight
    assert p.dtype == torch.bfloat16 and p._master.dtype == torch.float32
    torch.testing.assert_close(p._master, w0)
    o = topt.SGD(learning_rate=0.1, parameters=m.parameters())
    with tamp.auto_cast(level="O2"):
        m(torch.ones(2, 4)).float().sum().backward()
    o.step()
    torch.testing.assert_close(p._master, w0 - 0.1 * 2.0 * torch.ones(3, 4))
    assert torch.equal(p.detach(), p._master.bfloat16())
