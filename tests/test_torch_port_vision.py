"""PyTorch port, the classification zoo: ResNet-50 (BASELINE.json's config
#1) at full width, ViT-S/16 and the small zoo against the JAX package on
the CPU, with the weights carried across by
``text.models.load_paddle_tpu_state_dict``; the state dicts round-trip.

Tolerances, stated per test: eval logits within 1e-4 of their max
(convolution sums in another order); f32 ``TrainStep`` losses rtol 1e-4;
parameters and running statistics against JAX's relative to the update,
ResNet-50's step by step from a common start, within 3x a perturbed-input
control (a random-init ResNet in training amplifies rounding), ViT's
within 1e-3 of the update's norm;
the running statistics of ``accumulate_steps=2`` within 1e-4 of their
max.  The training batches are 4 x 3 x 64 x 64: at 2 x 3 x 32 x 32
ResNet's last stage is 1 x 1, so each of its batch norms normalises 2
values, and any two correct implementations part there (their 1e-5
differences at the stage's input reach 3e-2 at its output, measured on
the CPU); at 64 x 64 each normalises 16 and the two agree to 3e-5."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.text.models import (export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.vision import models as tmodels
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401


def _state(jm):
    """A float32 numpy copy of the JAX model's state (a view could see a
    donated buffer reused)."""
    return {k: np.array(jnp.asarray(v._value).astype(jnp.float32), copy=True)
            for k, v in jm.state_dict().items()}


def _port_of(jm, ctor, *args, **kw):
    tm = ctor(*args, device="cpu", **kw)
    load_paddle_tpu_state_dict(tm, _state(jm))
    return tm


def _close_to_max(got, want, rel, what=""):
    """``|got - want| <= rel * max|want|`` elementwise."""
    tol = rel * max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max err {err:.3g} > {tol:.3g}"


def _jax_eval(jm, x):
    """The JAX model's eval forward as one jitted program (an eager
    forward compiles each op: minutes for the deep nets)."""
    from paddle_tpu.framework.state import no_grad_ctx
    from paddle_tpu.tensor.tensor import Tensor

    jm.eval()
    params = {k: p._value for k, p in jm.named_parameters()}
    bufs = {k: b._value for k, b in jm.named_buffers()}

    def fwd(p, b, v):
        with no_grad_ctx(), jm.bind(p, b):
            return jm(Tensor(v))._value

    return np.asarray(jax.jit(fwd)(params, bufs, x))


def _data(seed, b=2, c=3, hw=32, classes=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, c, hw, hw).astype("float32"),
            rs.randint(0, classes, (b,)).astype("int64"))


@pytest.fixture(scope="module")
def resnet50_pair():
    paddle.seed(0)
    jm = jmodels.resnet50(num_classes=10)
    return jm, _port_of(jm, tmodels.resnet50, num_classes=10)


def test_resnet50_state_dict_round_trips_and_bn_names(resnet50_pair):
    """Load -> export gives the JAX state back exactly (conv weights and
    BN buffers as they are, the ``fc`` weight transposed twice); BN's
    buffers are ``_mean`` / ``_variance``; a missing key raises."""
    jm, tm = resnet50_pair
    want = _state(jm)
    fresh = tmodels.resnet50(num_classes=10, device="cpu")
    load_paddle_tpu_state_dict(fresh, want)
    got = export_paddle_tpu_state_dict(fresh, expected=want)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "bn1._mean" in got and "bn1._variance" in got
    assert not any(k.endswith("num_batches_tracked") for k in got)
    assert tuple(fresh.fc.weight.shape) == (10, 2048)
    with pytest.raises(KeyError):
        load_paddle_tpu_state_dict(fresh, {k: v for k, v in want.items()
                                           if k != "bn1._mean"})
    with pytest.raises(ValueError, match="pretrained"):
        tmodels.resnet50(pretrained=True, device="cpu")


def _momentum_step(model, step_cls, opt_mod, loss_cls, **kw):
    return step_cls(
        model, opt_mod.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=model.parameters(),
                                weight_decay=1e-4),
        loss_fn=loss_cls(), **kw)


def _dist(a, b):
    """``||a - b||`` over every tensor of the states."""
    return np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b))


def _update_gap(a, b, init):
    """``||a - b|| / ||b - init||``."""
    return _dist(a, b) / _dist(b, init)


def test_resnet50_eval_and_two_momentum_steps_f32(resnet50_pair):
    """Eval logits, then two ``TrainStep`` steps with ``Momentum(0.1, 0.9,
    weight_decay=1e-4)`` and ``CrossEntropyLoss`` against the JAX
    ``TrainStep``: the losses rtol 1e-4, and each step's update of the
    parameters and of the BN running statistics.

    A randomly initialised ResNet-50 in training mode is chaotic: its
    gradients move by up to ~30% of a tensor's max when the input moves
    by 1e-7 relative (measured on the CPU, port alone, at batches 4-16 and
    64-128 pixels), and after lr 0.1 the second step's loss is ~100, so
    two runs that part by rounding in step 1 part by ~40% of the update
    after step 2.  Each step is therefore held from a common start: step
    1 from the shared initial weights, step 2 from JAX's parameters and
    running statistics after step 1, loaded into the port, whose
    optimizer keeps the velocity of its own step 1.  The port also runs
    on the inputs perturbed by 1e-7 (a rounding-sized control), and at
    each step its distance to JAX, over the step's update, must be
    within 3x the control's distance (or 1e-4 of the update): measured
    0.031 against a control of 0.014 at both steps, while a port that
    skips step 2's update reads 1, one that drops the velocity 0.98."""
    jm, _ = resnet50_pair
    init = _state(jm)
    x, _y = _data(0)
    tm = _port_of(jm, tmodels.resnet50, num_classes=10)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        _close_to_max(tm(torch.from_numpy(x)).numpy(),
                      jm(paddle.to_tensor(x)).numpy(), 1e-4, "eval logits")
    batches = [_data(10 + i, b=4, hw=64) for i in range(2)]
    jm.train()
    jstep = _momentum_step(jm, paddle.jit.TrainStep, jopt,
                           jnn.CrossEntropyLoss)
    jl, jstates = [], []
    for xi, yi in batches:
        jl.append(float(jstep(paddle.to_tensor(xi), paddle.to_tensor(yi))))
        jstates.append(_state(jm))
    noise = np.random.RandomState(7)
    runs = {}
    for tag in ("port", "control"):
        tm = tmodels.resnet50(num_classes=10, device="cpu")
        load_paddle_tpu_state_dict(tm, init)
        step = _momentum_step(tm, tjit.TrainStep, topt, tnn.CrossEntropyLoss)
        losses, states = [], []
        for i, (xi, yi) in enumerate(batches):
            if i:
                load_paddle_tpu_state_dict(tm, jstates[i - 1])
            if tag == "control":
                xi = (xi * (1 + 1e-7 * noise.randn(*xi.shape))).astype(
                    "float32")
            losses.append(float(step(torch.from_numpy(xi),
                                     torch.from_numpy(yi))))
            states.append(export_paddle_tpu_state_dict(tm, expected=init))
        runs[tag] = losses, states
    np.testing.assert_allclose(runs["port"][0], jl, rtol=1e-4)
    stats = [k for k in init if k.endswith(("_mean", "_variance"))]
    for i, start in enumerate([init] + jstates[:-1]):
        for name, keys in (("params", [k for k in init if k not in stats]),
                           ("running stats", stats)):
            sub = [{k: st[k] for k in keys} for st in (
                runs["port"][1][i], runs["control"][1][i], jstates[i],
                start)]
            update = _dist(sub[2], sub[3])
            gap = _dist(sub[0], sub[2]) / update
            control = _dist(sub[1], sub[0]) / update
            assert gap <= max(3 * control, 1e-4), (i + 1, name, gap, control)


def test_resnet50_bf16_o2_step_and_accumulate(resnet50_pair):
    """One bf16 O2 step (the running statistics stay float32), then one
    f32 step with ``accumulate_steps=2``: the loss, and the running
    statistics updated once per micro-batch, as the reference's (both
    micro-batches see the initial weights, so these are well conditioned:
    within 1e-4 of their max).

    The O2 loss is held to 2e-2 of JAX's, or to twice the port's own
    spread when the input moves by one bf16 rounding (2^-8 relative,
    three draws), whichever is larger: the random-init network in
    training mode turns rounding into percent-level loss changes (its O2
    loss moved by up to 3.6% under 1e-3 input noise, measured on the
    CPU)."""
    jm0, _ = resnet50_pair
    x, y = _data(20, b=4, hw=64)
    for amp, acc in (("O2", 1), (None, 2)):
        paddle.seed(1)
        jm = jmodels.resnet50(num_classes=10)
        jm.set_state_dict({k: paddle.to_tensor(v)
                           for k, v in _state(jm0).items()})
        kw = dict(amp_level=amp, accumulate_steps=acc)
        jstep = _momentum_step(jm, paddle.jit.TrainStep, jopt,
                               jnn.CrossEntropyLoss, **kw)
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        losses = []
        for s in range(4 if amp == "O2" else 1):
            xs = x if s == 0 else (x * (1 + 2.0 ** -8 * np.random.RandomState(
                s).randn(*x.shape))).astype("float32")
            tm = _port_of(jm0, tmodels.resnet50, num_classes=10)
            tstep = _momentum_step(tm, tjit.TrainStep, topt,
                                   tnn.CrossEntropyLoss, **kw)
            losses.append(float(tstep(torch.from_numpy(xs),
                                      torch.from_numpy(y))))
            assert tm.bn1._mean.dtype == torch.float32
            if s == 0:
                got = export_paddle_tpu_state_dict(tm)
        tl = losses[0]
        if amp == "O2":
            spread = max(abs(v - tl) for v in losses[1:])
            assert abs(tl - jl) <= max(2e-2 * abs(jl), 2 * spread), \
                (tl, jl, losses)
            continue
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        want = _state(jm)
        for k in want:
            if k.endswith(("_mean", "_variance")):
                _close_to_max(got[k], want[k], 1e-4, k)


def test_vit_s16_forward_and_three_adamw_steps():
    """The reference's own ViT test (``vit_s_16(img_size=32, class_num=10,
    depth=2)``, AdamW 1e-3, 3 ``TrainStep`` steps): logits, the three
    losses (rtol 1e-4) and the parameters after the first step against
    JAX; 2 x 2 patches + the class token = 5 tokens.  Adam's first update
    is about ``lr * sign(g)``, so an element whose gradient is at rounding
    level (the key slice of each qkv bias has a zero gradient in exact
    arithmetic) moves by up to 2 * lr between two correct runs: the
    parameters are held, as in the GPT tests, to 1e-3 of the update's
    norm, the key slices apart.  After the first step the loss is ~1e-6 and every gradient is
    rounding noise, so later parameters are not compared."""
    paddle.seed(0)
    jm = jmodels.vit_s_16(img_size=32, class_num=10, depth=2)
    init = _state(jm)
    tm = _port_of(jm, tmodels.vit_s_16, img_size=32, class_num=10, depth=2)
    assert tuple(tm.pos_embed.shape) == (1, 5, 384)
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype("float32")
    y = np.random.RandomState(1).randint(0, 10, (2,)).astype("int64")
    with torch.no_grad():
        _close_to_max(tm(torch.from_numpy(x)).numpy(),
                      jm(paddle.to_tensor(x)).numpy(), 1e-4, "logits")
    jstep = paddle.jit.TrainStep(
        jm, jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters()),
        loss_fn=jnn.CrossEntropyLoss())
    tstep = tjit.TrainStep(
        tm, topt.AdamW(learning_rate=1e-3,
                       parameters=list(tm.named_parameters())),
        loss_fn=tnn.CrossEntropyLoss())
    losses = []
    for i in range(3):
        jl = float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)))
        tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        losses.append(tl)
        if i == 0:
            first = export_paddle_tpu_state_dict(tm, expected=init), _state(jm)
    got, want = first
    for k in want:
        if k.endswith("qkv.bias"):      # the key slice: one step at most
            d = want[k].shape[0] // 3
            assert np.abs(got[k][d:2 * d] - want[k][d:2 * d]).max() <= 2e-3
            got[k][d:2 * d] = want[k][d:2 * d]
    assert _update_gap(got, want, init) < 1e-3
    assert losses[-1] < losses[0]
    tm.eval()
    with torch.no_grad():
        a, b = tm(torch.from_numpy(x)), tm(torch.from_numpy(x))
    assert torch.equal(a, b)


def test_resnet18_card_gate_separates_faults(monkeypatch):
    """The gate of the card's ResNet-18 check (``test_torch_port_cuda.py::
    test_resnet18_card_matches_cpu``, ``chip_smoke.py``'s
    ``_resnet18_vs_f64``): one Momentum step's f32 update within 0.1
    (parameters) and 1e-4 (BN running statistics) of a float64 run's,
    over its norm.  On the CPU, at seeds 0 (one ReLU flip between f32 and
    float64) and 1 (none), the f32 update passes it (1.9e-3 and 4e-6),
    and each fault planted in the f32 run alone reads over 5x its limit:
    the update skipped (1), the batch norm's gradients cut from the
    batch statistics (over 1), the running update at torch's momentum
    convention, 0.1 on the old value (8)."""
    import paddle_tpu_torch.nn.functional as tF

    bn = tF.batch_norm

    def cut(x, rm, rv, weight, bias, training=False, momentum=0.9,
            epsilon=1e-5, **kw):
        if not training:
            return bn(x, rm, rv, weight, bias, training, momentum, epsilon,
                      **kw)
        var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            rm.copy_(momentum * rm + (1 - momentum) * mean)
            rv.copy_(momentum * rv + (1 - momentum) * var)
        sh = (1, -1, 1, 1)
        return ((x - mean.view(sh)) * torch.rsqrt(var + epsilon).view(sh)
                * weight.view(sh) + bias.view(sh))

    faults = {
        "clean": None, "skipped": None, "cut_statistics": cut,
        "torch_momentum": lambda *a, momentum=0.9, **kw: bn(
            *a, momentum=1 - momentum, **kw)}
    for seed in (0, 1):
        torch.manual_seed(seed)
        net = tmodels.resnet18(num_classes=10, device="cpu")
        init = {k: v.double() for k, v in net.state_dict().items()}
        rs = np.random.RandomState(seed)
        x = torch.from_numpy(rs.randn(4, 3, 64, 64).astype("float32"))
        y = torch.from_numpy(rs.randint(0, 10, (4,)))
        states = {}
        for tag, fault in [("f64", None)] + list(faults.items()):
            m = copy.deepcopy(net).train()
            if tag == "f64":
                m = m.double()
            monkeypatch.setattr(tF, "batch_norm", fault or bn)
            if tag != "skipped":
                tjit.TrainStep(m, topt.Momentum(
                    learning_rate=0.1, momentum=0.9,
                    parameters=m.parameters(), weight_decay=1e-4),
                    loss_fn=tnn.CrossEntropyLoss())(
                        x.double() if tag == "f64" else x, y)
            monkeypatch.setattr(tF, "batch_norm", bn)
            states[tag] = {k: v.detach().double()
                           for k, v in m.state_dict().items()}
        stats = [k for k in init if k.endswith(("_mean", "_variance"))]
        gaps = {}
        for name, keys in (("params", [k for k in init if k not in stats]),
                           ("stats", stats)):
            update = sum(float(((states["f64"][k] - init[k]) ** 2).sum())
                         for k in keys)
            for tag in faults:
                gaps[tag, name] = (sum(
                    float(((states[tag][k] - states["f64"][k]) ** 2).sum())
                    for k in keys) / update) ** 0.5
        limit = {"params": 0.1, "stats": 1e-4}
        for (tag, name), g in gaps.items():
            if tag == "clean":
                assert g <= limit[name], (seed, tag, name, g)
        for tag, name in (("skipped", "params"), ("skipped", "stats"),
                          ("cut_statistics", "params"),
                          ("torch_momentum", "stats")):
            assert gaps[tag, name] > 5 * limit[name], (seed, tag, name,
                                                       gaps[tag, name])


ZOO = {
    # name: (constructor arguments, input [C, HW]) at the reference tests'
    # sizes (tests/test_vision.py) or the smallest input the net takes
    "LeNet": ("LeNet", {}, (1, 28)),
    "resnet18": ("resnet18", dict(num_classes=7), (3, 32)),
    "resnext50_32x4d": ("resnext50_32x4d", dict(num_classes=7), (3, 32)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=7), (3, 64)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=7), (3, 64)),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(scale=0.5, num_classes=7), (3, 64)),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(scale=0.35, num_classes=7), (3, 64)),
    "squeezenet1_0": ("squeezenet1_0", dict(num_classes=7), (3, 64)),
    "squeezenet1_1": ("squeezenet1_1", dict(num_classes=7), (3, 64)),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", dict(num_classes=7),
                            (3, 64)),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", dict(num_classes=7),
                            (3, 64)),
    "vgg11_bn": ("vgg11", dict(batch_norm=True, num_classes=7), (3, 32)),
    "alexnet": ("alexnet", dict(num_classes=7), (3, 67)),
    "densenet121": ("densenet121", dict(num_classes=7), (3, 32)),
    "googlenet": ("googlenet", dict(num_classes=7), (3, 64)),
    "inception_v3": ("inception_v3", dict(num_classes=7), (3, 75)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_eval_logits_match_jax(name):
    ctor, kw, (c, hw) = ZOO[name]
    paddle.seed(0)
    jm = getattr(jmodels, ctor)(**kw)
    tm = _port_of(jm, getattr(tmodels, ctor), **kw)
    jm.eval()
    tm.eval()
    x = np.random.RandomState(3).rand(2, c, hw, hw).astype("float32")
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = _jax_eval(jm, x)
    assert got.shape == want.shape
    _close_to_max(got, want, 1e-4, name)


def test_vision_namespace():
    tvision.set_image_backend("cv2")
    assert tvision.get_image_backend() == "cv2"
    tvision.set_image_backend("pil")
    with pytest.raises(ValueError):
        tvision.set_image_backend("nope")
    assert set(tmodels.__all__) >= {"ResNet", "resnet50", "vit_b_16",
                                    "VisionTransformer", "LeNet", "GoogLeNet"}
    if not torch.cuda.is_available():   # the card by default, else raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodels.LeNet()
