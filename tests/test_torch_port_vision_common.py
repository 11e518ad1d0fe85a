"""PyTorch port, the rest of ``nn``'s common functionals and layers:
``interpolate`` in every mode against the JAX package's
``jax.image.resize``-backed one, its gradients against ``jax.grad`` of
the reference, pixel (un)shuffle, (un)fold, ``grid_sample`` /
``affine_grid``, ``Bilinear``, the distances, ``label_smooth``,
``sequence_mask``, ``ParamAttr`` and the dropout family (CPU).

Tolerances: f32 results and gradients within 1e-5 (abs) of the
reference's; bf16 ``interpolate`` within 2 bf16 steps (2 x 2^-7
relative) of its magnitude: both packages compute in bf16 with bf16
weights, but XLA keeps excess precision inside a fused expression and
may contract the axes in another order; dropout by its rates (the masks
are torch's draws, not JAX's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.models import (export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

EW = dict(rtol=0, atol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t)
                      .astype(jnp.float32))


def _fwd(jfn):
    """``jfn`` of the reference over jnp arrays, giving its array."""
    return lambda *vs: jfn(*[Tensor(v) for v in vs])._value


def _grad(jfn, r):
    """``jax.grad`` of ``sum(jfn(*vs) * r)`` to every argument."""
    def loss(*vs):
        return jnp.sum(_fwd(jfn)(*vs) * r)

    return lambda *vs: jax.grad(loss, argnums=tuple(range(len(vs))))(*vs)


def _jax_batch(calls):
    """``{key: (fn, arrays)}`` to ``{key: fn(*arrays)}`` (numpy), every
    ``fn`` over jnp arrays traced into one jitted program: the
    reference's eager ops, or one program a case, would each compile."""
    keys = list(calls)
    out = jax.jit(lambda args: [calls[k][0](*a) for k, a in zip(keys, args)])(
        [calls[k][1] for k in keys])
    return {k: jax.tree_util.tree_map(np.asarray, o)
            for k, o in zip(keys, out)}


def _tgrad(tfn, arrays, r):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (tfn(*ts) * torch.from_numpy(r)).sum().backward()
    return [t.grad.numpy() for t in ts]


# -------------------------------------------------------------- interpolate
_FORMATS = {1: ("NCL", (1, 2, 13)), 2: ("NCHW", (1, 2, 13, 7)),
            3: ("NCDHW", (1, 2, 5, 13, 7))}
_MODES = ["nearest", "linear", "bilinear", "trilinear", "bicubic", "area"]
_UP = {1: [25], 2: [25, 15], 3: [9, 25, 15]}
_DOWN = {1: [6], 2: [6, 4], 3: [3, 6, 4]}


def _interp_cases(nsp, mode):
    """The keywords of every case of one mode at one rank: up and down to
    odd sizes, by ``size`` and by ``scale_factor``, ``align_corners``
    both ways."""
    fmt = _FORMATS[nsp][0]
    return [dict(kw, mode=mode, align_corners=ac, data_format=fmt)
            for kw in (dict(size=_UP[nsp]), dict(size=_DOWN[nsp]),
                       dict(scale_factor=1.7),
                       dict(scale_factor=[0.45] * nsp))
            for ac in (False, True)]


_CHANNELS_LAST = _rand(7, 2, 11, 9, 3)
_UPSAMPLE_X = _rand(13, 2, 3, 7, 5)
_UPSAMPLES = [
    lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"),
    lambda nn: nn.UpsamplingBilinear2D(size=[11, 9]),
    lambda nn: nn.UpsamplingNearest2D(scale_factor=3)]


@pytest.fixture(scope="module")
def interp_ref():
    """The reference's ``interpolate`` for every case of this file's
    forward tests (every mode and rank, channels-last, the upsampling
    layers), as one jitted program."""
    calls = {}
    for nsp in _FORMATS:
        x = _rand(nsp, *_FORMATS[nsp][1])
        for mode in _MODES:
            for i, kw in enumerate(_interp_cases(nsp, mode)):
                calls[nsp, mode, i] = (_fwd(
                    lambda v, kw=kw: JF.interpolate(v, **kw)), [x])
    for mode in ("nearest", "bilinear", "bicubic"):
        for size in ([20, 17], [5, 4]):
            calls["NHWC", mode, tuple(size)] = (_fwd(
                lambda v, kw=dict(size=size, mode=mode, data_format="NHWC"):
                JF.interpolate(v, **kw)), [_CHANNELS_LAST])
    for i, make in enumerate(_UPSAMPLES):
        calls["layer", i] = (_fwd(make(jnn)), [_UPSAMPLE_X])
    return _jax_batch(calls)


@pytest.mark.parametrize("nsp", [1, 2, 3])
@pytest.mark.parametrize("mode", _MODES)
def test_interpolate_every_mode_matches_reference(nsp, mode, interp_ref):
    """Every mode at 3-d / 4-d / 5-d, up and down to odd sizes, by
    ``size`` and by ``scale_factor``, ``align_corners`` both ways, f32
    within 1e-5: ``nearest`` is half-pixel (PyTorch's nearest-exact),
    linear / cubic downsampling antialiased (torch has no antialias for
    3-d or 5-d input), ``area`` linear."""
    x = _rand(nsp, *_FORMATS[nsp][1])
    for i, kw in enumerate(_interp_cases(nsp, mode)):
        want = interp_ref[nsp, mode, i]
        got = TF.interpolate(torch.from_numpy(x), **kw).numpy()
        assert got.shape == want.shape, kw
        np.testing.assert_allclose(got, want, err_msg=str(kw), **EW)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_interpolate_channels_last(mode, interp_ref):
    for size in ([20, 17], [5, 4]):
        kw = dict(size=size, mode=mode, data_format="NHWC")
        np.testing.assert_allclose(
            TF.interpolate(torch.from_numpy(_CHANNELS_LAST), **kw).numpy(),
            interp_ref["NHWC", mode, tuple(size)], **EW)


def test_interpolate_bf16_computes_in_bf16():
    """A bf16 input stays bf16 and meets the reference's bf16 result
    within 2 bf16 steps of the output's magnitude."""
    x = _rand(8, 1, 3, 13, 7)
    cases = (("bilinear", [6, 4]), ("bicubic", [25, 15]), ("nearest", [6, 4]))
    want = _jax_batch({mode: (_fwd(lambda v, mode=mode, size=size:
                                   JF.interpolate(v.astype("bfloat16"),
                                                  size=size, mode=mode)
                                   .astype("float32")), [x])
                       for mode, size in cases})
    for mode, size in cases:
        got = TF.interpolate(torch.from_numpy(x).bfloat16(), size=size,
                             mode=mode)
        assert got.dtype == torch.bfloat16
        tol = 2 * 2.0 ** -7 * float(np.abs(want[mode]).max())
        np.testing.assert_allclose(got.float().numpy(), want[mode], rtol=0,
                                   atol=tol, err_msg=mode)


_GRAD_CASES = [
    ("nearest", (1, 2, 9, 7), ([20, 15], [4, 3])),
    ("bilinear", (1, 2, 9, 7), ([20, 15], [4, 3])),
    ("trilinear", (1, 2, 5, 9, 7), ([8, 20, 15], [3, 4, 3]))]


def _interp_grad_cases(mode, sizes):
    return [dict(size=size, mode=mode, align_corners=ac)
            for size in sizes for ac in (False, True)]


@pytest.fixture(scope="module")
def interp_grad_ref():
    """``jax.grad`` of the reference's ``interpolate`` for every case of
    the gradient test, as one jitted program."""
    calls = {}
    for mode, shape, sizes in _GRAD_CASES:
        x = _rand(11, *shape)
        for i, kw in enumerate(_interp_grad_cases(mode, sizes)):
            out = TF.interpolate(torch.from_numpy(x), **kw)
            calls[mode, i] = (_grad(lambda v, kw=kw: JF.interpolate(v, **kw),
                                    _rand(12, *out.shape)), [x])
    return _jax_batch(calls)


@pytest.mark.parametrize("mode,shape,sizes", _GRAD_CASES)
def test_interpolate_gradient_matches_jax_grad(mode, shape, sizes,
                                               interp_grad_ref):
    x = _rand(11, *shape)
    for i, kw in enumerate(_interp_grad_cases(mode, sizes)):
        out = TF.interpolate(torch.from_numpy(x), **kw)
        r = _rand(12, *out.shape)
        tg, = _tgrad(lambda v: TF.interpolate(v, **kw), [x], r)
        jg, = interp_grad_ref[mode, i]
        np.testing.assert_allclose(tg, jg, err_msg=str(kw), **EW)


def test_upsample_layers_match_reference(interp_ref):
    for i, make in enumerate(_UPSAMPLES):
        np.testing.assert_allclose(
            make(tnn)(torch.from_numpy(_UPSAMPLE_X)).numpy(),
            interp_ref["layer", i], **EW)


# ------------------------------------------------------- the other functionals
FUNCTIONAL_CASES = {
    "pixel_shuffle_nchw": (lambda F: lambda v: F.pixel_shuffle(v, 2),
                           [(2, 8, 3, 5)]),
    "pixel_shuffle_nhwc": (lambda F: lambda v: F.pixel_shuffle(
        v, 3, data_format="NHWC"), [(2, 3, 5, 18)]),
    "pixel_unshuffle": (lambda F: lambda v: F.pixel_unshuffle(v, 2),
                        [(2, 3, 6, 4)]),
    "unfold_pad1": (lambda F: lambda v: F.unfold(v, 3, paddings=1),
                    [(2, 3, 7, 6)]),
    "unfold_s2_d2_4pads": (lambda F: lambda v: F.unfold(
        v, [3, 2], strides=2, paddings=[1, 0, 2, 1], dilations=[2, 1]),
        [(1, 2, 9, 8)]),
    "fold": (lambda F: lambda v: F.fold(v, [6, 5], 3, paddings=1),
             [(2, 2 * 9, 30)]),
    "fold_s2": (lambda F: lambda v: F.fold(v, [7, 7], 3, strides=2),
                [(1, 2 * 9, 9)]),
    "bilinear": (lambda F: lambda a, b, w, bb: F.bilinear(a, b, w, bb),
                 [(4, 3), (4, 5), (2, 3, 5), (2,)]),
    "cosine_similarity": (lambda F: lambda a, b: F.cosine_similarity(a, b),
                          [(3, 5, 4), (3, 5, 4)]),
    "cosine_similarity_last": (lambda F: lambda a, b: F.cosine_similarity(
        a, b, axis=-1), [(3, 5), (3, 5)]),
    "pairwise_distance": (lambda F: lambda a, b: F.pairwise_distance(a, b),
                          [(4, 6), (4, 6)]),
    "pairwise_distance_p3_keep": (lambda F: lambda a, b: F.pairwise_distance(
        a, b, p=3.0, keepdim=True), [(4, 6), (4, 6)]),
    "label_smooth": (lambda F: lambda a: F.label_smooth(a, epsilon=0.2),
                     [(3, 5)]),
    "label_smooth_prior": (lambda F: lambda a, p: F.label_smooth(
        a, prior_dist=p), [(3, 5), (1, 5)]),
    "affine_grid": (lambda F: lambda th: F.affine_grid(th, [2, 1, 5, 7]),
                    [(2, 2, 3)]),
    "affine_grid_no_corners": (lambda F: lambda th: F.affine_grid(
        th, [2, 1, 4, 3], align_corners=False), [(2, 2, 3)]),
}


_GRID_X = _rand(40, 2, 3, 6, 5)
_GRID = np.random.RandomState(41).uniform(-1.3, 1.3, (2, 4, 7, 2)) \
    .astype("float32")


def _functional_case(name):
    """``(reference fn, port fn, arrays)`` of a functional or
    ``grid_sample`` case."""
    if name in FUNCTIONAL_CASES:
        make, shapes = FUNCTIONAL_CASES[name]
        return (make(JF), make(TF),
                [_rand(30 + i, *s) for i, s in enumerate(shapes)])
    kw = dict(zip(("padding_mode", "align_corners"), name[1:]))
    return (lambda v, g: JF.grid_sample(v, g, **kw),
            lambda v, g: TF.grid_sample(v, g, **kw), [_GRID_X, _GRID])


_GRID_CASES = [("grid_sample", p, ac) for p in ("zeros", "border")
               for ac in (True, False)]


@pytest.fixture(scope="module")
def functional_ref():
    """The reference's forward and (for a floating output) ``jax.grad``
    of ``sum(f * r)`` for every functional and ``grid_sample`` case, as
    one jitted program."""
    calls = {}
    for name in list(FUNCTIONAL_CASES) + _GRID_CASES:
        jfn, tfn, arrays = _functional_case(name)
        calls[name, "fwd"] = (_fwd(jfn), arrays)
        out = tfn(*[torch.from_numpy(a) for a in arrays])
        if out.is_floating_point():
            calls[name, "grad"] = (_grad(jfn, _rand(20, *out.shape)),
                                   arrays)
    return _jax_batch(calls)


def _fwd_bwd(name, ref):
    _, tfn, arrays = _functional_case(name)
    out = tfn(*[torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(out.numpy(), ref[name, "fwd"], **EW)
    if out.is_floating_point():
        r = _rand(20, *out.shape)
        for jg, tg in zip(ref[name, "grad"], _tgrad(tfn, arrays, r)):
            np.testing.assert_allclose(tg, jg, **EW)


@pytest.mark.parametrize("name", sorted(FUNCTIONAL_CASES))
def test_common_functional_matches_reference(name, functional_ref):
    _fwd_bwd(name, functional_ref)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_reference(padding_mode, align_corners,
                                       functional_ref):
    """The reference's bilinear sampling, gradients to the input and to
    the grid; the grid reaches past [-1, 1] so corners fall outside."""
    _fwd_bwd(("grid_sample", padding_mode, align_corners), functional_ref)


def test_sequence_mask_matches_reference():
    lens = np.array([[3, 0], [5, 2]], np.int64)
    for kw in (dict(), dict(maxlen=7), dict(maxlen=4, dtype="float32")):
        got = TF.sequence_mask(torch.from_numpy(lens), **kw)
        want = JF.sequence_mask(paddle.to_tensor(lens), **kw)
        np.testing.assert_array_equal(got.numpy(), _np(want).astype(
            got.numpy().dtype))
        assert str(got.dtype).split(".")[-1] == kw.get("dtype", "int64")


# ------------------------------------------------------------------ layers
def test_common_layers_with_weights_match_reference():
    """``Bilinear`` (weight ``[out, in1, in2]``, carried across as it is;
    its default init Xavier-uniform over the reference's fans),
    ``PixelShuffle`` / ``Unfold`` / ``Fold`` / ``Unflatten`` /
    ``CosineSimilarity`` / ``PairwiseDistance`` layers (the reference's
    calls as one jitted program)."""
    paddle.seed(0)
    jb = jnn.Bilinear(3, 5, 4)
    tb = tnn.Bilinear(3, 5, 4)
    load_paddle_tpu_state_dict(tb, {k: _np(v) for k, v in
                                    jb.state_dict().items()})
    a, b = _rand(50, 6, 3), _rand(51, 6, 5)
    x = _rand(52, 2, 8, 4, 6)
    cols = _rand(53, 2, 8 * 9, 24)
    u, v = _rand(54, 3, 7), _rand(55, 3, 7)
    unary = ((jnn.PixelShuffle(2), tnn.PixelShuffle(2)),
             (jnn.PixelUnshuffle(2), tnn.PixelUnshuffle(2)),
             (jnn.Unfold(3, paddings=1), tnn.Unfold(3, paddings=1)),
             (jnn.Unflatten(1, [2, 4]), tnn.Unflatten(1, [2, 4])))
    binary = ((jnn.CosineSimilarity(axis=1), tnn.CosineSimilarity(1)),
              (jnn.PairwiseDistance(p=1.0), tnn.PairwiseDistance(1.0)))
    calls = {"bilinear": (_fwd(jb), [a, b]),
             "fold": (_fwd(jnn.Fold([4, 6], 3, paddings=1)), [cols])}
    calls.update({("unary", i): (_fwd(jl), [x])
                  for i, (jl, _) in enumerate(unary)})
    calls.update({("binary", i): (_fwd(jl), [u, v])
                  for i, (jl, _) in enumerate(binary)})
    want = _jax_batch(calls)
    np.testing.assert_allclose(
        tb(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(),
        want["bilinear"], **EW)
    assert list(export_paddle_tpu_state_dict(tb)) == ["weight", "bias"]
    fan_in, fan_out = 3 * 5, 4 * 5
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    w = tnn.Bilinear(30, 50, 40).weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.9 * np.sqrt(
        6.0 / (30 * 50 + 40 * 50))
    assert tnn.Bilinear(3, 5, 4, bias_attr=False).bias is None
    for i, (_, tl) in enumerate(unary):
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                                   want["unary", i], **EW)
    np.testing.assert_allclose(
        tnn.Fold([4, 6], 3, paddings=1)(torch.from_numpy(cols)).numpy(),
        want["fold"], **EW)
    for i, (_, tl) in enumerate(binary):
        np.testing.assert_allclose(
            tl(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
            want["binary", i], **EW)


def test_param_attr_and_linear_initializer():
    """``nn.ParamAttr(initializer=...)`` draws a ``Linear``'s weight in
    paddle's ``[in, out]`` layout and its bias; ``bias_attr=False`` drops
    the bias; the regularizers are the reference's formulas."""
    from paddle_tpu_torch.nn import initializer as I

    torch.manual_seed(0)
    lin = tnn.Linear(200, 300, weight_attr=tnn.ParamAttr(
        initializer=I.Normal(0.0, 0.01)), bias_attr=tnn.ParamAttr(
        initializer=I.Constant(0.5)))
    assert tuple(lin.weight.shape) == (300, 200)
    assert abs(float(lin.weight.std()) - 0.01) < 1e-3
    assert torch.equal(lin.bias, torch.full((300,), 0.5))
    assert tnn.Linear(4, 5, bias_attr=False).bias is None
    conv = tnn.Conv2D(3, 4, 3, weight_attr=tnn.ParamAttr(
        initializer=I.Constant(0.25)))
    assert torch.equal(conv.weight, torch.full((4, 3, 3, 3), 0.25))
    p = _rand(60, 5)
    for name in ("L1Decay", "L2Decay"):
        np.testing.assert_allclose(
            getattr(tnn, name)(0.1)(torch.from_numpy(p)).numpy(),
            _np(getattr(jnn.param_attr, name)(0.1)(jnp.asarray(p))), **EW)


# ------------------------------------------------------------------ dropout
DROPOUTS = {
    "dropout2d": (lambda x, g: TF.dropout2d(x, 0.3, generator=g), (1,)),
    "dropout3d": (lambda x, g: TF.dropout3d(x.unsqueeze(-1), 0.3,
                                            generator=g), (1,)),
    "Dropout1D": (lambda x, g: tnn.Dropout1D(0.3, generator=g)(
        x.flatten(2)), (1,)),
    "Dropout2D_nhwc": (lambda x, g: tnn.Dropout2D(
        0.3, data_format="NHWC", generator=g)(x.permute(0, 2, 3, 1)), (3,)),
    "Dropout3D": (lambda x, g: tnn.Dropout3D(0.3, generator=g)(
        x.unsqueeze(-1)), (1,)),
    "alpha_dropout": (lambda x, g: TF.alpha_dropout(x, 0.3, generator=g),
                      None),
    "AlphaDropout": (lambda x, g: tnn.AlphaDropout(0.3, generator=g)(x),
                     None),
    "FeatureAlphaDropout": (lambda x, g: tnn.FeatureAlphaDropout(
        0.3, generator=g)(x), (1,)),
}


@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_dropout_family_rates_and_eval_identity(name):
    """The drop rate 0.3 (within 4 sigma over the draws), one draw per
    channel where the reference shares the mask along the spatial dims,
    the reference's SELU constants for the alpha variants (the dropped
    value and the mean / variance), an explicit generator reproducing
    its mask, and the identity in eval mode (bit for bit)."""
    fn, chan_axis = DROPOUTS[name]
    x = torch.from_numpy(np.abs(_rand(70, 64, 32, 6, 5)) + 0.5)
    out = fn(x, torch.Generator().manual_seed(0))
    again = fn(x, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    alpha = name.lower().endswith("alphadropout") or \
        name == "alpha_dropout"
    if alpha:
        a_prime = -1.6732632423543772 * 1.0507009873554805
        a = ((1 - 0.3) * (1 + 0.3 * a_prime ** 2)) ** -0.5
        b = -a * a_prime * 0.3
        dropped = torch.isclose(out, torch.tensor(a * a_prime + b))
    else:
        dropped = out == 0
        kept = ~dropped
        ref = x if out.shape == x.shape else None
        if ref is not None:
            torch.testing.assert_close(out[kept], ref[kept] / 0.7)
    rate = float(dropped.float().mean())
    n = dropped.numel() if chan_axis is None else 64 * 32
    assert abs(rate - 0.3) < 4 * np.sqrt(0.3 * 0.7 / n), rate
    if chan_axis is not None:       # whole channels share one draw
        per = dropped.movedim(chan_axis[0], 1).flatten(2)
        assert bool((per.all(-1) | (~per).all(-1)).all())
    mod_eval = {"Dropout1D": tnn.Dropout1D(0.3), "Dropout3D":
                tnn.Dropout3D(0.3), "AlphaDropout": tnn.AlphaDropout(0.3),
                "FeatureAlphaDropout": tnn.FeatureAlphaDropout(0.3),
                "Dropout2D_nhwc": tnn.Dropout2D(0.3)}.get(name)
    if mod_eval is not None:
        assert mod_eval.eval()(x) is x
    assert TF.dropout2d(x, 0.3, training=False) is x
    assert TF.alpha_dropout(x, 0.3, training=False) is x
    assert TF.dropout3d(x, 0.0) is x
