"""PyTorch port, the vision half of ``nn``: convolutions, pooling, the
norms, the activation layers, the common layers and the containers,
``hapi.flops`` over convolutions and QAT over a conv net, each against the
JAX package on the same numpy inputs (CPU).

Tolerances: elementwise f32 results within 1e-5 (abs) of the reference's;
convolution sums and their gradients within rtol 1e-4 / atol 1e-5 (the
product's summation order is PyTorch's, not XLA's); bf16 results within
one bf16 step of their magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import quantization as jquant
from paddle_tpu_torch import flops as tflops
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.models import (export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

EW = dict(rtol=0, atol=1e-5)            # elementwise f32
SUM = dict(rtol=1e-4, atol=1e-5)        # convolution sums


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t)
                      .astype(jnp.float32))


def _pair(*arrays):
    """Each array as a JAX tensor and a torch tensor, both needing grads."""
    j = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return j, t


def _check_fwd_bwd(jfn, tfn, arrays, tol, seed=99):
    """Forward and the gradients of ``sum(out * r)`` (``r`` random) for
    every input, both packages."""
    (j, t) = _pair(*arrays)
    jo, to = jfn(*j), tfn(*t)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    r = _rand(seed, *tuple(to.shape))
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    for jj, tt in zip(j, t):
        np.testing.assert_allclose(_np(tt.grad), _np(jj.grad), **tol)


# ------------------------------------------------------------ convolutions
CONV_CASES = {
    "2d_pad1": (2, (2, 3, 9, 9), (4, 3, 3, 3), dict(padding=1)),
    "2d_same_s2_odd": (2, (2, 3, 11, 13), (4, 3, 3, 3),
                       dict(padding="SAME", stride=2)),
    "2d_same_dil2": (2, (2, 3, 10, 9), (4, 3, 3, 3),
                     dict(padding="same", dilation=2)),
    "2d_same_k4_s3": (2, (1, 2, 10, 11), (3, 2, 4, 4),
                      dict(padding="SAME", stride=3)),
    "2d_valid": (2, (2, 3, 9, 8), (4, 3, 3, 2), dict(padding="VALID")),
    "2d_per_dim": (2, (2, 3, 9, 8), (4, 3, 3, 3), dict(padding=[1, 2])),
    "2d_2n_list": (2, (2, 3, 9, 8), (4, 3, 3, 3),
                   dict(padding=[0, 1, 2, 0], stride=2)),
    "2d_nested": (2, (2, 3, 9, 8), (4, 3, 3, 3),
                  dict(padding=[[1, 0], [0, 2]])),
    "1d_nested_nc": (1, (2, 3, 17), (5, 3, 4),
                     dict(padding=[[0, 0], [0, 0], [1, 2]])),
    "2d_groups_dil": (2, (2, 4, 12, 12), (6, 2, 3, 3),
                      dict(padding=2, dilation=2, groups=2)),
    "2d_depthwise_s2": (2, (2, 4, 9, 9), (4, 1, 3, 3),
                        dict(padding=1, stride=2, groups=4)),
    "2d_nhwc": (2, (2, 9, 8, 3), (4, 3, 3, 3),
                dict(padding=1, stride=2, data_format="NHWC")),
    "2d_nhwc_same": (2, (2, 9, 8, 3), (4, 3, 3, 3),
                     dict(padding="SAME", stride=2, data_format="NHWC")),
    "1d": (1, (2, 3, 17), (5, 3, 4), dict(padding=2, stride=3)),
    "1d_nlc_same": (1, (2, 17, 3), (5, 3, 4),
                    dict(padding="SAME", stride=2, data_format="NLC")),
    "3d": (3, (1, 2, 6, 7, 5), (3, 2, 3, 3, 2),
           dict(padding=[1, 0, 1], stride=[1, 2, 1])),
    "3d_ndhwc_same": (3, (1, 6, 7, 5, 2), (3, 2, 3, 3, 2),
                      dict(padding="SAME", stride=2, data_format="NDHWC")),
}


NO_BIAS = ("2d_pad1", "2d_same_s2_odd", "2d_depthwise_s2", "1d")


@pytest.mark.parametrize("case", list(CONV_CASES)
                         + [c + "_nobias" for c in NO_BIAS])
def test_conv_forms_match_jax(case):
    """Forward and the gradients of input, weight and bias (one bias-free
    case per kind of padding)."""
    n, xs, ws, kw = CONV_CASES[case.replace("_nobias", "")]
    name = f"conv{n}d"
    arrays = [_rand(1, *xs), _rand(2, *ws, scale=0.3)]
    if not case.endswith("_nobias"):
        arrays.append(_rand(3, ws[0]))
    jf, tf = getattr(JF, name), getattr(TF, name)

    def jfn(x, w, b=None):
        return jf(x, w, b, **kw)

    def tfn(x, w, b=None):
        return tf(x, w, b, **kw)

    _check_fwd_bwd(jfn, tfn, arrays, SUM)


CONV_T_CASES = {
    "2d_s2_opad": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                   dict(stride=2, padding=1, output_padding=1)),
    "2d_groups": (2, (2, 4, 5, 5), (4, 2, 3, 3),
                  dict(stride=2, padding=1, groups=2)),
    "2d_dil": (2, (1, 3, 5, 5), (3, 2, 3, 3), dict(stride=1, dilation=2)),
    "2d_output_size": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                       dict(stride=2, padding=1, output_size=[10, 12])),
    "2d_same": (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding="SAME")),
    "2d_valid": (2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding="VALID")),
    "2d_uneven": (2, (2, 4, 5, 6), (4, 3, 3, 3),
                  dict(stride=2, padding=[0, 1, 1, 0], output_padding=1)),
    "2d_nhwc": (2, (2, 5, 6, 4), (4, 3, 3, 3),
                dict(stride=2, padding=1, output_padding=1,
                     data_format="NHWC")),
    "1d": (1, (2, 3, 7), (3, 4, 3), dict(stride=3, padding=1,
                                          output_padding=2)),
    "3d": (3, (1, 2, 3, 4, 3), (2, 3, 2, 3, 2), dict(stride=2, padding=1)),
}


@pytest.mark.parametrize("case", list(CONV_T_CASES))
def test_conv_transpose_forms_match_jax(case):
    n, xs, ws, kw = CONV_T_CASES[case]
    name = f"conv{n}d_transpose"
    arrays = [_rand(4, *xs), _rand(5, *ws, scale=0.3),
              _rand(6, ws[1] * kw.get("groups", 1))]
    jf, tf = getattr(JF, name), getattr(TF, name)
    _check_fwd_bwd(lambda x, w, b: jf(x, w, b, **kw),
                   lambda x, w, b: tf(x, w, b, **kw), arrays, SUM)


def test_conv_transpose_bad_output_size_raises():
    x, w = torch.zeros(1, 2, 5, 5), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="output_padding"):
        TF.conv2d_transpose(x, w, stride=2, padding=1, output_size=[13, 13])


def test_conv_casts_input_to_weight_dtype_and_amp_white_list():
    """A bf16 weight convolves an f32 input in bf16 (the input is cast to
    the weight's dtype, not promoted), as in the reference; under O1 the
    conv runs in the amp dtype."""
    x, w = _rand(7, 2, 3, 8, 8), _rand(8, 4, 3, 3, 3, scale=0.3)
    jw = paddle.to_tensor(w).astype("bfloat16")
    tw = torch.from_numpy(w).bfloat16()
    jo = JF.conv2d(paddle.to_tensor(x), jw, padding=1)
    to = TF.conv2d(torch.from_numpy(x), tw, padding=1)
    assert to.dtype == torch.bfloat16 and str(jo.dtype).endswith("bfloat16")
    np.testing.assert_allclose(_np(to), _np(jo), rtol=2e-2, atol=2e-2)
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O1"):
        assert TF.conv2d(torch.from_numpy(x), torch.from_numpy(w)).dtype \
            == torch.bfloat16


# ------------------------------------------------------------------ pooling
POOL_CASES = {
    "max2d": ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3, stride=2,
                                               padding=1)),
    "max2d_ceil": ("max_pool2d", (2, 3, 10, 9),
                   dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max2d_ceil_pad": ("max_pool2d", (2, 3, 8, 8),
                       dict(kernel_size=2, stride=2, padding=1,
                            ceil_mode=True)),
    "max2d_same": ("max_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "max2d_uneven": ("max_pool2d", (2, 3, 9, 8),
                     dict(kernel_size=3, stride=2, padding=[0, 1, 1, 0])),
    "max2d_nhwc": ("max_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             ceil_mode=True)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                                  padding=1)),
    "avg2d_excl": ("avg_pool2d", (2, 3, 9, 9),
                   dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_incl": ("avg_pool2d", (2, 3, 9, 9),
                   dict(kernel_size=3, stride=2, padding=1,
                        exclusive=False)),
    "avg2d_ceil_excl": ("avg_pool2d", (2, 3, 10, 9),
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    "avg2d_ceil_incl": ("avg_pool2d", (2, 3, 10, 9),
                        dict(kernel_size=3, stride=2, ceil_mode=True,
                             exclusive=False)),
    "avg2d_same": ("avg_pool2d", (2, 3, 9, 8),
                   dict(kernel_size=3, stride=2, padding="SAME")),
    "avg2d_same_ceil": ("avg_pool2d", (2, 3, 9, 8),
                        dict(kernel_size=3, stride=2, padding="SAME",
                             ceil_mode=True)),
    "avg2d_divisor": ("avg_pool2d", (2, 3, 8, 8),
                      dict(kernel_size=2, stride=2, divisor_override=3)),
    "avg2d_s1_inception": ("avg_pool2d", (2, 3, 7, 7),
                           dict(kernel_size=3, stride=1, padding=1)),
    "avg2d_nhwc": ("avg_pool2d", (2, 9, 9, 3),
                   dict(kernel_size=3, stride=2, padding=1,
                        data_format="NHWC")),
    "avg1d": ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2,
                                             padding=1, ceil_mode=True)),
    "avg3d": ("avg_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2,
                                                  padding=1)),
    "lp2d_p2": ("lp_pool2d", (2, 3, 8, 9), dict(norm_type=2, kernel_size=3,
                                                stride=2)),
    "lp2d_p3_ceil": ("lp_pool2d", (2, 3, 8, 9),
                     dict(norm_type=3, kernel_size=2, stride=2,
                          ceil_mode=True)),
    "lp1d_inf": ("lp_pool1d", (2, 3, 9), dict(norm_type=float("inf"),
                                             kernel_size=3, stride=2)),
    "adaptive_avg2d_uneven": ("adaptive_avg_pool2d", (2, 3, 10, 7),
                              dict(output_size=(3, 4))),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", (2, 10, 7, 3),
                            dict(output_size=3, data_format="NHWC")),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 11),
                       dict(output_size=4)),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 7, 6),
                       dict(output_size=(2, 3, 4))),
    "adaptive_max2d_uneven": ("adaptive_max_pool2d", (2, 3, 10, 7),
                              dict(output_size=(3, 4))),
    "adaptive_max1d": ("adaptive_max_pool1d", (2, 3, 11),
                       dict(output_size=4)),
    "adaptive_max3d": ("adaptive_max_pool3d", (1, 2, 5, 7, 6),
                       dict(output_size=(2, 3, 4))),
    "fractional2d": ("fractional_max_pool2d", (2, 3, 11, 9),
                     dict(output_size=(7, 5), random_u=0.3)),
    "fractional3d": ("fractional_max_pool3d", (1, 2, 7, 6, 9),
                     dict(output_size=(4, 5, 6), random_u=0.71)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_jax(case):
    """Forward and gradient (random data: no ties in a max window)."""
    name, xs, kw = POOL_CASES[case]
    x = _rand(10, *xs)
    if name.startswith("lp_pool"):
        x = np.abs(x) + 0.1
    _check_fwd_bwd(lambda v: getattr(JF, name)(v, **kw),
                   lambda v: getattr(TF, name)(v, **kw), [x], EW)


def test_max_pool_gradient_goes_to_the_first_tie():
    """ReLU zeros tie in a max window: the gradient goes to the first
    maximum of each window, as the reference's select-and-scatter."""
    x = np.maximum(_rand(11, 2, 3, 8, 8), 0.0)
    x[:, :, :4, :4] = 0.0
    _check_fwd_bwd(lambda v: JF.max_pool2d(v, 3, 2, 1),
                   lambda v: TF.max_pool2d(v, 3, 2, 1), [x], EW)


@pytest.mark.parametrize("n,xs,kw", [
    (2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    (2, (2, 3, 10, 9), dict(kernel_size=3, stride=2, ceil_mode=True)),
    (1, (2, 3, 11), dict(kernel_size=2, stride=2)),
    (3, (1, 2, 4, 6, 5), dict(kernel_size=2, stride=2)),
], ids=["2d_pad", "2d_ceil", "1d", "3d"])
def test_return_mask_and_unpool_match_jax(n, xs, kw):
    x = _rand(12, *xs)
    jo, jm = getattr(JF, f"max_pool{n}d")(paddle.to_tensor(x), **kw,
                                         return_mask=True)
    to, tm = getattr(TF, f"max_pool{n}d")(torch.from_numpy(x), **kw,
                                         return_mask=True)
    np.testing.assert_array_equal(_np(to), _np(jo))
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm._value))
    ukw = {k: v for k, v in kw.items() if k != "ceil_mode"}
    size = list(xs)
    ju = getattr(JF, f"max_unpool{n}d")(jo, jm, output_size=size, **ukw)
    tu = getattr(TF, f"max_unpool{n}d")(to, tm, output_size=size, **ukw)
    np.testing.assert_array_equal(_np(tu), _np(ju))
    with pytest.raises(ValueError, match="string padding"):
        getattr(TF, f"max_unpool{n}d")(to, tm, kw["kernel_size"],
                                        padding="SAME")


def test_fractional_pool_draw_and_checks():
    x = torch.from_numpy(_rand(13, 1, 2, 9, 9))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = TF.fractional_max_pool2d(x, 5, generator=g1)
    b = tnn.FractionalMaxPool2D(5, generator=g2)(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="random_u"):
        TF.fractional_max_pool2d(x, 5, random_u=1.5)
    with pytest.raises(NotImplementedError):
        TF.fractional_max_pool2d(x, 5, kernel_size=2, random_u=0.5)
    with pytest.raises(ValueError, match="exceeds"):
        TF.fractional_max_pool2d(x, 10, random_u=0.5)


# ------------------------------------------------------------- batch norm
BN_CASES = {
    "nchw": ((4, 3, 5, 6), "NCHW"),
    "nhwc": ((4, 5, 6, 3), "NHWC"),
    "ncl": ((4, 3, 7), "NCL"),
    "nc": ((8, 3), "NCHW"),
    "ncdhw": ((2, 3, 3, 4, 5), "NCDHW"),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batch_norm_train_eval_running_stats_and_grads(case):
    """Three training calls (output, the gradients of x, weight and bias,
    and the running statistics after each), then eval, then
    ``use_global_stats`` in training (no update)."""
    shape, fmt = BN_CASES[case]
    c = shape[-1] if fmt == "NHWC" else shape[1]
    w, b = _rand(20, c) * 0.5 + 1.0, _rand(21, c)
    jrm, jrv = paddle.to_tensor(np.zeros(c, "float32")), \
        paddle.to_tensor(np.ones(c, "float32"))
    trm, trv = torch.zeros(c), torch.ones(c)
    for i in range(3):
        x = _rand(22 + i, *shape) * 2.0 + 0.5
        _check_fwd_bwd(
            lambda v, ww, bb: JF.batch_norm(v, jrm, jrv, ww, bb, training=True,
                                            data_format=fmt),
            lambda v, ww, bb: TF.batch_norm(v, trm, trv, ww, bb, training=True,
                                            data_format=fmt),
            [x, w, b], EW)
        np.testing.assert_allclose(trm.numpy(), _np(jrm), **EW)
        np.testing.assert_allclose(trv.numpy(), _np(jrv), **EW)
    x = _rand(30, *shape)
    for kw in (dict(training=False), dict(training=True,
                                          use_global_stats=True)):
        jo = JF.batch_norm(paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(w),
                           paddle.to_tensor(b), data_format=fmt, **kw)
        to = TF.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                           torch.from_numpy(b), data_format=fmt, **kw)
        np.testing.assert_allclose(to.numpy(), _np(jo), **EW)
    np.testing.assert_allclose(trm.numpy(), _np(jrm), **EW)


def test_batch_norm_bf16_rounds_as_the_reference():
    """bf16 activations: float32 statistics, one scale-and-shift in bf16;
    the output equals the reference's within one bf16 step and the
    running statistics stay float32 (equal to the reference's)."""
    x = _rand(31, 8, 4, 6, 6) * 3.0 + 1.0
    w, b = _rand(32, 4) + 1.0, _rand(33, 4)
    jx = paddle.to_tensor(x).astype("bfloat16")
    tx = torch.from_numpy(x).bfloat16()
    jrm, jrv = paddle.to_tensor(np.zeros(4, "float32")), \
        paddle.to_tensor(np.ones(4, "float32"))
    trm, trv = torch.zeros(4), torch.ones(4)
    jo = JF.batch_norm(jx, jrm, jrv, paddle.to_tensor(w).astype("bfloat16"),
                       paddle.to_tensor(b).astype("bfloat16"), training=True)
    to = TF.batch_norm(tx, trm, trv, torch.from_numpy(w).bfloat16(),
                       torch.from_numpy(b).bfloat16(), training=True)
    assert to.dtype == torch.bfloat16
    want = _np(jo)
    step = 2.0 ** -7 * np.maximum(np.abs(want), 1.0)
    assert np.all(np.abs(_np(to) - want) <= step)
    assert trm.dtype == torch.float32 and trv.dtype == torch.float32
    np.testing.assert_allclose(trm.numpy(), _np(jrm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), _np(jrv), rtol=1e-6, atol=1e-6)


def test_batch_norm_layers_state_dict_and_convert_sync():
    """The buffers are ``_mean`` / ``_variance`` (no
    ``num_batches_tracked``); the layers' keys equal the reference's; a
    training forward of the layer updates them as the functional does;
    ``SyncBatchNorm.convert_sync_batchnorm`` keeps weights and stats."""
    cases = [(jnn.BatchNorm2D(3), tnn.BatchNorm2D(3)),
             (jnn.BatchNorm1D(3), tnn.BatchNorm1D(3)),
             (jnn.BatchNorm3D(3), tnn.BatchNorm3D(3)),
             (jnn.BatchNorm(3, act="relu"), tnn.BatchNorm(3, act="relu")),
             (jnn.BatchNorm2D(3, weight_attr=False, bias_attr=False),
              tnn.BatchNorm2D(3, weight_attr=False, bias_attr=False))]
    shapes = [(4, 3, 5, 5), (4, 3, 6), (2, 3, 3, 3, 3), (4, 3, 5, 5),
              (4, 3, 5, 5)]
    for (jl, tl), shape in zip(cases, shapes):
        assert list(tl.state_dict()) == list(jl.state_dict())
        x = _rand(40, *shape)
        jo, to = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
        np.testing.assert_allclose(_np(to), _np(jo), **EW)
        for k, v in export_paddle_tpu_state_dict(tl).items():
            np.testing.assert_allclose(v, _np(jl.state_dict()[k]), **EW)
    seq = tnn.Sequential(tnn.Conv2D(3, 3, 1), tnn.BatchNorm2D(3))
    seq(torch.from_numpy(_rand(41, 4, 3, 5, 5)))
    before = {k: v.clone() for k, v in seq.state_dict().items()}
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    for k, v in out.state_dict().items():
        assert torch.equal(v, before[k])


NORM_CASES = {
    "group_norm": (lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
                   (2, 4, 5, 6), 4),
    "group_norm_nhwc": (lambda F, x, w, b: F.group_norm(
        x, 2, 1e-5, w, b, data_format="NHWC"), (2, 5, 6, 4), 4),
    "instance_norm": (lambda F, x, w, b: F.instance_norm(x, weight=w, bias=b),
                      (2, 3, 5, 6), 3),
    "layer_norm": (lambda F, x, w, b: F.layer_norm(x, [5, 6], w, b),
                   (2, 3, 5, 6), (5, 6)),
    "normalize": (lambda F, x, w, b: F.normalize(x * w + b, p=3, axis=1),
                  (2, 3, 5), 5),
    "local_response_norm": (lambda F, x, w, b: F.local_response_norm(
        x * w + b, 3, alpha=0.1, beta=0.75, k=2.0), (2, 6, 4, 5), 5),
    "local_response_norm_even": (lambda F, x, w, b: F.local_response_norm(
        x * w + b, 4), (2, 6, 4, 5), 5),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_other_norms_match_jax(case):
    fn, xs, ws = NORM_CASES[case]
    ws = (ws,) if isinstance(ws, int) else ws
    arrays = [_rand(50, *xs) * 2 + 0.3, _rand(51, *ws) * 0.3 + 1.0,
              _rand(52, *ws)]
    _check_fwd_bwd(lambda *a: fn(JF, *a), lambda *a: fn(TF, *a), arrays,
                   dict(rtol=1e-5, atol=1e-5))


def test_norm_layers_state_dicts_and_outputs_match_jax():
    pairs = [
        (jnn.GroupNorm(2, 4), tnn.GroupNorm(2, 4), (2, 4, 3, 3)),
        (jnn.InstanceNorm2D(3), tnn.InstanceNorm2D(3), (2, 3, 4, 4)),
        (jnn.InstanceNorm1D(3, weight_attr=False),
         tnn.InstanceNorm1D(3, weight_attr=False), (2, 3, 6)),
        (jnn.LocalResponseNorm(3), tnn.LocalResponseNorm(3), (2, 5, 3, 3)),
        (jnn.LayerNorm(6), tnn.LayerNorm(6), (2, 3, 6)),
    ]
    for jl, tl, shape in pairs:
        assert list(tl.state_dict()) == list(jl.state_dict())
        x = _rand(53, *shape)
        np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                                   _np(jl(paddle.to_tensor(x))), **EW)


# -------------------------------------------------------------- activations
ACT_LAYERS = [
    ("ReLU", ()), ("ReLU6", ()), ("ELU", (0.7,)), ("SELU", ()),
    ("CELU", (1.3,)), ("GELU", ()), ("GELU", (True,)), ("LeakyReLU", (0.2,)),
    ("Sigmoid", ()), ("Hardsigmoid", ()), ("Hardswish", ()),
    ("Hardtanh", (-0.5, 0.7)), ("Hardshrink", (0.4,)), ("Softshrink", (0.3,)),
    ("LogSigmoid", ()), ("Softplus", (2.0, 3.0)), ("Softsign", ()),
    ("Swish", ()), ("Silu", ()), ("Mish", ()), ("Tanh", ()),
    ("Tanhshrink", ()), ("ThresholdedReLU", (0.5,)), ("Softmax", (1,)),
    ("LogSoftmax", (-1,)), ("Maxout", (2,)), ("GLU", (1,)), ("Softmax2D", ()),
    ("PReLU", ()), ("PReLU", (4, 0.1)),
]


@pytest.mark.parametrize("name,args", ACT_LAYERS,
                         ids=[f"{n}{len(a)}" for n, a in ACT_LAYERS])
def test_activation_layers_match_jax(name, args):
    x = _rand(60, 2, 4, 3, 5) * 3.0
    jl, tl = getattr(jnn, name)(*args), getattr(tnn, name)(*args)
    assert list(tl.state_dict()) == list(jl.state_dict())
    _check_fwd_bwd(lambda v: jl(v), lambda v: tl(v), [x], EW)


def test_random_activations():
    """``rrelu`` outside training equals the reference; in training its
    slopes lie in [lower, upper) and come from the generator given;
    ``gumbel_softmax`` rows sum to 1 and ``hard`` is one-hot."""
    x = _rand(61, 4, 50)
    np.testing.assert_allclose(
        TF.rrelu(torch.from_numpy(x), training=False).numpy(),
        _np(JF.rrelu(paddle.to_tensor(x), training=False)), **EW)
    g = torch.Generator().manual_seed(1)
    y = TF.rrelu(torch.from_numpy(x), 0.1, 0.3, generator=g).numpy()
    neg = x < 0
    assert np.all(y[~neg] == x[~neg])
    slope = y[neg] / x[neg]
    assert slope.min() >= 0.1 - 1e-6 and slope.max() < 0.3 + 1e-6
    g2 = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(
        tnn.RReLU(0.1, 0.3, generator=g2)(torch.from_numpy(x)).numpy(), y)
    g3 = torch.Generator().manual_seed(2)
    s = TF.gumbel_softmax(torch.from_numpy(x), 0.5, generator=g3)
    np.testing.assert_allclose(s.sum(-1).numpy(), 1.0, atol=1e-5)
    # hard: the one-hot of the argmax in value (``y_hard + y - y``, exact
    # up to one rounding), the soft sample's gradient
    g3.manual_seed(2)
    xt = torch.from_numpy(x).requires_grad_()
    h = TF.gumbel_softmax(xt, 0.5, hard=True, generator=g3)
    onehot = np.eye(50, dtype="float32")[s.argmax(-1).numpy()]
    np.testing.assert_allclose(h.detach().numpy(), onehot, atol=1e-6)
    (h * torch.from_numpy(_rand(62, 4, 50))).sum().backward()
    assert float(xt.grad.abs().max()) > 0


# ------------------------------------------------------- common + containers
@pytest.mark.parametrize("pad,mode,fmt,shape", [
    ([1, 2], "constant", "NCL", (2, 3, 5)),
    ([1, 2, 0, 3], "constant", "NCHW", (2, 3, 4, 5)),
    ([1, 2, 0, 3], "constant", "NHWC", (2, 4, 5, 3)),
    ([1, 0, 2, 1, 1, 1], "constant", "NCDHW", (1, 2, 3, 4, 5)),
    ([0, 0, 1, 1, 2, 0, 1, 2], "constant", "NCHW", (2, 3, 4, 5)),
    ([1, 2, 2, 1], "reflect", "NCHW", (2, 3, 4, 5)),
    ([1, 2, 2, 1], "replicate", "NHWC", (2, 4, 5, 3)),
    ([1, 2], "circular", "NCL", (2, 3, 5)),
], ids=["1d", "2d", "2d_nhwc", "3d", "full", "reflect", "replicate_nhwc",
        "circular"])
def test_pad_matches_jax(pad, mode, fmt, shape):
    x = _rand(70, *shape)
    _check_fwd_bwd(lambda v: JF.pad(v, pad, mode, 0.5, fmt),
                   lambda v: TF.pad(v, pad, mode, 0.5, fmt), [x], EW)


def test_common_layers_match_jax():
    x = _rand(71, 2, 4, 3, 5)
    for jl, tl in [(jnn.Identity(), tnn.Identity()),
                   (jnn.Flatten(), tnn.Flatten()),
                   (jnn.Flatten(0, 2), tnn.Flatten(0, 2)),
                   (jnn.ChannelShuffle(2), tnn.ChannelShuffle(2)),
                   (jnn.Pad2D([1, 0, 2, 1], value=1.5),
                    tnn.Pad2D([1, 0, 2, 1], value=1.5)),
                   (jnn.ZeroPad2D([1, 1, 0, 2]), tnn.ZeroPad2D([1, 1, 0, 2])),
                   (jnn.Pad3D([1, 1, 0, 0, 1, 0], mode="replicate"),
                    tnn.Pad3D([1, 1, 0, 0, 1, 0], mode="replicate"))]:
        xx = x[:, :, None] if isinstance(tl, tnn.Pad3D) else x
        np.testing.assert_allclose(_np(tl(torch.from_numpy(xx))),
                                   _np(jl(paddle.to_tensor(xx))), **EW)
    w, b = _rand(72, 5, 7), _rand(73, 7)
    _check_fwd_bwd(JF.linear, TF.linear, [x, w, b], SUM)


def test_containers_keep_paddle_names():
    """Sub-layers named ``"0"``, ``"1"``, ... or as given (tuples, a list of
    pairs): the state-dict keys equal the reference's."""
    def build(nn):
        return nn.Sequential(
            nn.Sequential(("conv", nn.Conv2D(3, 4, 3)), ("bn",
                                                        nn.BatchNorm2D(4))),
            nn.Sequential([("a", nn.ReLU()), ("b", nn.Conv2D(4, 2, 1))]),
            nn.LayerList([nn.Linear(2, 2), nn.Linear(2, 3)]))
    jm, tm = build(jnn), build(tnn)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert len(tm) == 3 and isinstance(tm[1:], tnn.Sequential)
    ll = tnn.LayerList([tnn.ReLU()])
    ll.append(tnn.Tanh())
    ll.insert(0, tnn.Sigmoid())
    assert [type(m).__name__ for m in ll] == ["Sigmoid", "ReLU", "Tanh"]
    d = tnn.LayerDict({"x": tnn.ReLU()})
    d["y"] = tnn.Tanh()
    assert list(d.keys()) == ["x", "y"] and "y" in d
    pl = tnn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    assert list(dict(pl.named_parameters())) == ["0"]


# --------------------------------------------------------- flops and QAT
def test_flops_counts_convolutions_as_the_reference():
    """``hapi.flops`` of a conv + ReLU + Linear net (padding, stride,
    groups, a transposed conv) equals the reference's XLA count."""
    def build(nn):
        return nn.Sequential(
            nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
            nn.Conv2D(8, 8, 3, stride=2, padding=1, groups=2), nn.ReLU(),
            nn.Conv2DTranspose(8, 4, 3, stride=2, padding=1,
                               output_padding=1, bias_attr=False),
            nn.ReLU(), nn.Conv2D(4, 4, 5, bias_attr=False),
            nn.Flatten(), nn.Linear(4 * 12 * 12, 10))
    jm, tm = build(jnn), build(tnn)
    want = paddle.flops(jm, [2, 3, 16, 16])
    assert want > 0
    assert tflops(tm, [2, 3, 16, 16]) == want


def _qat_nets():
    def build(nn):
        return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.ReLU(),
                             nn.Conv2D(4, 4, 3, stride=2), nn.Flatten(),
                             nn.Linear(4 * 3 * 3, 5))
    paddle.seed(0)
    jm = build(jnn)
    tm = build(tnn)
    load_paddle_tpu_state_dict(tm, {k: _np(v) for k, v in
                                    jm.state_dict().items()})
    jq = jquant.QAT(jquant.QuantConfig()).quantize(jm)
    tq = tquant.QAT(tquant.QuantConfig()).quantize(tm)
    return jq, tq


def test_qat_wraps_convs_forward_and_grads_match_jax():
    """Both convs and the Linear are wrapped; the fake-quant forward, the
    loss and the STE gradients of every weight (one ``TrainStep`` of SGD
    at learning rate 1: the update is the gradient) and the quanters'
    scales match the reference's (rtol 1e-4: a rounding tie may move one
    grid step, none does here); ``convert_to_int8`` converts only the
    Linear."""
    import paddle_tpu.optimizer as jopt
    from paddle_tpu_torch import jit as tjit
    from paddle_tpu_torch import optimizer as topt

    jq, tq = _qat_nets()
    wrapped = [n for n, m in tq.named_modules()
               if isinstance(m, tquant._QuantedWrapper)]
    assert wrapped == ["0", "2", "4"]
    assert list(tq.state_dict()) == list(jq.state_dict())
    x, y = _rand(80, 2, 3, 8, 8), _rand(81, 2, 5)
    tq.eval()
    jq.eval()
    np.testing.assert_allclose(_np(tq(torch.from_numpy(x))),
                               _np(jq(paddle.to_tensor(x))), **SUM)
    tq.train()
    jq.train()
    before = {k: v.detach().clone() for k, v in tq.named_parameters()}
    jstep = paddle.jit.TrainStep(
        jq, jopt.SGD(learning_rate=1.0, parameters=jq.parameters()),
        loss_fn=lambda o, t: (o * t).sum())
    tstep = tjit.TrainStep(
        tq, topt.SGD(learning_rate=1.0, parameters=tq.parameters()),
        loss_fn=lambda o, t: (o * t).sum())
    jl = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
    tl = tstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    jstate = {k: _np(v) for k, v in jq.state_dict().items()}
    for k, v in export_paddle_tpu_state_dict(tq).items():
        if k in before:     # the update: minus the gradient
            t_before = before[k].numpy()
            t_before = t_before.T if t_before.ndim == 2 else t_before
            np.testing.assert_allclose(v - t_before, jstate[k] - t_before,
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        else:               # the quanters' scales
            np.testing.assert_allclose(v, jstate[k], rtol=1e-5, err_msg=k)
    tq.eval()
    tquant.convert_to_int8(tq)
    assert isinstance(tq[4], tquant.Int8Linear)
    assert isinstance(tq[0], tquant._QuantedWrapper)
