"""PyTorch port, the custom-op slice: ``register_op`` / ``load_op_library``
(the semantics of tests/test_custom_op.py), the plain version of the fused
bias + GELU kernel (K6) against the JAX Pallas kernel in interpret mode,
and the custom-op + QAT example against the JAX example from the same
weights (CPU).

The JAX example is imported by path (``examples/`` is not a package); its
``INTERPRET`` is already True off the TPU, so its ``bias_gelu`` runs the
Pallas kernel in interpret mode.  Importing it registers its op in the JAX
package's registry (``override=True``), as running it does."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.quantization import QAT as JQAT
from paddle_tpu.quantization import QuantConfig as JQuantConfig
from paddle_tpu.quantization import extract_scales as jextract_scales
import paddle_tpu_torch
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import custom_op
from paddle_tpu_torch.ops import bias_gelu as tbg

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jex():
    spec = importlib.util.spec_from_file_location(
        "jax_custom_op_and_quant", ROOT / "examples" / "custom_op_and_quant.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.INTERPRET
    return mod


# ------------------------------------------------------------ register_op
def _swish(x, beta=1.0):
    return x * torch.sigmoid(beta * x)


def _swish_fwd(x, beta=1.0):
    return _swish(x, beta), (x, beta)


def _swish_bwd(res, g):
    x, beta = res
    s = torch.sigmoid(beta * x)
    return (g * (s + beta * x * s * (1 - s)),)


@pytest.fixture
def swish_op():
    op = custom_op.register_op("fused_swish", lambda x: _swish(x),
                               vjp=(lambda x: _swish_fwd(x), _swish_bwd),
                               override=True)
    yield op
    custom_op.deregister_op("fused_swish")


def _ref_swish(x):
    return x * (1.0 / (1.0 + np.exp(-x)))


def test_register_and_call_eager(swish_op):
    x = torch.linspace(-3, 3, 12)
    np.testing.assert_allclose(ops.fused_swish(x).numpy(),
                               _ref_swish(x.numpy()), rtol=1e-5)
    assert ops.fused_swish is swish_op and custom_op.get_op("fused_swish") is swish_op


def test_grad_uses_the_pair_vjp(swish_op):
    """The (fwd, bwd) spelling: torch autograd runs the given backward."""
    calls = []

    def bwd(res, g):
        calls.append(1)
        return _swish_bwd(res, g)

    op = custom_op.register_op("fused_swish", lambda x: _swish(x),
                               vjp=(lambda x: _swish_fwd(x), bwd), override=True)
    xn = np.linspace(-2, 2, 8, dtype="float32")
    x = torch.tensor(xn, requires_grad=True)
    op(x).sum().backward()
    s = 1.0 / (1.0 + np.exp(-xn))
    np.testing.assert_allclose(x.grad.numpy(), s + xn * s * (1 - s), rtol=1e-5)
    assert calls == [1]


def test_bwd_only_vjp_spelling_and_keyword_arguments():
    """vjp=<bwd fn> takes the positional inputs as residuals; keyword
    arguments are bound before the autograd Function and get no gradient."""
    op = custom_op.register_op(
        "tmp_square", lambda x, k=1.0: k * x * x,
        vjp=lambda res, g: (g * 2.0 * res[0],), override=True)
    try:
        x = torch.tensor([3.0], requires_grad=True)
        op(x).backward()
        np.testing.assert_allclose(x.grad.numpy(), [6.0])
        np.testing.assert_allclose(op(torch.tensor([3.0]), k=2.0).numpy(), [18.0])
    finally:
        custom_op.deregister_op("tmp_square")


def test_tensor_and_non_tensor_residuals_and_arguments():
    """Residuals mix tensors (save_for_backward) and other values (ctx);
    a non-tensor positional argument gets None."""
    def fwd(x, y, alpha):
        return x * y * alpha, (x, "tag", y, alpha)

    def bwd(res, g):
        x, tag, y, alpha = res
        assert tag == "tag"
        return g * y * alpha, g * x * alpha, 123.0

    op = custom_op.register_op("tmp_mul", lambda x, y, a: x * y * a,
                               vjp=(fwd, bwd), override=True)
    try:
        x = torch.tensor([2.0, 3.0], requires_grad=True)
        y = torch.tensor([5.0, 7.0], requires_grad=True)
        op(x, y, 0.5).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.5, 3.5])
        np.testing.assert_allclose(y.grad.numpy(), [1.0, 1.5])
    finally:
        custom_op.deregister_op("tmp_mul")


def test_vjp_none_differentiates_fn():
    op = custom_op.register_op("tmp_cube", lambda x: x ** 3, override=True)
    try:
        x = torch.tensor([2.0], requires_grad=True)
        op(x).backward()
        np.testing.assert_allclose(x.grad.numpy(), [12.0])
    finally:
        custom_op.deregister_op("tmp_cube")


def test_decorator_spelling():
    @custom_op.register_op("tmp_double", override=True)
    def double(x):
        return 2 * x

    try:
        assert isinstance(double, custom_op.CustomOp)
        np.testing.assert_allclose(ops.tmp_double(torch.ones(2)).numpy(), [2.0, 2.0])
    finally:
        custom_op.deregister_op("tmp_double")


def test_name_collision_and_override():
    for builtin in ("flash_attention", "paged_attention", "bias_gelu"):
        with pytest.raises(ValueError, match="collides"):
            custom_op.register_op(builtin, lambda x: x)
    with pytest.raises(ValueError, match="identifier"):
        custom_op.register_op("not an identifier", lambda x: x)
    op1 = custom_op.register_op("tmp_op_xyz", lambda x: x)
    try:
        with pytest.raises(ValueError, match="already registered"):
            custom_op.register_op("tmp_op_xyz", lambda x: x + 1)
        op2 = custom_op.register_op("tmp_op_xyz", lambda x: x + 1, override=True)
        assert custom_op.get_op("tmp_op_xyz") is op2 is ops.tmp_op_xyz
        assert op1 is not op2
    finally:
        custom_op.deregister_op("tmp_op_xyz")
    assert custom_op.get_op("tmp_op_xyz") is None
    assert not hasattr(ops, "tmp_op_xyz")


def test_method_attachment_raises_without_a_tensor_substrate():
    with pytest.raises(NotImplementedError, match="Tensor"):
        custom_op.register_op("tmp_triple", lambda x: 3 * x, method=True,
                              override=True)
    assert custom_op.get_op("tmp_triple") is None
    assert not hasattr(torch.Tensor, "tmp_triple")


def test_wrong_gradient_count_raises():
    op = custom_op.register_op("tmp_bad", lambda x, y: x * y,
                               vjp=lambda res, g: (g,), override=True)
    try:
        x = torch.ones(2, requires_grad=True)
        with pytest.raises(ValueError, match="1 gradients for 2 arguments"):
            op(x, torch.ones(2)).sum().backward()
    finally:
        custom_op.deregister_op("tmp_bad")


def test_load_op_library(tmp_path):
    plugin = tmp_path / "my_ops_plugin.py"
    plugin.write_text(
        "import paddle_tpu_torch\n"
        "paddle_tpu_torch.register_op('tmp_plugin_relu6',\n"
        "                             lambda x: x.clamp(0.0, 6.0), override=True)\n"
        "paddle_tpu_torch.register_op('tmp_plugin_neg', lambda x: -x, override=True)\n")
    names = paddle_tpu_torch.load_op_library(str(plugin))
    try:
        assert set(names) == {"tmp_plugin_relu6", "tmp_plugin_neg"}
        x = torch.tensor([-1.0, 7.0])
        np.testing.assert_allclose(ops.tmp_plugin_neg(x).numpy(), [1.0, -7.0])
        np.testing.assert_allclose(ops.tmp_plugin_relu6(x).numpy(), [0.0, 6.0])
    finally:
        for n in names:
            custom_op.deregister_op(n)


def test_utils_re_exports_the_plugin_surface():
    from paddle_tpu_torch import utils

    assert utils.register_op is custom_op.register_op
    assert utils.load_op_library is custom_op.load_op_library
    assert paddle_tpu_torch.register_op is custom_op.register_op


# --------------------------------------------------------------- K6 plain
# absolute floor for float32 GELU values against the Pallas kernel: twice
# the largest difference measured in the cancelling tail (9.8e-7), where
# XLA's f32 erf error (up to 2.4e-7) is scaled by |z| / 2
ERF_ATOL = 2e-6


def _ulp_bf16(v):
    v = np.maximum(np.abs(v), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _exact_gelu(z):
    """gelu_erf in float64 (math.erf) of float32 z."""
    erf = np.vectorize(math.erf)
    return z.astype(np.float64) * 0.5 * (1.0 + erf(z.astype(np.float64) * 0.70710678))


def _k6_inputs(x_dtype, b_dtype, shape=(128, 64), seed=0):
    """The same values in both frameworks: x scaled so z spans [-12, 12]."""
    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(*shape).astype("float32") * 3).astype(x_dtype)
    b = jnp.asarray(rs.randn(shape[-1]).astype("float32")).astype(b_dtype)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, x_dtype))
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).to(getattr(torch, b_dtype))
    return x, b, tx, tb


def test_k6_plain_matches_pallas_f32(jex):
    """float32: within rtol 1e-6 with an absolute floor of ERF_ATOL.  The
    floor is XLA's f32 erf, which is off the true erf by up to 2.4e-7
    (torch's by 6e-8): where erf(z/sqrt 2) is near -1, ``1 + erf`` cancels
    and that absolute error becomes a large relative one.  The port is
    also held to the float64 GELU of the same inputs (measured 4.3e-7)."""
    x, b, tx, tb = _k6_inputs("float32", "float32")
    want = np.asarray(jex.bias_gelu(x, b))
    got = tbg.bias_gelu(tx, tb)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ERF_ATOL)
    exact = _exact_gelu(np.asarray(x) + np.asarray(b))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), tbg.bias_gelu_ref(tx, tb).numpy())


@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_bf16(jex, b_dtype):
    """bf16 x.  With a float32 bias (the AMP case) both sides compute in
    float32 and round once: within one bf16 ulp, or ERF_ATOL absolute in
    the cancelling tail (above).  With a bf16 bias the Pallas kernel adds and
    evaluates the GELU in bf16, rounding after every op; the port still
    computes in float32 and rounds once.  There the port is held to one
    bf16 ulp of the float64 GELU, and to the JAX result within the JAX
    result's own error plus one ulp."""
    x, b, tx, tb = _k6_inputs("bfloat16", b_dtype)
    want = np.asarray(jex.bias_gelu(x, b).astype(jnp.float32))
    got = tbg.bias_gelu(tx, tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    d = np.abs(got - want)
    ulp = _ulp_bf16(np.maximum(np.abs(got), np.abs(want)))
    exact = _exact_gelu(np.asarray(x.astype(jnp.float32)) + np.asarray(b.astype(jnp.float32)))
    assert (np.abs(got - exact) <= _ulp_bf16(exact) + ERF_ATOL).all()
    if b_dtype == "float32":
        assert (d <= ulp + ERF_ATOL).all(), d.max()
    else:
        assert (d <= np.abs(want - exact) + _ulp_bf16(exact) + ERF_ATOL).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_gradient_matches_jax(jex, dtype):
    """dx and db from torch autograd through ``BiasGelu`` (bias float32,
    as an AMP bias parameter) against the JAX example's ``bias_gelu_bwd``.
    The JAX formula runs in float32 here on both sides (the bias promotes
    z); the port rounds dx once to x's dtype: float32 rtol 1e-6 with the
    erf floor above (ERF_ATOL), bf16 within one ulp of JAX's float32 dz.
    db (float32, a sum of 128 rows) rtol 1e-5."""
    x, b, tx, tb = _k6_inputs(dtype, "float32", seed=1)
    g = np.random.RandomState(2).randn(128, 64).astype("float32")
    jg = jnp.asarray(g).astype(dtype)
    jdx, jdb = jex.bias_gelu_bwd((x, b), jg)
    txr = tx.clone().requires_grad_()
    tbr = tb.clone().requires_grad_()
    tbg.bias_gelu(txr, tbr).backward(torch.from_numpy(np.array(jg.astype(jnp.float32)))
                                    .to(tx.dtype))
    assert txr.grad.dtype == tx.dtype and tbr.grad.dtype == torch.float32
    jdx = np.asarray(jdx.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(txr.grad.numpy(), jdx, rtol=1e-6, atol=ERF_ATOL)
    else:
        d = np.abs(txr.grad.float().numpy() - jdx)
        assert (d <= _ulp_bf16(jdx) + ERF_ATOL).all(), d.max()
    np.testing.assert_allclose(tbr.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-5)


def test_k6_wrapper_shapes_dtypes_and_errors():
    """Non-contiguous x, 1-d and 3-d x, the counter untouched on the CPU,
    and the argument errors (no quiet fallback)."""
    launches = tbg.LAUNCHES
    x = torch.randn(4, 6, 10)
    b = torch.randn(10)
    xt = torch.randn(10, 6, 4).transpose(0, 2)
    for xi in (x, xt, x[0, 0]):
        np.testing.assert_allclose(tbg.bias_gelu(xi, b).numpy(),
                                   tbg.bias_gelu_ref(xi.contiguous(), b).numpy())
    # a 1-d x: db is dz itself (torch's sum over dim=() would sum all)
    x1 = torch.randn(10, requires_grad=True)
    b1 = torch.randn(10, requires_grad=True)
    tbg.bias_gelu(x1, b1).sum().backward()
    np.testing.assert_allclose(b1.grad.numpy(), x1.grad.numpy())
    assert tbg.LAUNCHES == launches
    with pytest.raises(ValueError, match=r"\[N\]"):
        tbg.bias_gelu(x, torch.randn(9))
    with pytest.raises(ValueError, match=r"\[N\]"):
        tbg.bias_gelu(x, torch.randn(1, 10))
    with pytest.raises(TypeError, match="floating"):
        tbg.bias_gelu(x.to(torch.int32), b)
    with pytest.raises(NotImplementedError, match="cuda or cpu"):
        tbg.bias_gelu(x.to("meta"), b.to("meta"))


# ------------------------------------------------------------ the example
def _jax_example_run(jex, steps=30):
    """The JAX example's main, returning what it prints: the wrapped
    ``Net``'s init state, the losses and the scales."""
    paddle.seed(0)
    model = JQAT(JQuantConfig()).quantize(jex.Net())
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    o = jopt.AdamW(learning_rate=3e-3, parameters=model.parameters())
    step = paddle.jit.TrainStep(model, o, loss_fn=jnn.CrossEntropyLoss())
    rs = np.random.RandomState(0)
    x = paddle.to_tensor(rs.randn(128, 32).astype("float32"))
    y = paddle.to_tensor(rs.randint(0, 10, (128,)).astype("int64"))
    losses = [float(step(x, y)) for _ in range(steps)]
    return state, losses, jextract_scales(model)


def test_example_qat_steps_match_jax(jex):
    """30 QAT steps through the registered K6 op from the JAX example's
    weights: losses rtol 1e-4, extract_scales keys equal and values rtol
    1e-4 (measured ~3e-7: the erf and the summation orders differ)."""
    from paddle_tpu_torch.examples import custom_op_and_quant as tex

    state, jl, js = _jax_example_run(jex)
    assert set(state) == {"b1", "fc1.inner.weight", "fc1.act_quanter.scale",
                          "fc1.weight_quanter.scale", "fc2.inner.weight",
                          "fc2.inner.bias", "fc2.act_quanter.scale",
                          "fc2.weight_quanter.scale"}
    launches = tbg.LAUNCHES
    tl, ts = tex.main("cpu", steps=30, state=state)
    assert tbg.LAUNCHES == launches          # the CPU takes the plain version
    assert len(tl) == 30 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, err_msg=k)
    assert isinstance(ops.fused_bias_gelu, custom_op.CustomOp)


def test_example_without_a_card_refuses_the_default_device(monkeypatch):
    """The example runs on the card unless asked for the CPU; with no card
    and no device it raises instead of dropping to the CPU."""
    from paddle_tpu_torch.examples import custom_op_and_quant as tex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.main()
