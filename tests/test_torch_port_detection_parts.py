"""PyTorch port, the parts of the detectors against the JAX package on
the CPU: CSPRepResNet + CustomCSPPAN with the weights carried across,
``RepVggBlock.convert_to_deploy``, the assignment and IoU helpers,
``varifocal_loss`` and the delta coder, values and gradients against
``jax.grad`` of the reference's.

Tolerances: within 1e-5 (abs) for the elementwise functions and their
gradients; backbone / neck outputs within 1e-4 of their max (convolution
sums in another order); the folded block within 1e-5 of the two
branches."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.vision.models import cspresnet as jcsp
from paddle_tpu.vision.models import detection as jdet
from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict
from paddle_tpu_torch.vision.models import cspresnet as tcsp
from paddle_tpu_torch.vision.models import detection as tdet
from _torch_port_detection_eval import EW, _carry, _head_outputs, _np
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401


def test_assignment_iou_and_giou_helpers():
    """``_center_inside_assign`` (the smallest containing valid gt,
    ties to the first), ``_iou_matrix`` with invalid gt zeroed,
    ``_pairwise_giou`` and its gradient."""
    cls, obj, box, centers, _ = _head_outputs(2, 2, 84, 3)
    gtb = np.array([[[0, 0, 40, 40], [10, 10, 30, 30], [0, 0, 0, 0]],
                    [[20, 20, 64, 64], [20, 20, 64, 64], [5, 5, 9, 9]]],
                   np.float32)
    gtl = np.array([[2, 0, -1], [1, 2, 0]], np.int64)
    jp = jdet._center_inside_assign(jnp.asarray(centers), jnp.asarray(gtb),
                                    jnp.asarray(gtl))
    tp = tdet._center_inside_assign(torch.from_numpy(centers),
                                    torch.from_numpy(gtb),
                                    torch.from_numpy(gtl))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = gtl >= 0
    np.testing.assert_allclose(
        tdet._iou_matrix(torch.from_numpy(box), torch.from_numpy(gtb),
                         torch.from_numpy(valid)).numpy(),
        np.asarray(jdet._iou_matrix(jnp.asarray(box), jnp.asarray(gtb),
                                    jnp.asarray(valid))), **EW)
    a, b = box[0, :20], box[1, :20] + 3.0
    tg = torch.from_numpy(a).requires_grad_()
    out = tdet._pairwise_giou(tg, torch.from_numpy(b))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jdet._pairwise_giou(jnp.asarray(a), jnp.asarray(b))), **EW)
    out.sum().backward()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jax.grad(
        lambda v: jdet._pairwise_giou(v, jnp.asarray(b)).sum())(
        jnp.asarray(a))), **EW)


def test_varifocal_loss_and_gradient():
    """The reference test's formula check, and values and gradients to
    the logits against the reference at random targets."""
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 3).astype("float32")
    q = np.zeros((6, 3), "float32")
    lab = np.zeros((6, 3), "float32")
    q[0, 1], lab[0, 1] = 0.7, 1.0
    got = tdet.varifocal_loss(torch.from_numpy(logits), torch.from_numpy(q),
                              torch.from_numpy(lab)).numpy()
    p = 1 / (1 + np.exp(-logits))
    bce = -(q * np.log(p) + (1 - q) * np.log(1 - p))
    np.testing.assert_allclose(got, bce * (0.75 * p ** 2 * (1 - lab)
                                           + q * lab), rtol=1e-4, atol=1e-5)
    logits = rs.randn(40, 5).astype("float32") * 3
    lab = (rs.rand(40, 5) < 0.3).astype("float32")
    q = lab * rs.rand(40, 5).astype("float32")
    for kw in (dict(), dict(alpha=0.5, gamma=1.5)):
        t = torch.from_numpy(logits).requires_grad_()
        out = tdet.varifocal_loss(t, torch.from_numpy(q),
                                  torch.from_numpy(lab), **kw)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(
            jdet.varifocal_loss(jnp.asarray(logits), jnp.asarray(q),
                                jnp.asarray(lab), **kw)), **EW)
        out.sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jax.grad(
            lambda v: jdet.varifocal_loss(v, jnp.asarray(q), jnp.asarray(lab),
                                          **kw).sum())(jnp.asarray(logits))),
            **EW)


def test_delta_coder_round_trip():
    """``_encode_deltas`` / ``_decode_deltas`` as the reference's, and
    decode(encode(gt)) == gt (within the dw / dh clip)."""
    rs = np.random.RandomState(3)
    xy = rs.uniform(0, 100, (2, 7, 2))
    props = np.concatenate([xy, xy + rs.uniform(4, 60, (2, 7, 2))], -1) \
        .astype("float32")
    gxy = xy + rs.uniform(-5, 5, (2, 7, 2))
    gtb = np.concatenate([gxy, gxy + rs.uniform(4, 60, (2, 7, 2))], -1) \
        .astype("float32")
    enc = tdet._encode_deltas(torch.from_numpy(props), torch.from_numpy(gtb))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jdet._encode_deltas(
        jnp.asarray(props), jnp.asarray(gtb))), **EW)
    dec = tdet._decode_deltas(torch.from_numpy(props), enc)
    np.testing.assert_allclose(dec.numpy(), gtb, rtol=1e-5, atol=1e-3)
    wild = rs.randn(2, 7, 4).astype("float32") * 6
    np.testing.assert_allclose(
        tdet._decode_deltas(torch.from_numpy(props),
                            torch.from_numpy(wild)).numpy(),
        np.asarray(jdet._decode_deltas(jnp.asarray(props),
                                       jnp.asarray(wild))), rtol=1e-5,
        atol=1e-4)


def test_csprepresnet_and_custom_csppan_forward():
    """``tests/test_detection_moe.py``'s small CSPRepResNet and
    CustomCSPPAN, the weights carried across: the taps' and the neck's
    shapes (finest first) and values, eval and train mode (the batch
    statistics), within 1e-4 of their max."""
    paddle.seed(0)
    jbb = jcsp.CSPRepResNet(layers=(1, 1, 1, 1),
                            channels=(16, 16, 32, 64, 128))
    jneck = jcsp.CustomCSPPAN(jbb.out_channels, out_channels=(48, 32, 24),
                              block_num=1)
    tbb = _carry(jbb, tcsp.CSPRepResNet(layers=(1, 1, 1, 1),
                                        channels=(16, 16, 32, 64, 128),
                                        device="cpu"))
    tneck = _carry(jneck, tcsp.CustomCSPPAN(tbb.out_channels,
                                            out_channels=(48, 32, 24),
                                            block_num=1, device="cpu"))
    assert tneck.out_channels == jneck.out_channels
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype("float32")
    for train in (False, True):
        for m in (jbb, jneck, tbb, tneck):
            m.train() if train else m.eval()
        jf, jo = _jax_forward(jbb, jneck, x)
        tf = tbb(torch.from_numpy(x))
        assert [tuple(f.shape) for f in tf] == \
            [(2, 32, 8, 8), (2, 64, 4, 4), (2, 128, 2, 2)]
        to = tneck(tf)
        assert [tuple(o.shape) for o in to] == \
            [(2, 24, 8, 8), (2, 32, 4, 4), (2, 48, 2, 2)]
        for a, want in zip(list(tf) + list(to), jf + jo):
            np.testing.assert_allclose(a.detach().numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def _jax_forward(bb, neck, x):
    """The reference backbone and neck on ``x`` in their current mode, as
    one jitted program through ``Layer.bind`` (eagerly each op would
    compile; the running statistics are not written back)."""
    from paddle_tpu.framework.state import no_grad_ctx
    from paddle_tpu.tensor.tensor import Tensor

    state = [({k: p._value for k, p in m.named_parameters()},
              {k: b._value for k, b in m.named_buffers()}) for m in (bb, neck)]

    def fwd(st, v):
        with no_grad_ctx(), bb.bind(*st[0]), neck.bind(*st[1]):
            feats = bb(Tensor(v))
            return [f._value for f in feats], [o._value for o in neck(feats)]

    jf, jo = jax.jit(fwd)(state, x)
    return [np.asarray(f) for f in jf], [np.asarray(o) for o in jo]


def test_convert_to_deploy_equals_two_branch_block():
    """The folded 3x3 conv gives the two-branch block's output (within
    1e-5, as the reference's own test), gains the ``conv`` state keys,
    and equals the reference's folded conv.  (The reference registers
    the folded conv as the sub-layer ``conv`` but its attribute still
    reads None, so its forward keeps the two branches; the port's runs
    the folded conv, the output the same within rounding.)"""
    paddle.seed(1)
    jb = jcsp.RepVggBlock(8, 8, act="relu")
    tb = _carry(jb, tcsp.RepVggBlock(8, 8, act="relu"))
    rs = np.random.RandomState(1)
    for bn in (tb.conv1.bn, tb.conv2.bn):          # non-trivial statistics
        bn._mean.copy_(torch.from_numpy(rs.randn(8).astype("float32")))
        bn._variance.copy_(torch.from_numpy(rs.rand(8).astype("float32")
                                            + 0.5))
    jb.set_state_dict({k: paddle.to_tensor(v) for k, v in
                       export_paddle_tpu_state_dict(tb).items()})
    jb.eval(), tb.eval()
    x = rs.randn(2, 8, 16, 16).astype("float32")
    before = tb(torch.from_numpy(x)).detach().numpy()
    assert not any(k.startswith("conv.") for k in tb.state_dict())
    tb.convert_to_deploy()
    jb.convert_to_deploy()
    assert {"conv.weight", "conv.bias"} <= set(tb.state_dict())
    after = tb(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(after, _np(jb(paddle.to_tensor(x))), **EW)
    jconv = jb._sub_layers["conv"]
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(tb.conv, name).detach().numpy(),
                                   _np(getattr(jconv, name)), **EW)
    assert tb.conv.weight.device == tb.conv1.conv.weight.device
    _carry(jb, tcsp.RepVggBlock(8, 8, act="relu").convert_to_deploy())


