"""PyTorch port, Faster R-CNN against the JAX package on the CPU, with the
weights carried across: one forward with loss and one eval at 1 x 3 x 64
x 64 and 5 classes, the whole ``_loss`` against ``jax.grad`` of the
reference's on random head outputs, the multi-level RoI features (their
gradient to the proposals too), the RPN's stable top-k on tied scores,
and the example.

Tolerances as in ``test_torch_port_detection.py``: the loss dict within
1e-4 relative, the loss function's gradients within 1e-5, RoI features
within 1e-5 of their max, the eval dicts under ``eval_differences``."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu.vision.models import detection as jdet
from paddle_tpu_torch.vision.models import detection as tdet
from _torch_port_detection_eval import (EW, _carry, check_eval,
                                        check_losses, gt, image, jax_call,
                                        jax_losses, port_cands)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401


@pytest.fixture(scope="module")
def rcnn_pair():
    paddle.seed(1)
    jm = jdet.faster_rcnn(num_classes=5, depth=18, num_proposals=16)
    return jm, _carry(jm, tdet.faster_rcnn(num_classes=5, depth=18,
                                           num_proposals=16, device="cpu"))


def _jax_heads(jm, img):
    """The reference's eval-mode class logits, deltas and proposals."""
    def heads(m, v):
        feats = m.neck(m.backbone(v))
        props = m.rpn(feats)[0]
        h = m.roi_head(m._roi_features(feats, props))
        return m.cls_score(h)._value, m.bbox_delta(h)._value, props._value

    return jax_call(jm, heads, img)


def _jax_cands(jm, cl, d, props):
    """The reference's candidates of ``_postprocess``: the predicted
    class's decoded box and its foreground probability, per image."""
    fg = jax.nn.softmax(cl, -1)[..., :jm.num_classes]
    label = fg.argmax(-1)
    dd = d.reshape(d.shape[:-1] + (jm.num_classes, 4))
    d_sel = jnp.take_along_axis(dd, label[..., None, None], axis=-2)[..., 0, :]
    boxes = jdet._decode_deltas(props, d_sel)
    return [(np.asarray(boxes[b], np.float32), np.asarray(fg.max(-1)[b]),
             np.asarray(label[b])) for b in range(cl.shape[0])]


def test_faster_rcnn_loss_and_eval_match_reference(rcnn_pair):
    """Train-mode forward with loss (the gt joins the proposals), then an
    eval: the loss dict within 1e-4; the detections under the rule (the
    random-init RoI head decodes boxes a few 1e-4 tall at coordinates
    near 1e3, whose overlaps rounding decides: such candidates count as
    explained, and the count is bounded)."""
    jm, tm = rcnn_pair
    img = image(0)
    gtb, gtl = gt()
    jl = jax_losses(jm, img, gtb, gtl)
    # on a copy: the reference's jitted call writes no running statistics
    tl = copy.deepcopy(tm).train()(torch.from_numpy(img),
                                   torch.from_numpy(gtb),
                                   torch.from_numpy(gtl))
    check_losses(jl, tl)
    jm.eval(), tm.eval()
    heads = _jax_heads(jm, img)
    jdets = jm._postprocess(*[Tensor(h) for h in heads])
    tdets = tm(torch.from_numpy(img))
    n = check_eval(jdets, tdets, _jax_cands(jm, *heads), port_cands(tm, img),
                   tm)
    assert n <= 4, n
    assert len(tdets) == 1 and tdets[0]["boxes"].shape == (16, 4)


def _rcnn_heads(seed, B=1, N=84, K=10, C=5):
    """Random RPN outputs over a 64 x 64 image's locations, and RoI head
    outputs over K proposals: half of them the gt boxes nudged (so the
    head has foreground), half random."""
    rs = np.random.RandomState(seed)
    gtb, gtl = gt()
    centers = np.concatenate([
        np.asarray(jdet._grid_centers(64 // s, 64 // s, float(s)))
        for s in (8, 16, 32)]).astype("float32")
    d = rs.uniform(2, 30, (B, N, 4)).astype("float32")
    rpn_box = np.concatenate([centers[None] - d[..., :2],
                              centers[None] + d[..., 2:]], -1)
    props = np.concatenate([
        gtb[:, [0, 1, 0, 1, 0]] + rs.uniform(-2, 2, (B, 5, 4)),
        rpn_box[:, rs.choice(N, K - 5, replace=False)]], 1).astype("float32")
    return [rs.randn(B, N).astype("float32"), rpn_box,
            rs.randn(B, K, C + 1).astype("float32"),
            (rs.randn(B, K, 4 * C) * 0.5).astype("float32"), props, gtb, gtl]


def test_faster_rcnn_loss_function_matches_jax_grad(rcnn_pair):
    """The whole ``_loss`` (RPN objectness and IoU terms, the RoI head's
    cross entropy and smooth-L1 on the encoded deltas) on random head
    outputs: every term, and the gradients of the total to the RPN's
    objectness and boxes, the class logits, the deltas and the proposals,
    against ``jax.grad`` of the reference's ``_loss``."""
    jm, tm = rcnn_pair
    arrays = _rcnn_heads(2)
    diff = arrays[:5]

    def jloss(*vs):
        return jm._loss(*[Tensor(v) for v in list(vs) + arrays[5:]])

    ts = [torch.from_numpy(a).requires_grad_() for a in diff]
    tl = tm._loss(*ts, *[torch.from_numpy(a) for a in arrays[5:]])
    jl = jloss(*diff)
    assert list(tl) == list(jl)             # the reference's key order
    check_losses(jl, tl)
    assert float(tl["loss_box"]) > 0 and float(tl["loss_rpn_box"]) > 0
    tl["loss"].backward()
    want = jax.jit(jax.grad(lambda *vs: jloss(*vs)["loss"]._value,
                            argnums=tuple(range(5))))(*diff)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **EW)
        assert np.abs(t.grad.numpy()).max() > 0


def test_roi_features_level_select_and_box_gradient(rcnn_pair):
    """``_roi_features``: proposals of every scale routed to P3-P5 by
    ``sqrt(wh)``, the pooled features within 1e-5 of their max and their
    gradient to the proposals against ``jax.grad`` of the reference's."""
    jm, tm = rcnn_pair
    rs = np.random.RandomState(5)
    feats = [rs.randn(2, 256, s, s).astype("float32") for s in (8, 4, 2)]
    xy = rs.uniform(0, 40, (2, 6, 2))
    wh = np.array([4, 10, 30, 60, 150, 300], np.float64)[None, :, None] \
        * rs.uniform(0.8, 1.2, (2, 6, 2))
    props = np.concatenate([xy, xy + wh], -1).astype("float32")
    tp = torch.from_numpy(props).requires_grad_()
    out = tm._roi_features([torch.from_numpy(f) for f in feats], tp)
    r = rs.randn(*out.shape).astype("float32")

    def jf(p):
        return jm._roi_features([Tensor(f) for f in feats], Tensor(p))._value

    want = np.asarray(jax.jit(jf)(props))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (out * torch.from_numpy(r)).sum().backward()
    g = jax.jit(jax.grad(lambda p: jnp.sum(jf(p) * r)))(props)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g), rtol=1e-4,
                               atol=1e-5)


def test_rpn_topk_is_stable_on_tied_scores(rcnn_pair):
    """Saturated objectness ties keep index order (a stable sort), as
    the reference's ``argsort``; ``torch.topk`` would not promise it."""
    tm = copy.deepcopy(rcnn_pair[1])
    with torch.no_grad():
        tm.rpn.obj.weight.zero_()
        tm.rpn.obj.bias.fill_(30.0)             # every location ties
        feats = [torch.from_numpy(np.random.RandomState(6).randn(
            1, 256, s, s).astype("float32")) for s in (8, 4, 2)]
        props, scores, obj, box = tm.rpn(feats)
    assert torch.equal(props, box[:, :16])
    assert bool((scores == obj[:, :16]).all())


def test_train_detection_example_runs_rcnn():
    from paddle_tpu_torch.examples import train_detection as ex

    out = ex.main(["--arch", "rcnn", "--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(v) for row in out["losses"] for v in row.values())
