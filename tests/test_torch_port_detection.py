"""PyTorch port, detection (BASELINE.json's config #3): YOLOv3 and
PP-YOLOE against the JAX package on the CPU, with the weights carried
across by ``load_paddle_tpu_state_dict``, each detector's whole loss
function against ``jax.grad`` of the reference's, PP-YOLOE's
``convert_to_deploy`` and the example.  (The parts:
``test_torch_port_detection_parts.py``; Faster R-CNN:
``test_torch_port_detection_rcnn.py``.)

The JAX package's whole-detector backward takes 35-68 s a detector on
a CPU, so gradients are held piecewise: the loss functions on random
head outputs here, the ops' gradients in ``test_torch_port_vision_ops.py``.
Each JAX detector is built once per module.

Tolerances: the loss dict within 1e-4 relative (atol 1e-5); gradients
of the loss functions within 1e-5 (abs); backbone / neck outputs within
1e-4 of their max (convolution sums in another order); the eval dicts
under ``_torch_port_detection_eval.eval_differences``: the same
detections except candidates within 1e-5 of a threshold (here none: the
count of such differences must be 0), and the port's dict equal to the
gather of its own NMS."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu.vision.models import detection as jdet
from paddle_tpu_torch.vision.models import cspresnet as tcsp
from paddle_tpu_torch.vision.models import detection as tdet
from _torch_port_detection_eval import (EW, _carry, _head_outputs, _np,
                                        _value, check_eval, check_losses, gt,
                                        image, jax_call, jax_losses,
                                        port_cands)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

@pytest.fixture(scope="module")
def yolo_pair():
    paddle.seed(0)
    jm = jdet.yolov3(num_classes=5, depth=18)
    return jm, _carry(jm, tdet.yolov3(num_classes=5, depth=18, device="cpu"))


@pytest.fixture(scope="module")
def ppyoloe_pair():
    paddle.seed(0)
    jm = jdet.ppyoloe(num_classes=5, size="s")
    return jm, _carry(jm, tdet.ppyoloe(num_classes=5, size="s",
                                       device="cpu"))


def _jax_cands(scores, box):
    """The reference's candidates: each location's best class score."""
    best, label = scores.max(-1), scores.argmax(-1)
    return [(np.asarray(box[b], np.float32), np.asarray(best[b]),
             np.asarray(label[b])) for b in range(box.shape[0])]


@pytest.mark.parametrize("arch", ["yolo", "ppyoloe"])
def test_detector_loss_and_eval_match_reference(arch, yolo_pair,
                                                ppyoloe_pair):
    """One forward with loss (train mode, 1 x 3 x 64 x 64, 5 classes) and
    one eval at the weights carried across: the loss dict within 1e-4,
    then the detections, with no difference at all."""
    jm, tm = yolo_pair if arch == "yolo" else ppyoloe_pair
    img = image(0)
    gtb, gtl = gt()
    jl = jax_losses(jm, img, gtb, gtl)
    # on a copy: the reference's jitted call writes no running statistics
    tl = copy.deepcopy(tm).train()(torch.from_numpy(img),
                                   torch.from_numpy(gtb),
                                   torch.from_numpy(gtl))
    check_losses(jl, tl)
    jm.eval(), tm.eval()
    n_out = 3 if arch == "yolo" else 2      # cls, (obj), box
    jp = jax_call(jm, lambda m, v: tuple(
        _value(o) for o in m._dense_predictions(v))[:n_out], img)
    jdets = jm._postprocess(*[Tensor(o) for o in jp])
    with torch.no_grad():
        tdets = tm(torch.from_numpy(img))
    if arch == "yolo":
        js = jax.nn.sigmoid(jp[0]) * jax.nn.sigmoid(jp[1])
    else:
        js = jax.nn.sigmoid(jp[0])
    assert check_eval(jdets, tdets,
                      _jax_cands(np.asarray(js), np.asarray(jp[-1])),
                      port_cands(tm, img), tm) == 0
    assert set(tdets[0]) == {"boxes", "scores", "labels", "valid"}
    assert tdets[0]["valid"].dtype == torch.bool


@pytest.mark.parametrize("arch", ["yolo", "ppyoloe"])
def test_loss_function_matches_jax_grad(arch, yolo_pair, ppyoloe_pair):
    """The detector's whole ``_loss`` on random head outputs: every term
    within 1e-5, and the gradient of the total to each head output
    against ``jax.grad`` of the reference's ``_loss``."""
    jm, tm = yolo_pair if arch == "yolo" else ppyoloe_pair
    cls, obj, box, centers, strides = _head_outputs(1, 1, 84, 5)
    gtb, gtl = gt()
    if arch == "yolo":
        diff = [cls, obj, box]

        def jloss(c, o, b):
            return jm._loss(Tensor(c), Tensor(o), Tensor(b),
                            jnp.asarray(centers), jnp.asarray(strides),
                            Tensor(gtb), Tensor(gtl))

        def tloss(c, o, b):
            return tm._loss(c, o, b, torch.from_numpy(centers),
                            torch.from_numpy(strides), torch.from_numpy(gtb),
                            torch.from_numpy(gtl))
    else:
        diff = [cls, box]

        def jloss(c, b):
            return jm._loss(Tensor(c), Tensor(b), jnp.asarray(centers),
                            Tensor(gtb), Tensor(gtl))

        def tloss(c, b):
            return tm._loss(c, b, torch.from_numpy(centers),
                            torch.from_numpy(gtb), torch.from_numpy(gtl))
    ts = [torch.from_numpy(a).requires_grad_() for a in diff]
    tl = tloss(*ts)
    jl = jloss(*diff)
    assert list(tl) == list(jl)             # the reference's key order
    check_losses(jl, tl)
    tl["loss"].backward()
    want = jax.jit(jax.grad(lambda *vs: jloss(*vs)["loss"]._value,
                            argnums=tuple(range(len(diff)))))(*diff)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **EW)
        assert np.abs(t.grad.numpy()).max() > 0


def test_ppyoloe_convert_to_deploy_and_sizes(ppyoloe_pair):
    """``PPYOLOE.convert_to_deploy`` folds every RepVgg block of the
    backbone and the neck; the eval scores move by rounding only; the
    size table's widths (s / m / l / x) as the reference's."""
    _, tm = ppyoloe_pair
    m = copy.deepcopy(tm).eval()
    img = torch.from_numpy(image(4))
    with torch.no_grad():
        s0 = m._dense_predictions(img)[0]
        m.convert_to_deploy()
        s1 = m._dense_predictions(img)[0]
    blocks = [b for b in m.modules() if isinstance(b, tcsp.RepVggBlock)]
    assert blocks and all(b.conv is not None for b in blocks)
    torch.testing.assert_close(s1, s0, rtol=1e-4, atol=1e-4)
    for size, want in (("s", (0.50, 0.33)), ("m", (0.75, 0.67)),
                       ("l", (1.00, 1.00)), ("x", (1.25, 1.33))):
        assert tdet.PPYOLOE._sizes[size] == want == jdet.PPYOLOE._sizes[size]


@pytest.mark.parametrize("arch", ["yolo", "ppyoloe"])
def test_train_detection_example_runs(arch):
    from paddle_tpu_torch.examples import train_detection as ex

    out = ex.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(v) for row in out["losses"] for v in row.values())
    assert out["device"] == "cpu" and out["detections"] >= 0
