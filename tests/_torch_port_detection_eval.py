"""Shared helpers of the detection parity tests (imported by them, not a
test module itself): the weights carried across, the gt and image of the
tests, the loss-dict check, and the check of two runs' evaluation dicts
under ``_torch_port_detection_compare.eval_differences``."""

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.tensor.tensor import Tensor
from paddle_tpu.vision import ops as jops
from paddle_tpu.vision.models import detection as jdet
from paddle_tpu_torch.text.models import (export_paddle_tpu_state_dict,
                                          load_paddle_tpu_state_dict)
from paddle_tpu_torch.vision import ops as tops
from _torch_port_detection_compare import eval_differences

LOSS = dict(rtol=1e-4, atol=1e-5)
EW = dict(rtol=0, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t))


def _state(jm):
    return {k: np.array(jnp.asarray(v._value), copy=True)
            for k, v in jm.state_dict().items()}


def _carry(jm, tm):
    """Load the JAX model's weights into the port's; the export gives
    them back (every key and shape both ways)."""
    want = _state(jm)
    load_paddle_tpu_state_dict(tm, want)
    got = export_paddle_tpu_state_dict(tm, expected=want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return tm


def jax_call(jm, fn, *arrays):
    """``fn(jm, *tensors)`` (returning arrays) as one jitted program over
    the JAX model's weights through ``Layer.bind``: its eager ops would
    each compile.  Running statistics the call computes in training mode
    are not written back."""
    import jax

    from paddle_tpu.framework.state import no_grad_ctx

    state = ({k: p._value for k, p in jm.named_parameters()},
             {k: b._value for k, b in jm.named_buffers()})

    def run(st, *vs):
        with no_grad_ctx(), jm.bind(*st):
            return fn(jm, *[Tensor(v) for v in vs])

    return jax.jit(run)(state, *arrays)


def jax_losses(jm, img, gtb, gtl):
    """The JAX detector's training-mode loss dict, as floats."""
    jm.train()
    out = jax_call(jm, lambda m, *ts: {k: v._value for k, v in
                                       m(*ts).items()}, img, gtb, gtl)
    return {k: float(v) for k, v in out.items()}


def gt(b=1):
    """``tests/test_detection_moe.py``'s gt (image 0's box on image 0 of
    a 1-image batch), padded to 5 with label -1."""
    gtb = np.zeros((2, 5, 4), dtype="float32")
    gtl = np.full((2, 5), -1, dtype="int64")
    gtb[0, 0] = [10, 10, 60, 60]
    gtl[0, 0] = 3
    gtb[1, 0] = [30, 40, 100, 110]
    gtl[1, 0] = 1
    if b == 1:                      # a second box inside the 64 x 64 image
        gtb, gtl = gtb[:1].copy(), gtl[:1].copy()
        gtb[0, 1] = [5, 20, 30, 50]
        gtl[0, 1] = 1
    return gtb, gtl


def image(seed=0, b=1, hw=64):
    return np.random.RandomState(seed).randn(b, 3, hw, hw).astype("float32")


def _head_outputs(seed, B, N, C):
    """Random head outputs over a 64 x 64 image's 84 locations: class
    logits, objectness, and boxes around each location's centre."""
    rs = np.random.RandomState(seed)
    centers = np.concatenate([
        np.asarray(jdet._grid_centers(64 // s, 64 // s, float(s)))
        for s in (8, 16, 32)]).astype("float32")
    assert centers.shape[0] == N
    strides = np.concatenate([np.full(((64 // s) ** 2,), float(s))
                              for s in (8, 16, 32)]).astype("float32")
    d = rs.uniform(2, 30, (B, N, 4)).astype("float32")
    box = np.concatenate([centers[None] - d[..., :2],
                          centers[None] + d[..., 2:]], -1)
    return (rs.randn(B, N, C).astype("float32"),
            rs.randn(B, N, 1).astype("float32"), box, centers, strides)


def check_losses(jl, tl):
    """The same keys, each value within ``LOSS``."""
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(_np(jl[k])),
                                   err_msg=k, **LOSS)


def _value(t):
    return t._value if isinstance(t, Tensor) else t


def port_cands(tm, img):
    """The port model's candidates per image, numpy: (boxes, best score,
    label) from its ``_candidates``."""
    with torch.no_grad():
        boxes, best, label = tm._candidates(*tm._dense_predictions(
            torch.from_numpy(img)))
    return [(boxes[b].numpy(), best[b].numpy(), label[b].numpy())
            for b in range(img.shape[0])]


def _keep_list(nms, boxes, best, label, thresh):
    idx, valid = nms(boxes, best, thresh, None, label)
    return [int(i) for i in _np(idx)[_np(valid)]]


def check_eval(jdets, tdets, jcands, tcands, model):
    """Per image: the port's dict is the gather of its own NMS over its
    candidates, and its detections equal the reference's under
    ``eval_differences``; returns the count of explained differences."""
    thr, st, k = model.nms_thresh, model.score_thresh, model.top_k
    n_explained = 0
    for jd, td, jc, tc in zip(jdets, tdets, jcands, tcands):
        keep_j = _keep_list(lambda *a: jops.nms_padded(
            *[Tensor(v) if isinstance(v, np.ndarray) else v for v in a]),
            *jc, thr)
        keep_t = _keep_list(lambda *a: tops.nms_padded(
            *[torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for v in a]), *tc, thr)
        iv = np.array(keep_t[:k] + [0] * (min(k, len(tc[1])) - len(keep_t[:k])))
        boxes, best, label = tc
        np.testing.assert_array_equal(_np(td["boxes"]), boxes[iv])
        np.testing.assert_array_equal(_np(td["labels"]), label[iv])
        valid = np.zeros(len(iv), bool)
        valid[:len(keep_t[:k])] = True
        np.testing.assert_array_equal(_np(td["valid"]),
                                      valid & (best[iv] > st))
        diff, bad = eval_differences(jc, tc, keep_j, keep_t, thr, st, k)
        assert not bad, f"unexplained differences {sorted(bad)}"
        n_explained += len(diff)
        want_valid = _np(jd["valid"])
        assert int(want_valid.sum()) - len(diff) <= \
            int(_np(td["valid"]).sum()) <= int(want_valid.sum()) + len(diff)
    return n_explained
