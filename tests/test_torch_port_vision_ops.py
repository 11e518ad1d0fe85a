"""PyTorch port, ``vision.ops`` against the JAX package's on the same numpy
inputs (CPU): every function at the reference tests' inputs and beyond,
``roi_align`` / ``roi_pool`` / ``psroi_pool`` and ``deform_conv2d``
gradients against ``jax.grad`` of the reference functions (to the boxes
and the offsets as well as to ``x``), and ``nms`` / ``nms_padded`` on tied
scores, negative coordinates and categories.

Tolerances: f32 values and gradients within 1e-5 (abs) of the
reference's, 1e-4 relative where a result sums many products
(``deform_conv2d``'s contraction, ``yolo_loss``); NMS index lists equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.vision.ops as JO
from paddle_tpu.tensor.tensor import Tensor
import paddle_tpu_torch.vision.ops as TO
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.text.models import load_paddle_tpu_state_dict
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

EW = dict(rtol=0, atol=1e-5)
SUM = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t))


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype("float32")


def _boxes(seed, n, hw, neg=False):
    rs = np.random.RandomState(seed)
    lo = -4.0 if neg else 0.0
    xy = rs.uniform(lo, hw * 0.6, (n, 2))
    wh = rs.uniform(1.5, hw * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def _grads(jfn, tfn, arrays, diff):
    """Forward and ``grad(sum(f * r))`` to the arrays at ``diff``: the
    port's by torch autograd against the reference's eager ``jax.grad``
    (for a reference whose jitted gradient is not its eager one)."""
    got, g, r = _port_grads(tfn, arrays, diff)
    want = jax.grad(_diff_loss(jfn, arrays, diff, r),
                    argnums=tuple(range(len(diff))))(
        *[arrays[i] for i in diff])
    fwd = np.asarray(_fwd(jfn)(*arrays))
    return got, fwd, g, [np.asarray(w) for w in want]


def _diff_loss(jfn, arrays, diff, r):
    """``sum(jfn(...) * r)`` of the reference over the arrays at
    ``diff`` (the others held at ``arrays``)."""
    def loss(*vs):
        args = list(arrays)
        for i, v in zip(diff, vs):
            args[i] = v
        return jnp.sum(jfn(*[Tensor(a) for a in args])._value * r)

    return loss


def _port_grads(tfn, arrays, diff):
    """The port's forward and autograd of ``sum(f * r)`` to the arrays
    at ``diff``, with ``r``."""
    t_args = [torch.from_numpy(a).requires_grad_(i in diff)
              for i, a in enumerate(arrays)]
    out = tfn(*t_args)
    r = _rand(9, *out.shape)
    (out * torch.from_numpy(r)).sum().backward()
    return out.detach().numpy(), [t_args[i].grad.numpy() for i in diff], r


def _jax_batch(calls):
    """``{key: (fn, arrays)}`` to ``{key: fn(*arrays)}`` (numpy), every
    ``fn`` over jnp arrays traced into one jitted program: the
    reference's eager ops, or one program a case, would each compile."""
    keys = list(calls)
    out = jax.jit(lambda args: [calls[k][0](*a) for k, a in zip(keys, args)])(
        [calls[k][1] for k in keys])
    return {k: jax.tree_util.tree_map(np.asarray, o)
            for k, o in zip(keys, out)}


def _fwd(jfn):
    """``jfn`` of the reference over jnp arrays, giving its array."""
    return lambda *vs: jfn(*[Tensor(v) for v in vs])._value


def _grad_batch(cases):
    """``{key: (jfn, tfn, arrays, diff)}``: the port's forward and
    gradients (``_port_grads``) beside the reference's forward and
    ``jax.grad`` to the same arrays, every reference call in one jitted
    program.  Gives ``{key: (got, fwd, grads, want)}``."""
    port, calls = {}, {}
    for k, (jfn, tfn, arrays, diff) in cases.items():
        port[k] = _port_grads(tfn, arrays, diff)
        calls[k, "fwd"] = (_fwd(jfn), arrays)
        calls[k, "grad"] = (
            lambda *vs, jfn=jfn, arrays=arrays, diff=diff, r=port[k][2]:
            jax.grad(_diff_loss(jfn, arrays, diff, r),
                     argnums=tuple(range(len(diff))))(*vs),
            [arrays[i] for i in diff])
    ref = _jax_batch(calls)
    return {k: (port[k][0], ref[k, "fwd"], port[k][1], list(ref[k, "grad"]))
            for k in cases}


ROI_CASES = {
    "aligned_sr_default": dict(output_size=3, spatial_scale=0.5),
    "aligned_sr3": dict(output_size=(2, 4), spatial_scale=0.25,
                        sampling_ratio=3),
    "unaligned": dict(output_size=3, spatial_scale=0.5, aligned=False),
    "unaligned_sr1": dict(output_size=2, spatial_scale=1.0, aligned=False,
                          sampling_ratio=1),
}
_PSROI = [_rand(7, 2, 8, 9, 7), _boxes(8, 3, 9),   # 2 x 2 bins, 2 a bin
          np.array([2, 1], np.int32)]
_ROI_ONE = [_rand(3, 1, 4, 12, 12), _boxes(4, 6, 12),
            np.array([6], np.int32)]


def _roi_case(name):
    kw = ROI_CASES[name]
    return (lambda a, b, n: JO.roi_align(a, b, n, **kw),
            lambda a, b, n: TO.roi_align(a, b, n, **kw),
            [_rand(1, 2, 3, 11, 9), _boxes(2, 5, 20, neg=True),
             np.array([3, 2], np.int32)], (0, 1))


@pytest.fixture(scope="module")
def roi_ref():
    """Every ``roi_align`` case and ``psroi_pool``, forward and gradient,
    and ``RoIAlign`` on one image: the reference's calls as one jitted
    program."""
    cases = {name: _roi_case(name) for name in ROI_CASES}
    cases["psroi"] = (lambda a, b, n: JO.psroi_pool(a, b, n, 2, 0.7),
                      lambda a, b, n: TO.psroi_pool(a, b, n, 2, 0.7),
                      _PSROI, (0,))
    out = _grad_batch(cases)
    out["RoIAlign"] = _jax_batch({0: (_fwd(JO.RoIAlign(3, 0.5)),
                                      _ROI_ONE)})[0]
    return out


@pytest.mark.parametrize("name", sorted(ROI_CASES))
def test_roi_align_value_and_gradients_to_x_and_boxes(name, roi_ref):
    """Two images, boxes 3 + 2 (some crossing the border, so the clamp
    acts); the gradient reaches ``x`` and every box coordinate as
    ``jax.grad`` of the reference's gives it."""
    got, fwd, g, w = roi_ref[name]
    np.testing.assert_allclose(got, fwd, **EW)
    np.testing.assert_allclose(g[0], w[0], **EW)
    np.testing.assert_allclose(g[1], w[1], **EW)
    assert np.abs(g[1]).max() > 0


def test_roi_align_reference_tests_and_one_image(roi_ref):
    """The reference test's constant map pools to the constant; one image
    (``N == 1``) indexes every box to it; ``RoIAlign`` as the function."""
    x = np.full((1, 2, 16, 16), 3.5, "float32")
    b = np.array([[2.0, 2.0, 10.0, 10.0]], "float32")
    out = TO.roi_align(torch.from_numpy(x), torch.from_numpy(b),
                       torch.tensor([1]), output_size=4)
    assert tuple(out.shape) == (1, 2, 4, 4)
    np.testing.assert_allclose(out.numpy(), 3.5, rtol=1e-5)
    x, b, n = _ROI_ONE
    got = TO.RoIAlign(3, 0.5)(torch.from_numpy(x), torch.from_numpy(b),
                              torch.tensor([6]))
    np.testing.assert_allclose(got.numpy(), roi_ref["RoIAlign"], **EW)


def test_roi_pool_and_psroi_pool_with_gradients(roi_ref):
    """``roi_pool``'s max over 4 x 4 samples a bin and ``psroi_pool``,
    with gradients.  ``roi_pool`` is held to the reference's eager
    gradient: the reference's own box gradient under ``jax.jit`` differs
    from its eager one by up to 0.8 here, the port and the eager
    reference agree within 1e-5."""
    x = _rand(5, 2, 3, 10, 12)
    boxes = _boxes(6, 4, 10)
    num = np.array([1, 3], np.int32)
    got, fwd, g, w = _grads(
        lambda a, b, n: JO.roi_pool(a, b, n, 2, 0.8),
        lambda a, b, n: TO.roi_pool(a, b, n, 2, 0.8), [x, boxes, num],
        diff=(0, 1))
    np.testing.assert_allclose(got, fwd, **EW)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **EW)
    got = TO.RoIPool(2, 0.8)(torch.from_numpy(x), torch.from_numpy(boxes),
                             torch.from_numpy(num))
    np.testing.assert_allclose(got.numpy(), fwd, **EW)
    got, fwd, g, w = roi_ref["psroi"]
    np.testing.assert_allclose(got, fwd, **EW)
    np.testing.assert_allclose(g[0], w[0], **EW)
    blocks = np.arange(4, dtype="float32")      # the reference's own test
    xc = blocks[None, :, None, None] * np.ones((1, 4, 4, 4), "float32")
    out = TO.psroi_pool(torch.from_numpy(xc),
                        torch.tensor([[0.0, 0.0, 4.0, 4.0]]),
                        torch.tensor([1]), 2)
    np.testing.assert_allclose(out.numpy().reshape(2, 2),
                               blocks.reshape(2, 2), rtol=1e-5)


DEFORM_CASES = {
    "v1_pad1": (dict(padding=1), (2, 4, 7, 6), (6, 4, 3, 3), 1, False),
    "v2_mask": (dict(padding=1), (2, 4, 7, 6), (6, 4, 3, 3), 1, True),
    "v1_stride2_dil2": (dict(stride=2, padding=2, dilation=2), (1, 4, 9, 8),
                        (4, 4, 3, 3), 1, False),
    "v2_groups_dg": (dict(padding=1, groups=2, deformable_groups=2),
                     (1, 4, 6, 6), (6, 2, 3, 3), 2, True),
}


def _deform_case(name):
    kw, xs, ws, dg, v2 = DEFORM_CASES[name]
    n, c, h, w_ = xs
    co, _, kh, kw_ = ws
    s, p, d = kw.get("stride", 1), kw.get("padding", 0), kw.get("dilation", 1)
    ho = (h + 2 * p - d * (kh - 1) - 1) // s + 1
    wo = (w_ + 2 * p - d * (kw_ - 1) - 1) // s + 1
    x, w = _rand(10, *xs), _rand(11, *ws, scale=0.3)
    off = _rand(12, n, dg * 2 * kh * kw_, ho, wo, scale=1.5)
    arrays = [x, off, w, _rand(13, co)]
    if v2:
        arrays.append(np.random.RandomState(14).rand(
            n, dg * kh * kw_, ho, wo).astype("float32"))

    def call(mod):
        def f(a, o, ww, b, *m):
            return mod.deform_conv2d(a, o, ww, b, mask=m[0] if m else None,
                                     **kw)
        return f

    return call(JO), call(TO), arrays, tuple(range(len(arrays)))


@pytest.fixture(scope="module")
def deform_ref():
    """Every ``deform_conv2d`` case, forward and gradients: the
    reference's calls as one jitted program."""
    return _grad_batch({name: _deform_case(name) for name in DEFORM_CASES})


@pytest.mark.parametrize("name", sorted(DEFORM_CASES))
def test_deform_conv2d_gradients_to_x_offsets_mask_and_weight(name,
                                                              deform_ref):
    got, fwd, g, want = deform_ref[name]
    np.testing.assert_allclose(got, fwd, **SUM)
    for a, b in zip(g, want):
        np.testing.assert_allclose(a, b, **SUM)
    assert np.abs(g[1]).max() > 0               # the offsets' gradient


def test_deform_conv2d_zero_offsets_equal_conv2d_and_layer():
    """The reference test: zero offsets give ``conv2d``, a 0.5 mask half
    of it; ``DeformConv2D`` with the reference's weights carried across
    gives its output."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 8, 8).astype("float32"))
    w = torch.from_numpy(rs.randn(6, 4, 3, 3).astype("float32") * 0.2)
    off = torch.zeros(2, 18, 8, 8)
    ref = TF.conv2d(x, w, padding=1)
    torch.testing.assert_close(TO.deform_conv2d(x, off, w, padding=1), ref,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        TO.deform_conv2d(x, off, w, padding=1,
                         mask=torch.full((2, 9, 8, 8), 0.5)),
        ref * 0.5, rtol=1e-4, atol=1e-4)
    paddle.seed(0)
    jl = JO.DeformConv2D(4, 5, 3, padding=1)
    tl = TO.DeformConv2D(4, 5, 3, padding=1)
    load_paddle_tpu_state_dict(tl, {k: _np(v) for k, v in
                                    jl.state_dict().items()})
    o = _rand(15, 2, 18, 8, 8)
    np.testing.assert_allclose(
        tl(x, torch.from_numpy(o)).detach().numpy(),
        _jax_batch({0: (_fwd(jl), [x.numpy(), o])})[0], **SUM)


# ----------------------------------------------------------------------- NMS
def _np_nms(boxes, scores, thresh):
    """The reference test's numpy greedy NMS."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(boxes[i, 0], boxes[order[1:], 0])
        yy1 = np.maximum(boxes[i, 1], boxes[order[1:], 1])
        xx2 = np.minimum(boxes[i, 2], boxes[order[1:], 2])
        yy2 = np.minimum(boxes[i, 3], boxes[order[1:], 3])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        a1 = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a2 = ((boxes[order[1:], 2] - boxes[order[1:], 0])
              * (boxes[order[1:], 3] - boxes[order[1:], 1]))
        order = order[1:][inter / (a1 + a2 - inter + 1e-10) <= thresh]
    return np.array(keep)


NMS_CASES = {
    "reference_test": dict(seed=3, n=30, thr=0.4, ties=False, cats=None),
    "tied_scores": dict(seed=4, n=60, thr=0.3, ties=True, cats=None),
    "tied_top_k": dict(seed=5, n=80, thr=0.5, ties=True, cats=None, top_k=7),
    "negative_categories": dict(seed=6, n=50, thr=0.45, ties=True, cats=3,
                                neg=True),
    "dense_chain": dict(seed=7, n=300, thr=0.2, ties=False, cats=None,
                        top_k=40),
}


def _nms_case(name):
    """``(boxes, scores, categories or None)`` of an ``NMS_CASES`` case."""
    c = NMS_CASES[name]
    rs = np.random.RandomState(c["seed"])
    boxes = _boxes(c["seed"], c["n"], 60, neg=c.get("neg", False))
    if name == "dense_chain":
        boxes = np.concatenate([rs.uniform(0, 30, (c["n"], 2))] * 2, 1) \
            .astype("float32")
        boxes[:, 2:] += 12.0
    scores = rs.rand(c["n"]).astype("float32")
    if c["ties"]:
        scores = np.round(scores * 4) / 4       # a few values, many ties
    cats = None if c["cats"] is None else rs.randint(0, c["cats"], c["n"])
    return boxes, scores, cats


@pytest.fixture(scope="module")
def nms_ref():
    """The reference's ``nms_padded`` on every case, as one jitted
    program."""
    calls = {}
    for name, c in NMS_CASES.items():
        arrays = [a for a in _nms_case(name) if a is not None]

        def f(b, s, *cat, c=c):
            idx, valid = JO.nms_padded(Tensor(b), Tensor(s), c["thr"],
                                       c.get("top_k"),
                                       Tensor(cat[0]) if cat else None)
            return idx._value, valid._value
        calls[name] = (f, arrays)
    return _jax_batch(calls)


@pytest.mark.parametrize("name", sorted(NMS_CASES))
def test_nms_padded_index_lists_equal_reference(name, nms_ref):
    """``nms_padded`` returns the reference's index list and valid flags
    exactly: saturated (tied) scores keep index order, ``top_k`` cuts the
    kept list, categories never suppress each other (negative
    coordinates too), and a dense overlapping set (long suppression
    chains) resolves to the same greedy set."""
    c = NMS_CASES[name]
    boxes, scores, cats = _nms_case(name)
    top_k = c.get("top_k")
    jidx, jval = nms_ref[name]
    tidx, tval = TO.nms_padded(torch.from_numpy(boxes),
                               torch.from_numpy(scores), c["thr"], top_k,
                               None if cats is None else
                               torch.from_numpy(cats))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tval.numpy(), jval)
    kept = TO.nms(torch.from_numpy(boxes), c["thr"],
                  torch.from_numpy(scores), top_k=top_k,
                  category_idxs=None if cats is None else
                  torch.from_numpy(cats))
    assert kept.dtype == torch.int64
    np.testing.assert_array_equal(kept.numpy(), jidx[jval])
    if cats is None and top_k is None:
        np.testing.assert_array_equal(np.sort(kept.numpy()),
                                      np.sort(_np_nms(boxes, scores,
                                                      c["thr"])))


def test_nms_without_scores_and_small_cases():
    """Without scores the input order ranks; the reference tests'
    three-box and cross-category cases."""
    b = _boxes(20, 12, 30)
    np.testing.assert_array_equal(
        TO.nms(torch.from_numpy(b), 0.3).numpy(),
        _np(JO.nms(paddle.to_tensor(b), 0.3)))
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                         dtype=torch.float32)
    idx, valid = TO.nms_padded(boxes, torch.tensor([0.9, 0.8, 0.7]), 0.5,
                               top_k=3)
    assert set(idx[valid].tolist()) == {0, 2}
    neg = torch.tensor([[-5, -5, 10, 10], [-5, -5, 10, 10]],
                       dtype=torch.float32)
    _, valid = TO.nms_padded(neg, torch.tensor([0.9, 0.8]), 0.5, top_k=2,
                             category_idxs=torch.tensor([0, 1]))
    assert int(valid.sum()) == 2


def test_box_iou_and_matrix_nms():
    a, b = _boxes(21, 7, 40), _boxes(22, 5, 40)
    np.testing.assert_allclose(
        TO.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        _jax_batch({0: (_fwd(JO.box_iou), [a, b])})[0], **EW)
    boxes = _boxes(23, 20, 50)
    scores = np.random.RandomState(24).rand(4, 20).astype("float32")
    for kw in (dict(score_threshold=0.1, keep_top_k=15),
               dict(score_threshold=0.05, use_gaussian=True, nms_top_k=12,
                    normalized=False, return_index=True, background_label=-1,
                    post_threshold=0.3, return_rois_num=False)):
        got = TO.matrix_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            **kw)
        want = JO.matrix_nms(paddle.to_tensor(boxes),
                             paddle.to_tensor(scores), **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), _np(wv), **EW)
    empty, n0 = TO.matrix_nms(torch.from_numpy(boxes[:3]),
                              torch.from_numpy(scores[:1, :3]), 0.1,
                              background_label=0)
    assert empty.shape[0] == 0 and int(n0[0]) == 0


# ------------------------------------------------------------ boxes and yolo
def _values(out):
    """A reference result (a Tensor, or a list or tuple of them) as
    arrays."""
    if isinstance(out, (list, tuple)):
        return [_values(o) for o in out]
    return out._value


def test_box_coder_prior_box_yolo_box_distribute():
    """Every case's reference call in one jitted program, then the port's
    against it."""
    pb = _boxes(30, 6, 20)
    tb = _boxes(31, 4, 20)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    feat, img = np.zeros((1, 8, 3, 4), "float32"), np.zeros((1, 3, 24, 32),
                                                           "float32")
    x = _rand(33, 2, 2 * 9, 4, 5)
    size = np.array([[64, 80], [40, 50]], np.int32)
    rois = np.array([[0, 0, 500, 500], [0, 0, 14, 14], [0, 0, 224, 224],
                     [3, 4, 90, 60], [1, 1, 1, 1]], "float32")
    prior_kws = (dict(min_sizes=[8.0], aspect_ratios=[1.0]),
                 dict(min_sizes=[6.0, 10.0], max_sizes=[12.0, 20.0],
                      aspect_ratios=[2.0], flip=True, clip=True),
                 dict(min_sizes=[6.0], max_sizes=[12.0], aspect_ratios=[2.0],
                      min_max_aspect_ratios_order=True, steps=(8.0, 8.0)))
    yolo_kws = (dict(clip_bbox=True), dict(clip_bbox=False, scale_x_y=1.2))
    deltas = {0: _rand(32, 4, 6, 4, scale=0.3),
              1: _rand(32, 6, 4, 4, scale=0.3)}

    def ref(mod, wrap):
        """Every call of ``mod``'s functions, ``wrap`` making its tensors
        from numpy (the reference's run inside the jitted program)."""
        out = {}
        for norm in (True, False):
            out["enc", norm] = mod.box_coder(wrap(pb), wrap(var), wrap(tb),
                                             box_normalized=norm)
            for axis in (0, 1):
                out["dec", norm, axis] = mod.box_coder(
                    wrap(pb), None, wrap(deltas[axis]), "decode_center_size",
                    norm, axis)
        for i, kw in enumerate(prior_kws):
            out["prior", i] = mod.prior_box(wrap(feat), wrap(img), **kw)
        for i, kw in enumerate(yolo_kws):
            out["yolo", i] = mod.yolo_box(wrap(x), wrap(size),
                                          [10, 13, 16, 30], 4, 0.3, 16, **kw)
        for po in (False, True):
            out["fpn", po] = mod.distribute_fpn_proposals(
                wrap(rois), 2, 5, 4, 224, pixel_offset=po)
        return out

    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: {k: _values(v) for k, v in ref(JO, Tensor).items()})())
    got = ref(TO, lambda a: None if a is None else torch.from_numpy(a))
    for k in got:
        tol = SUM if k[0] == "yolo" else EW
        if k[0] == "fpn":
            (tm, tr), (jm, jr) = got[k], want[k]
            for a, b in zip(tm, jm):
                np.testing.assert_array_equal(a.numpy(), b)
            np.testing.assert_array_equal(tr.numpy(), jr)
        elif k[0] in ("prior", "yolo"):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a.numpy(), b, err_msg=str(k),
                                           **tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k],
                                       err_msg=str(k), **tol)


_YOLO_CASES = [(False, False), (True, True)]


def _yolo_case(score, smooth):
    """Two images, three gts (one padding row, one of another head's
    anchor), the ignore rule active."""
    rs = np.random.RandomState(40)
    N, A, ncls, H, W = 2, 3, 4, 4, 4
    x = (rs.randn(N, A * (5 + ncls), H, W) * 0.5).astype("float32")
    gt_box = np.array([[[0.5, 0.5, 0.4, 0.4], [0.2, 0.3, 0.05, 0.08],
                        [0, 0, 0, 0]],
                       [[0.7, 0.6, 0.9, 0.8], [0.31, 0.72, 0.2, 0.3],
                        [0.1, 0.1, 0.1, 0.1]]], "float32")
    gt_label = np.array([[1, 3, 0], [2, 0, 1]], np.int64)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
               116, 90, 156, 198, 373, 326]
    arrays = [x, gt_box, gt_label]
    if score:
        arrays.append(rs.rand(N, 3).astype("float32"))

    def call(mod):
        def f(xv, gb, gl, *gs):
            return mod.yolo_loss(xv, gb, gl, anchors, [0, 1, 2], ncls, 0.5,
                                 8, gt_score=gs[0] if gs else None,
                                 use_label_smooth=smooth)
        return f

    return call(JO), call(TO), arrays, (0,)


@pytest.fixture(scope="module")
def yolo_loss_ref():
    """Both ``yolo_loss`` cases, forward and gradient to the head's
    output: the reference's calls as one jitted program."""
    return _grad_batch({c: _yolo_case(*c) for c in _YOLO_CASES})


@pytest.mark.parametrize("score,smooth", _YOLO_CASES)
def test_yolo_loss_and_gradient(score, smooth, yolo_loss_ref):
    """The loss per image and its gradient to the head's output against
    ``jax.grad`` of the reference."""
    got, fwd, g, w = yolo_loss_ref[score, smooth]
    assert got.shape == (2,)
    np.testing.assert_allclose(got, fwd, **SUM)
    np.testing.assert_allclose(g[0], w[0], **SUM)


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image

    arr = np.random.RandomState(50).randint(0, 256, (9, 11, 3)) \
        .astype("uint8")
    p = str(tmp_path / "a.png")
    Image.fromarray(arr).save(p)
    raw = TO.read_file(p)
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(), _np(JO.read_file(p)))
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            TO.decode_jpeg(raw, mode).numpy(),
            _np(JO.decode_jpeg(JO.read_file(p), mode)))
    np.testing.assert_array_equal(TO.decode_jpeg(raw).numpy(),
                                  arr.transpose(2, 0, 1))
