"""The rule by which two runs' detections of one image are compared
(numpy only: the detection parity tests and ``chip_smoke.py`` import it).
A candidate that one run keeps and the other does not is *explained*
when rounding may decide it; anything else is a fault."""

import numpy as np

NEAR = 1e-5


def _shifted(boxes, labels):
    """The boxes as ``nms_padded`` sees them: shifted per category by
    ``max - min + 1`` (float32)."""
    boxes = boxes.astype(np.float32)
    lo = boxes.min()
    span = np.float32(boxes.max() - lo + np.float32(1.0))
    return (boxes - lo) + (labels.astype(np.float32) * span)[:, None]


def _iou(a, b):
    """IoU of box ``a`` ``[4]`` with boxes ``b`` ``[N, 4]`` (``+1e-10``)."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + 1e-10)


def eval_differences(cand_a, cand_b, keep_a, keep_b, nms_thresh,
                     score_thresh, top_k):
    """Compare two runs' detections of one image.

    ``cand_*``: ``(boxes [N, 4], best [N], label [N])`` numpy, every
    candidate; ``keep_*``: each run's NMS keep list (indices in score
    order, not cut at ``top_k``).  A run's detections are the first
    ``top_k`` kept with a score above ``score_thresh``.  A candidate in
    one run's detections and not the other's is *explained* when its
    score is within 1e-5 of ``score_thresh``, or when an IoU that decides
    it (with a candidate of its category) is within 1e-5 of
    ``nms_thresh`` or falls on opposite sides of it in the two runs'
    arithmetic, or when the two candidates' scores are within 1e-5 (their
    order may flip); then also, transitively, a candidate that an
    explained one overlaps above ``nms_thresh - 1e-5``, and one pushed
    past ``top_k`` by explained ones.  Returns ``(differing,
    unexplained)`` index sets."""
    (ba, sa, la), (bb, sb, lb) = cand_a, cand_b
    va = [i for i in keep_a[:top_k] if sa[i] > score_thresh]
    vb = [i for i in keep_b[:top_k] if sb[i] > score_thresh]
    diff = set(va) ^ set(vb)
    xa, xb = _shifted(ba, la), _shifted(bb, lb)
    explained = set()
    for d in diff:
        if min(abs(sa[d] - score_thresh), abs(sb[d] - score_thresh)) <= NEAR:
            explained.add(d)
            continue
        ia, ib = _iou(xa[d], xa), _iou(xb[d], xb)
        others = np.arange(len(sa)) != d
        near = (np.minimum(abs(ia - nms_thresh), abs(ib - nms_thresh))
                <= NEAR) | ((ia > nms_thresh) != (ib > nms_thresh))
        ties = (np.abs(sa - sa[d]) <= NEAR) & ((ia > nms_thresh)
                                               | (ib > nms_thresh))
        if ((near | ties) & others).any():
            explained.add(d)
    grew = True
    while grew:
        grew = False
        for d in diff - explained:
            hit = any(_iou(xa[e], xa[d:d + 1])[0] > nms_thresh - NEAR or
                      _iou(xb[e], xb[d:d + 1])[0] > nms_thresh - NEAR
                      for e in explained)
            cut = explained and ((d in keep_a[top_k:]) or
                                 (d in keep_b[top_k:]))
            if hit or cut:
                explained.add(d)
                grew = True
    return diff, diff - explained
