"""Streaming metrics (counterpart of ``paddle_tpu/metric/__init__.py``).

The arithmetic is the reference's numpy: a tensor on the card is read
back once where a metric first needs it (``compute`` / ``update``).
"""

from __future__ import annotations

import numpy as np
import torch

# np.trapz was renamed np.trapezoid in numpy 2.0
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l.squeeze(-1)
        if l.ndim == p.ndim:  # one-hot
            l = l.argmax(-1)
        topk_idx = np.argsort(-p, axis=-1)[..., : self.maxk]
        correct = topk_idx == l[..., None]
        return correct.astype(np.float32)

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        for i, k in enumerate(self.topk):
            self.total[i] += c[..., :k].any(-1).sum()
            self.count[i] += num
        accs = self.total / np.maximum(self.count, 1)
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        accs = self.total / np.maximum(self.count, 1)
        return float(accs[0]) if len(self.topk) == 1 else [float(a) for a in accs]

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1).astype(bool)
        bins = np.minimum((p * self.num_thresholds).astype(int), self.num_thresholds)
        n = self.num_thresholds + 1
        self._stat_pos += np.bincount(bins[l], minlength=n)
        self._stat_neg += np.bincount(bins[~l], minlength=n)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds descending
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional accuracy (``paddle.metric.accuracy``): the share of rows
    whose label is among the top ``k`` of ``input``, as a 0-d float32
    tensor on ``input``'s device."""
    l = label
    if l.ndim == input.ndim and l.shape[-1] == 1:
        l = l.squeeze(-1)
    _, idx = torch.topk(input, k, dim=-1)
    correct_mask = (idx == l.unsqueeze(-1)).any(-1)
    return correct_mask.float().mean()


class DetectionMAP(Metric):
    """VOC-style mean average precision for detection (reference:
    paddle.metric.DetectionMAP / ppdet VOCMetric): greedy IoU matching per
    class at ``overlap_threshold``, AP by 11-point interpolation or the
    integral (area-under-PR) rule, averaged over classes with ground truth.

    Host-side numpy: evaluation runs on padded eval outputs, never inside
    a compiled step.  Feed per-image results with :meth:`update`.
    """

    def __init__(self, num_classes, overlap_threshold=0.5,
                 evaluate_difficult=False, map_type="11point", name=None):
        if map_type not in ("11point", "integral"):
            raise ValueError(f"bad map_type {map_type!r}")
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.map_type = map_type
        self._name = name or "mAP"
        self.reset()

    def reset(self):
        # per class: list of (score, tp) over all images + total gt count
        self._scored = [[] for _ in range(self.num_classes)]
        self._n_gt = [0] * self.num_classes

    @staticmethod
    def _iou(a, b):
        ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
        iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
        ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
        iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        aa = np.clip(a[:, 2] - a[:, 0], 0, None) * \
            np.clip(a[:, 3] - a[:, 1], 0, None)
        ab = np.clip(b[:, 2] - b[:, 0], 0, None) * \
            np.clip(b[:, 3] - b[:, 1], 0, None)
        return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-10)

    def update(self, boxes, scores, labels, gt_boxes, gt_labels, valid=None,
               gt_difficult=None):
        """One IMAGE's detections vs its ground truth (arrays or Tensors).

        boxes [K,4], scores [K], labels [K], optional valid [K] bool;
        gt_boxes [M,4], gt_labels [M] (label < 0 = padding);
        gt_difficult [M] bool — with evaluate_difficult=False (the VOC
        default), difficult gts are excluded from the recall denominator
        and matching them is neither TP nor FP.
        """
        b = np.asarray(_np(boxes), "float64").reshape(-1, 4)
        s = np.asarray(_np(scores), "float64").reshape(-1)
        l = np.asarray(_np(labels)).reshape(-1).astype(int)
        gb = np.asarray(_np(gt_boxes), "float64").reshape(-1, 4)
        gl = np.asarray(_np(gt_labels)).reshape(-1).astype(int)
        gd = (np.zeros(len(gl), bool) if gt_difficult is None
              else np.asarray(_np(gt_difficult)).reshape(-1).astype(bool))
        if valid is not None:
            v = np.asarray(_np(valid)).reshape(-1).astype(bool)
            b, s, l = b[v], s[v], l[v]
        keep_gt = gl >= 0
        gb, gl, gd = gb[keep_gt], gl[keep_gt], gd[keep_gt]
        count_gt = gd == False if not self.evaluate_difficult \
            else np.ones(len(gl), bool)  # noqa: E712
        for c in range(self.num_classes):
            self._n_gt[c] += int(((gl == c) & count_gt).sum())
        for c in np.unique(l):
            if not 0 <= c < self.num_classes:
                continue
            det = l == c
            db, ds = b[det], s[det]
            order = np.argsort(-ds)
            db, ds = db[order], ds[order]
            sel = gl == c
            cgt, cdiff = gb[sel], gd[sel]
            matched = np.zeros(len(cgt), bool)
            ious_all = self._iou(db, cgt) if len(db) and len(cgt) else None
            for i in range(len(db)):
                if ious_all is None:
                    self._scored[c].append((float(ds[i]), 0))
                    continue
                ious = ious_all[i]
                j = int(ious.argmax())
                if ious[j] >= self.overlap_threshold:
                    if cdiff[j] and not self.evaluate_difficult:
                        continue  # difficult match: neither TP nor FP
                    if not matched[j]:
                        matched[j] = True
                        self._scored[c].append((float(ds[i]), 1))
                        continue
                self._scored[c].append((float(ds[i]), 0))

    def accumulate(self):
        aps = []
        for c in range(self.num_classes):
            if self._n_gt[c] == 0:
                continue
            if not self._scored[c]:
                aps.append(0.0)
                continue
            arr = sorted(self._scored[c], key=lambda x: -x[0])
            tp = np.asarray([t for _, t in arr], "float64")
            cum_tp = np.cumsum(tp)
            prec = cum_tp / (np.arange(len(tp)) + 1)
            rec = cum_tp / self._n_gt[c]
            if self.map_type == "11point":
                ap = 0.0
                for r in np.linspace(0, 1, 11):
                    p = prec[rec >= r].max() if (rec >= r).any() else 0.0
                    ap += p / 11.0
            else:  # integral (area under monotone PR envelope)
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
                ap = float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0

    def name(self):
        return self._name
