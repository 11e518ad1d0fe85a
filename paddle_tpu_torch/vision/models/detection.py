"""Detection models, BASELINE.json's config #3 (counterpart of
``paddle_tpu/vision/models/detection.py``): ``YOLOv3`` (an anchor-free
dense head over ResNet + FPN), ``FasterRCNN`` (RPN top-k proposals and
multi-level RoIAlign) and ``PPYOLOE`` (CSPRepResNet + CustomCSPPAN,
VariFocal and GIoU losses).

Training: ``model(img, gt_boxes, gt_labels)`` returns the loss dict; the
gt is padded to a fixed count with label -1.  Evaluation: ``model(img)``
returns one dict an image of tensors padded to ``top_k``: ``boxes``,
``scores``, ``labels`` and ``valid`` (kept by ``vision.ops.nms_padded``
and above ``score_thresh``).  The shapes are static, as in the reference:
the RPN keeps a fixed ``num_proposals`` by a stable sort (ties by index),
every proposal is RoI-aligned on every level and one level selected, and
the assignment (``_center_inside_assign``, ``_iou_matrix``) and losses are
the reference's formulas in PyTorch ops on the device.  Where the
reference takes ``jnp.maximum`` / ``jnp.clip`` of a value that carries a
gradient, so does this port (``torch.maximum`` splits the gradient at a
tie the same way).  The proposals are not detached: the RoI head's loss
reaches the RPN's regression through ``roi_align``'s box gradient.

``yolov3`` / ``ppyoloe`` / ``faster_rcnn`` and the classes take
``device=`` (None: the card, an error without one; ``"cpu"``) and
``dtype=``; the weights are drawn on the CPU from torch's default
generator and then moved.
"""

from __future__ import annotations

import math

import torch

from ... import nn
from ...device import resolve_device
from ...nn import functional as F
from .. import ops as vops
from .resnet import resnet18, resnet50


def _max(v, c):
    return torch.maximum(v, torch.full((), c, dtype=v.dtype, device=v.device))


def _min(v, c):
    return torch.minimum(v, torch.full((), c, dtype=v.dtype, device=v.device))


class ResNetBackbone(torch.nn.Module):
    """The C3 / C4 / C5 taps of a ResNet-50 (or -18)."""

    def __init__(self, depth=50, device=None, dtype=None):
        super().__init__()
        ctor = resnet50 if depth == 50 else resnet18
        net = ctor(num_classes=0, with_pool=False, device="cpu")
        self.stem = nn.Sequential(net.conv1, net.bn1, net.relu, net.maxpool)
        self.layer1, self.layer2 = net.layer1, net.layer2
        self.layer3, self.layer4 = net.layer3, net.layer4
        self.out_channels = [512, 1024, 2048] if depth == 50 \
            else [128, 256, 512]
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x):
        x = self.stem(x)
        c3 = self.layer2(self.layer1(x))
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class FPN(torch.nn.Module):
    """Top-down feature pyramid; each coarser map is upsampled to the
    finer map's exact size (nearest), so odd sizes work."""

    def __init__(self, in_channels, out_channel=256, device=None, dtype=None):
        super().__init__()
        self.lateral = nn.LayerList([nn.Conv2D(c, out_channel, 1)
                                     for c in in_channels])
        self.output = nn.LayerList([nn.Conv2D(out_channel, out_channel, 3,
                                              padding=1)
                                    for _ in in_channels])
        self.out_channel = out_channel
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, feats):
        lat = [m(f) for m, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            up = F.interpolate(lat[i + 1], size=lat[i].shape[2:],
                               mode="nearest")
            lat[i] = lat[i] + up
        return [o(m) for o, m in zip(self.output, lat)]


class YOLOHead(torch.nn.Module):
    """Anchor-free dense head: per level and location, class logits C,
    objectness 1 and ltrb 4."""

    def __init__(self, num_classes, in_channel=256):
        super().__init__()
        self.num_classes = num_classes
        self.cls_conv = nn.Sequential(
            nn.Conv2D(in_channel, in_channel, 3, padding=1), nn.Silu())
        self.reg_conv = nn.Sequential(
            nn.Conv2D(in_channel, in_channel, 3, padding=1), nn.Silu())
        self.cls_pred = nn.Conv2D(in_channel, num_classes, 1)
        self.obj_pred = nn.Conv2D(in_channel, 1, 1)
        self.reg_pred = nn.Conv2D(in_channel, 4, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            c = self.cls_conv(f)
            r = self.reg_conv(f)
            outs.append((self.cls_pred(c), self.obj_pred(r), self.reg_pred(r)))
        return outs


def _grid_centers(h, w, stride, device):
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)   # [HW, 2]


def _decode_ltrb(centers, reg, stride):
    """ltrb distances (stride units, softplus >= 0) -> xyxy."""
    d = torch.logaddexp(reg, torch.zeros_like(reg)) * stride
    return torch.stack([centers[..., 0] - d[..., 0],
                        centers[..., 1] - d[..., 1],
                        centers[..., 0] + d[..., 2],
                        centers[..., 1] + d[..., 3]], dim=-1)


def _flat(t):
    """``[B, C, H, W]`` -> ``[B, H * W, C]``."""
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _bce_logits(logits, targets):
    return _max(logits, 0.0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))


def _one_hot(labels, n):
    return (labels[..., None] == torch.arange(n, device=labels.device)
            ).float()


def _center_inside_assign(centers, gtb, gtl):
    """FCOS-style static assignment: each location is positive for the
    smallest valid gt box containing its centre.  Returns (pos ``[B, N]``,
    tgt_label ``[B, N]``, tgt_box ``[B, N, 4]``)."""
    cx, cy = centers[:, 0], centers[:, 1]
    x1, y1, x2, y2 = gtb[..., 0], gtb[..., 1], gtb[..., 2], gtb[..., 3]
    valid_gt = gtl >= 0
    inside = ((cx[None, :, None] >= x1[:, None]) &
              (cx[None, :, None] <= x2[:, None]) &
              (cy[None, :, None] >= y1[:, None]) &
              (cy[None, :, None] <= y2[:, None]) &
              valid_gt[:, None, :])                          # [B, N, M]
    area = _max((x2 - x1) * (y2 - y1), 1.0)
    area_big = torch.where(valid_gt, area, torch.full_like(area, 1e18)
                           )[:, None, :] * torch.where(
        inside, torch.ones((), device=gtb.device),
        torch.full((), 1e9, device=gtb.device))
    match = torch.argmin(area_big, dim=-1)                   # [B, N]
    pos = inside.any(-1)
    tgt_label = torch.gather(gtl, 1, match)
    tgt_box = torch.gather(gtb, 1, match[..., None].expand(-1, -1, 4))
    return pos, tgt_label, tgt_box


def _inter_areas(a, b):
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = _max(ix2 - ix1, 0.0) * _max(iy2 - iy1, 0.0)
    area_a = _max(a[..., 2] - a[..., 0], 0.0) * _max(a[..., 3] - a[..., 1], 0.0)
    area_b = _max(b[..., 2] - b[..., 0], 0.0) * _max(b[..., 3] - b[..., 1], 0.0)
    return inter, area_a, area_b


def _pairwise_iou(a, b):
    """Elementwise IoU of aligned xyxy boxes ``[..., 4]``."""
    inter, area_a, area_b = _inter_areas(a, b)
    return inter / _max(area_a + area_b - inter, 1e-9)


def _iou_matrix(boxes, gt, valid_gt):
    """``[B, N, 4] x [B, M, 4]`` -> ``[B, N, M]`` IoU, invalid gt zero."""
    iou = _pairwise_iou(boxes[:, :, None, :], gt[:, None, :, :])
    return torch.where(valid_gt[:, None, :], iou, torch.zeros_like(iou))


def _pairwise_giou(a, b):
    """Elementwise GIoU of aligned xyxy boxes ``[..., 4]``."""
    iou = _pairwise_iou(a, b)
    ex1 = torch.minimum(a[..., 0], b[..., 0])
    ey1 = torch.minimum(a[..., 1], b[..., 1])
    ex2 = torch.maximum(a[..., 2], b[..., 2])
    ey2 = torch.maximum(a[..., 3], b[..., 3])
    hull = _max(ex2 - ex1, 0.0) * _max(ey2 - ey1, 0.0)
    inter, area_a, area_b = _inter_areas(a, b)
    union = _max(area_a + area_b - inter, 1e-9)
    return iou - (hull - union) / _max(hull, 1e-9)


class _Detector(torch.nn.Module):
    """The evaluation contract the three detectors share:
    ``_dense_predictions(img)`` gives the head's outputs,
    ``_candidates(*dense)`` every candidate as (boxes ``[B, N, 4]``, best
    score ``[B, N]``, label ``[B, N]``), and ``_postprocess(*dense)`` the
    reference's padded dicts."""

    @torch.no_grad()
    def _postprocess(self, *dense):
        return _padded_detections(*self._candidates(*dense),
                                  self.nms_thresh, self.top_k,
                                  self.score_thresh)


def _padded_detections(boxes, best, label, nms_thresh, top_k, score_thresh):
    """Per image: ``nms_padded`` over every candidate by its best score
    and category, then the reference's padded dict (padding rows read
    candidate 0; ``valid`` also needs the score above ``score_thresh``)."""
    results = []
    for b in range(boxes.shape[0]):
        idx, valid = vops.nms_padded(boxes[b], best[b], nms_thresh,
                                     top_k=top_k, category_idxs=label[b])
        iv = torch.clamp(idx, min=0)
        sc = best[b][iv]
        results.append({"boxes": boxes[b][iv], "scores": sc,
                        "labels": label[b][iv],
                        "valid": valid & (sc > score_thresh)})
    return results


class YOLOv3(_Detector):
    """Anchor-free single-stage detector over ResNet + FPN, with
    objectness BCE over every location, class BCE and an IoU loss on the
    positives of :func:`_center_inside_assign`."""

    strides = (8, 16, 32)

    def __init__(self, num_classes=80, backbone=None, depth=50, max_boxes=50,
                 score_thresh=0.05, nms_thresh=0.6, top_k=100, device=None,
                 dtype=None):
        super().__init__()
        self.backbone = backbone or ResNetBackbone(depth, device="cpu")
        self.neck = FPN(self.backbone.out_channels, device="cpu")
        self.head = YOLOHead(num_classes, self.neck.out_channel)
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.top_k = top_k
        self.to(device=resolve_device(device), dtype=dtype)

    def _dense_predictions(self, img):
        outs = self.head(self.neck(self.backbone(img)))
        cls_l, obj_l, box_l, ctr_l, str_l = [], [], [], [], []
        for (cls, obj, reg), stride in zip(outs, self.strides):
            H, W = cls.shape[2:]
            centers = _grid_centers(H, W, float(stride), img.device)
            cls_l.append(_flat(cls))
            obj_l.append(_flat(obj))
            box_l.append(_decode_ltrb(centers[None], _flat(reg),
                                      float(stride)))
            ctr_l.append(centers)
            str_l.append(torch.full((H * W,), float(stride),
                                    device=img.device))
        return (torch.cat(cls_l, 1), torch.cat(obj_l, 1), torch.cat(box_l, 1),
                torch.cat(ctr_l, 0), torch.cat(str_l, 0))

    def forward(self, img, gt_boxes=None, gt_labels=None):
        cls, obj, box, centers, strides = self._dense_predictions(img)
        if gt_boxes is not None:
            return self._loss(cls, obj, box, centers, strides, gt_boxes,
                              gt_labels)
        return self._postprocess(cls, obj, box)

    @staticmethod
    def _candidates(cls, obj, box, *_):
        best, label = (torch.sigmoid(cls) * torch.sigmoid(obj)).max(-1)
        return box, best, label

    def _loss(self, cls, obj, box, centers, strides, gt_boxes, gt_labels):
        C = self.num_classes
        pos, tgt_label, tgt_box = _center_inside_assign(centers, gt_boxes,
                                                        gt_labels)
        obj_t = pos.float()
        l_obj = _bce_logits(obj[..., 0], obj_t).mean()
        onehot = _one_hot(torch.clamp(tgt_label, 0, C - 1), C)
        n_pos = _max(obj_t.sum(), 1.0)
        l_cls = (_bce_logits(cls, onehot).sum(-1) * obj_t).sum() / n_pos
        iou = _pairwise_iou(box, tgt_box)
        l_box = ((1.0 - iou) * obj_t).sum() / n_pos
        return {"loss": l_obj + l_cls + 2.0 * l_box, "loss_obj": l_obj,
                "loss_cls": l_cls, "loss_box": l_box}


# ======================================================================= RCNN
_DELTA_W = (10.0, 10.0, 5.0, 5.0)       # the reference's bbox coder weights


def _encode_deltas(proposals, gt):
    """xyxy proposals and gt -> (dx, dy, dw, dh) targets."""
    pw = _max(proposals[..., 2] - proposals[..., 0], 1e-4)
    ph = _max(proposals[..., 3] - proposals[..., 1], 1e-4)
    px = proposals[..., 0] + 0.5 * pw
    py = proposals[..., 1] + 0.5 * ph
    gw = _max(gt[..., 2] - gt[..., 0], 1e-4)
    gh = _max(gt[..., 3] - gt[..., 1], 1e-4)
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    wx, wy, ww, wh = _DELTA_W
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)],
                       dim=-1)


def _decode_deltas(proposals, deltas, clip=math.log(1000.0 / 16)):
    """Inverse of :func:`_encode_deltas`, dw / dh clipped to ``clip``."""
    pw = _max(proposals[..., 2] - proposals[..., 0], 1e-4)
    ph = _max(proposals[..., 3] - proposals[..., 1], 1e-4)
    px = proposals[..., 0] + 0.5 * pw
    py = proposals[..., 1] + 0.5 * ph
    wx, wy, ww, wh = _DELTA_W
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = _min(_max(deltas[..., 2] / ww, -clip), clip)
    dh = _min(_max(deltas[..., 3] / wh, -clip), clip)
    cx, cy = px + dx * pw, py + dy * ph
    w, h = pw * torch.exp(dw), ph * torch.exp(dh)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def _smooth_l1(x, beta=1.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _softmax_ce(logits, labels):
    return torch.logsumexp(logits, -1) - \
        torch.gather(logits, -1, labels[..., None])[..., 0]


class RPNHead(torch.nn.Module):
    """Region proposals over the FPN levels: objectness and ltrb boxes
    at every location, the ``num_proposals`` best kept by a stable
    descending sort."""

    def __init__(self, in_channel=256, num_proposals=128):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2D(in_channel, in_channel, 3,
                                            padding=1), nn.ReLU())
        self.obj = nn.Conv2D(in_channel, 1, 1)
        self.reg = nn.Conv2D(in_channel, 4, 1)
        self.num_proposals = num_proposals

    def forward(self, feats, strides=(8, 16, 32)):
        objs, boxes = [], []
        for f, stride in zip(feats, strides):
            H, W = f.shape[2:]
            h = self.conv(f)
            objs.append(_flat(self.obj(h))[..., 0])
            centers = _grid_centers(H, W, float(stride), f.device)
            boxes.append(_decode_ltrb(centers[None], _flat(self.reg(h)),
                                      float(stride)))
        obj, box = torch.cat(objs, 1), torch.cat(boxes, 1)
        idx = torch.argsort(-obj, dim=1, stable=True)[:, :self.num_proposals]
        proposals = torch.gather(box, 1, idx[..., None].expand(-1, -1, 4))
        scores = torch.gather(obj, 1, idx)
        return proposals, scores, obj, box


class FasterRCNN(_Detector):
    """Two-stage detector: ResNet + FPN, the RPN's top-k proposals (with
    the gt boxes joined at training), RoIAlign 7 x 7 on P3-P5 with the
    level chosen per proposal, a two-layer head, class-specific deltas."""

    def __init__(self, num_classes=80, depth=50, num_proposals=128,
                 roi_resolution=7, nms_thresh=0.5, top_k=100,
                 score_thresh=0.05, device=None, dtype=None):
        super().__init__()
        from ...nn import initializer as I

        self.backbone = ResNetBackbone(depth, device="cpu")
        self.neck = FPN(self.backbone.out_channels, device="cpu")
        self.rpn = RPNHead(self.neck.out_channel, num_proposals)
        ch = self.neck.out_channel
        self.roi_head = nn.Sequential(
            nn.Linear(ch * roi_resolution * roi_resolution, 1024), nn.ReLU(),
            nn.Linear(1024, 1024), nn.ReLU())
        # the reference's bbox head init: small normals, zero biases
        self.cls_score = nn.Linear(
            1024, num_classes + 1,
            weight_attr=nn.ParamAttr(initializer=I.Normal(0.0, 0.01)),
            bias_attr=nn.ParamAttr(initializer=I.Constant(0.0)))
        self.bbox_delta = nn.Linear(
            1024, 4 * num_classes,
            weight_attr=nn.ParamAttr(initializer=I.Normal(0.0, 0.001)),
            bias_attr=nn.ParamAttr(initializer=I.Constant(0.0)))
        self.num_classes = num_classes
        self.roi_resolution = roi_resolution
        self.nms_thresh = nms_thresh
        self.top_k = top_k
        self.score_thresh = score_thresh
        self.to(device=resolve_device(device), dtype=dtype)

    def _roi_features(self, feats, proposals):
        """RoIAlign of every proposal on P3, P4 and P5, then per proposal
        the level ``clip(floor(4 + log2(sqrt(wh) / 224 + 1e-9)), 3, 5)``."""
        B, K = proposals.shape[:2]
        rois = proposals.reshape(B * K, 4)
        boxes_num = torch.full((B,), K, dtype=torch.int32,
                               device=proposals.device)
        pooled = torch.stack([
            vops.roi_align(f, rois, boxes_num,
                           output_size=self.roi_resolution,
                           spatial_scale=1.0 / s)
            for f, s in zip(feats[:3], (8, 16, 32))])      # [3, B*K, ...]
        w = _max(proposals[..., 2] - proposals[..., 0], 1e-4)
        h = _max(proposals[..., 3] - proposals[..., 1], 1e-4)
        k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224.0 + 1e-9))
        lvl = torch.clamp(k, 3, 5).reshape(-1).long() - 3
        sel = pooled[lvl, torch.arange(B * K, device=lvl.device)]
        return sel.reshape(B, K, -1)

    def _dense_predictions(self, img, gt_boxes=None):
        """The RPN's outputs over every location, the proposals (with the
        gt boxes joined when given), and the RoI head's class logits
        ``[B, K(+M), C + 1]`` and deltas ``[B, K(+M), 4 C]``."""
        feats = self.neck(self.backbone(img))
        proposals, _, rpn_obj_all, rpn_box_all = self.rpn(feats)
        if gt_boxes is not None:
            proposals = torch.cat([proposals, gt_boxes], dim=1)
        h = self.roi_head(self._roi_features(feats, proposals))
        return (self.cls_score(h), self.bbox_delta(h), proposals,
                rpn_obj_all, rpn_box_all)

    def forward(self, img, gt_boxes=None, gt_labels=None):
        cls_logits, deltas, proposals, rpn_obj, rpn_box = \
            self._dense_predictions(img, gt_boxes)
        if gt_boxes is not None:
            return self._loss(rpn_obj, rpn_box, cls_logits, deltas,
                              proposals, gt_boxes, gt_labels)
        return self._postprocess(cls_logits, deltas, proposals)

    def _loss(self, rpn_obj, rpn_box, cls_logits, deltas, proposals,
              gt_boxes, gt_labels):
        C = self.num_classes
        gtb, gtl = gt_boxes, gt_labels
        valid_gt = gtl >= 0
        # RPN: IoU-matched objectness, IoU loss on its positives
        iou_dense = _iou_matrix(rpn_box, gtb, valid_gt)          # [B, N, M]
        best_dense, match_dense = iou_dense.max(-1)
        rpn_t = (best_dense > 0.5).float()
        l_rpn = _bce_logits(rpn_obj, rpn_t).mean()
        gt_dense = torch.gather(gtb, 1, match_dense[..., None].expand(-1, -1,
                                                                      4))
        iou_rpn = _pairwise_iou(rpn_box, gt_dense)
        l_rpn_box = ((1 - iou_rpn) * rpn_t).sum() / _max(rpn_t.sum(), 1.0)
        # RoI head: proposals matched to the gt
        best, match = _iou_matrix(proposals, gtb, valid_gt).max(-1)
        fg = best > 0.5
        tgt_label = torch.where(fg, torch.gather(gtl, 1, match),
                                torch.full_like(match, C))
        l_cls = _softmax_ce(cls_logits, torch.clamp(tgt_label, 0, C)).mean()
        tgt_box = torch.gather(gtb, 1, match[..., None].expand(-1, -1, 4))
        tgt_delta = _encode_deltas(proposals, tgt_box)            # [B, K, 4]
        d = deltas.reshape(deltas.shape[:-1] + (C, 4))
        cls_idx = torch.clamp(tgt_label, 0, C - 1)
        d_sel = torch.gather(d, -2, cls_idx[..., None, None].expand(
            -1, -1, 1, 4))[..., 0, :]
        fgf = fg.float()
        l_box = (_smooth_l1(d_sel - tgt_delta).sum(-1) * fgf).sum() / \
            _max(fgf.sum(), 1.0)
        return {"loss": l_rpn + l_rpn_box + l_cls + l_box, "loss_rpn": l_rpn,
                "loss_rpn_box": l_rpn_box, "loss_cls": l_cls,
                "loss_box": l_box}

    def _candidates(self, cls_logits, deltas, proposals, *_):
        """The predicted foreground class's probability and its decoded
        box, for every proposal."""
        C = self.num_classes
        best, label = torch.softmax(cls_logits, -1)[..., :C].max(-1)
        d = deltas.reshape(deltas.shape[:-1] + (C, 4))
        d_sel = torch.gather(d, -2, label[..., None, None].expand(
            -1, -1, 1, 4))[..., 0, :]
        return _decode_deltas(proposals, d_sel), best, label


def varifocal_loss(pred_logits, gt_score, label, alpha=0.75, gamma=2.0):
    """VariFocal loss, elementwise: BCE against the IoU target
    ``gt_score``, positives weighted by it, negatives by ``alpha *
    p^gamma``."""
    p = torch.sigmoid(pred_logits)
    weight = alpha * (p ** gamma) * (1.0 - label) + gt_score * label
    bce = _max(pred_logits, 0.0) - pred_logits * gt_score + \
        torch.log1p(torch.exp(-pred_logits.abs()))
    return bce * weight


class PPYOLOEHead(torch.nn.Module):
    """Per-level decoupled head over the CSPPAN taps: eSE-attended class
    stem with a residual, a regression stem, 1x1 predictions."""

    def __init__(self, num_classes, in_channels):
        super().__init__()
        from .cspresnet import ConvBNLayer, EffectiveSELayer

        self.num_classes = num_classes
        self.stem_cls = nn.LayerList()
        self.stem_reg = nn.LayerList()
        self.pred_cls = nn.LayerList()
        self.pred_reg = nn.LayerList()
        self.attn_cls = nn.LayerList()
        for c in in_channels:
            self.stem_cls.append(ConvBNLayer(c, c, 3, padding=1, act="swish"))
            self.attn_cls.append(EffectiveSELayer(c))
            self.stem_reg.append(ConvBNLayer(c, c, 3, padding=1, act="swish"))
            self.pred_cls.append(nn.Conv2D(c, num_classes, 1))
            self.pred_reg.append(nn.Conv2D(c, 4, 1))

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            c = self.attn_cls[i](self.stem_cls[i](f)) + f
            r = self.stem_reg[i](f)
            outs.append((self.pred_cls[i](c), self.pred_reg[i](r)))
        return outs


class PPYOLOE(_Detector):
    """PP-YOLOE: CSPRepResNet, CustomCSPPAN, an anchor-free head,
    VariFocal class loss and GIoU box loss.  ``size``: ``"s"`` / ``"m"``
    / ``"l"`` / ``"x"``, the (width, depth) multipliers of the reference's
    table."""

    strides = (8, 16, 32)
    _sizes = {"s": (0.50, 0.33), "m": (0.75, 0.67),
              "l": (1.00, 1.00), "x": (1.25, 1.33)}

    def __init__(self, num_classes=80, size="s", max_boxes=50,
                 score_thresh=0.05, nms_thresh=0.6, top_k=100, device=None,
                 dtype=None):
        super().__init__()
        from .cspresnet import CSPRepResNet, CustomCSPPAN

        width, depth = self._sizes[size]
        self.backbone = CSPRepResNet(width_mult=width, depth_mult=depth,
                                     device="cpu")
        neck_out = tuple(max(int(round(c * width)), 16)
                         for c in (768, 384, 192))
        self.neck = CustomCSPPAN(self.backbone.out_channels,
                                 out_channels=neck_out,
                                 block_num=max(int(round(3 * depth)), 1),
                                 device="cpu")
        self.head = PPYOLOEHead(num_classes, self.neck.out_channels)
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.top_k = top_k
        self.to(device=resolve_device(device), dtype=dtype)

    def convert_to_deploy(self):
        from .cspresnet import _convert_to_deploy

        return _convert_to_deploy(self)     # backbone and neck blocks

    def _dense_predictions(self, img):
        outs = self.head(self.neck(self.backbone(img)))
        cls_l, box_l, ctr_l = [], [], []
        for (cls, reg), stride in zip(outs, self.strides):
            H, W = cls.shape[2:]
            centers = _grid_centers(H, W, float(stride), img.device)
            cls_l.append(_flat(cls))
            box_l.append(_decode_ltrb(centers[None], _flat(reg),
                                      float(stride)))
            ctr_l.append(centers)
        return torch.cat(cls_l, 1), torch.cat(box_l, 1), torch.cat(ctr_l, 0)

    def forward(self, img, gt_boxes=None, gt_labels=None):
        cls, box, centers = self._dense_predictions(img)
        if gt_boxes is not None:
            return self._loss(cls, box, centers, gt_boxes, gt_labels)
        return self._postprocess(cls, box)

    def _loss(self, cls, box, centers, gt_boxes, gt_labels):
        C = self.num_classes
        pos, tgt_label, tgt_box = _center_inside_assign(centers, gt_boxes,
                                                        gt_labels)
        posf = pos.float()
        n_pos = _max(posf.sum(), 1.0)
        iou = _pairwise_iou(box, tgt_box)                   # quality q
        label = _one_hot(torch.clamp(tgt_label, 0, C - 1), C) * posf[..., None]
        gt_score = label * iou.detach()[..., None]
        l_vfl = varifocal_loss(cls, gt_score, label).sum() / n_pos
        giou = _pairwise_giou(box, tgt_box)
        l_box = ((1.0 - giou) * posf).sum() / n_pos
        return {"loss": l_vfl + 2.5 * l_box, "loss_vfl": l_vfl,
                "loss_box": l_box}

    @staticmethod
    def _candidates(cls, box, *_):
        best, label = torch.sigmoid(cls).max(-1)
        return box, best, label


def yolov3(num_classes=80, **kwargs):
    return YOLOv3(num_classes=num_classes, **kwargs)


def ppyoloe(num_classes=80, **kwargs):
    """PP-YOLOE: CSPRepResNet + CustomCSPPAN + VariFocal / GIoU."""
    return PPYOLOE(num_classes=num_classes, **kwargs)


def faster_rcnn(num_classes=80, **kwargs):
    return FasterRCNN(num_classes=num_classes, **kwargs)
