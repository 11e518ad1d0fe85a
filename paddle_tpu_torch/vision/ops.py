"""Detection ops (counterpart of ``paddle_tpu/vision/ops.py``), plain
PyTorch on the tensors' device.

- ``roi_align`` samples ``sr x sr`` points a bin (``sr = 2`` when
  ``sampling_ratio <= 0``), each clamped into ``[0, H - 1] x [0, W - 1]``
  before the floor, and gathers the four corners straight from ``x`` by
  (batch index, y, x): no per-RoI copy of the feature map, which the
  reference's ``x[batch_idx]`` makes.  The bilinear weights are functions
  of the boxes, so the gradient reaches the boxes as well as ``x`` (as
  ``jax.grad`` of the reference does; Faster R-CNN trains its RPN through
  them).
- ``nms_padded`` keeps the reference's greedy keep set exactly: a stable
  descending sort (ties by index), the ``+1e-10`` IoU denominator, the
  strict ``>``, and with ``category_idxs`` the per-category shift by
  ``max - min + 1``.  It is resolved on the device as the fixed point of
  ``keep[j] = not any(keep[i] and iou[i, j] > t for i < j)``, iterated in
  parallel over a prefix of the sorted boxes that grows until it holds
  ``top_k`` kept ones: the host reads a flag every few iterations, never
  once per box.
- ``deform_conv2d`` is the reference's bilinear im2col (zero outside the
  input) and one contraction per group; v2 when ``mask`` is given.
- ``read_file`` / ``decode_jpeg`` run on the host (PIL).
"""

from __future__ import annotations

import numpy as np
import torch


def _clip(v, lo, hi):
    """``jnp.clip``: ``minimum(maximum(v, lo), hi)``, whose gradient is
    split in half where ``v`` equals a bound (as JAX's)."""
    lo_t = torch.full((), lo, dtype=v.dtype, device=v.device)
    hi_t = torch.full((), hi, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo_t), hi_t)


# --------------------------------------------------------------- roi_align
def _batch_index(boxes_num, R, N, device):
    """The image of each RoI: ``searchsorted(cumsum(boxes_num), i,
    right)`` (all 0 for one image)."""
    if N == 1:
        return torch.zeros(R, dtype=torch.long, device=device)
    ends = torch.cumsum(torch.as_tensor(boxes_num, device=device).long(), 0)
    return torch.searchsorted(ends, torch.arange(R, device=device),
                              right=True)


def _roi_align_impl(x, boxes, boxes_num, output_size, spatial_scale,
                    sampling_ratio, aligned):
    N, C, H, W = x.shape
    R = boxes.shape[0]
    ph, pw = output_size
    dev = x.device
    offset = 0.5 if aligned else 0.0
    b = _batch_index(boxes_num, R, N, dev)
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        one = torch.ones((), dtype=roi_w.dtype, device=dev)
        roi_w, roi_h = torch.maximum(roi_w, one), torch.maximum(roi_h, one)
    bin_h, bin_w = roi_h / ph, roi_w / pw
    sr = sampling_ratio if sampling_ratio > 0 else 2
    frac = (torch.arange(sr, device=dev) + 0.5) / sr
    ys = y1[:, None, None] + (torch.arange(ph, device=dev)[None, :, None]
                              + frac[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (torch.arange(pw, device=dev)[None, :, None]
                              + frac[None, None, :]) * bin_w[:, None, None]
    yy = _clip(ys, 0.0, H - 1.0).reshape(R, ph * sr)
    xx = _clip(xs, 0.0, W - 1.0).reshape(R, pw * sr)
    y0, x0 = torch.floor(yy).long(), torch.floor(xx).long()
    y1_, x1_ = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    wy, wx = yy - y0, xx - x0
    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    row = b[:, None] * H

    def g(yi, xi):          # (R, ph*sr, pw*sr, C), gathered from x itself
        return flat[((row + yi) * W)[:, :, None] + xi[:, None, :]]

    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    out = (g(y0, x0) * ((1 - wy) * (1 - wx)) + g(y0, x1_) * ((1 - wy) * wx)
           + g(y1_, x0) * (wy * (1 - wx)) + g(y1_, x1_) * (wy * wx))
    out = out.reshape(R, ph, sr, pw, sr, C).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """``[R, C, ph, pw]`` bilinear RoI features of ``x`` ``[N, C, H, W]``
    over ``boxes`` ``[R, 4]`` (xyxy), ``boxes_num[i]`` of them on image
    ``i``."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    return _roi_align_impl(x, boxes, boxes_num, output_size, spatial_scale,
                           sampling_ratio, aligned)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """Max over a 4 x 4 grid of bilinear samples a bin (the reference's
    approximation of RoI max pooling)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    out = _roi_align_impl(x, boxes, boxes_num, (ph * 4, pw * 4),
                          spatial_scale, 1, False)
    R, C = out.shape[:2]
    return out.reshape(R, C, ph, 4, pw, 4).amax(dim=(3, 5))


class RoIAlign:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


# ------------------------------------------------------------------- iou/nms
def box_iou(boxes1, boxes2):
    """``[M, 4] x [N, 4]`` (xyxy) -> ``[M, N]`` IoU, ``+1e-10`` in the
    denominator."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)


# fixed-point iterations between two reads of the convergence flag
_NMS_CHECK_EVERY = 4


def _greedy_keep(boxes, iou_threshold):
    """Greedy NMS keep flags of score-sorted ``boxes`` ``[P, 4]``: the
    unique fixed point of ``keep[j] = not any_{i < j}(keep[i] and
    iou[i, j] > t)``.  Iterated from all-kept, entries ``0 .. k - 1`` are
    final after ``k`` rounds, so it stops at the first round that changes
    nothing (at most ``P``)."""
    P = boxes.shape[0]
    sup = torch.triu(box_iou(boxes, boxes) > iou_threshold, diagonal=1)
    keep = torch.ones(P, dtype=torch.bool, device=boxes.device)
    for _ in range(0, P + 1, _NMS_CHECK_EVERY):
        for _ in range(_NMS_CHECK_EVERY):
            prev, keep = keep, ~(sup & keep[:, None]).any(0)
        if torch.equal(prev, keep):
            break
    return keep


def _nms_impl(boxes, scores, iou_threshold, max_out):
    """``(indices, valid)`` of length ``min(max_out, n)``: the first kept
    boxes in score order (ties by index), padded with -1."""
    n = boxes.shape[0]
    dev = boxes.device
    max_out = min(max_out, n)
    order = torch.argsort(-scores, stable=True)
    bs = boxes[order]
    # keep[j] depends on boxes before j only, so a prefix that keeps
    # max_out boxes already gives the answer
    P = n if max_out >= n else min(n, max(4 * max_out, 1024))
    while True:
        keep = _greedy_keep(bs[:P], iou_threshold)
        kept = torch.nonzero(keep).flatten()
        if P == n or kept.numel() >= max_out:
            break
        P = min(n, 2 * P)
    kept = kept[:max_out]
    idx = torch.full((max_out,), -1, dtype=torch.long, device=dev)
    idx[:kept.numel()] = order[kept]
    valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
    valid[:kept.numel()] = True
    return idx, valid


def nms_padded(boxes, scores, iou_threshold=0.3, top_k=None,
               category_idxs=None):
    """``(indices, valid)`` of greedy NMS, ``min(top_k, n)`` long
    (``top_k``: all boxes when None), -1 where ``valid`` is False.  With
    ``category_idxs`` the boxes of each category are shifted apart by
    ``max - min + 1`` (so boxes of two categories never overlap, negative
    coordinates too)."""
    bv, sv = boxes, scores.float()
    n = bv.shape[0]
    max_out = int(top_k) if top_k is not None else n
    if category_idxs is not None:
        lo = bv.min()
        span = bv.max() - lo + 1.0
        bv = (bv - lo) + (category_idxs.float() * span)[:, None]
    return _nms_impl(bv, sv, iou_threshold, max_out)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """The kept indices, in score order (input order without ``scores``),
    as an int64 tensor: :func:`nms_padded` with the padding stripped."""
    n = boxes.shape[0]
    if scores is None:
        scores = torch.arange(n, 0, -1, dtype=torch.float32,
                              device=boxes.device)
    idx, valid = nms_padded(boxes, scores, iou_threshold, top_k,
                            category_idxs)
    return idx[valid].long()


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2., background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2) of one image: ``bboxes`` ``[N, 4]``, ``scores``
    ``[C, N]``.  Each class's ``nms_top_k`` best boxes decay by
    ``min_i f(iou_ij) / f(comp_i)`` over higher-scored ``i``; the
    ``keep_top_k`` best entries ``[cls, score, x1, y1, x2, y2]`` above
    ``max(score_threshold, post_threshold)`` are returned (then the count
    and the indices, as asked)."""
    bv, sv = bboxes, scores
    C = sv.shape[0]
    dev = bv.device
    off = 0.0 if normalized else 1.0
    cls_keep = [c for c in range(C) if c != background_label]

    def tail(out, out_idx):
        parts = [out]                      # reference order: out, num, index
        if return_rois_num:
            parts.append(torch.tensor([out.shape[0]], dtype=torch.int32,
                                      device=dev))
        if return_index:
            parts.append(out_idx.long())
        return parts[0] if len(parts) == 1 else tuple(parts)

    if not cls_keep:
        return tail(torch.zeros((0, 6), device=dev),
                    torch.zeros((0,), dtype=torch.long, device=dev))
    s_dec, orders = [], []
    for c in cls_keep:
        sc = sv[c]
        order = torch.argsort(-sc, stable=True)[:nms_top_k]
        b, s = bv[order], sc[order]
        tl = torch.maximum(b[:, None, :2], b[None, :, :2])
        br = torch.minimum(b[:, None, 2:], b[None, :, 2:])
        wh = torch.clamp(br - tl + off, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        area = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
        iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                                  min=1e-9)
        m = iou.shape[0]
        upper = torch.triu(iou, diagonal=1)
        comp = upper.max(0).values
        pair = torch.triu(torch.ones((m, m), dtype=torch.bool, device=dev),
                          diagonal=1)
        if use_gaussian:
            ratio = torch.exp(-gaussian_sigma * (upper ** 2
                                                 - comp[:, None] ** 2))
        else:
            ratio = (1 - upper) / torch.clamp(1 - comp[:, None], min=1e-9)
        ratio = torch.where(pair, ratio, torch.ones_like(ratio))
        decay = torch.clamp(ratio.min(0).values, max=1.0)
        s_dec.append(s * decay)
        orders.append(order)
    s_dec, orders = torch.stack(s_dec), torch.stack(orders)    # [Ck, m]
    m = s_dec.shape[1]
    cls_col = torch.tensor(cls_keep, dtype=torch.float32, device=dev)[
        :, None, None].expand(len(cls_keep), m, 1)
    entries = torch.cat([cls_col, s_dec[:, :, None], bv[orders]], dim=2)
    all_out, all_idx = entries.reshape(-1, 6), orders.reshape(-1)
    sel = torch.argsort(-all_out[:, 1], stable=True)[:keep_top_k]
    out, out_idx = all_out[sel], all_idx[sel]
    keep = out[:, 1] > max(float(score_threshold), float(post_threshold))
    return tail(out[keep], out_idx[keep])


# --------------------------------------------------------------- yolo / boxes
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLO head ``[N, A * (5 + C), H, W]`` into boxes ``[N, A *
    H * W, 4]`` (pixels of ``img_size`` ``[N, 2]`` = (h, w)) and scores
    ``[N, A * H * W, C]`` (zero where the objectness is not above
    ``conf_thresh``)."""
    N, _, H, W = x.shape
    A = len(anchors) // 2
    dev, dt = x.device, x.dtype
    anc = torch.tensor(anchors, dtype=dt, device=dev).reshape(A, 2)
    p = x.reshape(N, A, 5 + class_num, H, W)
    gx = (torch.sigmoid(p[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
          + torch.arange(W, device=dev)[None, None, None, :]) / W
    gy = (torch.sigmoid(p[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
          + torch.arange(H, device=dev)[None, None, :, None]) / H
    gw = torch.exp(p[:, :, 2]) * anc[None, :, 0, None, None] / \
        (W * downsample_ratio)
    gh = torch.exp(p[:, :, 3]) * anc[None, :, 1, None, None] / \
        (H * downsample_ratio)
    conf = torch.sigmoid(p[:, :, 4])
    probs = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] > conf_thresh, probs,
                        torch.zeros_like(probs))
    imw = img_size[:, 1].to(dt)[:, None, None, None]
    imh = img_size[:, 0].to(dt)[:, None, None, None]
    x1 = (gx - gw / 2) * imw
    y1 = (gy - gh / 2) * imh
    x2 = (gx + gw / 2) * imw
    y2 = (gy + gh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.minimum(torch.maximum(zero, x1), imw - 1)
        y1 = torch.minimum(torch.maximum(zero, y1), imh - 1)
        x2 = torch.minimum(torch.maximum(zero, x2), imw - 1)
        y2 = torch.minimum(torch.maximum(zero, y2), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    return boxes, scores


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode ``target_box`` ``[N, 4]`` against the priors ``[M, 4]`` into
    ``[N, M, 4]`` centre-size deltas over the variances, or decode deltas
    ``[N, M, 4]`` (priors along ``axis``) back into boxes."""
    pb, pbv, tb = prior_box, prior_box_var, target_box
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    px = pb[:, 0] + pw / 2
    py = pb[:, 1] + ph / 2
    if pbv is None:
        var = torch.ones((1, 4), dtype=pb.dtype, device=pb.device)
    elif pbv.ndim == 1:
        var = pbv[None, :]
    else:
        var = pbv
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tx = tb[:, 0] + tw / 2
        ty = tb[:, 1] + th / 2
        ox = (tx[:, None] - px[None, :]) / pw[None, :]
        oy = (ty[:, None] - py[None, :]) / ph[None, :]
        ow = torch.log(tw[:, None] / pw[None, :])
        oh = torch.log(th[:, None] / ph[None, :])
        return torch.stack([ox, oy, ow, oh], dim=-1) / var[None, :, :]
    if axis == 0:
        px_, py_, pw_, ph_ = px[None, :], py[None, :], pw[None, :], ph[None, :]
        var = var[None, :, :]
    else:
        px_, py_, pw_, ph_ = px[:, None], py[:, None], pw[:, None], ph[:, None]
        var = var[:, None, :]
    d = tb * var
    cx = d[..., 0] * pw_ + px_
    cy = d[..., 1] * ph_ + py_
    w = torch.exp(d[..., 2]) * pw_
    h = torch.exp(d[..., 3]) * ph_
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - norm,
                        cy + h / 2 - norm], dim=-1)


def _deform_bilinear(img, py, px):
    """``img`` ``[N, c, H, W]`` sampled at ``py`` / ``px`` ``[N, K, Ho,
    Wo]``: ``[N, c, K, Ho, Wo]``, corners outside the input zero."""
    N, c, H, W = img.shape
    flat = img.reshape(N, c, H * W)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    out = 0.0
    for yy, wyy in ((y0, 1 - wy), (y0 + 1, wy)):
        for xx, wxx in ((x0, 1 - wx), (x0 + 1, wx)):
            yi, xi = yy.long(), xx.long()
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, 1,
                                                                         -1)
            v = flat.gather(2, idx.expand(N, c, idx.shape[-1]))
            wt = torch.where(valid, wyy * wxx, torch.zeros_like(wyy))
            out = out + v.reshape((N, c) + tuple(py.shape[1:])) * wt[:, None]
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution, v1 (v2 with ``mask`` ``[N, dg * K, Ho,
    Wo]``): ``offset`` ``[N, dg * 2K, Ho, Wo]`` as (dy, dx) pairs per
    kernel tap; the sampled columns contracted with ``weight`` ``[Co,
    C / groups, kh, kw]`` per group."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    d = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    N, C, H, W = x.shape
    Co, _, kh, kw = weight.shape
    dev = x.device
    Ho = (H + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    Wo = (W + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    K = kh * kw
    oy = torch.arange(Ho, device=dev) * s[0] - p[0]
    ox = torch.arange(Wo, device=dev) * s[1] - p[1]
    ky = torch.arange(kh, device=dev) * d[0]
    kx = torch.arange(kw, device=dev) * d[1]
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        Ho, Wo, kh, kw).reshape(Ho, Wo, K)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        Ho, Wo, kh, kw).reshape(Ho, Wo, K)
    dg = deformable_groups
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    pos_y = base_y.permute(2, 0, 1)[None, None] + off[:, :, :, 0]
    pos_x = base_x.permute(2, 0, 1)[None, None] + off[:, :, :, 1]
    mv = mask.reshape(N, dg, K, Ho, Wo) if mask is not None else None
    cpg = C // dg
    cols = []
    for g in range(dg):
        sampled = _deform_bilinear(x[:, g * cpg:(g + 1) * cpg], pos_y[:, g],
                                   pos_x[:, g])
        if mv is not None:
            sampled = sampled * mv[:, g][:, None]
        cols.append(sampled)
    cols = torch.cat(cols, dim=1)                      # [N, C, K, Ho, Wo]
    gin, gout = C // groups, Co // groups
    outs = []
    for g in range(groups):
        wg = weight[g * gout:(g + 1) * gout].reshape(gout, -1)
        cg = cols[:, g * gin:(g + 1) * gin].reshape(N, gin * K, Ho * Wo)
        outs.append(torch.einsum("ok,nkp->nop", wg, cg))
    out = torch.cat(outs, dim=1).reshape(N, Co, Ho, Wo)
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


class DeformConv2D(torch.nn.Module):
    """Deformable conv layer; the caller gives the offsets (and v2's
    mask) each forward.  Weight ``[out, in / groups, kh, kw]``,
    Xavier-uniform, bias zero (the reference's defaults)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        from ..nn import initializer as I
        from ..nn.layers.common import make_parameter

        k = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self._cfg = dict(stride=stride, padding=padding, dilation=dilation,
                         deformable_groups=deformable_groups, groups=groups)
        self.weight = make_parameter(
            [out_channels, in_channels // groups, k[0], k[1]], weight_attr,
            I.XavierUniform())
        self.bias = make_parameter([out_channels], bias_attr, 0.0)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._cfg)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling: channel block (i, j) averages only
    the pixels whose centre lies in bin (i, j)."""
    osz = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    N, C, H, W = x.shape
    ph, pw = osz
    co = C // (ph * pw)
    dev = x.device
    counts = torch.as_tensor(boxes_num, device=dev).long()
    bidx = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                   counts)
    bx = boxes * spatial_scale
    x1, y1, x2, y2 = bx[:, 0], bx[:, 1], bx[:, 2], bx[:, 3]
    bh = torch.clamp(y2 - y1, min=1e-3) / ph
    bw = torch.clamp(x2 - x1, min=1e-3) / pw
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    i = torch.arange(ph, device=dev)[None, :, None]
    j = torch.arange(pw, device=dev)[None, :, None]
    in_y = (ys >= y1[:, None, None] + i * bh[:, None, None]) & \
        (ys < y1[:, None, None] + (i + 1) * bh[:, None, None])   # [R, ph, H]
    in_x = (xs >= x1[:, None, None] + j * bw[:, None, None]) & \
        (xs < x1[:, None, None] + (j + 1) * bw[:, None, None])   # [R, pw, W]
    m = (in_y[:, :, None, :, None] & in_x[:, None, :, None, :]).to(x.dtype)
    denom = torch.clamp(m.sum((-2, -1)), min=1.0)                # [R, ph, pw]
    img = x.reshape(N, co, ph, pw, H, W)[bidx]
    return (img * m[:, None]).sum((-2, -1)) / denom[:, None]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes ``[H, W, P, 4]`` (normalised by the image) per cell
    of ``input``'s ``[H, W]``, and their variances."""
    H, W = input.shape[2], input.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    dev = input.device
    step_h = steps[1] or IH / H
    step_w = steps[0] or IW / W
    ars = []
    for ar in aspect_ratios:
        ars.append(ar)
        if flip and ar != 1.0:
            ars.append(1.0 / ar)
    sizes = []
    for idx, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            sizes.append((ms, ms))
            if max_sizes:
                mx = max_sizes[idx]
                sizes.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
            for ar in ars:
                if ar != 1.0:
                    sizes.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        else:
            for ar in ars:
                sizes.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
            if max_sizes:
                mx = max_sizes[idx]
                sizes.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
    cy = (torch.arange(H, device=dev) + offset) * step_h
    cx = (torch.arange(W, device=dev) + offset) * step_w
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    wh = torch.tensor(sizes, dtype=torch.float32, device=dev)
    boxes = torch.stack([
        (cxg[..., None] - wh[None, None, :, 0] / 2) / IW,
        (cyg[..., None] - wh[None, None, :, 1] / 2) / IH,
        (cxg[..., None] + wh[None, None, :, 0] / 2) / IW,
        (cyg[..., None] + wh[None, None, :, 1] / 2) / IH], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(boxes.shape)
    return boxes, var


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """The FPN level of each RoI, ``floor(log2(sqrt(area) / refer_scale +
    1e-8)) + refer_level`` clipped to the levels, as one boolean mask per
    level over all RoIs and the restore index of a stable sort by level
    (the reference's static-shape contract)."""
    off = 1.0 if pixel_offset else 0.0
    w = torch.clamp(fpn_rois[:, 2] - fpn_rois[:, 0] + off, min=0.0)
    h = torch.clamp(fpn_rois[:, 3] - fpn_rois[:, 1] + off, min=0.0)
    lvl = torch.floor(torch.log2(torch.sqrt(w * h) / refer_scale + 1e-8)) \
        + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).int()
    masks = [lvl == (min_level + i) for i in range(max_level - min_level + 1)]
    order = torch.argsort(lvl, stable=True)
    restore = torch.argsort(order, stable=True).int()
    return masks, restore


def read_file(filename, name=None):
    """The file's bytes as a CPU uint8 tensor."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode an encoded image (uint8 tensor) to CHW uint8 on the host
    (PIL); ``mode`` ``"gray"`` / ``"rgb"`` converts."""
    import io as _io

    from PIL import Image

    raw = bytes(np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                           else x, np.uint8))
    img = Image.open(_io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _bce(logit, tgt):
    return torch.clamp(logit, min=0) - logit * tgt + \
        torch.log1p(torch.exp(-logit.abs()))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=False, name=None, scale_x_y=1.0):
    """YOLOv3 loss of one head, per image ``[N]``: BCE on xy and L1 on wh
    at the responsible anchor of each gt (its best over all anchors, if
    that one is this head's), objectness BCE except where a prediction
    overlaps a gt above ``ignore_thresh``, per-class BCE.  ``gt_box`` ``[N,
    B, 4]`` normalised (cx, cy, w, h), zero rows padding."""
    A = len(anchor_mask)
    dev = x.device
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev).reshape(-1, 2)
    gbox, glab, gscore = gt_box, gt_label, gt_score
    N, C, H, W = x.shape
    pred = x.reshape(N, A, C // A, H, W)
    tx, ty, tw, th = pred[:, :, 0], pred[:, :, 1], pred[:, :, 2], pred[:, :, 3]
    tobj, tcls = pred[:, :, 4], pred[:, :, 5:]
    img_w, img_h = W * downsample_ratio, H * downsample_ratio
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    mask_anc = anc[torch.tensor(anchor_mask, device=dev)]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    px = (alpha * torch.sigmoid(tx) + beta + gx[None, None]) / W
    py = (alpha * torch.sigmoid(ty) + beta + gy[None, None]) / H
    pw = torch.exp(torch.clamp(tw, -10, 10)) * \
        mask_anc[None, :, 0, None, None] / img_w
    ph = torch.exp(torch.clamp(th, -10, 10)) * \
        mask_anc[None, :, 1, None, None] / img_h
    B = gbox.shape[1]
    valid = (gbox[..., 2] > 0) & (gbox[..., 3] > 0)
    gw, gh = gbox[..., 2] * img_w, gbox[..., 3] * img_h
    inter = torch.minimum(gw[..., None], anc[None, None, :, 0]) * \
        torch.minimum(gh[..., None], anc[None, None, :, 1])
    union = gw[..., None] * gh[..., None] \
        + anc[None, None, :, 0] * anc[None, None, :, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    in_head = torch.zeros_like(best, dtype=torch.bool)
    local_a = torch.zeros_like(best)
    for li, am in enumerate(anchor_mask):
        hit = best == am
        in_head = in_head | hit
        local_a = torch.where(hit, torch.full_like(local_a, li), local_a)
    resp = valid & in_head
    gi = torch.clamp((gbox[..., 0] * W).int(), 0, W - 1).long()
    gj = torch.clamp((gbox[..., 1] * H).int(), 0, H - 1).long()
    n_idx = torch.arange(N, device=dev)[:, None].expand(N, B)
    ones = torch.ones_like(gw)
    score = gscore if gscore is not None else ones
    flat = ((n_idx * A + local_a) * H + gj) * W + gi
    obj_tgt = torch.zeros(N * A * H * W, device=dev).scatter_reduce(
        0, flat.reshape(-1), torch.where(resp, score, torch.zeros_like(score))
        .reshape(-1).float(), reduce="amax").reshape(N, A, H, W)
    pb = torch.stack([px, py, pw, ph], -1).reshape(N, -1, 4)
    gb = gbox
    x1 = torch.maximum(pb[:, :, None, 0] - pb[:, :, None, 2] / 2,
                       gb[:, None, :, 0] - gb[:, None, :, 2] / 2)
    y1 = torch.maximum(pb[:, :, None, 1] - pb[:, :, None, 3] / 2,
                       gb[:, None, :, 1] - gb[:, None, :, 3] / 2)
    x2 = torch.minimum(pb[:, :, None, 0] + pb[:, :, None, 2] / 2,
                       gb[:, None, :, 0] + gb[:, None, :, 2] / 2)
    y2 = torch.minimum(pb[:, :, None, 1] + pb[:, :, None, 3] / 2,
                       gb[:, None, :, 1] + gb[:, None, :, 3] / 2)
    inter2 = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    area_p = pb[:, :, None, 2] * pb[:, :, None, 3]
    area_g = gb[:, None, :, 2] * gb[:, None, :, 3]
    iou = inter2 / torch.clamp(area_p + area_g - inter2, min=1e-9)
    iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
    best_iou = iou.max(-1).values.reshape(N, A, H, W)
    ignore = (best_iou > ignore_thresh) & (obj_tgt < 0.5)
    sx = gbox[..., 0] * W - gi
    sy_ = gbox[..., 1] * H - gj
    tw_t = torch.log(torch.clamp(
        gw / torch.clamp(anc[best][..., 0], min=1e-9), min=1e-9))
    th_t = torch.log(torch.clamp(
        gh / torch.clamp(anc[best][..., 1], min=1e-9), min=1e-9))
    box_scale = 2.0 - gbox[..., 2] * gbox[..., 3]

    def at(t):
        return t[n_idx, local_a, gj, gi]

    zero = torch.zeros_like(score)
    w_resp = torch.where(resp, score, zero)
    sc = torch.where(resp, box_scale * score, zero)
    loss_xy = (sc * (_bce(at(tx), sx) + _bce(at(ty), sy_))).sum(-1)
    loss_wh = (sc * ((at(tw) - tw_t).abs() + (at(th) - th_t).abs())).sum(-1)
    obj_w = torch.where(ignore, torch.zeros_like(obj_tgt),
                        torch.ones_like(obj_tgt))
    loss_obj = (obj_w * _bce(tobj, obj_tgt)).sum((1, 2, 3))
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    onehot = (glab.long()[..., None] == torch.arange(class_num, device=dev)
              ).float()
    cls_onehot = onehot * (1 - smooth) + smooth / class_num
    cls_pred = tcls.permute(0, 1, 3, 4, 2)[n_idx, local_a, gj, gi]
    loss_cls = (w_resp[..., None] * _bce(cls_pred, cls_onehot)).sum((-1, -2))
    return loss_xy + loss_wh + loss_obj + loss_cls
