"""Functional image ops on numpy HWC arrays (counterpart of
``paddle_tpu/vision/transforms/functional.py``, a numpy copy of it: the
same arithmetic, so both packages give the same pixels).  They run on the
host, in the loader's workers.  ``resize`` is bilinear with half-pixel
centres (or nearest by ``floor(i * h / oh)``) and truncates to uint8;
``rotate`` / ``affine`` / ``perspective`` inverse-map through
``_sample``.  ``to_tensor`` returns a CPU ``torch.Tensor``; ``normalize``
and ``erase`` return a tensor for a tensor and numpy for numpy.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch


def _as_hwc(img):
    if hasattr(img, "numpy"):  # Tensor
        img = img.numpy()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(pic, data_format="CHW"):
    """HWC uint8 [0,255] → float32 CHW [0,1] (paddle.vision F.to_tensor)."""
    img = _as_hwc(pic)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format == "CHW":
        img = np.transpose(img, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(img))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = hasattr(img, "numpy")
    arr = img.numpy() if is_tensor else np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (arr - mean) / std
    if is_tensor:
        return torch.from_numpy(np.ascontiguousarray(out))
    return out


def resize(img, size, interpolation="bilinear"):
    """Resize HWC ndarray. size: int (short side) or (h, w)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    if (oh, ow) == (h, w):
        return img
    if interpolation == "nearest":
        ys = (np.arange(oh) * h / oh).astype(np.int64).clip(0, h - 1)
        xs = (np.arange(ow) * w / ow).astype(np.int64).clip(0, w - 1)
        return img[ys][:, xs]
    # bilinear, half-pixel centers
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.floor(ys).astype(np.int64).clip(0, h - 1)
    x0 = np.floor(xs).astype(np.int64).clip(0, w - 1)
    y1 = (y0 + 1).clip(0, h - 1)
    x1 = (x0 + 1).clip(0, w - 1)
    wy = (ys - y0).clip(0, 1)[:, None, None]
    wx = (xs - x0).clip(0, 1)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def crop(img, top, left, height, width):
    img = _as_hwc(img)
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    left, top, right, bottom = padding
    pads = ((top, bottom), (left, right), (0, 0))
    if padding_mode == "constant":
        return np.pad(img, pads, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, pads, mode=mode)


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img)
    f = img.astype(np.float32)
    gray = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    gray = gray[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    if img.dtype == np.uint8:  # preserve dtype so ToTensor's /255 still fires
        gray = np.clip(gray, 0, 255).astype(np.uint8)
    return gray


def adjust_brightness(img, brightness_factor):
    img = _as_hwc(img)
    out = img.astype(np.float32) * brightness_factor
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


def adjust_contrast(img, contrast_factor):
    img = _as_hwc(img)
    mean = to_grayscale(img).mean()
    out = (img.astype(np.float32) - mean) * contrast_factor + mean
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


def adjust_saturation(img, saturation_factor):
    img = _as_hwc(img)
    gray = to_grayscale(img, 3)
    out = img.astype(np.float32) * saturation_factor + gray * (1 - saturation_factor)
    return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


def adjust_hue(img, hue_factor):
    if not (-0.5 <= hue_factor <= 0.5):
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = _as_hwc(img)
    dtype = img.dtype
    arr = img.astype(np.float32) / (255.0 if dtype == np.uint8 else 1.0)
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr[..., :3].max(-1)
    minc = arr[..., :3].min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    rc = (maxc - r) / np.maximum(delta, 1e-12)
    gc = (maxc - g) / np.maximum(delta, 1e-12)
    bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0, h)
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r2 = np.select(conds, [v, q, p, p, t, v])
    g2 = np.select(conds, [t, v, v, q, p, p])
    b2 = np.select(conds, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1)
    if dtype == np.uint8:
        return np.clip(out * 255.0, 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def rotate(img, angle, interpolation="nearest", expand=False, center=None, fill=0):
    """Rotate by angle degrees CCW around center (nearest-neighbour inverse map)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    theta = np.deg2rad(angle)
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else (center[1], center[0])
    if expand:
        nh = int(abs(h * np.cos(theta)) + abs(w * np.sin(theta)) + 0.5)
        nw = int(abs(w * np.cos(theta)) + abs(h * np.sin(theta)) + 0.5)
    else:
        nh, nw = h, w
    ys, xs = np.meshgrid(np.arange(nh, dtype=np.float32),
                         np.arange(nw, dtype=np.float32), indexing="ij")
    ys = ys - (nh - 1) / 2.0
    xs = xs - (nw - 1) / 2.0
    src_y = ys * np.cos(theta) - xs * np.sin(theta) + cy
    src_x = ys * np.sin(theta) + xs * np.cos(theta) + cx
    yi = np.round(src_y).astype(np.int64)
    xi = np.round(src_x).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full((nh, nw, img.shape[2]), fill, dtype=img.dtype)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def erase(img, i, j, h, w, v, inplace=False):
    is_tensor = hasattr(img, "numpy")
    if is_tensor:
        t = img
        if not inplace:
            t = t.clone()
        t[..., i:i + h, j:j + w] = v
        return t
    img = img if inplace else img.copy()
    img[i:i + h, j:j + w] = v
    return img


def _inverse_affine_matrix(angle, translate, scale, shear, center):
    """Inverse of the torchvision/reference affine parameterization:
    M = T(center) R(angle) Sh(shear) S(scale) T(-center) T(translate)."""
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (shear if isinstance(shear, (list, tuple))
                                      else (shear, 0.0)))
    cx, cy = center
    tx, ty = translate
    # forward matrix coefficients (as in the reference implementation)
    a = np.cos(rot - sy) / np.cos(sy)
    b = -np.cos(rot - sy) * np.tan(sx) / np.cos(sy) - np.sin(rot)
    c = np.sin(rot - sy) / np.cos(sy)
    d = -np.sin(rot - sy) * np.tan(sx) / np.cos(sy) + np.cos(rot)
    m = np.array([[a * scale, b * scale, 0.0],
                  [c * scale, d * scale, 0.0],
                  [0.0, 0.0, 1.0]], np.float64)
    m[0, 2] = cx + tx - m[0, 0] * cx - m[0, 1] * cy
    m[1, 2] = cy + ty - m[1, 0] * cx - m[1, 1] * cy
    return np.linalg.inv(m)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Affine warp (reference: paddle.vision.transforms.functional.affine):
    rotation + translation + scale + shear about the center, inverse-mapped
    with nearest/bilinear sampling."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    inv = _inverse_affine_matrix(angle, translate, scale, shear, center)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return _sample(img, src_y, src_x, interpolation, fill)


def perspective(img, startpoints, endpoints, interpolation="nearest", fill=0):
    """Perspective warp mapping startpoints -> endpoints (reference:
    F.perspective; points are [[x, y]] quads)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    # solve the 8-dof homography sending endpoints -> startpoints (inverse
    # map for sampling)
    a = []
    bvec = []
    for (ex, ey), (sx_, sy_) in zip(endpoints, startpoints):
        a.append([ex, ey, 1, 0, 0, 0, -sx_ * ex, -sx_ * ey])
        bvec.append(sx_)
        a.append([0, 0, 0, ex, ey, 1, -sy_ * ex, -sy_ * ey])
        bvec.append(sy_)
    coef = np.linalg.lstsq(np.asarray(a, np.float64),
                           np.asarray(bvec, np.float64), rcond=None)[0]
    hm = np.append(coef, 1.0).reshape(3, 3)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    den = hm[2, 0] * xs + hm[2, 1] * ys + hm[2, 2]
    src_x = (hm[0, 0] * xs + hm[0, 1] * ys + hm[0, 2]) / den
    src_y = (hm[1, 0] * xs + hm[1, 1] * ys + hm[1, 2]) / den
    return _sample(img, src_y, src_x, interpolation, fill)


def _sample(img, src_y, src_x, interpolation, fill):
    h, w = img.shape[:2]
    if interpolation == "bilinear":
        y0 = np.floor(src_y).astype(np.int64)
        x0 = np.floor(src_x).astype(np.int64)
        wy = (src_y - y0)[..., None]
        wx = (src_x - x0)[..., None]

        def at(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float64)
            return np.where(valid[..., None], v, float(fill))

        out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x0 + 1) * (1 - wy) * wx
               + at(y0 + 1, x0) * wy * (1 - wx) + at(y0 + 1, x0 + 1) * wy * wx)
        return out.astype(img.dtype)
    yi = np.round(src_y).astype(np.int64)
    xi = np.round(src_x).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.full(img.shape, fill, dtype=img.dtype)
    out[valid] = img[yi[valid], xi[valid]]
    return out
