"""Transform classes (counterpart of
``paddle_tpu/vision/transforms/transforms.py``, copied).  The random ones
draw from Python's ``random`` module in the reference's order, so under
one ``random.seed`` both packages crop, flip and jitter alike."""

from __future__ import annotations

import numbers
import random

import numpy as np

from . import functional as F


class BaseTransform:
    """Base: subclasses implement _apply_image (and optionally keys routing)."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def __call__(self, inputs):
        if isinstance(inputs, tuple):
            return tuple(self._apply_image(i) for i in inputs)
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.transpose(np.asarray(img), self.order)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        h, w = np.asarray(img).shape[:2]
        th, tw = self.size
        if self.pad_if_needed and w < tw:
            img = F.pad(img, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and h < th:
            img = F.pad(img, (0, th - h), self.fill, self.padding_mode)
        h, w = np.asarray(img).shape[:2]
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(img, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = np.asarray(img).shape[:2]
        area = h * w
        for _ in range(10):
            target_area = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                img = F.crop(img, top, left, ch, cw)
                return F.resize(img, self.size, self.interpolation)
        return F.resize(F.center_crop(img, min(h, w)), self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.vflip(img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_brightness(img, random.uniform(max(0, 1 - self.value),
                                                       1 + self.value))


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_contrast(img, random.uniform(max(0, 1 - self.value),
                                                     1 + self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_saturation(img, random.uniform(max(0, 1 - self.value),
                                                       1 + self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.transforms = [
            BrightnessTransform(brightness),
            ContrastTransform(contrast),
            SaturationTransform(saturation),
            HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False, center=None,
                 fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand, self.center,
                        self.fill)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0,
                 inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        arr = np.asarray(img) if not hasattr(img, "shape") else img
        if hasattr(arr, "numpy"):
            h, w = arr.shape[-2], arr.shape[-1]
        else:
            h, w = arr.shape[0], arr.shape[1]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            aspect = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                return F.erase(img, i, j, eh, ew, self.value, self.inplace)
        return img


class RandomAffine(BaseTransform):
    """Random affine: rotation + translation + scale + shear (reference:
    paddle.vision.transforms.RandomAffine)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        h, w = F._as_hwc(img).shape[:2]
        angle = random.uniform(*self.degrees)
        if self.translate is not None:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
            translate = (tx, ty)
        else:
            translate = (0.0, 0.0)
        scale = random.uniform(*self.scale) if self.scale is not None else 1.0
        if self.shear is not None:
            sh = self.shear
            if isinstance(sh, numbers.Number):
                sh = (-sh, sh)
            if len(sh) == 2:
                shear = (random.uniform(sh[0], sh[1]), 0.0)
            else:
                shear = (random.uniform(sh[0], sh[1]),
                         random.uniform(sh[2], sh[3]))
        else:
            shear = (0.0, 0.0)
        return F.affine(img, angle, translate, scale, shear,
                        self.interpolation, self.fill, self.center)


class RandomPerspective(BaseTransform):
    """Random four-point perspective distortion (reference transform)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        h, w = F._as_hwc(img).shape[:2]
        d = self.distortion_scale
        hd = int(d * h / 2)
        wd = int(d * w / 2)
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [[random.randint(0, wd), random.randint(0, hd)],
               [w - 1 - random.randint(0, wd), random.randint(0, hd)],
               [w - 1 - random.randint(0, wd), h - 1 - random.randint(0, hd)],
               [random.randint(0, wd), h - 1 - random.randint(0, hd)]]
        return F.perspective(img, start, end, self.interpolation, self.fill)
