"""VOC2012 segmentation dataset (counterpart of
``paddle_tpu/vision/datasets/voc.py``).

Reads the extracted VOCdevkit layout (ImageSets/Segmentation split lists,
JPEGImages, SegmentationClass) under ``data_file``, the ``VOC2012`` or
``VOCdevkit/VOC2012`` directory; nothing is downloaded.  Images decode via
PIL (``.npy`` raw arrays are accepted too), returning (image HWC uint8,
label HW uint8) with 255 = ignore.
"""

from __future__ import annotations

import os

import numpy as np

from ...io import Dataset

_SPLIT_FILES = {"train": "train.txt", "valid": "val.txt", "test": "val.txt",
                "trainval": "trainval.txt"}


def _find_root(data_file):
    for cand in (data_file,
                 os.path.join(data_file, "VOC2012"),
                 os.path.join(data_file, "VOCdevkit", "VOC2012")):
        if os.path.isdir(os.path.join(cand, "ImageSets")):
            return cand
    raise RuntimeError(
        f"no VOC2012 layout under {data_file!r} (need ImageSets/, "
        "JPEGImages/, SegmentationClass/)")


def _load_image(path):
    if path.endswith(".npy"):  # raw-array fixtures (tests, pre-decoded sets)
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


class VOC2012(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            raise RuntimeError("nothing is downloaded; pass data_file "
                               "pointing at the extracted VOC2012 directory")
        if mode not in _SPLIT_FILES:
            raise ValueError(f"mode must be one of {sorted(_SPLIT_FILES)}")
        self.root = _find_root(str(data_file))
        self.transform = transform
        split = os.path.join(self.root, "ImageSets", "Segmentation",
                             _SPLIT_FILES[mode])
        with open(split) as f:
            self.names = [ln.strip() for ln in f if ln.strip()]
        if not self.names:
            raise RuntimeError(f"split file {split!r} lists no images")
        self._img_dir = os.path.join(self.root, "JPEGImages")
        self._lbl_dir = os.path.join(self.root, "SegmentationClass")
        # fixture-friendly: accept .npy alongside .jpg/.png
        self._img_ext = ".jpg" if os.path.exists(os.path.join(
            self._img_dir, self.names[0] + ".jpg")) else ".npy"
        self._lbl_ext = ".png" if os.path.exists(os.path.join(
            self._lbl_dir, self.names[0] + ".png")) else ".npy"

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        name = self.names[idx]
        img = _load_image(os.path.join(self._img_dir, name + self._img_ext))
        lbl = _load_image(os.path.join(self._lbl_dir, name + self._lbl_ext))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(lbl, np.uint8)
