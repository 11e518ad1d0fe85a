"""Flowers-102 from local files: the image directory, ``imagelabels.mat``
and ``setid.mat`` (counterpart of ``paddle_tpu/vision/datasets/flowers.py``;
no downloader)."""

from __future__ import annotations

import os

from ...io import Dataset
from .folder import default_loader


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None, mode="train",
                 transform=None, download=False, backend=None):
        if download and data_file is None:
            raise RuntimeError("nothing is downloaded; pass data_file/label_file/setid_file")
        for p, name in ((data_file, "data_file"), (label_file, "label_file"),
                        (setid_file, "setid_file")):
            if p is None or not os.path.exists(p):
                raise RuntimeError(f"flowers {name} not found at {p!r}")
        import scipy.io as sio  # optional dep; only needed for this dataset

        labels = sio.loadmat(label_file)["labels"][0]
        setid = sio.loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        self.indexes = setid[key][0]
        self.labels = labels
        self.data_dir = data_file
        self.transform = transform

    def __getitem__(self, idx):
        index = self.indexes[idx]
        img = default_loader(os.path.join(self.data_dir, f"image_{index:05d}.jpg"))
        label = int(self.labels[index - 1]) - 1
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.indexes)
