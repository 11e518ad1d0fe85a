"""MNIST / FashionMNIST from local IDX files, gzipped or not (counterpart
of ``paddle_tpu/vision/datasets/mnist.py``; no downloader)."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

_NO_DOWNLOAD = ("nothing is downloaded; place the IDX files locally and pass "
                "image_path/label_path")


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=False, backend=None):
        if image_path is None or label_path is None:
            raise RuntimeError(_NO_DOWNLOAD)
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise RuntimeError(
                f"{self.NAME} files not found at {image_path} / {label_path}; " + _NO_DOWNLOAD)
        self.mode = mode
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise RuntimeError(f"bad magic {magic} in {path}")
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise RuntimeError(f"bad magic {magic} in {path}")
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx][:, :, None]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"
