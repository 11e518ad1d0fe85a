"""Cifar10 / 100 from a local python-pickle tarball or its extracted
directory (counterpart of ``paddle_tpu/vision/datasets/cifar.py``; no
downloader)."""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset


class Cifar10(Dataset):
    NAME = "cifar-10-batches-py"
    TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
    TEST_FILES = ["test_batch"]
    LABEL_KEY = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None, download=False,
                 backend=None):
        if data_file is None:
            raise RuntimeError("nothing is downloaded; pass data_file pointing "
                               "at the cifar tar.gz or extracted directory")
        if not os.path.exists(data_file):
            raise RuntimeError(f"cifar data not found at {data_file}")
        self.mode = mode
        self.transform = transform
        names = self.TRAIN_FILES if mode == "train" else self.TEST_FILES
        batches = []
        if os.path.isdir(data_file):
            for n in names:
                with open(os.path.join(data_file, n), "rb") as f:
                    batches.append(pickle.load(f, encoding="bytes"))
        else:
            with tarfile.open(data_file) as tf:
                for member in tf.getmembers():
                    if os.path.basename(member.name) in names:
                        batches.append(pickle.load(tf.extractfile(member),
                                                   encoding="bytes"))
        images, labels = [], []
        for b in batches:
            images.append(np.asarray(b[b"data"], dtype=np.uint8))
            labels.extend(b[self.LABEL_KEY])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NAME = "cifar-100-python"
    TRAIN_FILES = ["train"]
    TEST_FILES = ["test"]
    LABEL_KEY = b"fine_labels"
