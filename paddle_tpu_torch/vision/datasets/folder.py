"""DatasetFolder / ImageFolder (counterpart of
``paddle_tpu/vision/datasets/folder.py``): ``.npy`` arrays or PIL images
under a local root."""

from __future__ import annotations

import os

import numpy as np

from ...io import Dataset

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff",
                  ".webp", ".npy")


def has_valid_extension(filename, extensions=IMG_EXTENSIONS):
    return filename.lower().endswith(tuple(extensions))


def default_loader(path):
    if path.lower().endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        with open(path, "rb") as f:
            img = Image.open(f)
            return np.asarray(img.convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            "PIL is unavailable; store images as .npy arrays or pass a custom loader"
        ) from e


def make_dataset(directory, class_to_idx, extensions=None, is_valid_file=None):
    instances = []
    if extensions is not None and is_valid_file is None:
        def is_valid_file(p):  # noqa: F811
            return has_valid_extension(p, extensions)
    for target_class in sorted(class_to_idx):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file is None or is_valid_file(path):
                    instances.append((path, class_index))
    return instances


class DatasetFolder(Dataset):
    """root/class_x/xxx.ext layout → (image, class_index) samples."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions, is_valid_file)
        if not samples:
            raise RuntimeError(f"found 0 files in subfolders of {root}")
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def _find_classes(directory):
        classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders found in {directory}")
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat (or nested) folder of images → (image,) samples, no labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS

        samples = []
        for r, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(r, fname)
                if is_valid_file is not None:
                    if is_valid_file(path):
                        samples.append(path)
                elif has_valid_extension(path, extensions):
                    samples.append(path)
        if not samples:
            raise RuntimeError(f"found 0 files in {root}")
        self.samples = samples

    def __getitem__(self, index):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return (sample,)

    def __len__(self):
        return len(self.samples)
