"""The real-data path end to end (counterpart of
``examples/train_imagefolder.py``): a class-per-folder image tree through
``DatasetFolder``, host-side transforms (resize, random crop and flip,
normalize), an ``io.DataLoader`` with 2 workers, and ``hapi.Model.fit``
training ResNet-18 with Momentum, then ``evaluate`` with deterministic
transforms.  Runs on the card unless told:

    python -m paddle_tpu_torch.examples.train_imagefolder [DATA_DIR]
        [--epochs 3] [--device cpu]

Without ``DATA_DIR`` it writes a small 3-class tree of ``.npy`` images
(a class-coloured channel over noise, from ``RandomState(0)``) to a
temporary directory.  :func:`main` returns the per-batch losses and the
evaluation's logs.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import hapi, metric, nn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision import transforms as T
from paddle_tpu_torch.vision.datasets import DatasetFolder
from paddle_tpu_torch.vision.models import resnet18

IMG = 64


def synthesize_tree(root, n_per_class=24, size=IMG):
    """3 classes of class-coloured ``size`` x ``size`` ``.npy`` images
    under ``root``."""
    rs = np.random.RandomState(0)
    for cls in range(3):
        d = os.path.join(root, f"class_{cls}")
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            img = rs.rand(size, size, 3).astype("float32") * 0.3
            img[..., cls] += 0.7
            np.save(os.path.join(d, f"{i}.npy"), (img * 255).astype("uint8"))
    return root


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data", nargs="?", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    root = args.data
    if root is None:
        root = synthesize_tree(tempfile.mkdtemp(prefix="imagefolder_"))
        print(f"(no DATA_DIR given: synthesized 3-class tree at {root})")

    train_tf = T.Compose([
        T.Resize(IMG + 8), T.RandomCrop(IMG), T.RandomHorizontalFlip(),
        T.Transpose(), T.Normalize(mean=[127.5] * 3, std=[127.5] * 3)])
    ds = DatasetFolder(root, transform=train_tf)
    print(f"{len(ds)} images, {len(ds.classes)} classes: {ds.classes}")
    loader = DataLoader(ds, batch_size=16, shuffle=True, num_workers=2,
                        drop_last=True)

    torch.manual_seed(0)
    net = resnet18(num_classes=len(ds.classes), device=args.device)
    model = hapi.Model(net, device=args.device)
    model.prepare(
        optimizer=opt.Momentum(learning_rate=0.01, momentum=0.9,
                               parameters=net.parameters()),
        loss=nn.CrossEntropyLoss(), metrics=metric.Accuracy())
    rec = _Losses()
    model.fit(loader, epochs=args.epochs, verbose=1, callbacks=[rec])
    eval_tf = T.Compose([
        T.Resize(IMG), T.CenterCrop(IMG), T.Transpose(),
        T.Normalize(mean=[127.5] * 3, std=[127.5] * 3)])
    res = model.evaluate(DataLoader(DatasetFolder(root, transform=eval_tf),
                                    batch_size=16), verbose=0)
    print("eval:", res)
    return {"losses": rec.losses, "eval": res, "root": root}


if __name__ == "__main__":
    main()
