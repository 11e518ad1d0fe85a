"""BASELINE.json's config #1: ResNet-50 trained on one card (counterpart of
``examples/train_resnet50.py``): ``jit.TrainStep`` with ``Momentum(lr,
0.9, weight_decay=1e-4)``, ``CrossEntropyLoss`` and AMP (O2 by default),
over one synthetic batch of 3 x 224 x 224 images from
``numpy.RandomState(0)``, as the reference's default run.  Runs on the
card by default:

    python -m paddle_tpu_torch.examples.train_resnet50 [--batch-size 128]
        [--steps 50] [--amp O0|O1|O2] [--lr 0.1] [--device cpu]
        [--data ROOT]

``--data ROOT`` reads a class-per-folder image tree (``.npy`` arrays or
images PIL opens) through the reference's pipeline: ``Resize(256)``,
``RandomCrop(224)``, ``RandomHorizontalFlip``, ``ToTensor``,
``Normalize`` (ImageNet's mean and std), shuffled by an
``io.DataLoader`` with 4 workers, each batch moved to the card in one
copy.  The tree is read by ``DatasetFolder``, which labels each image by
its folder: the reference names ``ImageFolder``, whose samples carry no
label for ``CrossEntropyLoss``.  :func:`main` returns the losses and
the timing.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch import jit, nn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.vision.models import resnet50


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--amp", default="O2", choices=["O0", "O1", "O2"])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--data", default=None,
                    help="class-per-folder image tree (optional)")
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    torch.manual_seed(0)
    model = resnet50(num_classes=1000, device=args.device)
    device = next(model.parameters()).device
    optim = opt.Momentum(learning_rate=args.lr, momentum=0.9,
                         parameters=model.parameters(), weight_decay=1e-4)
    step = jit.TrainStep(model, optim, loss_fn=nn.CrossEntropyLoss(),
                         amp_level=None if args.amp == "O0" else args.amp)
    it = (_folder_batches(args.data, args.batch_size, device)
          if args.data else _synthetic_batches(args.batch_size, device))

    losses = [float(step(*next(it)))]   # the first step: warm-up
    t0 = time.perf_counter()
    last = None
    for i in range(args.steps):
        last = step(*next(it))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: loss {float(last):.4f}")
    if last is not None:
        losses.append(float(last))      # waits for the device
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    print(f"{args.batch_size / dt:.0f} imgs/sec ({dt * 1e3:.1f} ms/step)")
    return {"losses": losses, "step_ms": dt * 1e3,
            "images_per_s": args.batch_size / dt, "device": str(device),
            "data": args.data}


def _synthetic_batches(batch_size, device):
    """One batch from ``RandomState(0)``, again and again."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch_size, 3, 224, 224)
                         .astype("float32")).to(device)
    y = torch.from_numpy(rng.randint(0, 1000, (batch_size,))
                         .astype("int64")).to(device)
    while True:
        yield x, y


def _folder_batches(root, batch_size, device):
    """Epoch after epoch of the tree under ``root`` through the
    reference's transforms and a shuffling ``DataLoader``."""
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder

    tf = T.Compose([T.Resize(256), T.RandomCrop(224),
                    T.RandomHorizontalFlip(), T.ToTensor(),
                    T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])])
    loader = DataLoader(DatasetFolder(root, transform=tf),
                        batch_size=batch_size, shuffle=True,
                        num_workers=4, drop_last=True)
    while True:
        for x, y in loader:
            yield (torch.as_tensor(x).to(device, non_blocking=True),
                   torch.as_tensor(y).long().to(device, non_blocking=True))


if __name__ == "__main__":
    main()
