"""BASELINE.json's config #3 in miniature (counterpart of
``examples/train_detection.py``): a detector trained eagerly with Adam
2e-4 on synthetic boxes, then one evaluation.  Runs on the card unless
told:

    python -m paddle_tpu_torch.examples.train_detection
        [--arch yolo|ppyoloe|rcnn] [--steps 20] [--classes 8] [--device cpu]

``yolo``: ``yolov3(depth=18)``; ``ppyoloe``: ``ppyoloe(size="s")``;
``rcnn``: ``faster_rcnn(depth=18, num_proposals=64)``.  Each step draws 2
images of 160 x 160 and 1-3 boxes each (from ``RandomState(0)``), padded
to 8 with label -1.  :func:`main` returns the losses and the count of
detections on image 0.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.vision.models import faster_rcnn, ppyoloe, yolov3


def synth_batch(rng, b=2, size=160, max_boxes=8, classes=8):
    """``b`` random images of ``size`` (an int, or ``(h, w)``) and their
    padded gt: 1-3 boxes of 24-47 pixels an image, the rest label -1
    (numpy)."""
    h, w = (size, size) if isinstance(size, int) else size
    img = rng.randn(b, 3, h, w).astype("float32")
    gtb = np.zeros((b, max_boxes, 4), dtype="float32")
    gtl = np.full((b, max_boxes), -1, dtype="int64")
    for i in range(b):
        n = rng.randint(1, 4)
        for j in range(n):
            x1, y1 = rng.randint(0, [w - 48, h - 48])
            bw, bh = rng.randint(24, 48, 2)
            gtb[i, j] = [x1, y1, x1 + bw, y1 + bh]
            gtl[i, j] = rng.randint(0, classes)
    return img, gtb, gtl


def build(arch, classes, device=None):
    if arch == "yolo":
        return yolov3(num_classes=classes, depth=18, device=device)
    if arch == "ppyoloe":
        return ppyoloe(num_classes=classes, size="s", device=device)
    return faster_rcnn(num_classes=classes, depth=18, num_proposals=64,
                       device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yolo",
                    choices=["yolo", "ppyoloe", "rcnn"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    torch.manual_seed(0)
    model = build(args.arch, args.classes, args.device)
    device = next(model.parameters()).device
    optim = opt.Adam(learning_rate=2e-4, parameters=model.parameters())
    rng = np.random.RandomState(0)
    history = []
    for i in range(args.steps):
        img, gtb, gtl = (torch.from_numpy(a).to(device)
                         for a in synth_batch(rng, classes=args.classes))
        losses = model(img, gtb, gtl)
        losses["loss"].backward()
        optim.step()
        optim.clear_grad()
        history.append({k: float(v) for k, v in losses.items()})
        if (i + 1) % 5 == 0:
            print(f"step {i + 1}: " +
                  " ".join(f"{k}={v:.3f}" for k, v in history[-1].items()))
    model.eval()
    img = torch.from_numpy(synth_batch(rng, classes=args.classes)[0])
    dets = model(img.to(device))
    n = int(dets[0]["valid"].sum())
    print(f"eval: {n} detections on image 0")
    return {"losses": history, "detections": n, "device": str(device)}


if __name__ == "__main__":
    main()
