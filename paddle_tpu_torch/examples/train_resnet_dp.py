"""BASELINE.json's config #4: Fleet data-parallel ResNet (counterpart of
``examples/train_resnet_dp.py``).  One process per rank: each takes its
slice of the global batch (``shard_input``) and ``DataParallel``
mean-reduces the gradients after each backward.  The batch norms are
converted to ``SyncBatchNorm`` when there is more than one rank, so each
normalizes over the global batch as the reference's batch norm over its
dp-laid batch does; the losses are then the single-process run's.

    python -m paddle_tpu_torch.examples.train_resnet_dp --nprocs 2 \\
        [--steps 20] [--batch-size 64] [--depth 18] [--device cpu]

``--nprocs N`` starts N rank processes through
``paddle_tpu_torch.distributed.spawn`` (``PADDLE_DISTRI_BACKEND=gloo``
puts them on one card); without it the script is one
rank of a job that ``python -m paddle_tpu_torch.distributed.launch``
started (or a world of one).  Each rank runs on its card unless
``--device`` names another.  :func:`main` returns this rank's loss of
every step (the first, untimed, included) and the images/s.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch import jit, nn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.vision.models import resnet18, resnet50


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--device", default=None,
                    help="the rank's card unless given (e.g. cpu)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="start this many rank processes (spawn)")
    return ap


def main(argv=None, log=print):
    args = _parser().parse_args(argv)
    dist.init_parallel_env(device=args.device)
    fleet.init(is_collective=True)  # pure DP over every rank
    dev = dist.env.device()
    seed(0)
    ctor = resnet18 if args.depth == 18 else resnet50
    net = ctor(num_classes=100, device="cpu")
    if dist.get_world_size() > 1:
        net = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    net.to(dev)
    model = fleet.distributed_model(net)
    optim = fleet.distributed_optimizer(
        opt.Momentum(learning_rate=0.1, momentum=0.9,
                     parameters=net.parameters()))
    step = jit.TrainStep(net, optim, loss_fn=nn.CrossEntropyLoss())

    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.randn(args.batch_size, 3, 64, 64).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 100, (args.batch_size,)).astype("int64"))
    if hasattr(model, "shard_input"):   # the rank's slice of the batch
        x, y = model.shard_input(x), model.shard_input(y)
    x, y = x.to(dev), y.to(dev)

    losses = [step(x, y)]
    float(losses[0])
    t0 = time.time()
    for i in range(args.steps):
        losses.append(step(x, y))
        if (i + 1) % 5 == 0 and dist.get_rank() == 0:
            log(f"step {i + 1}: loss {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    dt = (time.time() - t0) / max(args.steps, 1)
    ips = args.batch_size / dt
    if dist.get_rank() == 0:
        log(f"{ips:.0f} imgs/sec over {dist.get_world_size()} devices")
    return {"rank": dist.get_rank(), "losses": losses, "imgs_per_s": ips}


def _rank_main(argv):
    main(argv)
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    args = _parser().parse_args()
    if args.nprocs:
        argv = [a for a in sys.argv[1:]]
        i = argv.index("--nprocs")
        del argv[i:i + 2]
        dist.spawn(_rank_main, args=(argv,), nprocs=args.nprocs)
    else:
        main()
