"""BASELINE.json's config #5: a GPT decoder LM under Fleet hybrid
parallelism, dp x pp x mp (counterpart of ``examples/train_gpt_hybrid.py``).
One process per rank: a rank holds its mp shard of its pp stage's blocks
(and the embeddings, the final LayerNorm and the tied head as replicas),
runs its dp block of every micro-batch, and the loss is the dp mean of
the vocab-sharded cross-entropy.

    python -m paddle_tpu_torch.examples.train_gpt_hybrid --nprocs 8 \\
        [--dp 2 --pp 2 --mp 2] [--steps 10] [--device cpu]

``--nprocs N`` starts N rank processes through
``paddle_tpu_torch.distributed.spawn`` (``PADDLE_DISTRI_BACKEND=gloo``
puts them on one card); without it the script is one rank of a job that
``python -m paddle_tpu_torch.distributed.launch`` started.  Each rank
runs on its card unless ``--device`` names another.  The batch is
``micro x dp`` rows, the same on every rank.  :func:`main` returns this
rank's loss of every step (the first, untimed, included) and the
tokens/s; :func:`build_model` builds the rank's model alone.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch import jit
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework.random import seed
from paddle_tpu_torch.text.models import GPTForCausalLM, GPTForCausalLMPipe


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the rank's card unless given (e.g. cpu)")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="start this many rank processes (spawn)")
    return ap


def build_model(args, hcg):
    """The example's model from ``seed(0)``, on the CPU: this rank's part
    of the GPT (its stage's blocks and mp shards) at pp > 1."""
    seed(0)
    lm = GPTForCausalLM(vocab_size=args.vocab, hidden_size=args.hidden,
                        num_hidden_layers=args.layers,
                        num_attention_heads=args.heads,
                        max_position_embeddings=args.seq, device="cpu")
    if args.pp > 1:
        return GPTForCausalLMPipe(lm, hcg, n_micro=args.micro,
                                  batch_axis="dp" if args.dp > 1 else None)
    return lm


def main(argv=None, log=print):
    args = _parser().parse_args(argv)
    dist.init_parallel_env(device=args.device)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": args.dp, "pp_degree": args.pp,
                               "mp_degree": args.mp,
                               "order": ["dp", "pp", "mp"]}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    dev = dist.env.device()
    rank = dist.get_rank()
    if rank == 0:
        log(f"topology: dp{args.dp} x pp{args.pp} x mp{args.mp} over "
            f"{dist.get_world_size()} ranks")

    model = build_model(args, hcg).to(dev)
    optim = fleet.distributed_optimizer(
        opt.AdamW(learning_rate=3e-4, parameters=model.parameters()))
    step = jit.TrainStep(model, optim, loss_fn=None)

    B = args.micro * max(args.dp, 1)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(
        rng.randint(1, args.vocab, (B, args.seq)).astype("int64")).to(dev)

    losses = [step({"input_ids": ids, "labels": ids})]
    float(losses[0])
    t0 = time.time()
    for i in range(args.steps):
        losses.append(step({"input_ids": ids, "labels": ids}))
        if rank == 0:
            log(f"step {i + 1}: loss {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    dt = (time.time() - t0) / max(args.steps, 1)
    tps = B * args.seq / dt
    if rank == 0:
        log(f"{tps:.0f} tokens/sec ({dt * 1e3:.1f} ms/step) on "
            f"dp{args.dp} x pp{args.pp} x mp{args.mp}")
    return {"rank": rank, "dp_rank": hcg.get_data_parallel_rank(),
            "stage": hcg.get_stage_id(),
            "mp_rank": hcg.get_model_parallel_rank(), "losses": losses,
            "tokens_per_s": tps}


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
