"""``python -m paddle_tpu_torch.distributed.launch`` — the job launcher
(counterpart of ``paddle_tpu/distributed/launch``).

One process per device, as upstream Paddle's launcher starts on GPUs
(the reference starts one per host: its process drives every chip).
The devices are ``--devices`` / ``--gpus`` (a comma list of card ids,
each rank's ``FLAGS_selected_gpus``) or ``--nproc_per_node`` processes;
over ``--nnodes`` hosts the global rank is ``node_rank * nproc + local``
and rank 0's ``--master`` address is the rendezvous store's.  Each
process gets the env contract of :mod:`..env` (:func:`build_env`), its
output goes to ``--log_dir/workerlog.<rank>`` when given, and the
launcher waits for all of them: when one fails it stops the rest and
returns the failing code.  ``--run_all_nodes`` and
``--elastic_max_restarts`` wait for the elastic part of ROADMAP Queue 1
item 9.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py --device cpu
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

_ELASTIC_PENDING = ("{} waits for the elastic part of ROADMAP Queue 1 "
                    "item 9 (distributed)")


def build_env(nnodes=1, node_rank=0, master="127.0.0.1:8765",
              nproc_per_node=1, local_rank=0, device_id=None):
    """The env contract of local rank ``local_rank`` on node
    ``node_rank``: rank 0's endpoint is ``master``, the others' ports
    follow it."""
    host, _, port = master.partition(":")
    port = int(port or 8765)
    world = nnodes * nproc_per_node
    rank = node_rank * nproc_per_node + local_rank
    endpoints = [f"{host}:{port + r}" for r in range(world)]
    env = {"PADDLE_TRAINERS_NUM": str(world),
           "PADDLE_TRAINER_ID": str(rank),
           "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
           "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
           "PADDLE_LOCAL_RANK": str(local_rank),
           "PADDLE_NNODES": str(nnodes)}
    if device_id is not None:
        env["FLAGS_selected_gpus"] = str(device_id)
    return env


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a training job: one process per device.")
    parser.add_argument("--nnodes", type=int,
                        default=int(os.environ.get("PADDLE_NNODES", "1")),
                        help="number of hosts in the job")
    parser.add_argument("--node_rank", type=int,
                        default=int(os.environ.get("PADDLE_NODE_RANK", "0")),
                        help="this host's rank")
    parser.add_argument("--master", type=str,
                        default=os.environ.get("PADDLE_MASTER",
                                               "127.0.0.1:8765"),
                        help="rank 0's host:port (the rendezvous store)")
    parser.add_argument("--devices", "--gpus", type=str, default=None,
                        help="comma list of card ids, one process each")
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="processes on this host (without --devices)")
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--run_all_nodes", action="store_true")
    parser.add_argument("--elastic_max_restarts", type=int, default=0)
    parser.add_argument("script", help="training script to run")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.run_all_nodes:
        raise SystemExit(_ELASTIC_PENDING.format("--run_all_nodes"))
    if args.elastic_max_restarts:
        raise SystemExit(_ELASTIC_PENDING.format("--elastic_max_restarts"))
    if args.devices:
        devices = [int(d) for d in args.devices.split(",") if d != ""]
    else:
        n = args.nproc_per_node
        if n is None:
            import torch

            n = max(torch.cuda.device_count(), 1)
        devices = [None] * n
    procs, logs = [], []
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for local, dev in enumerate(devices):
        env = dict(os.environ)
        env.update(build_env(args.nnodes, args.node_rank, args.master,
                             len(devices), local, dev))
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir,
                                    f"workerlog.{env['PADDLE_TRAINER_ID']}"),
                       "w")
            logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + list(args.script_args), env=env,
            stdout=out, stderr=subprocess.STDOUT if out else None))
    return _wait(procs, logs)


def _wait(procs, logs):
    """Wait for every process; on the first failure stop the rest.
    Returns the first non-zero exit code, or 0."""
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if code == 0:
        code = next((p.returncode for p in procs if p.returncode), 0)
    return code
