"""Process environment of a distributed run (counterpart of
``paddle_tpu/distributed/env.py``).

One process per rank, as upstream Paddle runs on GPUs.  The launcher
(:mod:`.launch`, or :func:`..parallel.spawn`) hands each process the
reference's env contract:

- ``PADDLE_TRAINER_ID`` — this process's global rank;
- ``PADDLE_TRAINERS_NUM`` — the world size;
- ``PADDLE_TRAINER_ENDPOINTS`` — every rank's ``host:port``, rank 0's
  first (its address is the rendezvous store's);
- ``PADDLE_CURRENT_ENDPOINT`` — this rank's;
- ``PADDLE_LOCAL_RANK`` — the rank on its node (the card it takes is
  ``cuda:<local rank>``, or the ``FLAGS_selected_gpus`` entry upstream
  Paddle's launcher sets).

With none of it set, a process is a world of one, as the reference's
single-host call is.  The backend is NCCL for a card and gloo for the
CPU; ``PADDLE_DISTRI_BACKEND`` (upstream Paddle's variable) overrides it.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

_STATE = {"initialized": False, "device": None, "backend": None}


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _local_rank():
    return _env_int("PADDLE_LOCAL_RANK", _env_int("PADDLE_TRAINER_ID", 0))


def _rank_device(device):
    """The rank's device: ``device`` as given, else (None, or ``"cuda"``
    without an index) the card of its local rank (``FLAGS_selected_gpus``
    first), through ``resolve_device``."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    sel = os.environ.get("FLAGS_selected_gpus", "")
    idx = int(sel.split(",")[0]) if sel else _local_rank()
    return torch.device(dev.type, idx % max(torch.cuda.device_count(), 1))


def init_parallel_env(device=None, timeout_s=None):
    """``paddle.distributed.init_parallel_env``: join the job described by
    the env contract (a world of one without it) and return a
    :class:`ParallelEnv`.

    ``device``: None is this rank's card (``cuda:<local rank>``; an error
    without a card), ``"cpu"`` the CPU, as the port's entry points take
    it; the backend is ``PADDLE_DISTRI_BACKEND``, else NCCL for a card and
    gloo for the CPU.  ``timeout_s`` bounds each collective's wait.  A
    second call returns at once."""
    if _STATE["initialized"]:
        return ParallelEnv()
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = os.environ.get("PADDLE_DISTRI_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    rank = _env_int("PADDLE_TRAINER_ID", 0)
    world = _env_int("PADDLE_TRAINERS_NUM", 1)
    kw = {"backend": backend, "rank": rank, "world_size": world}
    if timeout_s is not None:
        kw["timeout"] = timedelta(seconds=timeout_s)
    if backend == "nccl":
        kw["device_id"] = dev
    if not dist.is_initialized():
        if world == 1 and not os.environ.get("PADDLE_TRAINER_ENDPOINTS"):
            # a world of one rendezvous in memory: no port, no network
            kw["store"] = dist.HashStore()
        else:
            master = os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                    "127.0.0.1:6170").split(",")[0]
            kw["init_method"] = f"tcp://{master}"
        dist.init_process_group(**kw)
    _STATE.update(initialized=True, device=dev, backend=backend)
    from . import collective as _c

    _c._ensure_default_group()
    return ParallelEnv()


def _shutdown():
    """Tear the default process group down (``destroy_process_group()``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(initialized=False, device=None, backend=None)


def is_initialized():
    return _STATE["initialized"]


def device():
    """This rank's device (None before :func:`init_parallel_env`)."""
    return _STATE["device"]


def backend():
    """The default group's backend name (None before
    :func:`init_parallel_env`)."""
    return _STATE["backend"]


def get_rank(group=None):
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", 0)


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", 1)


class ParallelEnv:
    """Reference: ``paddle.distributed.ParallelEnv``."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        dev = _STATE["device"]
        return (dev.index or 0) if dev is not None and dev.type == "cuda" \
            else 0

    @property
    def dev_id(self):
        return self.device_id

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return _local_rank()
