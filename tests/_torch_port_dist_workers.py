"""Rank processes of the distributed port tests (imported by them, not a
test module itself).

:class:`RankPool` starts ``n`` gloo rank processes on the CPU, each with
one torch thread, and sends them jobs: ``pool.run("name", *args)`` calls
``name(*args)`` of this module on every rank and returns the results in
rank order.  The rank side imports only torch, numpy and
``paddle_tpu_torch``; arguments and results are numpy arrays and plain
Python values.  Each job sets up the topology it needs and tears it down.
"""

import os
import secrets
import socket
import subprocess
import sys
import threading
import traceback
from multiprocessing.connection import Client, Listener

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RankPool:
    """``n`` rank processes of one gloo job on the CPU."""

    def __init__(self, n=4, start_timeout=120.0):
        self.n = n
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        store = f"127.0.0.1:{_free_port()}"
        self._procs = []
        for r in range(n):
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": str(n),
                "PADDLE_TRAINER_ENDPOINTS": ",".join([store] * n),
                "PADDLE_CURRENT_ENDPOINT": store,
                "PADDLE_LOCAL_RANK": str(r),
                "PADDLE_DISTRI_BACKEND": "gloo", "OMP_NUM_THREADS": "1",
                "RANK_POOL_ADDRESS": "%s:%d" % self._listener.address,
                "RANK_POOL_KEY": key.hex(),
                "PYTHONPATH": os.pathsep.join(
                    [REPO, HERE, env.get("PYTHONPATH", "")])})
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import _torch_port_dist_workers as w; w.serve()"],
                env=env, cwd=REPO))
        conns = {}

        def accept():
            for _ in range(n):
                c = self._listener.accept()
                conns[c.recv()] = c

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        t.join(start_timeout)
        if len(conns) != n:
            self.close()
            raise RuntimeError(f"only {len(conns)} of {n} rank processes "
                               "started")
        self._conns = [conns[r] for r in range(n)]

    def run(self, job, *args, timeout=120.0, **kw):
        for c in self._conns:
            c.send((job, args, kw))
        out, errs = [], []
        for r, c in enumerate(self._conns):
            if not c.poll(timeout):
                raise TimeoutError(f"rank {r} did not finish {job} in "
                                   f"{timeout} s")
            status, val = c.recv()
            (out if status == "ok" else errs).append(val)
        if errs:
            raise AssertionError(f"{job} failed on a rank:\n" + errs[0])
        return out

    def close(self):
        for c in getattr(self, "_conns", []):
            try:
                c.send(None)
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()


# ------------------------------------------------------------ the rank side
def serve():
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(device="cpu", timeout_s=300)
    host, port = os.environ["RANK_POOL_ADDRESS"].rsplit(":", 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ["RANK_POOL_KEY"]))
    conn.send(dist.get_rank())
    while True:
        msg = conn.recv()
        if msg is None:
            break
        job, args, kw = msg
        try:
            conn.send(("ok", globals()[job](*args, **kw)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy().copy()


def _calls():
    from paddle_tpu_torch.profiler import metrics

    fam = metrics.get_registry().counter("collective.calls")
    out = {}
    for _, labels, value in fam.samples():
        out[labels["op"]] = out.get(labels["op"], 0) + int(value)
    return out


def _fleet(dp=1, mp=1):
    import paddle_tpu_torch.distributed.fleet as fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _unfleet():
    from paddle_tpu_torch.distributed import collective, topology

    hcg = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    for gid in getattr(hcg, "_group_ids", ()):
        collective._GROUPS.pop(gid, None)


OPS = ("SUM", "MAX", "MIN", "PROD", "AVG")


def collectives(x, x_rs, x_a2a, x_a2as, obj):
    """Every eager op on a new group of the 4 ranks (and a subgroup):
    each rank passes its row of the stacked inputs, and the row 0 value
    for the replicated readings."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp

    before = _calls()
    g = dist.new_group([0, 1, 2, 3])
    r = g.rank
    T = torch.from_numpy
    out = {}
    for name in OPS:
        op = getattr(ReduceOp, name)
        out[f"all_reduce_{name}"] = _np(dist.all_reduce(T(x[r].copy()),
                                                        op=op, group=g))
        out[f"all_reduce_rep_{name}"] = _np(dist.all_reduce(
            T(x[0].copy()), op=op, group=g))
        out[f"reduce_{name}"] = _np(dist.reduce(T(x[r].copy()), dst=1, op=op,
                                                group=g))
        t = torch.empty(x_rs.shape[2:])
        out[f"reduce_scatter_{name}"] = _np(dist.reduce_scatter(
            t, [T(p.copy()) for p in x_rs[r]], op=op, group=g))
        t = torch.empty(x_rs.shape[2:])
        out[f"reduce_scatter_rep_{name}"] = _np(dist.reduce_scatter(
            t, [T(p.copy()) for p in x_rs[0]], op=op, group=g))
    lst = []
    out["all_gather"] = _np(dist.all_gather(lst, T(x[r].copy()), group=g))
    out["all_gather_list"] = [_np(t) for t in lst]
    out["all_gather_rep"] = _np(dist.all_gather([], T(x[0].copy()), group=g))
    out["broadcast"] = _np(dist.broadcast(T(x[r].copy()), src=2, group=g))
    out["broadcast_rep"] = _np(dist.broadcast(T(x[0].copy()), src=2, group=g))
    t = torch.empty(x.shape[1:])
    out["scatter"] = _np(dist.scatter(
        t, [T(p.copy()) for p in x] if r == 1 else None, src=1, group=g))
    lst = []
    out["alltoall"] = _np(dist.alltoall(lst, [T(p.copy()) for p in x_a2a[r]],
                                        group=g))
    n = g.nranks
    out["alltoall_single"] = _np(dist.alltoall_single(
        None, T(x_a2as[r * n:(r + 1) * n].copy()), [1] * n, [1] * n, group=g))
    # uneven splits: rank r sends (r + i) % 2 + 1 rows to rank i
    send = [(r + i) % 2 + 1 for i in range(n)]
    recv = [(j + r) % 2 + 1 for j in range(n)]
    rows = torch.arange(sum(send), dtype=torch.float32) + 100 * r
    out["alltoall_single_uneven"] = _np(dist.alltoall_single(
        None, rows, send, recv, group=g))
    out["all_gather_object"] = dist.all_gather_object([], {"rank": r,
                                                           "v": [r] * r},
                                                      group=g)
    out["all_gather_object_rep"] = dist.all_gather_object([], obj, group=g)
    dist.barrier(g)
    # p2p around the ring: a real transfer between processes
    recv_buf = torch.empty(x.shape[1:])
    req_s = dist.isend(T(x[r].copy()), dst=(r + 1) % n, group=g)
    req_r = dist.irecv(recv_buf, src=(r - 1) % n, group=g)
    req_s.wait()
    req_r.wait()
    out["p2p_ring"] = _np(recv_buf)
    if r % 2 == 0:
        dist.send(T(x[r].copy() * 2), dst=r + 1)
        out["p2p_pair"] = None
    else:
        out["p2p_pair"] = _np(dist.recv(torch.empty(x.shape[1:]), src=r - 1))
    sub = dist.new_group([1, 3])
    out["sub_rank"] = sub.rank
    out["sub_all_reduce"] = _np(dist.all_reduce(T(x[r].copy()), group=sub))
    after = _calls()
    out["calls"] = {k: v - before.get(k, 0) for k, v in after.items()}
    dist.destroy_process_group(sub)
    dist.destroy_process_group(g)
    return out


def tp_layers(a):
    """The TP layers at mp = 4 from full weights; each rank returns its
    outputs and its shards of the gradients."""
    import torch

    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.text.models import load_paddle_tpu_state_dict

    hcg = _fleet(mp=4)
    r = hcg.get_model_parallel_rank()
    T = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    out = {"mp_rank": r}

    def grads(*ts):
        return [_np(t.grad) for t in ts]

    # column (gathered) -> out [B, o]
    col = mpl.ColumnParallelLinear(a["w1"].shape[0], a["w1"].shape[1],
                                   gather_output=True)
    load_paddle_tpu_state_dict(col, {"weight": a["w1"], "bias": a["b1"]})
    x = T(a["x"]).requires_grad_()
    y = col(x)
    (y * T(a["dy1"])).sum().backward()
    out["col_y"] = _np(y)
    out["col_dx"], out["col_dw"], out["col_db"] = grads(x, col.weight,
                                                        col.bias)
    # column (no gather) -> row (input parallel)
    col = mpl.ColumnParallelLinear(a["w1"].shape[0], a["w1"].shape[1],
                                   gather_output=False)
    row = mpl.RowParallelLinear(a["w2"].shape[0], a["w2"].shape[1],
                                input_is_parallel=True)
    load_paddle_tpu_state_dict(col, {"weight": a["w1"], "bias": a["b1"]})
    load_paddle_tpu_state_dict(row, {"weight": a["w2"], "bias": a["b2"]})
    x = T(a["x"]).requires_grad_()
    y = row(col(x))
    (y * T(a["dy2"])).sum().backward()
    out["mlp_y"] = _np(y)
    out["mlp_dx"], out["mlp_dw1"], out["mlp_db1"], out["mlp_dw2"], \
        out["mlp_db2"] = grads(x, col.weight, col.bias, row.weight, row.bias)
    # row with a full-width input (scattered on the way in)
    row = mpl.RowParallelLinear(a["w2"].shape[0], a["w2"].shape[1],
                                input_is_parallel=False)
    load_paddle_tpu_state_dict(row, {"weight": a["w2"], "bias": a["b2"]})
    h = T(a["h"]).requires_grad_()
    y = row(h)
    (y * T(a["dy2"])).sum().backward()
    out["row_y"] = _np(y)
    out["row_dh"], out["row_dw"], out["row_db"] = grads(h, row.weight,
                                                        row.bias)
    # vocab-parallel embedding
    emb = mpl.VocabParallelEmbedding(*a["emb"].shape)
    load_paddle_tpu_state_dict(emb, {"weight": a["emb"]})
    e = emb(T(a["ids"]))
    (e * T(a["de"])).sum().backward()
    out["emb_y"] = _np(e)
    out["emb_dw"] = _np(emb.weight.grad)
    # parallel cross-entropy over this rank's vocab slice
    v_loc = a["logits"].shape[-1] // 4
    loc = T(a["logits"][..., r * v_loc:(r + 1) * v_loc]).requires_grad_()
    loss = mpl.ParallelCrossEntropy()(loc, T(a["labels"]))
    (loss * T(a["dl"])).sum().backward()
    out["ce_loss"] = _np(loss)
    out["ce_dlogits"] = _np(loc.grad)
    out["sharded"] = sorted(k for k, p in
                            [("col.weight", col.weight), ("col.bias", col.bias),
                             ("row.weight", row.weight), ("row.bias", row.bias),
                             ("emb.weight", emb.weight)]
                            if mpl.is_sharded(p))
    _unfleet()
    return out


def _mlp(state):
    import torch

    from paddle_tpu_torch import nn

    m = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))
    from paddle_tpu_torch.text.models import load_paddle_tpu_state_dict

    load_paddle_tpu_state_dict(m, state)
    # a rank that starts elsewhere is put right by DataParallel's broadcast
    if int(os.environ["PADDLE_TRAINER_ID"]) != 0:
        with torch.no_grad():
            for p in m.parameters():
                p.add_(1.0)
    return m


def dp_train(state, x, y, steps):
    """DataParallel at dp = 4 through TrainStep (Momentum, CE): this
    rank's losses, its final weights and the reductions made."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch import optimizer as opt

    m = _mlp(state)
    model = dist.DataParallel(m)
    o = opt.Momentum(learning_rate=0.05, momentum=0.9,
                     parameters=model.parameters())
    step = jit.TrainStep(model, o, loss_fn=nn.CrossEntropyLoss())
    xl = model.shard_input(torch.from_numpy(x))
    yl = model.shard_input(torch.from_numpy(y))
    losses = [float(step(xl, yl)) for _ in range(steps)]
    from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict

    return {"losses": losses, "reductions": model.reductions,
            "state": export_paddle_tpu_state_dict(m)}


def dp_counts(state, x, y):
    """Gradient reductions after each of: an eager backward, the eager
    step, a TrainStep call, a second eager backward."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, nn
    from paddle_tpu_torch import optimizer as opt

    m = _mlp(state)
    model = dist.DataParallel(m)
    o = opt.Momentum(learning_rate=0.05, momentum=0.9,
                     parameters=model.parameters())
    lossf = nn.CrossEntropyLoss()
    xl = model.shard_input(torch.from_numpy(x))
    yl = model.shard_input(torch.from_numpy(y))
    counts = []
    calls0 = _calls().get("all_reduce", 0)
    lossf(model(xl), yl).backward()
    counts.append(model.reductions)
    o.step()
    o.clear_grad()
    counts.append(model.reductions)
    jit.TrainStep(model, o, loss_fn=lossf)(xl, yl)
    counts.append(model.reductions)
    lossf(model(xl), yl).backward()
    counts.append(model.reductions)
    return {"counts": counts,
            "all_reduce_calls": _calls().get("all_reduce", 0) - calls0}


def dp_after_failed_backward(state, x, y):
    """A backward that raises on every rank after the last layer's
    gradients have landed, then a clean backward: whether the first
    raised, the reductions and all_reduce calls of the two, and the
    gradients after the second."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn

    class Fault(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h):
            return h.view_as(h)

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("injected backward fault")

    m = _mlp(state)
    model = dist.DataParallel(m)
    lossf = nn.CrossEntropyLoss()
    xl = model.shard_input(torch.from_numpy(x))
    yl = model.shard_input(torch.from_numpy(y))
    calls0 = _calls().get("all_reduce", 0)
    try:
        lossf(m[2](Fault.apply(m[1](m[0](xl)))), yl).backward()
        raised = False
    except RuntimeError as e:
        raised = "injected backward fault" in str(e)
    landed = m[2].weight.grad is not None
    for p in m.parameters():
        p.grad = None
    lossf(model(xl), yl).backward()
    return {"raised": raised, "landed": landed,
            "reductions": model.reductions,
            "all_reduce_calls": _calls().get("all_reduce", 0) - calls0,
            "grads": {n: p.grad.numpy().copy()
                      for n, p in m.named_parameters()}}


def gpt_hybrid(state, ids, cfg, steps, lr):
    """GPT at dp2 x mp2 through TrainStep (AdamW, ClipGradByGlobalNorm):
    this rank's losses; its weights carried by shard and exported back."""
    import torch

    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              export_paddle_tpu_state_dict,
                                              load_paddle_tpu_state_dict)

    hcg = _fleet(dp=2, mp=2)
    model = GPTForCausalLM(device="cpu", **cfg)
    load_paddle_tpu_state_dict(model, state)
    back = export_paddle_tpu_state_dict(model, expected=state)
    carried = all(np.array_equal(back[k], state[k]) for k in state)
    before = _calls()
    dp = fleet.distributed_model(model)
    o = fleet.distributed_optimizer(opt.AdamW(
        learning_rate=lr, weight_decay=0.01, parameters=dp.parameters(),
        grad_clip=opt.ClipGradByGlobalNorm(1.0)))
    step = jit.TrainStep(dp, o, loss_fn=None)
    local = dp.shard_input(torch.from_numpy(ids))
    losses = [float(step({"input_ids": local, "labels": local}))
              for _ in range(steps)]
    after = _calls()   # the training path's collectives only
    out = {"losses": losses, "carried": carried,
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "reductions": dp.reductions,
           "calls": {k: v - before.get(k, 0) for k, v in after.items()
                     if v - before.get(k, 0)},
           "heads": model.gpt.layers[0].qkv.weight.shape[0]
           // (3 * model.gpt.layers[0].head_dim),
           "final": export_paddle_tpu_state_dict(model)}
    _unfleet()
    return out


def gpt_norm(state, ids, cfg, dp=2, mp=2):
    """The loss and the global gradient norm that ClipGradByGlobalNorm
    takes at ``dp`` x ``mp`` after one backward of the mean next-token
    loss."""
    import torch

    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              load_paddle_tpu_state_dict)

    _fleet(dp=dp, mp=mp)
    model = GPTForCausalLM(device="cpu", **cfg)
    load_paddle_tpu_state_dict(model, state)
    wrapped = fleet.distributed_model(model)
    local = torch.from_numpy(ids)
    if hasattr(wrapped, "shard_input"):
        local = wrapped.shard_input(local)
    loss = wrapped(local, labels=local)
    loss.backward()
    loss = loss.detach()
    norm = opt.ClipGradByGlobalNorm(1.0)._global_norm(
        [(p, p.grad) for p in model.parameters()])
    _unfleet()
    return float(loss), float(norm)


def watchdog(deadline_s, hang_s, dump_dir):
    """Rank 0's collective hangs ``hang_s`` in the ``collective_hang``
    fault; every rank's watchdog reports the stuck all_reduce (its flight
    dump under ``dump_dir``)."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.observability.flight_recorder import FlightRecorder
    from paddle_tpu_torch.observability.watchdog import CollectiveWatchdog

    rec = FlightRecorder(dir=os.path.join(dump_dir, f"rank{dist.get_rank()}"))
    wd = CollectiveWatchdog(deadline_s=deadline_s, poll_s=0.02,
                            recorder=rec).start()
    try:
        if dist.get_rank() == 0:
            faults.inject("collective_hang", seconds=hang_s, times=1)
        dist.all_reduce(torch.ones(2))
    finally:
        wd.stop()
        faults.clear()
    return [dict(r) for r in wd.fired]


def hcg_coords(order, dims):
    """This rank's coordinates and groups under a hybrid topology."""
    import warnings

    import paddle_tpu_torch.distributed.fleet as fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict({f"{a}_degree": d for a, d in zip(order, dims)},
                            order=list(order))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fleet.init(is_collective=True, strategy=s)
        hcg = fleet.get_hybrid_communicate_group()
        out = {"rank": hcg.get_global_rank(),
               "dp": hcg.get_data_parallel_rank(),
               "mp": hcg.get_model_parallel_rank(),
               "pp": hcg.get_stage_id(),
               "sharding": hcg.get_sharding_parallel_rank(),
               "sep": hcg.get_sep_parallel_rank(),
               "groups": {a: getattr(getattr(hcg, f"get_{n}_parallel_group")(),
                                     "ranks", None)
                          for a, n in (("dp", "data"), ("mp", "model"),
                                       ("pp", "pipe"),
                                       ("sharding", "sharding"),
                                       ("sep", "sep"))},
               "mode": hcg.get_parallel_mode(),
               "dp_src": hcg.get_data_parallel_group_src_rank()}
    _unfleet()
    return out


def example(name, argv):
    """Run a port example's ``main(argv)`` on this rank."""
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.examples.{name}")
    return mod.main(argv, log=lambda *a: None)


def card_tp_check(out_dir):
    """One rank of a 2-rank gloo job on the one card (started by
    ``paddle_tpu_torch.distributed.spawn``): the mp = 2 layers on card
    tensors against the plain math on the full weights on the card, and
    gloo's refusal of a card all_gather; writes ``rank<r>.json``."""
    import json

    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.text.models import load_paddle_tpu_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    hcg = _fleet(mp=2)
    r = hcg.get_model_parallel_rank()
    g = torch.Generator().manual_seed(5)
    full = {k: torch.randn(*s, generator=g) for k, s in
            (("x", (4, 64)), ("w1", (64, 128)), ("b1", (128,)),
             ("w2", (128, 64)), ("b2", (64,)), ("dy", (4, 64)),
             ("emb", (96, 32)), ("logits", (6, 96)))}
    ids = torch.randint(0, 96, (3, 5), generator=g)
    labels = torch.randint(0, 96, (6,), generator=g)
    dev = torch.device("cuda")
    c = {k: v.to(dev) for k, v in full.items()}
    col = mpl.ColumnParallelLinear(64, 128, gather_output=False)
    row = mpl.RowParallelLinear(128, 64, input_is_parallel=True)
    load_paddle_tpu_state_dict(col, {"weight": full["w1"].numpy(),
                                     "bias": full["b1"].numpy()})
    load_paddle_tpu_state_dict(row, {"weight": full["w2"].numpy(),
                                     "bias": full["b2"].numpy()})
    col.to(dev)
    row.to(dev)
    x = c["x"].clone().requires_grad_()
    y = row(col(x))
    (y * c["dy"]).sum().backward()
    xr = c["x"].clone().requires_grad_()
    w1 = c["w1"].clone().requires_grad_()
    yr = (xr @ w1 + c["b1"]) @ c["w2"] + c["b2"]
    (yr * c["dy"]).sum().backward()
    err = {"mlp_y": float((y - yr).abs().max()),
           "mlp_dx": float((x.grad - xr.grad).abs().max()),
           "mlp_dw1_shard": float((col.weight.grad.T - w1.grad.chunk(
               2, dim=1)[r]).abs().max())}
    emb = mpl.VocabParallelEmbedding(96, 32)
    load_paddle_tpu_state_dict(emb, {"weight": full["emb"].numpy()})
    emb.to(dev)
    err["emb_y"] = float((emb(ids.to(dev)) - c["emb"][ids.to(dev)])
                         .abs().max())
    loc = c["logits"].chunk(2, dim=-1)[r]
    ce = mpl.parallel_softmax_cross_entropy(loc, labels.to(dev))
    ref = torch.nn.functional.cross_entropy(c["logits"], labels.to(dev),
                                            reduction="none")
    err["ce"] = float((ce - ref).abs().max())
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "on_card": bool(y.is_cuda and ce.is_cuda), "err": err}
    try:
        dist.all_gather([], c["x"])
        out["gloo_card_all_gather"] = "ran"
    except RuntimeError as e:
        out["gloo_card_all_gather"] = str(e)
    _unfleet()
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def spawn_probe(out_dir):
    """A rank started by ``paddle_tpu_torch.distributed.spawn`` on the
    CPU: its env contract and a real all_reduce, to ``rank<r>.json``."""
    import json

    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist

    env = dist.init_parallel_env(device="cpu")
    t = dist.all_reduce(torch.tensor([float(env.rank + 1)]))
    out = {"rank": env.rank, "world": env.world_size, "sum": float(t[0]),
           "local": env.local_rank, "backend": dist.get_backend(),
           "endpoints": env.trainer_endpoints}
    with open(os.path.join(out_dir, f"rank{env.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
