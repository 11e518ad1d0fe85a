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
        self._listener = Listener(("127.0.0.1", 0), authkey=key, backlog=n)
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
        self.submit(job, *args, **kw)
        return self.collect(job, timeout)

    def submit(self, job, *args, **kw):
        """Start ``job`` on every rank (:meth:`collect` its results), so
        the caller can work meanwhile."""
        for c in self._conns:
            c.send((job, args, kw))

    def collect(self, job, timeout=120.0):
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


def gpt_generate_mp(state, ids, cfg, new, page_size):
    """``generate()`` on this rank of an mp = 2 fleet world: greedy dense,
    paged and no-cache ids, a sampled paged run and beam search, and the
    heads this rank's caches hold."""
    import torch

    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              load_paddle_tpu_state_dict)
    from paddle_tpu_torch.text.models.gpt import local_heads

    hcg = _fleet(mp=2)
    model = GPTForCausalLM(device="cpu", **cfg).eval()
    load_paddle_tpu_state_dict(model, state)
    x = torch.from_numpy(ids)
    kw = dict(max_new_tokens=new, page_size=page_size)
    out = {"mp_rank": hcg.get_model_parallel_rank(),
           "heads": local_heads(model.gpt.layers[0]),
           "dense": model.generate(x, temperature=0.0, **kw),
           "paged": model.generate(x, temperature=0.0, cache_impl="paged",
                                   **kw),
           "sampled": model.generate(x, temperature=0.8, top_k=8, seed=3,
                                     cache_impl="paged", **kw),
           "no_cache": model.generate(x, temperature=0.0, use_cache=False,
                                      max_new_tokens=new),
           "beam": model.generate(x, decode_strategy="beam_search",
                                  num_beams=2, max_new_tokens=new)}
    _unfleet()
    return {k: _np(v) if torch.is_tensor(v) else v for k, v in out.items()}


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


def gpt_hybrid_example_init(argv):
    """The ``train_gpt_hybrid`` example's starting weights, built on the
    ranks as the example builds them and gathered by stage and shard
    into the reference's full dict (``lm.`` dropped)."""
    from paddle_tpu_torch.examples import train_gpt_hybrid as ex
    from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict

    args = ex._parser().parse_args(argv)
    hcg = _pp_fleet(dp=args.dp, pp=args.pp, mp=args.mp)
    state = export_paddle_tpu_state_dict(ex.build_model(args, hcg))
    _unfleet()
    return {k[3:] if k.startswith("lm.") else k: v for k, v in state.items()}


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


def card_pp_check(out_dir):
    """One pp rank of a 2-rank gloo job on the one card (started by
    ``paddle_tpu_torch.distributed.spawn``): a stage hop of card tensors
    (plain and with the shape header), then GPT-tiny's pp = 2 pipe from
    ``out_dir/gpt.npz`` trained 2 SGD steps on the card; writes
    ``rank<r>.json``."""
    import json

    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_schedule \
        import _Hops
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              GPTForCausalLMPipe,
                                              load_paddle_tpu_state_dict)

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    hcg = _pp_fleet(pp=2)
    s = hcg.get_stage_id()
    dev = torch.device("cuda")
    sent = torch.arange(4096, dtype=torch.float32, device=dev)
    odd = torch.randn(3, 5, device=dev).to(torch.bfloat16)
    before = _bytes("broadcast")
    got = _Hops(hcg).exchange([(0, 0, sent if s == 0 else None)], like=sent)
    hdr = _Hops(hcg, header=True).exchange([(0, 0, odd if s == 1 else None)],
                                           like=sent)
    out = {"rank": dist.get_rank(), "stage": s,
           "hop_bytes": _bytes("broadcast") - before}
    if s == 1:
        out["hop_ok"] = bool(got[0].is_cuda and torch.equal(got[0], sent))
    else:
        out["hop_ok"] = bool(hdr[0].is_cuda and hdr[0].dtype == torch.bfloat16
                             and tuple(hdr[0].shape) == (3, 5))
    state = dict(np.load(os.path.join(out_dir, "gpt.npz")))
    cfg = json.load(open(os.path.join(out_dir, "cfg.json")))
    ids = torch.from_numpy(np.load(os.path.join(out_dir, "ids.npy"))).to(dev)
    pipe = GPTForCausalLMPipe(GPTForCausalLM(device="cuda", **cfg), hcg,
                              n_micro=2, schedule="1f1b")
    load_paddle_tpu_state_dict(pipe, {"lm." + k: v for k, v in state.items()})
    step = jit.TrainStep(pipe, optimizer.SGD(learning_rate=0.5,
                                             parameters=pipe.parameters()))
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    out["losses"] = [float(step({"input_ids": ids, "labels": ids}))
                     for _ in range(2)]
    out["launches"] = [fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES]
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


# --------------------------------------------------------------- pipeline
def _pp_fleet(dp=1, pp=1, mp=1, pipeline=None):
    import paddle_tpu_torch.distributed.fleet as fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "pp_degree": pp, "mp_degree": mp,
                        "order": ["dp", "pp", "mp"]}
    if pipeline is not None:
        s.pipeline = True
        s.pipeline_configs = pipeline
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _replica(world_per_replica):
    """The topology of a job that needs ``world_per_replica`` ranks: the
    rest of the world are dp replicas, which would only repeat the first
    one's work; they build the topology (its groups are collective) and
    then stay idle (None), keeping the pool's CPU load to one replica."""
    return int(os.environ["PADDLE_TRAINERS_NUM"]) // world_per_replica


def _idle(hcg):
    if hcg.get_data_parallel_rank() == 0:
        return False
    _unfleet()
    return True


def _bytes(op):
    from paddle_tpu_torch.profiler import metrics

    fam = metrics.get_registry().counter("collective.bytes")
    return sum(v for _, lab, v in fam.samples() if lab["op"] == op)


def pp_toy(a, pp, schedule, remat=True):
    """The toy ``tanh(h @ W + b)`` block through ``spmd_pipeline`` at
    ``pp`` stages (dp = world / pp replicas, each the whole batch): the
    output, the gradients of this stage's W and b and of x for the
    cotangent ``a["dy"]``, and the ``pp_ppermute`` bytes recorded."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline)

    hcg = _pp_fleet(dp=_replica(pp), pp=pp)
    if _idle(hcg):
        return None
    s = hcg.get_stage_id()
    W = torch.from_numpy(a["W"][s].copy()).requires_grad_()
    b = torch.from_numpy(a["b"][s].copy()).requires_grad_()
    x = torch.from_numpy(a["x"].copy()).requires_grad_()

    def block(p, h):
        return torch.tanh(h @ p[0] + p[1])

    before = _bytes("pp_ppermute")
    hops0 = _calls().get("broadcast", 0)
    out = spmd_pipeline(block, (W, b), x, schedule=schedule, remat=remat)
    pp_bytes = _bytes("pp_ppermute") - before
    (out * torch.from_numpy(a["dy"])).sum().backward()
    res = {"stage": s, "out": _np(out), "dW": _np(W.grad), "db": _np(b.grad),
           "dx": _np(x.grad), "pp_bytes": pp_bytes,
           "broadcasts": _calls().get("broadcast", 0) - hops0}
    _unfleet()
    return res


def pp_stalled_stage(a, deadline_s, hang_s, dump_dir):
    """Stage 0 stalls ``hang_s`` in its first hop (the ``collective_hang``
    fault at its second collective, after the per-call stage check): the
    other stages' collective watchdogs report the stuck hop; the
    pipeline's output once the stage resumes."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline)
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.observability.flight_recorder import FlightRecorder
    from paddle_tpu_torch.observability.watchdog import CollectiveWatchdog

    hcg = _pp_fleet(dp=_replica(4), pp=4)
    if _idle(hcg):
        return None
    s = hcg.get_stage_id()
    rec = FlightRecorder(dir=os.path.join(
        dump_dir, f"rank{os.environ['PADDLE_TRAINER_ID']}"))
    wd = CollectiveWatchdog(deadline_s=deadline_s, poll_s=0.02,
                            recorder=rec).start()
    try:
        if s == 0:
            faults.inject("collective_hang", seconds=hang_s, at_trips={2})
        out = spmd_pipeline(lambda p, h: torch.tanh(h @ p[0] + p[1]),
                            (torch.from_numpy(a["W"][s].copy()),
                             torch.from_numpy(a["b"][s].copy())),
                            torch.from_numpy(a["x"].copy()))
    finally:
        wd.stop()
        faults.clear()
    _unfleet()
    return {"stage": s, "out": _np(out),
            "fired": [{k: r[k] for k in ("op", "nranks", "ranks_missing")}
                      for r in wd.fired]}


def pp_errors(a):
    """The reference's errors, raised on every stage alike."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline, spmd_pipeline_1f1b)

    hcg = _pp_fleet(dp=_replica(2), pp=2)
    if _idle(hcg):
        return None
    s = hcg.get_stage_id()
    W = torch.from_numpy(a["W"][s].copy())
    b = torch.from_numpy(a["b"][s].copy())
    x = torch.from_numpy(a["x"].copy())
    fn = lambda p, h: torch.tanh(h @ p[0] + p[1])  # noqa: E731
    out = {}

    def err(name, call):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    err("m_lt_s", lambda: spmd_pipeline(fn, (W, b), x[:1]))
    err("m_lt_s_1f1b", lambda: spmd_pipeline_1f1b(fn, (W, b), x[:1]))
    err("schedule", lambda: spmd_pipeline(fn, (W, b), x, schedule="zb"))
    err("interleaved_m", lambda: spmd_pipeline(fn, (W, b), x[:3],
                                               schedule="interleaved"))
    # stage 1 is handed two layers, stage 0 one
    err("stage_dim", lambda: spmd_pipeline(
        fn, (W.repeat(s + 1, 1), b.repeat(s + 1)), x))
    _unfleet()
    return out


def _gpt_pipe(state, cfg, schedule, n_micro, batch_axis=None, **kw):
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              GPTForCausalLMPipe,
                                              load_paddle_tpu_state_dict)

    seed(0)
    pipe = GPTForCausalLMPipe(GPTForCausalLM(device="cpu", **cfg),
                              n_micro=n_micro, batch_axis=batch_axis,
                              schedule=schedule, **kw)
    load_paddle_tpu_state_dict(pipe, state)
    return pipe


def pp_gpt_forward(state, ids, cfg, pp, mp, schedule):
    """``pipeline_forward``'s eval hidden at pp x mp from the reference's
    weights (the rest of the world dp replicas), and the same through
    ``stack_block_params`` and ``spmd_pipeline``."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        spmd_pipeline)
    from paddle_tpu_torch.text.models import (block_fn_for, pipeline_forward,
                                              stack_block_params)
    from paddle_tpu_torch.text.models.gpt import single_block_fn_for

    hcg = _pp_fleet(dp=_replica(pp * mp), pp=pp, mp=mp)
    if _idle(hcg):
        return None
    pipe = _gpt_pipe(state, cfg, schedule, 4).eval()
    gpt = pipe.lm.gpt
    with torch.no_grad():
        h = pipeline_forward(gpt, torch.from_numpy(ids), hcg,
                             n_micro=4, schedule=schedule)
        # the reference callers' form: the stage's blocks stacked
        order = "lap" if schedule == "interleaved" else "stage"
        fn = single_block_fn_for(gpt) if order == "lap" else block_fn_for(gpt)
        x = gpt.embed(torch.from_numpy(ids))
        y = spmd_pipeline(fn, stack_block_params(gpt, pp, order),
                          x.reshape((4, -1) + tuple(x.shape[1:])),
                          schedule=schedule)
        h_stacked = gpt.final_ln(y.reshape(x.shape))
    blocks = sorted(int(k.split(".")[3]) for k, _ in pipe.named_parameters()
                    if k.startswith("lm.gpt.layers."))
    out = {"hidden": _np(h), "hidden_stacked": _np(h_stacked),
           "stage": hcg.get_stage_id(), "blocks": sorted(set(blocks))}
    _unfleet()
    return out


def pp_gpt_train(state, ids, cfg, steps, lr, schedule, dp=1, pp=2, mp=1,
                 amp_level=None, accumulate_steps=1, n_micro=4):
    """``GPTForCausalLMPipe`` trained through ``TrainStep`` (AdamW,
    ClipGradByGlobalNorm(1.0)) at dp x pp x mp (dp with
    ``batch_axis='dp'``; the rest of the world plain replicas): the
    losses, the weights gathered back into the reference's dict, what
    the rank holds, and the dtypes its blocks' qkv projection gave (every
    block call binds into one held block's structure, recomputes too)."""
    import torch

    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict

    hcg = _pp_fleet(dp=_replica(pp * mp), pp=pp, mp=mp)
    if dp == 1 and _idle(hcg):
        return None
    pipe = _gpt_pipe(state, cfg, schedule, n_micro,
                     batch_axis="dp" if dp > 1 else None)
    dtypes = set()
    next(iter(pipe.lm.gpt.layers.values())).qkv.register_forward_hook(
        lambda m, i, o: dtypes.add(str(o.dtype)))
    o = opt.AdamW(learning_rate=lr, weight_decay=0.01,
                  parameters=pipe.parameters(),
                  grad_clip=opt.ClipGradByGlobalNorm(1.0))
    step = jit.TrainStep(pipe, o, loss_fn=None, amp_level=amp_level,
                         accumulate_steps=accumulate_steps)
    x = torch.from_numpy(ids)
    before = _calls()
    losses = [float(step({"input_ids": x, "labels": x}))
              for _ in range(steps)]
    after = _calls()
    held = sorted({int(k.split(".")[3]) for k in pipe.state_dict()
                   if k.startswith("lm.gpt.layers.")})
    out = {"losses": losses, "stage": hcg.get_stage_id(),
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(), "held": held,
           "n_moments": sum(len(o._state_of(p)) > 0
                            for p in pipe.parameters()),
           "n_params": len(list(pipe.parameters())),
           "qkv_dtypes": sorted(dtypes),
           "calls": {k: v - before.get(k, 0) for k, v in after.items()
                     if v - before.get(k, 0)},
           "final": export_paddle_tpu_state_dict(pipe)}
    _unfleet()
    return out


def pp_convert(state, cfg):
    """The reference pipe's dict loaded by stage at pp2 x mp2 and
    exported back."""
    from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict

    if _idle(_pp_fleet(dp=_replica(4), pp=2, mp=2)):
        return None
    pipe = _gpt_pipe(state, cfg, "gpipe", 4)
    own = sorted(pipe.state_dict())
    back = export_paddle_tpu_state_dict(pipe, expected=state)
    _unfleet()
    return {"own": own, "same": all(np.array_equal(back[k], state[k])
                                    for k in state)}


def pp_head_loss(h, w, labels):
    """``sharded_vocab_head_loss`` at mp = 2 (the rest dp replicas, no
    dp mean): the loss, the hidden's gradient and this rank's rows of the
    weight's gradient."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        sharded_vocab_head_loss)

    hcg = _pp_fleet(dp=_replica(2), mp=2)
    if _idle(hcg):
        return None
    r = hcg.get_model_parallel_rank()
    ht = torch.from_numpy(h.copy()).requires_grad_()
    wt = torch.from_numpy(np.split(w, 2)[r].copy()).requires_grad_()
    loss = sharded_vocab_head_loss(ht, wt, torch.from_numpy(labels))
    loss.backward()
    out = {"mp_rank": r, "loss": float(loss), "dh": _np(ht.grad),
           "dw": _np(wt.grad)}
    _unfleet()
    return out


def pp_norm(state, ids, cfg):
    """ClipGradByGlobalNorm's norm at pp2 x mp2 after one backward of
    the pipe's loss."""
    import torch

    from paddle_tpu_torch import optimizer as opt

    if _idle(_pp_fleet(dp=_replica(4), pp=2, mp=2)):
        return None
    pipe = _gpt_pipe(state, cfg, "1f1b", 4)
    x = torch.from_numpy(ids)
    loss = pipe(x, labels=x)
    loss.backward()
    norm = opt.ClipGradByGlobalNorm(1.0)._global_norm(
        [(p, p.grad) for p in pipe.parameters()])
    _unfleet()
    return float(loss), float(norm)


def pp_strategy():
    """The schedule from ``strategy.pipeline_configs['schedule_mode']``
    at pp = 2, as ``tests/test_gpt_hybrid.py`` asserts it."""
    import warnings

    import torch

    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.text.models import GPTForCausalLMPipe

    if _idle(_pp_fleet(dp=_replica(2), pp=2,
                       pipeline={"schedule_mode": "1F1B"})):
        fleet._FLEET["strategy"] = None
        return None
    strategy = fleet.get_strategy()
    # defaults-merge: a partial update keeps schedule_mode
    strategy.pipeline_configs = {"accumulate_steps": 4}
    out = {"kept": strategy.pipeline_configs["schedule_mode"]}
    cfg = dict(vocab_size=64, hidden_size=32, num_attention_heads=2,
               max_position_embeddings=32, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        1, 64, (4, 8)).astype("int64"))
    torch.manual_seed(0)
    pipe = GPTForCausalLMPipe(num_hidden_layers=2, n_micro=2, **cfg)
    out["mode_1f1b"] = pipe._schedule
    with torch.no_grad():
        out["loss_1f1b"] = float(pipe(ids, labels=ids))
    # 1F1B is an execution order: the gpipe schedule's numerics
    torch.manual_seed(0)
    ref = GPTForCausalLMPipe(num_hidden_layers=2, n_micro=2,
                             schedule="gpipe", **cfg)
    with torch.no_grad():
        out["loss_gpipe"] = float(ref(ids, labels=ids))
    strategy.pipeline_configs = {"schedule_mode": "Interleave"}
    pipe2 = GPTForCausalLMPipe(num_hidden_layers=4, n_micro=2, **cfg)
    out["mode_interleave"] = pipe2._schedule
    with torch.no_grad():
        out["loss_interleave"] = float(pipe2(ids, labels=ids))
    pipe3 = GPTForCausalLMPipe(num_hidden_layers=2, n_micro=2,
                               schedule="gpipe", **cfg)
    out["mode_explicit"] = pipe3._schedule
    strategy.pipeline_configs = {"schedule_mode": "VPP"}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pipe4 = GPTForCausalLMPipe(num_hidden_layers=2, n_micro=2, **cfg)
    out["mode_unknown"] = pipe4._schedule
    out["warned"] = [str(w.message) for w in rec
                     if "schedule_mode" in str(w.message)]
    _unfleet()
    fleet._FLEET["strategy"] = None
    return out


def _pl_descs(d, n_out):
    """Embedding -> 3 x (Linear, Tanh) -> the tied head (a
    SharedLayerDesc pair)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)

    def head(layer, x):
        return x @ layer.weight.T

    return ([SharedLayerDesc("emb", nn.Embedding, None, "weight", n_out, d)]
            + [LayerDesc(nn.Linear, d, d), nn.Tanh()] * 3
            + [SharedLayerDesc("emb", nn.Embedding, head, "weight", n_out,
                               d)])


def pp_layer_train(state, x, y, steps, lr, acc, pp=2):
    """A ``PipelineLayer`` (embedding, three Linear + Tanh, the tied head)
    through ``fleet.distributed_model`` and ``train_batch`` (SGD):
    ``segment_parts``, the losses, and the weights gathered back."""
    import torch

    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)
    from paddle_tpu_torch.text.models import (export_paddle_tpu_state_dict,
                                              load_paddle_tpu_state_dict)

    # every dp replica runs: PipelineParallel mean-reduces over dp
    hcg = _pp_fleet(dp=_replica(pp), pp=pp,
                    pipeline={"accumulate_steps": acc})
    d, n_out = state["1.weight"].shape[0], state["0.weight"].shape[0]
    torch.manual_seed(0)
    pl = PipelineLayer(_pl_descs(d, n_out), num_stages=pp, topology=hcg,
                       loss_fn=nn.CrossEntropyLoss())
    load_paddle_tpu_state_dict(pl, state)
    model = fleet.distributed_model(pl)
    o = opt.SGD(learning_rate=lr, parameters=model.parameters())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(model.train_batch((xt, yt), o)) for _ in range(steps)]
    out = {"wrapped": type(model) is PipelineParallel,
           "segment_parts": pl.segment_parts, "stage": hcg.get_stage_id(),
           "own": sorted(pl.state_dict()), "losses": losses,
           "final": export_paddle_tpu_state_dict(pl)}
    _unfleet()
    return out
