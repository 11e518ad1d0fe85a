"""PyTorch port, distributed part one: process groups, every eager
collective and ``ReduceOp``, the hybrid topology and the collective
watchdog, held against ``paddle_tpu.distributed``.

The reference is single-controller: an eager call on a rank-stacked
array ``[N, *S]`` stands for "each of the N ranks holds a tensor of shape
S".  The port runs one process per rank, so four gloo rank processes
(``_torch_port_dist_workers.RankPool``, one torch thread each) each pass
their row, and rank r's result must equal row r of the reference's
stacked output on a group of 4 of the 8 virtual CPU devices; for the
replicated reading every rank passes the same value and gets the
reference's result for that value.  Topologies are pure index
arithmetic, held to the reference's directly."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu_torch.distributed import topology as ttopo
from _torch_port_dist_workers import OPS, REPO, RankPool

RS = np.random.RandomState(0)
X = (RS.rand(4, 3) + 0.5).astype("float32")          # positive (PROD's log)
X_RS = (RS.rand(4, 4, 2) + 0.5).astype("float32")    # reduce_scatter pieces
X_A2A = RS.rand(4, 4, 2).astype("float32")
X_A2AS = RS.rand(16, 2).astype("float32")
OBJ = {"step": 7, "names": ["a", "b"]}
EXACT = dict(rtol=0, atol=0)
F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def port(pool):
    """Every op's per-rank results, from one job."""
    return pool.run("collectives", X, X_RS, X_A2A, X_A2AS, OBJ)


@pytest.fixture
def jgroup():
    g = jdist.new_group(list(range(4)))
    yield g
    jdist.destroy_process_group()


def _j(t):
    return np.asarray(t.numpy())


def _jt(a):
    return paddle.to_tensor(np.array(a))


def test_jax_collective_families_are_in_the_readme_table(jgroup):
    """The reference's eager collectives register only families of the
    README metrics table that ``test_memory_observability.py`` reads."""
    import re

    from paddle_tpu.profiler import metrics as jmetrics

    jdist.all_reduce(_jt(X), group=jgroup)
    jdist.all_gather([], _jt(X), group=jgroup)
    jdist.barrier(jgroup)
    readme = open(os.path.join(REPO, "README.md")).read()
    documented = set(re.findall(r"^\| `([a-z0-9_.]+)` \|", readme,
                                flags=re.M))
    live = {m.name for m in jmetrics.get_registry().metrics()
            if m.name.startswith("collective.")}
    assert live and live <= documented, sorted(live - documented)


@pytest.mark.parametrize("op", OPS)
def test_all_reduce(port, jgroup, op):
    rop = getattr(jdist.ReduceOp, op)
    want = _j(jdist.all_reduce(_jt(X), op=rop, group=jgroup))
    rep = _j(jdist.all_reduce(_jt(X[0]), op=rop, group=jgroup))
    tol = EXACT if op in ("MAX", "MIN") else F32
    for r in range(4):
        np.testing.assert_allclose(port[r][f"all_reduce_{op}"], want[r],
                                   **tol)
        np.testing.assert_allclose(port[r][f"all_reduce_rep_{op}"], rep,
                                   **tol)


@pytest.mark.parametrize("op", OPS)
def test_reduce(port, jgroup, op):
    """Rank 1 (dst) gets the reduction; every other rank keeps its row."""
    rop = getattr(jdist.ReduceOp, op)
    want = _j(jdist.reduce(_jt(X), dst=1, op=rop, group=jgroup))
    tol = EXACT if op in ("MAX", "MIN") else F32
    for r in range(4):
        np.testing.assert_allclose(port[r][f"reduce_{op}"], want[r], **tol)
    np.testing.assert_array_equal(port[0]["reduce_SUM"], X[0])


@pytest.mark.parametrize("op", OPS)
def test_reduce_scatter(port, jgroup, op):
    rop = getattr(jdist.ReduceOp, op)
    out = paddle.Tensor(np.zeros((4, 2), "float32"))
    want = _j(jdist.reduce_scatter(out, _jt(X_RS), op=rop, group=jgroup))
    # a list is every rank's same contribution (the replicated reading)
    out = paddle.Tensor(np.zeros((4, 2), "float32"))
    rep = _j(jdist.reduce_scatter(out, [_jt(p) for p in X_RS[0]], op=rop,
                                  group=jgroup))
    tol = EXACT if op in ("MAX", "MIN") else F32
    for r in range(4):
        np.testing.assert_allclose(port[r][f"reduce_scatter_{op}"], want[r],
                                   **tol)
        np.testing.assert_allclose(port[r][f"reduce_scatter_rep_{op}"],
                                   rep[r], **tol)


def test_all_gather(port, jgroup):
    lst = []
    want = _j(jdist.all_gather(lst, _jt(X), group=jgroup))
    rep = _j(jdist.all_gather([], _jt(X[0]), group=jgroup))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["all_gather"], want)
        np.testing.assert_array_equal(np.stack(port[r]["all_gather_list"]),
                                      np.stack([_j(t) for t in lst]))
        np.testing.assert_array_equal(port[r]["all_gather_rep"], rep)


def test_broadcast(port, jgroup):
    want = _j(jdist.broadcast(_jt(X), src=2, group=jgroup))
    rep = _j(jdist.broadcast(_jt(X[0]), src=2, group=jgroup))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["broadcast"], want[r])
        np.testing.assert_array_equal(port[r]["broadcast_rep"], rep)


def test_scatter(port, jgroup):
    # its stacked output (given a tensor, it writes row 0 into it)
    want = _j(jdist.scatter(None, [_jt(p) for p in X], src=1, group=jgroup))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["scatter"], want[r])


def test_alltoall(port, jgroup):
    outs = []
    want = _j(jdist.alltoall(outs, _jt(X_A2A), group=jgroup))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["alltoall"], want[r])


def test_alltoall_single_with_split_sizes(port, jgroup):
    """Equal split sizes against the reference's stacked layout; uneven
    ones (which the reference cannot express) against their definition:
    rank i's slice j lands on rank j after those of ranks < i."""
    want = _j(jdist.alltoall_single(None, _jt(X_A2AS), [1] * 4, [1] * 4,
                                    group=jgroup))
    for r in range(4):
        np.testing.assert_array_equal(port[r]["alltoall_single"],
                                      want[r * 4:(r + 1) * 4])
    for r in range(4):
        parts = []
        for i in range(4):
            send = [(i + j) % 2 + 1 for j in range(4)]
            start = sum(send[:r])
            parts.append(np.arange(start, start + send[r]) + 100 * i)
        np.testing.assert_array_equal(port[r]["alltoall_single_uneven"],
                                      np.concatenate(parts))


def test_all_gather_object(port, jgroup):
    rep = jdist.all_gather_object([], OBJ, group=jgroup)
    for r in range(4):
        assert port[r]["all_gather_object_rep"] == rep
        assert port[r]["all_gather_object"] == [
            {"rank": i, "v": [i] * i} for i in range(4)]


def test_send_recv_are_point_to_point(port):
    """A real transfer between processes (the reference's same-process
    mailbox cannot reach another process): isend / irecv around the ring
    and send / recv between pairs."""
    for r in range(4):
        np.testing.assert_array_equal(port[r]["p2p_ring"], X[(r - 1) % 4])
        if r % 2:
            np.testing.assert_array_equal(port[r]["p2p_pair"], 2 * X[r - 1])


def test_subgroup_members_and_outsiders(port):
    for r in range(4):
        assert port[r]["sub_rank"] == {1: 0, 3: 1}.get(r, -1)
        want = X[1] + X[3] if r in (1, 3) else X[r]
        np.testing.assert_array_equal(port[r]["sub_all_reduce"], want)


def test_each_call_counts_once(port):
    """``collective.calls`` counts every op once per call (barrier
    included; the outsiders of the subgroup count nothing)."""
    n = len(OPS)
    for r in range(4):
        want = {"all_reduce": 2 * n + (1 if r in (1, 3) else 0),
                "reduce": n, "reduce_scatter": 2 * n, "all_gather": 2,
                "broadcast": 2, "scatter": 1, "alltoall": 1,
                "alltoall_single": 2, "all_gather_object": 2, "barrier": 1,
                "send": 1 + (r % 2 == 0), "recv": 1 + (r % 2 == 1)}
        assert port[r]["calls"] == want, (r, port[r]["calls"])


TOPOS = [(("dp", "pp", "sharding", "sep", "mp"), (2, 1, 1, 1, 4)),
         (("dp", "pp", "mp"), (2, 2, 2)),
         (("dp", "pp", "sharding", "sep", "mp"), (1, 2, 2, 2, 1)),
         (("mp", "dp"), (4, 2))]


@pytest.mark.parametrize("order,dims", TOPOS)
def test_topology_index_arithmetic_matches_reference(order, dims):
    t, j = ttopo.CommunicateTopology(order, dims), \
        jtopo.CommunicateTopology(order, dims)
    assert t.world_size() == j.world_size()
    for a in order:
        assert t.get_comm_list(a) == j.get_comm_list(a)
        assert t.get_dim(a) == j.get_dim(a)
        for i in range(t.get_dim(a)):
            assert t.get_axis_list(a, i) == j.get_axis_list(a, i)
    for r in range(t.world_size()):
        assert {k: int(v) for k, v in t.get_coord(r).items()} == \
            {k: int(v) for k, v in j.get_coord(r).items()}
        assert t.get_rank(**t.get_coord(r)) == j.get_rank(**j.get_coord(r))


@pytest.mark.parametrize("order,dims", [
    (("dp", "pp", "sharding", "sep", "mp"), (2, 1, 1, 1, 2)),
    (("dp", "pp", "sharding", "sep", "mp"), (1, 1, 1, 1, 4)),
    (("mp", "dp"), (2, 2))])
def test_hybrid_group_rank_getters_are_each_rank_s_own(pool, order, dims):
    """Each rank's getters return its real coordinate (no warning: the
    reference warns that one process drives every rank, which cannot
    happen here) and its groups are the reference's comm lists."""
    res = pool.run("hcg_coords", order, dims)
    ref = jtopo.CommunicateTopology(order, dims)
    for r, got in enumerate(res):
        coord = {k: int(v) for k, v in ref.get_coord(r).items()}
        assert got["rank"] == r
        for a in order:
            assert got[a] == coord[a]
            assert got["groups"][a] == next(
                g for g in ref.get_comm_list(a) if r in g)
        assert got["dp_src"] == got["groups"]["dp"][0]
    dmap = dict(zip(order, dims))
    want_mode = ("hybrid" if dmap.get("mp", 1) > 1 or dmap.get("pp", 1) > 1
                 else "data" if dmap.get("dp", 1) > 1 else "single")
    assert {g["mode"] for g in res} == {want_mode}


def test_watchdog_fires_on_a_collective_hang(pool, tmp_path):
    """Rank 0 hangs inside the ``collective_hang`` fault: every rank's
    watchdog fires once for the stuck all_reduce, naming itself present
    and the others missing, and dumps a flight record; the record has the
    reference's keys."""
    res = pool.run("watchdog", 0.2, 0.8, str(tmp_path))
    for r, fired in enumerate(res):
        assert len(fired) == 1, fired
        f = fired[0]
        assert f["op"] == "all_reduce" and f["nranks"] == 4
        assert f["ranks_present"] == [r]
        assert f["ranks_missing"] == [i for i in range(4) if i != r]
        assert f["age_s"] >= 0.2
        doc = json.load(open(f["dump_path"]))
        assert doc["reason"] == "collective_watchdog"
        assert doc["extra"]["op"] == "all_reduce"
    # the reference's record on the same fault
    from paddle_tpu.observability import faults, watchdog
    from paddle_tpu.observability.flight_recorder import FlightRecorder

    x = _jt(np.ones((8, 2), "float32"))
    jdist.all_reduce(x)             # its first dispatch is not watched
    wd = watchdog.CollectiveWatchdog(
        deadline_s=0.1, poll_s=0.02,
        recorder=FlightRecorder(dir=str(tmp_path / "jax"))).start()
    faults.inject("collective_hang", seconds=0.4, times=1)
    try:
        jdist.all_reduce(_jt(np.ones((8, 2), "float32")))
    finally:
        faults.clear()
        wd.stop()
    assert len(wd.fired) == 1
    assert set(wd.fired[0]) == set(res[0][0])


def test_world_of_one_without_env():
    """No env contract: a world of one (an in-memory rendezvous); every
    op is the identity or the one-element list; the CPU backend is gloo."""
    import paddle_tpu_torch.distributed as dist

    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("PADDLE_TRAINER")}
    try:
        env = dist.init_parallel_env(device="cpu")
        assert (env.rank, env.world_size) == (0, 1)
        assert dist.get_backend() == "gloo"
        t = torch.tensor([1.5, 2.0])
        assert torch.equal(dist.all_reduce(t.clone()), t)
        assert torch.equal(dist.all_gather([], t), t[None])
        assert dist.all_gather_object([], "x") == ["x"]
        assert torch.equal(dist.broadcast(t.clone(), src=0), t)
        out = torch.empty(2)
        assert torch.equal(dist.reduce_scatter(out, [t]), t)
        assert torch.equal(dist.alltoall_single(None, t), t)
        dist.barrier()
        with pytest.raises(ValueError):        # torch's own rule
            dist.send(t, dst=0)
    finally:
        dist.destroy_process_group()
        os.environ.update(saved)
    assert not dist.is_initialized()


def test_spawn_starts_one_process_per_rank(tmp_path):
    """``spawn`` starts ``nprocs`` processes (the reference runs ``func``
    once), each with its rank's env contract."""
    import paddle_tpu_torch.distributed as dist
    from _torch_port_dist_workers import spawn_probe

    dist.spawn(spawn_probe, args=(str(tmp_path),), nprocs=2, backend="gloo")
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert [(g["rank"], g["world"], g["sum"], g["local"], g["backend"])
            for g in got] == [(0, 2, 3.0, 0, "gloo"), (1, 2, 3.0, 1, "gloo")]
    assert got[0]["endpoints"] == got[1]["endpoints"] and \
        len(got[0]["endpoints"]) == 2


def test_launch_starts_one_process_per_rank(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
    hands each process the env contract; their all_reduce is real; the
    elastic flags name the part of item 9 they wait for."""
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent(f"""
        import json, os, sys, torch
        torch.set_num_threads(1)
        import paddle_tpu_torch.distributed as dist
        env = dist.init_parallel_env(device="cpu")
        t = dist.all_reduce(torch.tensor([float(env.rank + 1)]))
        json.dump({{"rank": env.rank, "world": env.world_size,
                    "sum": float(t[0]), "local": env.local_rank,
                    "endpoint": env.current_endpoint}},
                  open(os.path.join({str(tmp_path)!r},
                                    f"r{{env.rank}}.json"), "w"))
        dist.destroy_process_group()
    """))
    env = dict(os.environ, PYTHONPATH=REPO, PADDLE_DISTRI_BACKEND="gloo")
    port = __import__("_torch_port_dist_workers")._free_port()
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master", f"127.0.0.1:{port}",
         "--log_dir", str(tmp_path / "log"), str(script)],
        env=env, cwd=REPO, timeout=120).returncode
    assert rc == 0, open(tmp_path / "log" / "workerlog.0").read()
    got = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert [(g["rank"], g["world"], g["sum"], g["local"]) for g in got] == \
        [(0, 2, 3.0, 0), (1, 2, 3.0, 1)]
    assert got[0]["endpoint"] == f"127.0.0.1:{port}"
    from paddle_tpu_torch.distributed.launch import main

    for flag in (["--run_all_nodes"], ["--elastic_max_restarts", "2"]):
        with pytest.raises(SystemExit, match="elastic part"):
            main([*flag, str(script)])
