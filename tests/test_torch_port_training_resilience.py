"""PyTorch port, training resilience: paddle_tpu_torch's io/checkpoint
manifests, resilience/checkpoint (``AsyncCheckpointManager``),
supervisor, emergency and chaos, on the CPU against the JAX package on
the same numpy inputs.

- Manifests: the same ``files`` dict (sha256, bytes) on one directory;
  each ``corrupt_checkpoint`` mode damages the same bytes and both
  ``verify_manifest``\\ s report the same problems.
- A checkpoint of a plain tree written by either package verifies and
  restores in the other: equal ``tree.json`` documents, equal arrays.
- Two pins of the reference (ROADMAP Queue 3): a bfloat16 leaf is written
  as ``|V2`` bytes, restores as those bytes with ``to_tensors=False`` and
  raises ``TypeError`` with ``to_tensors=True``; the ``checkpoint.snapshot``
  ledger row reads 0 bytes while nothing is queued, and its byte source
  raises with a save queued, so the ledger drops the row.
- Interval, rotation, partial-save GC, quarantine naming,
  ``restore_latest_valid`` over all-corrupt checkpoints and the
  writer-behind drop count: equal to JAX's.
- ``RecoverySupervisor``: restart counts, ``on_restart`` calls, backoff
  delays, resume points and outcome equal to JAX's for transient, fatal,
  numeric failures and an exhausted budget.
- A chaos run (MLP from the same numpy weights, the fault at the same
  trip of ``chaos.train_step``): per-step losses within 1e-5 of JAX's and
  1e-6 of the port's clean run; ``run_smoke(device="cpu")`` with the
  reference's report keys and invariants.
- The async-safety boundary: a ``save(block=False)`` followed by in-place
  updates (``add_`` on every parameter; a ``TrainStep``) restores the
  pre-update bytes.
- Emergency saves: a serving watchdog fire commits a checkpoint through
  the fire listener; SIGTERM in a worker that imports only the port and
  torch commits one and the worker still dies by SIGTERM."""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.io import checkpoint as jio_ckpt
from paddle_tpu.observability import faults as jfaults
from paddle_tpu.observability import memory as jmemory
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu import resilience as jres
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.io import checkpoint as tio_ckpt
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.observability import flight_recorder, watchdog
from paddle_tpu_torch.observability import memory as tmemory
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.resilience import chaos as tchaos
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")


def _res(pkg):
    return jres if pkg == "jax" else tres


def _npz(d):
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _tree_doc(d):
    with open(os.path.join(d, "tree.json")) as f:
        return json.load(f)


def _plain_tree(pkg, seed=0):
    """Nested dict / list / tuple, f32 / i64 arrays, numpy scalars, str,
    None, bool, int, float; the f32 leaf as each package's tensor."""
    rs = np.random.RandomState(seed)
    w = rs.randn(3, 4).astype("float32")
    w_leaf = paddle.to_tensor(w) if pkg == "jax" else torch.from_numpy(w)
    return {
        "model": {"w": w_leaf, "b": np.arange(4, dtype="int64"),
                  "blocks": [rs.randn(2).astype("float32"),
                             (np.int64(3), np.float32(2.5))]},
        "step_count": 7, "lr": 0.125, "tag": "resilience",
        "shape": (3, 4), "none": None, "flag": True,
        "np_scalar": np.float32(2.5),
    }


# ============================================================== manifests
def test_write_manifest_same_files_and_cross_verify(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    (d / "arrays.npz").write_bytes(os.urandom(3000))
    (d / "tree.json").write_text('{"a": 1}')
    (d / "sub").mkdir()                          # not a regular file
    docs = {}
    for pkg, mod in (("jax", jio_ckpt), ("port", tio_ckpt)):
        docs[pkg] = mod.write_manifest(str(d), step=3, kind="unit")
        other = tio_ckpt if pkg == "jax" else jio_ckpt
        assert other.verify_manifest(str(d)) == (True, [])
    assert docs["jax"] == docs["port"]
    assert docs["port"]["schema"] == "paddle_tpu.io.checkpoint.manifest.v1"
    assert tio_ckpt.MANIFEST_NAME == jio_ckpt.MANIFEST_NAME
    assert sorted(docs["port"]["files"]) == ["arrays.npz", "tree.json"]
    assert docs["port"]["files"]["arrays.npz"]["bytes"] == 3000


@pytest.mark.parametrize("mode,kw", [("flip", {}), ("flip", {"nbytes": 7}),
                                     ("truncate", {}),
                                     ("flip", {"filename": "tree.json"})])
def test_corrupt_modes_damage_equal_bytes_and_report_equal(tmp_path, mode,
                                                           kw):
    with tres.AsyncCheckpointManager(tmp_path / "src") as mgr:
        mgr.save(4, _plain_tree("port"), block=True)
    roots = {}
    for pkg in PKGS:
        roots[pkg] = tmp_path / pkg
        shutil.copytree(tmp_path / "src", roots[pkg])
        path = (jchaos if pkg == "jax" else tchaos).corrupt_checkpoint(
            str(roots[pkg]), mode=mode, **kw)
        assert path == os.path.join(str(roots[pkg]), "step_00000004",
                                    kw.get("filename", "arrays.npz"))
    name = kw.get("filename", "arrays.npz")
    blobs = [(roots[p] / "step_00000004" / name).read_bytes() for p in PKGS]
    assert blobs[0] == blobs[1]
    reports = [mod.verify_manifest(str(roots[p] / "step_00000004"))
               for mod in (jio_ckpt, tio_ckpt) for p in PKGS]
    assert all(r == reports[0] for r in reports)
    assert reports[0][0] is False and reports[0][1]
    for ch in (jchaos, tchaos):
        with pytest.raises(ValueError):
            ch.corrupt_checkpoint(str(roots["port"]), mode="shred")
        with pytest.raises(FileNotFoundError):
            ch.corrupt_checkpoint(str(tmp_path / "src" / "step_00000004"))


# ====================================================== cross-package I/O
@pytest.mark.parametrize("writer", PKGS)
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    dirs = {}
    for pkg in PKGS:
        with _res(pkg).AsyncCheckpointManager(tmp_path / pkg) as mgr:
            mgr.save(12, _plain_tree(pkg))
        dirs[pkg] = str(tmp_path / pkg / "step_00000012")
    # both writers produce the same tree document and arrays
    assert _tree_doc(dirs["jax"]) == _tree_doc(dirs["port"])
    assert _tree_doc(dirs["port"])["schema"] == \
        "paddle_tpu.resilience.checkpoint.v1"
    za, zb = _npz(dirs["jax"]), _npz(dirs["port"])
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype
        np.testing.assert_array_equal(za[k], zb[k])

    root = tmp_path / writer
    outs = {}
    for reader in PKGS:
        mgr = _res(reader).AsyncCheckpointManager(root)
        assert mgr.all_steps() == [12] and mgr.verify(12) == (True, [])
        outs[reader] = mgr.restore(12, to_tensors=False)
        step, out = mgr.restore_latest_valid(to_tensors=False)
        assert step == 12
        mgr.close()
    ref = _plain_tree("port")
    for out in outs.values():
        np.testing.assert_array_equal(out["model"]["w"],
                                      ref["model"]["w"].numpy())
        assert out["model"]["b"].dtype == np.int64
        assert isinstance(out["model"]["blocks"][1], tuple)
        assert out["model"]["blocks"][1][0] == np.int64(3)
        assert out["model"]["blocks"][1][1].dtype == np.float32
        assert out["shape"] == (3, 4) and out["none"] is None
        assert out["flag"] is True and out["tag"] == "resilience"
        assert out["np_scalar"] == np.float32(2.5)
    # the port's tensors land on the device it is given
    mgr = tres.AsyncCheckpointManager(root)
    out = mgr.restore(12, device="cpu")
    assert isinstance(out["model"]["w"], torch.Tensor)
    assert out["model"]["w"].device.type == "cpu"
    assert out["model"]["b"].dtype == torch.int64
    torch.testing.assert_close(out["model"]["w"], ref["model"]["w"],
                               rtol=0, atol=0)
    mgr.close()


def test_bf16_leaf_is_v2_bytes_in_both_packages(tmp_path):
    """Pinned (ROADMAP Queue 3): numpy has no bfloat16, so the leaf goes to
    disk as ``|V2`` bytes; restore returns those bytes without tensors
    and raises TypeError with them (walking on past it in
    ``restore_latest_valid``, which quarantines the step)."""
    vals = np.linspace(-2, 2, 6, dtype=np.float32)
    leaves = {"jax": jnp.asarray(vals, dtype=jnp.bfloat16),
              "port": torch.from_numpy(vals).to(torch.bfloat16)}
    for pkg in PKGS:
        with _res(pkg).AsyncCheckpointManager(tmp_path / pkg) as mgr:
            mgr.save(1, {"h": leaves[pkg]})
    za = _npz(tmp_path / "jax" / "step_00000001")["a0"]
    zb = _npz(tmp_path / "port" / "step_00000001")["a0"]
    assert za.dtype.str == zb.dtype.str == "|V2"
    assert za.tobytes() == zb.tobytes()
    for writer in PKGS:
        for reader in PKGS:
            root = tmp_path / f"{writer}-{reader}"
            shutil.copytree(tmp_path / writer, root)
            mgr = _res(reader).AsyncCheckpointManager(root)
            out = mgr.restore(1, to_tensors=False)
            assert out["h"].dtype.str == "|V2"
            assert out["h"].tobytes() == za.tobytes()
            kw = {"device": "cpu"} if reader == "port" else {}
            with pytest.raises(TypeError):
                mgr.restore(1, to_tensors=True, **kw)
            assert mgr.restore_latest_valid(**kw) == (None, None)
            assert any(".corrupt-" in n for n in os.listdir(root))
            mgr.close()


def test_snapshot_ledger_row_pinned(tmp_path, monkeypatch):
    """Pinned (ROADMAP Queue 3): the ``checkpoint.snapshot`` row's byte
    source walks each queued snapshot's dict KEYS; with nothing queued it
    reads 0, with a save queued it raises and the ledger drops the row
    for good — in both packages."""
    rows = {}
    for pkg, mem in (("jax", jmemory), ("port", tmemory)):
        led = mem.MemoryLedger()
        monkeypatch.setattr(mem, "ledger", lambda led=led: led)
        mgr = _res(pkg).AsyncCheckpointManager(tmp_path / pkg)
        idle = led.owner_rows()
        mgr._write_lock.acquire()
        try:
            mgr.save(1, {"w": np.ones(8, "float32")})
            t0 = time.time()
            while (mgr._pending or not mgr._busy) and time.time() - t0 < 10:
                time.sleep(0.005)       # the writer took step 1, waits
            mgr.save(2, {"w": np.ones(8, "float32")})
            assert len(mgr._pending) == 1
            queued = led.owner_rows()
        finally:
            mgr._write_lock.release()
        mgr.wait_until_finished()
        rows[pkg] = (idle, queued, led.owner_rows(), len(led._regs))
        mgr.close()
    assert rows["jax"] == rows["port"]
    assert rows["port"][0] == [{"owner": "checkpoint.snapshot",
                                "replica": "-", "device": "host",
                                "bytes": 0, "arrays": 0,
                                "meta": {"kind": "checkpoint"}}]
    assert rows["port"][1:] == ([], [], 0)


# ===================================================== manager behaviour
def _counter(pkg, name):
    return (jmetrics if pkg == "jax" else tmetrics).counter(name).total()


def _manager_story(pkg, root):
    """Interval, rotation, partial-save GC, quarantine naming, an
    all-corrupt restore and the writer-behind drop count."""
    R = _res(pkg)
    out = {}
    mgr = R.AsyncCheckpointManager(root / "a", max_to_keep=2,
                                   save_interval_steps=2)
    st = {"v": np.arange(3, dtype="float32")}
    out["saves"] = [mgr.save(3, st), mgr.save(3, st, force=True)] + \
        [mgr.save(s, st, block=True) for s in (4, 6, 8)]
    out["rotation"] = mgr.all_steps()
    orphan = root / "a" / "step_00000099.tmp-12345"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial garbage")
    out["listed"] = mgr.all_steps()
    mgr.close()
    mgr = R.AsyncCheckpointManager(root / "a", max_to_keep=2)
    out["gc"] = (orphan.exists(), mgr.all_steps())
    R.corrupt_checkpoint(mgr)
    step, state = mgr.restore_latest_valid(to_tensors=False)
    out["fallback"] = (step, state["v"].tolist())
    out["quarantined"] = sorted(
        re.sub(r"\d{10}$", "T", n) for n in os.listdir(root / "a")
        if ".corrupt-" in n)
    R.corrupt_checkpoint(mgr, step=6, mode="truncate")
    c0 = _counter(pkg, "resilience.checkpoint_corruptions")
    out["all_corrupt"] = mgr.restore_latest_valid(to_tensors=False)
    out["corruptions"] = _counter(pkg, "resilience.checkpoint_corruptions") \
        - c0
    out["after"] = mgr.all_steps()
    mgr.close()
    # the writer falls behind: queue depth 2, four saves while it is busy
    mgr = R.AsyncCheckpointManager(root / "b", queue_depth=2)
    d0 = _counter(pkg, "resilience.checkpoint_saves_dropped")
    mgr._write_lock.acquire()
    try:
        mgr.save(1, st)
        t0 = time.time()
        while (mgr._pending or not mgr._busy) and time.time() - t0 < 10:
            time.sleep(0.005)
        for s in (2, 3, 4):
            mgr.save(s, st)
    finally:
        mgr._write_lock.release()
    mgr.wait_until_finished()
    out["dropped"] = _counter(pkg, "resilience.checkpoint_saves_dropped") - d0
    out["committed"] = mgr.all_steps()
    mgr.close()
    return out


def test_manager_behaviour_equals_reference(tmp_path):
    stories = {pkg: _manager_story(pkg, tmp_path / pkg) for pkg in PKGS}
    assert stories["jax"] == stories["port"]
    s = stories["port"]
    assert s["saves"] == [False, True, True, True, True]
    assert s["rotation"] == [6, 8] and s["listed"] == [6, 8]
    assert s["gc"] == (False, [6, 8])
    assert s["fallback"] == (6, [0.0, 1.0, 2.0])
    assert s["quarantined"] == ["step_00000008.corrupt-T"]
    assert s["all_corrupt"] == (None, None) and s["corruptions"] == 1
    assert s["dropped"] == 1 and s["committed"] == [1, 3, 4]


# ============================================================ supervisor
SCENARIOS = {
    # failure schedule by attempt (None: return), supervisor kwargs
    "transient": (["preempt", "timeout", None], {}),
    "fatal": (["value", "value"], {"max_fatal_restarts": 1}),
    "numeric": (["numeric", None], {"max_numeric_restarts": 2}),
    "budget": (["preempt"] * 3, {"max_transient_restarts": 2}),
}


def _supervise(pkg, root, scenario):
    R = _res(pkg)
    schedule, kw = SCENARIOS[scenario]
    mgr = R.AsyncCheckpointManager(root)
    calls, restarts, delays = [], [], []
    errors = {"preempt": R.PreemptionError, "timeout": R.CollectiveTimeoutError,
              "value": ValueError, "numeric": R.NumericFault}

    def train(start, state):
        n = len(calls)
        calls.append((start, None if state is None else int(state["n"])))
        mgr.save(n + 1, {"n": n + 1, "w": np.full(2, n, "float32")},
                 block=True)
        kind = schedule[n]
        if kind is None:
            return "done"
        raise errors[kind](f"attempt {n}")

    pol = R.RetryPolicy(base_delay=0.001, max_delay=0.004, jitter=0.5,
                        seed=3)
    delay = pol.delay
    pol.delay = lambda a: delays.append(delay(a)) or delays[-1]
    sup = R.RecoverySupervisor(
        mgr, policy=pol, to_tensors=False,
        on_restart=lambda kind, exc, n: restarts.append(
            (kind, type(exc).__name__, n)), **kw)
    try:
        outcome = sup.run(train)
    except Exception as e:
        outcome = type(e).__name__
    mgr.close()
    return {"outcome": outcome, "restarts": sup.restarts, "calls": calls,
            "on_restart": restarts, "delays": delays}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisor_equals_reference(tmp_path, scenario):
    got = {pkg: _supervise(pkg, tmp_path / pkg, scenario) for pkg in PKGS}
    assert got["jax"] == got["port"]
    want_outcome = {"transient": "done", "numeric": "done",
                    "fatal": "ValueError", "budget": "PreemptionError"}
    assert got["port"]["outcome"] == want_outcome[scenario]
    if scenario == "numeric":
        assert got["port"]["restarts"] == {"transient": 0, "fatal": 0,
                                           "numeric": 1}
    if scenario == "budget":
        assert got["port"]["restarts"]["transient"] == 3


def test_supervisor_restores_tensors_on_the_given_device(tmp_path):
    mgr = tres.AsyncCheckpointManager(tmp_path)
    mgr.save(2, {"w": torch.ones(3)}, block=True)
    seen = []
    tres.RecoverySupervisor(mgr, device="cpu").run(
        lambda start, state: seen.append((start, state["w"])))
    assert seen[0][0] == 2 and seen[0][1].device.type == "cpu"
    mgr.close()


# ================================================================= chaos
def _mlp_weights():
    rs = np.random.RandomState(11)
    return {"0.weight": (rs.randn(16, 32) * 0.3).astype("float32"),
            "0.bias": (rs.randn(32) * 0.1).astype("float32"),
            "2.weight": (rs.randn(32, 4) * 0.3).astype("float32"),
            "2.bias": (rs.randn(4) * 0.1).astype("float32")}


def _chaos_run(pkg, root, fail_at=None, total_steps=6):
    """The chaos smoke's loop from fixed numpy weights (paddle's [in, out]
    Linear layout; the port's are transposed): with ``fail_at``, trip
    ``fail_at + 1`` of ``chaos.train_step`` corrupts the newest checkpoint
    and raises a transient CollectiveTimeoutError."""
    R = _res(pkg)
    mgr = R.AsyncCheckpointManager(root, max_to_keep=3)
    rs = np.random.RandomState(7)
    xn = rs.randn(32, 16).astype("float32")
    yn = rs.randint(0, 4, (32,)).astype("int64")
    w = _mlp_weights()
    losses = {}
    if pkg == "jax":
        x, y = paddle.to_tensor(xn), paddle.to_tensor(yn)
        lossf, faults = jnn.CrossEntropyLoss(), jfaults
    else:
        x, y = torch.from_numpy(xn), torch.from_numpy(yn)
        lossf, faults = nn.CrossEntropyLoss(), tfaults

    def build(state):
        if pkg == "jax":
            m = jnn.Sequential(jnn.Linear(16, 32), jnn.Tanh(),
                               jnn.Linear(32, 4))
            m.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
            o = jopt.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=m.parameters())
            if state is not None:
                m.set_state_dict(state["model"])
                o.set_state_dict(state["opt"])
            return m, o
        m = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4))
        m.load_state_dict({k: torch.from_numpy(v.T.copy() if v.ndim == 2
                                               else v) for k, v in w.items()})
        o = optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                               parameters=m.parameters())
        if state is not None:
            m.load_state_dict(state["model"])
            o.set_state_dict(state["opt"])
        return m, o

    def train_fn(start, state):
        m, o = build(state)
        for step in range(start, total_steps):
            faults.maybe("chaos.train_step")
            loss = lossf(m(x), y)
            loss.backward()
            o.step()
            o.clear_grad()
            losses[step] = float(loss.detach())
            mgr.save(step + 1, {"model": m.state_dict(),
                                "opt": o.state_dict()}, block=True)
        return losses

    def sabotage():
        R.corrupt_checkpoint(mgr)
        raise R.CollectiveTimeoutError(f"injected at step {fail_at}")

    kw = {} if pkg == "jax" else {"device": "cpu"}
    sup = R.RecoverySupervisor(
        mgr, policy=R.RetryPolicy(base_delay=0.001, max_delay=0.002, seed=0),
        max_transient_restarts=2, **kw)
    if fail_at is None:
        sup.run(train_fn)
    else:
        with faults.FaultPlan(seed=0).add("chaos.train_step", fn=sabotage,
                                          at_trips={fail_at + 1}):
            sup.run(train_fn)
    mgr.close()
    quarantined = [n for n in os.listdir(root) if ".corrupt-" in n]
    return [losses[s] for s in sorted(losses)], sup.restarts, quarantined


def test_chaos_losses_equal_reference_and_clean_run(tmp_path):
    clean, _, _ = _chaos_run("port", tmp_path / "clean")
    got = {pkg: _chaos_run(pkg, tmp_path / pkg, fail_at=3) for pkg in PKGS}
    for pkg in PKGS:
        losses, restarts, quarantined = got[pkg]
        assert len(losses) == 6
        assert restarts == {"transient": 1, "fatal": 0}
        assert quarantined and all(n.startswith("step_00000003.corrupt-")
                                   for n in quarantined)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["port"][0], clean, rtol=1e-6, atol=1e-7)
    assert clean[-1] < clean[0]


def test_run_smoke_report_matches_reference(tmp_path):
    reps = {"jax": jchaos.run_smoke(total_steps=5, fail_at=2,
                                    directory=str(tmp_path / "jax")),
            "port": tchaos.run_smoke(total_steps=5, fail_at=2,
                                     directory=str(tmp_path / "port"),
                                     device="cpu")}
    assert sorted(reps["jax"]) == sorted(reps["port"])
    for k in ("completed_steps", "injected_failure_at_step",
              "transient_restarts", "resumed_from_step",
              "corrupt_checkpoints_quarantined"):
        assert reps["port"][k] == reps["jax"][k], k
    assert reps["port"]["transient_restarts"] == 1
    assert reps["port"]["resumed_from_step"] == 1
    assert np.isfinite(reps["port"]["final_loss"])
    assert reps["port"]["checkpoint_saves"] >= 6
    assert reps["port"]["elapsed_s"] > 0
    json.dumps(reps["port"])
    assert not tfaults.armed("chaos.train_step")
    assert tres.__all__ == jres.__all__


# ================================================== async-safety boundary
def test_async_save_then_inplace_add_restores_pre_update_bytes(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    sd = m.state_dict()
    before = {k: v.clone() for k, v in sd.items()}
    mgr = tres.AsyncCheckpointManager(tmp_path)
    mgr._write_lock.acquire()          # the write lands after the updates
    try:
        assert mgr.save(1, {"model": sd}, block=False)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(1.0)
    finally:
        mgr._write_lock.release()
    mgr.wait_until_finished()
    out = mgr.restore(1, device="cpu")["model"]
    for k, v in before.items():
        assert torch.equal(out[k], v), k
        assert not torch.equal(out[k], m.state_dict()[k]), k
    mgr.close()


def _tensor_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensor_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def test_async_save_of_trainstep_state_survives_the_next_step(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
    step = jit.TrainStep(m, optimizer.AdamW(
        learning_rate=1e-2, parameters=m.parameters()),
        loss_fn=nn.CrossEntropyLoss())
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(16, 8).astype("float32"))
    y = torch.from_numpy(rs.randint(0, 4, (16,)))
    step(x, y)
    sd = step.state_dict()
    live = _tensor_leaves(sd)
    before = {k: v.clone() for k, v in live.items()}
    mgr = tres.AsyncCheckpointManager(tmp_path)
    mgr._write_lock.acquire()
    try:
        mgr.save(1, sd)
        step(x, y)                     # in place: params, moments, t
    finally:
        mgr._write_lock.release()
    mgr.wait_until_finished()
    out = mgr.restore(1, device="cpu")
    got = _tensor_leaves(out)
    assert sorted(got) == sorted(before)
    for k in before:
        assert torch.equal(got[k], before[k]), k
    assert any(not torch.equal(before[k], live[k]) for k in live)
    assert out["step"] == 1
    mgr.close()


# ============================================================= emergency
def test_watchdog_fire_triggers_emergency_checkpoint(tmp_path):
    mgr = tres.AsyncCheckpointManager(tmp_path / "ckpt")
    n0 = tmetrics.counter("resilience.emergency_saves").total()
    disarm = tres.arm_emergency_checkpoint(
        mgr, lambda: (42, {"w": torch.ones(3)}), signals=())
    engine = types.SimpleNamespace(
        _progress_t=time.monotonic() - 10.0, _started=True, _queue=[1],
        _slots=[], _iteration=5, stats=lambda: {"queue_depth": 1})
    rec = flight_recorder.FlightRecorder(dir=str(tmp_path / "flight"))
    wd = watchdog.ServingWatchdog(engine, deadline_s=0.05, poll_s=0.02,
                                  recorder=rec).start()
    try:
        t0 = time.time()
        while 42 not in mgr.all_steps() and time.time() - t0 < 10:
            time.sleep(0.02)
    finally:
        wd.stop()
        disarm()
    assert len(wd.fired) == 1
    assert mgr.all_steps() == [42] and mgr.verify(42) == (True, [])
    with open(os.path.join(mgr.directory, "step_00000042",
                           "manifest.json")) as f:
        assert json.load(f)["kind"] == "watchdog_serving"
    np.testing.assert_allclose(mgr.restore(42, device="cpu")["w"].numpy(),
                               1.0)
    assert tmetrics.counter("resilience.emergency_saves").total() == n0 + 1
    watchdog._notify_fire("serving", {"op": "x"})   # disarmed: no save
    assert mgr.all_steps() == [42]
    mgr.close()


_SIGTERM_WORKER = r"""
import os, signal, sys, time
import torch
from paddle_tpu_torch.resilience import (AsyncCheckpointManager,
                                         arm_emergency_checkpoint)

mgr = AsyncCheckpointManager(os.environ["CKPT_DIR"])
state = {"w": torch.full((4,), 3.0), "step": 11}
arm_emergency_checkpoint(mgr, lambda: (11, state), signals=("SIGTERM",))
print("ARMED", sorted({m.split(".")[0] for m in sys.modules}
                      & {"jax", "paddle_tpu"}), flush=True)
os.kill(os.getpid(), signal.SIGTERM)   # preemption notice
time.sleep(30)                          # must never get here
"""


def test_sigterm_triggers_emergency_checkpoint_then_dies(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_SIGTERM_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CKPT_DIR"] = str(tmp_path / "ckpt")
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert "ARMED []" in r.stdout, r.stdout + r.stderr
    assert r.returncode == -signal.SIGTERM, (r.returncode, r.stderr)
    mgr = tres.AsyncCheckpointManager(tmp_path / "ckpt")
    assert mgr.all_steps() == [11] and mgr.verify(11) == (True, [])
    out = mgr.restore(11, device="cpu")
    np.testing.assert_allclose(out["w"].numpy(), 3.0)
    assert out["step"] == 11
    mgr.close()
    # the reference reads what the port's emergency save wrote
    jm = jres.AsyncCheckpointManager(tmp_path / "ckpt")
    np.testing.assert_allclose(jm.restore(11, to_tensors=False)["w"], 3.0)
    jm.close()


def test_emergency_off_main_thread_skips_signals(tmp_path):
    mgr = tres.AsyncCheckpointManager(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "disarm", tres.arm_emergency_checkpoint(
            mgr, lambda: (1, {}), signals=("SIGTERM",), on_watchdog=False)))
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) == before
    box["disarm"]()
    mgr.close()
