"""The serving mesh: one tensor-parallel engine as one process per shard
(the port's form of ``ServingEngine(mesh=...)`` of
``paddle_tpu/serving/engine.py``).

The reference is single-controller: one process holds a
``jax.sharding.Mesh`` and GSPMD partitions each program over its
``"model"`` axis.  PyTorch has no single-controller mesh, so here:

- the engine's own process is shard 0, the LEADER.  It keeps everything
  host-side — the queue, the scheduler thread, the ``BlockManager``, the
  page tables and lengths, the sampler, QoS, metrics and health — and
  serves its shard of the model (``text.models.gpt.mp_shard``) over its
  own KV-head slice of the pools;
- :class:`ServingMesh` starts ``mp - 1`` FOLLOWER processes (the
  ``spawn`` start method), each handed only its own shard
  (``torch.save`` bytes over its command pipe) and the adapter's pool
  geometry.  A follower schedules nothing: the leader sends it every
  dispatch's name and host arrays first (:meth:`ServingMesh.mirror`), and
  it runs the same adapter closure over its shard and its pools; only the
  leader reads logits and samples, so every rank makes the same
  scheduling decision by construction;
- the ranks meet in an engine-private process group (:class:`MeshGroup`)
  built straight on a ``TCPStore``: gloo, or NCCL where every mesh entry
  is a distinct card (two ranks on one card must use gloo, which NCCL
  refuses).  It never touches the default group a user's
  ``init_parallel_env`` made, so several mesh engines share a process.
  The row-parallel layers sum their partial products through it (two
  all-reduces per block), as does ``Int8Linear``'s dynamic activation
  absmax under ``weight_dtype="int8"`` (MAX);
- every other pool access reaches the followers too: a restart's zeroing
  (or the CPU's rebuild), the spill tier's page snapshot and restore, and
  :meth:`ServingMesh.close`, which joins them.

Gloo's hops go through the host and a CUDA graph cannot capture them, so
a mesh engine's programs run eagerly on every rank.  A follower that dies,
fails or times out makes the leader raise :class:`MeshError`, which the
engine treats as fatal: it never waits past the group timeout (300 s:
room for a follower's first kernel build) and never carries on
unsharded.
"""

from __future__ import annotations

import datetime
import io
import multiprocessing
import threading
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist

#: the mesh axis tensor-parallel serving shards over (pool KV-head dim,
#: Megatron weight splits), as the reference names it
_MP_AXIS = "model"

#: how long a collective or a follower's answer may take, and a
#: follower's start-up (its interpreter, its shard, its pools)
_TIMEOUT_S = 300.0
_START_TIMEOUT_S = 600.0


class MeshError(RuntimeError):
    """A follower of a serving mesh died, failed or timed out, or a
    mirrored dispatch broke off half way: the engine's group is unusable,
    so the failure is fatal (never a restart)."""


def normalize_mesh(mesh):
    """``ServingEngine(mesh=...)`` -> ``(devices | None, mp, solo_device)``.

    Takes the reference's flat-device-list form: a sequence of
    ``torch.device``s or strings (``["cuda:0", "cuda:1"]``; ``["cuda:0",
    "cuda:0"]`` puts two shards on one card).  A 1-long list degrades to
    plain ``device=`` placement of that device (mp = 1), so a dp pool over
    mp-sized carves handles ``mp=1`` uniformly.  A ``jax.sharding.Mesh``
    has no counterpart, and a ``ProcessMesh`` waits for auto_parallel:
    both raise ``TypeError``."""
    if mesh is None:
        return None, 1, None
    kind = type(mesh).__name__
    if kind == "ProcessMesh" or hasattr(mesh, "dim_names"):
        raise TypeError(
            "ServingEngine(mesh=) takes a flat device list; a ProcessMesh "
            "waits for distributed.auto_parallel, ROADMAP Queue 1 item 9 "
            "part five")
    if kind == "Mesh" or hasattr(mesh, "axis_names"):
        raise TypeError(
            "ServingEngine(mesh=) takes a flat device list (one process per "
            "shard): a jax.sharding.Mesh has no counterpart in the port")
    if isinstance(mesh, (str, torch.device)):
        raise TypeError(f"mesh= is a sequence of devices, got {mesh!r} "
                        "(pass device= for one device)")
    devs = [torch.device(d) for d in mesh]
    # "cuda" is the current card, as device= reads it; each rank names its
    # card by index
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs:
        raise ValueError("mesh= device list must be non-empty")
    if len(devs) == 1:
        return None, 1, devs[0]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh= mixes device types: {devs}")
    return devs, len(devs), None


def _dumps(obj):
    """Tensors across a command pipe as ``torch.save`` bytes (no shared
    memory, any dtype)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data):
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=False)


def _new_group(store, rank, size, devices):
    """The engine-private process group: NCCL where every mesh entry is a
    distinct card, else gloo."""
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    distinct = len({(d.type, d.index or 0) for d in devices}) == len(devices)
    if all(d.type == "cuda" for d in devices) and distinct \
            and dist.is_nccl_available():
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts), "nccl"
    return dist.ProcessGroupGloo(store, rank, size, timeout), "gloo"


class MeshGroup:
    """One rank's handle on the engine-private group: the all-reduce the
    row-parallel layers and the int8 absmax call, with its counts.

    ``calls`` / ``bytes`` count the all-reduces; ``hop_s`` is the wall
    inside them (the transfer and the wait for the peers), ``compute_s``
    the wall spent first waiting for this rank's own queued kernels (on
    the card the stream is drained before the hop, which gloo would
    otherwise do inside it), so the two split a step's host time.  During
    a cost count (``observability.perf.count_cost``) the hop does
    nothing: the count is this shard's own work."""

    def __init__(self, rank, size):
        self.rank, self.size = int(rank), int(size)
        self.pg = None
        self.backend = None
        self.reset_counts()

    def reset_counts(self):
        self.calls = 0
        self.bytes = 0
        self.hop_s = 0.0
        self.compute_s = 0.0

    def counts(self):
        return {"calls": self.calls, "bytes": self.bytes,
                "hop_s": self.hop_s, "compute_s": self.compute_s,
                "backend": self.backend}

    def all_reduce(self, t, op="sum"):
        """``t`` summed (or max-ed) over the mesh; 16-bit floats are
        reduced in float32 and rounded once.  Returns the result (``t``
        itself when it was float32 and contiguous)."""
        from ..observability import perf as _perf

        if _perf.counting_kernels():
            return t
        if self.pg is None:
            raise MeshError("the serving mesh is not connected")
        buf = t.float().contiguous() if t.dtype != torch.float32 \
            else t.contiguous()
        t0 = time.perf_counter()
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).synchronize()
        t1 = time.perf_counter()
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX if op == "max" \
            else dist.ReduceOp.SUM
        try:
            self.pg.allreduce([buf], opts).wait()
        except Exception as e:
            raise MeshError(f"serving-mesh all_reduce failed on rank "
                            f"{self.rank}: {e}") from e
        self.calls += 1
        self.bytes += buf.numel() * buf.element_size()
        self.compute_s += t1 - t0
        self.hop_s += time.perf_counter() - t1
        return buf if buf.dtype == t.dtype else buf.to(t.dtype)


# the launch counters a follower reports (the kernels of the mesh's path)
_COUNTERS = (("flash_attention", "LAUNCHES", "k1"),
             ("paged_attention", "LAUNCHES", "k3"),
             ("paged_attention", "QUANT_LAUNCHES", "k4"),
             ("paged_attention", "DECODE_ATTEND_LAUNCHES", "decode_attend"),
             ("paged_attention", "CHUNK_LAUNCHES", "chunk"),
             ("paged_attention", "QUANT_CHUNK_LAUNCHES", "quant_chunk"))


def launch_counts():
    """This process's K1 / K3 / K4 launch counters."""
    import importlib

    return {key: getattr(importlib.import_module(f"..ops.{mod}", __package__),
                         attr) for mod, attr, key in _COUNTERS}


def zero_launch_counts():
    import importlib

    for mod, attr, _ in _COUNTERS:
        setattr(importlib.import_module(f"..ops.{mod}", __package__), attr, 0)


def _feed(conn, data):
    """Send a follower its shard; a follower that died first reports
    through :meth:`ServingMesh.connect` instead."""
    try:
        conn.send_bytes(data)
    except OSError:
        pass


def _shutdown(procs, conns):
    """Stop followers: ask, wait, then kill.  (A module function: the
    engine's finalizer holds no reference to the engine.)"""
    for c in conns:
        try:
            c.send(("exit",))
        except Exception:
            pass
    deadline = time.monotonic() + 10.0
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5.0)
    for c in conns:
        try:
            c.close()
        except Exception:
            pass


class ServingMesh:
    """The leader's side of a serving mesh: ``mp - 1`` follower processes
    over ``devices[1:]``, the private group and the command pipes.

    ``shards[r - 1]`` is follower ``r``'s model shard (a CPU module);
    ``spec`` is what a follower needs to rebuild the engine's pools:
    ``{"kv_dtype", "page_size", "num_pages"}``.  The followers start at
    once and the group forms on first use (:meth:`connect`), so several
    engines built back to back start their followers side by side."""

    def __init__(self, devices, shards, spec):
        self.devices = [torch.device(d) for d in devices]
        self.mp = len(self.devices)
        self.group = MeshGroup(0, self.mp)
        self._lock = threading.RLock()
        self._closed = False
        ctx = multiprocessing.get_context("spawn")
        self._store = dist.TCPStore("127.0.0.1", 0, self.mp, True,
                                    datetime.timedelta(
                                        seconds=_START_TIMEOUT_S),
                                    wait_for_workers=False)
        port = self._store.port
        self.procs, self.conns, self._feeders = [], [], []
        for r in range(1, self.mp):
            data = _dumps(shards[r - 1])
            here, there = ctx.Pipe()
            p = ctx.Process(target=_follower_main,
                            args=(r, self.mp, port, there,
                                  [str(d) for d in self.devices], spec),
                            name=f"paddle-serving-mesh[{r}]", daemon=True)
            p.start()
            there.close()
            # the shard's bytes go down the pipe from a thread: the
            # follower reads them only once torch is imported
            feeder = threading.Thread(target=_feed, args=(here, data),
                                      daemon=True)
            feeder.start()
            self.procs.append(p)
            self.conns.append(here)
            self._feeders.append(feeder)
        self._finalizer = weakref.finalize(self, _shutdown, self.procs,
                                           self.conns)

    @property
    def connected(self):
        return self.group.pg is not None

    # ------------------------------------------------------------ health
    def _fail(self, what, cause=None):
        """Raise :class:`MeshError` with a follower's own report when one
        sent it (its traceback), else its exit code."""
        detail = []
        for r, (p, c) in enumerate(zip(self.procs, self.conns), 1):
            try:
                while c.poll(0):
                    msg = c.recv()
                    if msg and msg[0] == "error":
                        detail.append(f"follower {r} failed:\n{msg[1]}")
            except (EOFError, OSError):
                pass
            if not p.is_alive():
                detail.append(f"follower {r} exited with code {p.exitcode}")
        raise MeshError(f"serving mesh: {what}"
                        + ("\n" + "\n".join(detail) if detail else "")) \
            from cause

    def check(self):
        """Raise :class:`MeshError` if a follower died or reported a
        failure."""
        if self._closed:
            raise MeshError("serving mesh: closed")
        for p, c in zip(self.procs, self.conns):
            # once connected a follower speaks only when asked, or to
            # report its failure
            if not p.is_alive() or (self.connected and c.poll(0)):
                self._fail("a follower is gone")

    def connect(self):
        """Wait for every follower's shard and pools, then form the
        private group (idempotent)."""
        with self._lock:
            if self.connected:
                return
            self.check()
            deadline = time.monotonic() + _START_TIMEOUT_S
            for r, (p, c) in enumerate(zip(self.procs, self.conns), 1):
                while not c.poll(0.05):
                    if not p.is_alive() or time.monotonic() > deadline:
                        self._fail(f"follower {r} did not start")
                try:
                    msg = c.recv()
                except (EOFError, OSError) as e:
                    self._fail(f"follower {r} did not start", e)
                if msg[0] != "ready":
                    self._fail(f"follower {r} did not start:\n{msg[1]}")
            for f in self._feeders:
                f.join()
            self._feeders = []
            for c in self.conns:
                c.send(("connect",))
            try:
                self.group.pg, self.group.backend = _new_group(
                    self._store, 0, self.mp, self.devices)
            except Exception as e:
                self._fail("the group did not form", e)

    # ----------------------------------------------------------- commands
    def _send(self, msgs):
        """Send follower ``r`` its message ``msgs[r - 1]``, the group up
        and every follower alive first."""
        with self._lock:
            self.connect()
            self.check()
            try:
                for c, m in zip(self.conns, msgs):
                    c.send(m)
            except (OSError, ValueError) as e:
                self._fail("a follower's pipe is closed", e)

    def mirror(self, name, host, inject):
        """Start dispatch ``name`` (an adapter closure: ``"step"``,
        ``"prefill"``, ``"prefill_chunk"``, ``"verify"``) on every
        follower with the leader's host arrays (and the numeric guard's
        ``inject``, which only the leader's sampler reads)."""
        msg = ("run", name, [np.asarray(a) for a in host],
               None if inject is None else np.asarray(inject))
        self._send([msg] * len(self.conns))

    def reset_pools(self):
        """A restart on every follower: pools zeroed in place on the card,
        rebuilt on the CPU (as the leader does)."""
        self._send([("reset",)] * len(self.conns))

    def _ask(self, msg):
        with self._lock:
            self._send([msg] * len(self.conns))
            out = []
            for r, (p, c) in enumerate(zip(self.procs, self.conns), 1):
                deadline = time.monotonic() + _TIMEOUT_S
                while not c.poll(0.05):
                    if not p.is_alive() or time.monotonic() > deadline:
                        self._fail(f"follower {r} did not answer {msg[0]}")
                try:
                    reply = c.recv()
                except (EOFError, OSError) as e:
                    self._fail(f"follower {r} did not answer {msg[0]}", e)
                if reply[0] != "ok":
                    self._fail(f"follower {r} failed {msg[0]}\n{reply[1]}")
                out.append(_loads(reply[1]))
            return out

    def snapshot(self, page):
        """Each follower's copy of page row ``page`` of every pool (host
        tensors), in rank order."""
        return self._ask(("snapshot", int(page)))

    def restore(self, page, parts):
        """Write ``parts[r - 1]`` (a tuple of host tensors, one per pool)
        into page row ``page`` on follower ``r``."""
        self._send([("restore", int(page), _dumps(part)) for part in parts])

    def query(self, reset=False):
        """Every follower's counters: launches, all-reduces, its card's
        peak and current allocation, its pools' bytes and shapes
        (``reset`` zeroes the launch and hop counts and the peak after
        reading)."""
        return self._ask(("query", bool(reset)))

    def close(self):
        """Join the followers (killing any that do not exit)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._finalizer()
            self.group.pg = None


# ------------------------------------------------------------ the follower
def _mirror_run(adapter, pools, name, host, device):
    """A follower's half of a dispatch: the adapter closure over this
    shard's pools (outputs dropped; the pools are written in place)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host]
    if name == "prefill_chunk":
        ids, nvalid, table, lens = t[:4]
        adapter.prefill_chunk(ids, nvalid, *pools, table, lens)
    else:
        x, table, lens = t[:3]
        getattr(adapter, name)(x, *pools, table, lens)


def _follower_main(rank, mp, port, conn, devices, spec):
    """Entry of follower ``rank``: load its shard, build its pools, report
    ``ready``, then serve the leader's commands until ``exit`` (or the
    pipe's end, when the leader is gone).  Any failure is reported to the
    leader and ends the process (which closes its side of the group, so
    the leader's hop raises at once)."""
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    try:
        from ..text.models.gpt import attach_mesh_group
        from .adapter import GPTAdapter
        from .quant.adapter import QuantizedGPTAdapter

        if device.type == "cuda":
            torch.cuda.set_device(device)
        shard = _loads(conn.recv_bytes()).to(device).eval()
        group = MeshGroup(rank, mp)
        attach_mesh_group(shard, group)
        cls = QuantizedGPTAdapter if spec["kv_dtype"] == "int8" \
            else GPTAdapter
        adapter = cls(shard, spec["page_size"])
        pools = tuple(adapter.init_pools(spec["num_pages"]))
        conn.send(("ready",))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            op = msg[0]
            if op == "exit":
                return
            if op == "connect":
                store = dist.TCPStore("127.0.0.1", port, mp, False,
                                      datetime.timedelta(
                                          seconds=_START_TIMEOUT_S))
                group.pg, group.backend = _new_group(
                    store, rank, mp, [torch.device(d) for d in devices])
            elif op == "run":
                _mirror_run(adapter, pools, msg[1], msg[2], device)
            elif op == "reset":
                if device.type == "cuda":
                    for p in pools:
                        p.zero_()
                else:
                    pools = None
                    pools = tuple(adapter.init_pools(spec["num_pages"]))
            elif op == "snapshot":
                page = msg[1]
                conn.send(("ok", _dumps(tuple(p[:, page].to("cpu", copy=True)
                                              for p in pools))))
            elif op == "restore":
                for p, a in zip(pools, _loads(msg[2])):
                    p[:, msg[1]].copy_(a)
            elif op == "query":
                cuda = device.type == "cuda"
                out = {"rank": rank, "launches": launch_counts(),
                       "mesh": group.counts(),
                       "peak_bytes": torch.cuda.max_memory_allocated(device)
                       if cuda else None,
                       "allocated_bytes": torch.cuda.memory_allocated(device)
                       if cuda else None,
                       "pool_bytes": sum(p.numel() * p.element_size()
                                         for p in pools),
                       "pool_shapes": [list(p.shape) for p in pools]}
                if msg[1]:
                    zero_launch_counts()
                    group.reset_counts()
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(device)
                conn.send(("ok", _dumps(out)))
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
