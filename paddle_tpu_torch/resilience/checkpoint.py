"""Async checkpointing with atomic commit, checksum manifests, and
corruption fallback — the save half of the recovery loop (counterpart of
``paddle_tpu/resilience/checkpoint.py``).

Layered on :mod:`paddle_tpu_torch.io.checkpoint`'s manifest protocol
(``write_manifest`` / ``verify_manifest``): each checkpoint is a directory

.. code-block:: text

    <dir>/step_00000012/
        tree.json      # pytree structure + scalar leaves
        arrays.npz     # every array leaf, host-side
        manifest.json  # sha256 + byte counts over both (written LAST)

written under a ``.tmp-<pid>`` name and renamed into place only after the
manifest is fsynced — a crash mid-save leaves a ``.tmp`` orphan (garbage-
collected, never restored from), and a committed directory that later
fails its checksums is QUARANTINED and restore falls back to the previous
valid step instead of feeding corrupt weights to the optimizer.  The
layout, the tree schema and the step naming are the reference's, so a
checkpoint directory written by either package restores in the other.

``save()`` copies the state to host numpy before it returns and hands the
disk work to one background writer thread, so steady-state checkpointing
costs the train loop a host copy, not an fsync.  The copy is the
async-safety boundary, and here it is a real one: the optimizer and
``jit.TrainStep`` update parameters and optimizer state IN PLACE (the
reference's arrays are immutable), so a snapshot that aliased them, or
that was still copying off the card when the next step ran, would commit
a state that never existed.  A CUDA tensor is copied with a synchronous
``.to("cpu", copy=True)``, finished before ``save()`` returns; a CPU
tensor is cloned (its ``.numpy()`` would alias its storage).
``save_emergency()`` is the synchronous spelling the SIGTERM / watchdog
hooks use (:mod:`.emergency`).

Array leaves are written as numpy arrays.  A bfloat16 tensor (numpy has
no such type) is written as its raw two bytes per element with dtype
``|V2``, which is what the reference's ``np.savez`` writes for a
``jnp.bfloat16`` leaf: the files interchange, and, as in the reference,
such a leaf restores as ``|V2`` bytes with ``to_tensors=False`` and
raises ``TypeError`` with ``to_tensors=True``.  ``to_tensors=True``
restores ``torch.Tensor``\\ s on ``device`` (the card unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..io.checkpoint import verify_manifest, write_manifest
from ..profiler import metrics as _metrics

logger = logging.getLogger("paddle_tpu_torch.resilience")

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TREE_SCHEMA = "paddle_tpu.resilience.checkpoint.v1"


# ----------------------------------------------------------- pytree <-> disk
def _host_copy(t):
    """A host numpy array that owns its bytes: a synchronous copy off the
    card, or a clone of a CPU tensor.  bfloat16 becomes its raw bytes as
    ``|V2`` (the reference's on-disk form of a bfloat16 leaf)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _snapshot(tree, arrays):
    """State pytree -> JSON-able structure; array leaves become host numpy
    copies keyed into ``arrays`` (the copy is the async-safety boundary:
    the caller may update its tensors in place the moment save()
    returns)."""
    if isinstance(tree, torch.Tensor):
        key = f"a{len(arrays)}"
        arrays[key] = _host_copy(tree)
        return {"__array__": key}
    if hasattr(tree, "shape") and hasattr(tree, "dtype") \
            and not isinstance(tree, (np.generic,)):
        key = f"a{len(arrays)}"
        arrays[key] = np.array(tree)  # np.array copies; np.asarray may alias
        return {"__array__": key}
    if isinstance(tree, np.generic):
        return {"__scalar__": tree.item(), "__dtype__": str(tree.dtype)}
    if isinstance(tree, dict):
        bad = [k for k in tree if not isinstance(k, str)]
        if bad:
            raise TypeError(
                f"checkpoint dict keys must be str (JSON round-trip would "
                f"silently stringify {bad[:3]!r}); convert keys explicitly")
        return {"__dict__": {k: _snapshot(v, arrays)
                             for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"__list__": [_snapshot(v, arrays) for v in tree]}
    if isinstance(tree, tuple):
        return {"__tuple__": [_snapshot(v, arrays) for v in tree]}
    if isinstance(tree, (bool, int, float, str, type(None))):
        return tree
    raise TypeError(
        f"unsupported checkpoint leaf {type(tree).__name__}; state must be "
        "a pytree of Tensors/arrays/scalars/str (nest dicts/lists/tuples)")


def _rebuild(node, arrays, device):
    """``device`` None: numpy leaves; else tensors on that device (a
    ``|V2`` leaf raises ``TypeError`` there, as in the reference)."""
    if isinstance(node, dict):
        if "__array__" in node:
            v = arrays[node["__array__"]]
            return v if device is None else torch.from_numpy(v).to(device)
        if "__scalar__" in node:
            return np.dtype(node["__dtype__"]).type(node["__scalar__"])
        if "__dict__" in node:
            return {k: _rebuild(v, arrays, device)
                    for k, v in node["__dict__"].items()}
        if "__list__" in node:
            return [_rebuild(v, arrays, device) for v in node["__list__"]]
        if "__tuple__" in node:
            return tuple(_rebuild(v, arrays, device)
                         for v in node["__tuple__"])
    return node


class CheckpointCorruptionError(RuntimeError):
    """Every on-disk checkpoint failed its checksum manifest."""


class AsyncCheckpointManager:
    """Background-writing, checksum-verified checkpoint rotation.

    Save every K steps, keep the last N, resume from the latest, with the
    resilience extensions: ``save`` returns before the disk write,
    ``restore_latest_valid`` skips — and quarantines — corrupt steps, and
    ``save_emergency`` is the synchronous crash-path spelling.
    """

    def __init__(self, directory, max_to_keep=5, save_interval_steps=1,
                 queue_depth=2):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep) if max_to_keep else None
        self.save_interval_steps = max(int(save_interval_steps), 1)
        self._queue_depth = max(int(queue_depth), 1)
        self._pending = []           # [(step, structure, arrays)]
        self._cv = threading.Condition()
        self._busy = False           # writer mid-checkpoint
        self._stop = False
        self._error = None           # first writer failure, surfaced on wait
        self._write_lock = threading.Lock()   # writer thread vs emergency
        self._thread = None
        self._m_saves = _metrics.counter(
            "resilience.checkpoint_saves", "committed checkpoints by kind")
        self._m_save_seconds = _metrics.histogram(
            "resilience.checkpoint_save_seconds",
            "snapshot-to-commit latency of one checkpoint")
        self._m_dropped = _metrics.counter(
            "resilience.checkpoint_saves_dropped",
            "queued saves dropped because the writer fell behind")
        self._m_corrupt = _metrics.counter(
            "resilience.checkpoint_corruptions",
            "checkpoints quarantined after failing their manifest")
        self._register_memory()
        self._gc_partials()

    def _register_memory(self):
        """Ledger owner ``checkpoint.snapshot`` (observability/memory.py):
        queued-but-unwritten snapshots are host numpy, not card memory, so
        the row registers with ``device="host"`` — visible in the owner
        table, excluded from the allocator reconciliation.  The byte
        source is the reference's as written: it walks each queued
        snapshot's dict keys, so with a save queued it raises and the
        ledger drops the row (ROADMAP Queue 3, pinned)."""
        import weakref

        from ..observability import memory as _obs_memory

        ref = weakref.ref(self)

        def src():
            mgr = ref()
            if mgr is None:
                return None
            return sum(int(a.nbytes) for _, _, arrays in mgr._pending
                       for a in arrays)
        _obs_memory.ledger().register(
            "checkpoint.snapshot", src, replica="-", device="host",
            meta={"kind": "checkpoint"})

    # ------------------------------------------------------------- locations
    def _step_dir(self, step):
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def all_steps(self):
        """Committed steps (ascending).  Commit = the directory rename
        happened; validity (checksums) is checked at restore time."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for n in names:
            m = _STEP_RE.match(n)
            if m and os.path.isdir(os.path.join(self.directory, n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step):
        """(ok, problems) for one committed step's manifest."""
        return verify_manifest(self._step_dir(step))

    def valid_steps(self):
        return [s for s in self.all_steps() if self.verify(s)[0]]

    # ------------------------------------------------------------------ save
    def save(self, step, state, force=False, block=False):
        """Snapshot ``state`` to host and queue the disk write.  Returns
        True when a save was scheduled (False: off-interval step, or an
        older queued save was superseded by this one under backlog).  The
        snapshot is complete when this returns, whatever ``block``."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        arrays = {}
        structure = _snapshot(state, arrays)
        with self._cv:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("previous async checkpoint failed") from err
            while len(self._pending) >= self._queue_depth:
                # writer fell behind: the OLDEST queued save is the least
                # useful one — drop it rather than stall the train loop
                dropped_step, _, _ = self._pending.pop(0)
                self._m_dropped.inc()
                logger.warning(
                    "async checkpoint writer behind: dropped queued save of "
                    "step %d (step %d supersedes it)", dropped_step, step)
            self._pending.append((step, structure, arrays))
            self._ensure_thread()
            self._cv.notify_all()
        if block:
            self.wait_until_finished()
        return True

    def save_emergency(self, step, state, reason="emergency",
                       from_signal=False):
        """Synchronous save on the crash path (SIGTERM, watchdog fire):
        snapshot + write + commit before returning, bypassing the queue.
        Never raises — the emergency path must not mask the original
        failure — and BOUNDS its wait on the writer lock (the caller may
        be a signal handler; waiting forever on a wedged writer thread
        would keep the dying process alive).  ``from_signal`` additionally
        skips logging and metric locks: the interrupted frame may hold
        them, and blocking there would deadlock the dying process (the
        flight recorder's signal-path rule).  Returns the committed path
        or None."""
        try:
            arrays = {}
            structure = _snapshot(state, arrays)
            path = self._write(int(step), structure, arrays, kind=reason,
                               lock_timeout=10.0,
                               record_metrics=not from_signal)
            return path
        except Exception:
            if not from_signal:
                logger.exception("emergency checkpoint of step %s failed",
                                 step)
            return None

    def wait_until_finished(self):
        """Block until every queued save committed; re-raise the first
        writer failure if one happened."""
        with self._cv:
            while self._pending or self._busy:
                self._cv.wait(timeout=0.05)
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("async checkpoint failed") from err

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.wait_until_finished()
        finally:
            self.close()

    # ---------------------------------------------------------------- writer
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._writer_loop, name="paddle-ckpt-writer",
                daemon=True)
            self._thread.start()

    def _writer_loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop and not self._pending:
                    return
                step, structure, arrays = self._pending.pop(0)
                self._busy = True
            try:
                self._write(step, structure, arrays, kind="async")
            except Exception as e:
                logger.exception("async checkpoint of step %d failed", step)
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write(self, step, structure, arrays, kind, lock_timeout=None,
               record_metrics=True):
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        if lock_timeout is not None:
            if not self._write_lock.acquire(timeout=lock_timeout):
                raise TimeoutError(
                    f"checkpoint writer lock not acquired within "
                    f"{lock_timeout}s (emergency save path)")
        else:
            self._write_lock.acquire()
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump({"schema": _TREE_SCHEMA, "step": step,
                           "tree": structure}, f)
                f.flush()
                os.fsync(f.fileno())
            # manifest last: its presence certifies a complete write
            write_manifest(tmp, step=step, kind=kind, time=time.time())
            if os.path.isdir(final):
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._fsync_dir(self.directory)
        finally:
            self._write_lock.release()
        if record_metrics:  # skipped on the signal path: no metric locks
            self._m_saves.inc(kind=kind)
            self._m_save_seconds.observe(time.perf_counter() - t0)
        self._gc()
        return final

    @staticmethod
    def _fsync_dir(path):
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass  # not all filesystems allow directory fsync

    # ------------------------------------------------------------------- gc
    def _gc_partials(self):
        """Drop orphaned partial saves (``step_*.tmp-*``) — a previous
        process died mid-write; these were never committed and must never
        shadow a real checkpoint or leak disk.  Called ONLY at manager
        startup, when no writer can be mid-save: a post-commit sweep would
        race a concurrent emergency save's in-progress tmp directory and
        delete the checkpoint at exactly the moment it was needed."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for n in names:
            if ".tmp-" in n and n.startswith("step_"):
                shutil.rmtree(os.path.join(self.directory, n),
                              ignore_errors=True)

    def _gc(self):
        if not self.max_to_keep:
            return
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _quarantine(self, step, problems):
        src = self._step_dir(step)
        dst = f"{src}.corrupt-{int(time.time())}"
        logger.error(
            "checkpoint step %d failed its manifest (%s); quarantined to %s",
            step, "; ".join(problems), dst)
        try:
            os.replace(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        self._m_corrupt.inc()

    def _read(self, step, device):
        d = self._step_dir(step)
        with open(os.path.join(d, "tree.json")) as f:
            doc = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return _rebuild(doc["tree"], arrays, device)

    def restore(self, step=None, to_tensors=True, device=None):
        """Restore one step (default latest committed), verifying its
        manifest first.  ``to_tensors``: array leaves as tensors on
        ``device`` (None: the card), else numpy.  Raises
        :class:`CheckpointCorruptionError` if that step is corrupt — use
        :meth:`restore_latest_valid` for automatic fallback.  Returns None
        when no checkpoint exists."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        ok, problems = self.verify(step)
        if not ok:
            raise CheckpointCorruptionError(
                f"checkpoint step {step} failed verification: "
                f"{'; '.join(problems)}")
        return self._read(int(step), resolve_device(device) if to_tensors
                          else None)

    def restore_latest_valid(self, to_tensors=True, device=None):
        """Newest checkpoint that passes its checksum manifest, walking
        backwards over corrupt ones (each is quarantined so the next
        attempt doesn't re-verify it).  Returns ``(step, state)`` or
        ``(None, None)`` when nothing restorable exists."""
        device = resolve_device(device) if to_tensors else None
        for step in reversed(self.all_steps()):
            ok, problems = self.verify(step)
            if not ok:
                self._quarantine(step, problems)
                continue
            try:
                return step, self._read(step, device)
            except Exception as e:  # unreadable despite manifest: quarantine
                self._quarantine(step, [repr(e)])
        return None, None
