"""Programs: one step bound to static input buffers — on the card a CUDA
graph, on the CPU the eager step.

The TPU package compiles each static key of a step (a serving dispatch, a
``generate()`` decode step) into one XLA executable and replays it.  The
port's counterpart is a :class:`Program`:

- its inputs live in static buffers, filled before each run from the
  host (on the card through pinned staging buffers with
  ``non_blocking=True``: no host sync);
- on the card its first run is the eager step — which builds and loads
  the kernels (``nvcc`` on first use), sets their attributes and gives
  this run's outputs — followed by the capture of the same step into a
  ``torch.cuda.CUDAGraph`` on a side stream, in the memory pool the
  caller shares among its programs; every later run replays the graph and
  returns its static outputs;
- a ``torch.Generator`` the step draws from is registered with the graph,
  so each replay draws new numbers, the ones an eager run at the same
  offset would draw;
- the kernels' launch counters (``LAUNCHES`` and the per-body dicts of
  ``ops.flash_attention``, ``ops.paged_attention``, ``ops.bias_gelu``)
  count in Python and do not tick on replay: the capturing thread's
  launches are recorded as the graph's own (``ops._build
  .recording_launches``: the capture launches nothing, and other
  threads' launches meanwhile count as theirs) and added on every
  replay;
- on the CPU every run is the eager step over the same buffers.

A failed capture raises: a program never falls back to eager runs.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from ..ops import _build


#: replays of any program, process-wide (the launch counters count the
#: kernels inside them)
REPLAYS = 0

#: an argument of :meth:`Program.feed` that leaves its static buffer as it
#: is (a device-resident input the caller has not changed since it last
#: fed it: no host copy, no transfer)
KEEP = object()


def rng_position(gen):
    """Where ``gen`` is in its stream, restorable by :func:`set_rng_position`
    without replacing the generator's state object (a graph that registered
    the generator holds that object; ``set_state`` would swap it out and
    break every later replay)."""
    if gen.device.type == "cuda":
        return (gen.initial_seed(), gen.get_offset())
    return gen.get_state()


def set_rng_position(gen, pos):
    if gen.device.type == "cuda":
        gen.manual_seed(pos[0])
        gen.set_offset(pos[1])
    else:
        gen.set_state(pos)


# one capture stream per (device, cuBLAS handle).  cuBLAS keeps a workspace
# per (handle, stream) for the life of the process, so a stream per capture
# or per thread would add one with every new engine thread.  A handle
# belongs to one live thread at a time (two engines never capture on one
# stream) and passes to a later thread when its own ends, so a replacement
# engine reuses its predecessor's stream and workspaces.
_CAPTURE_STREAMS = {}


# the collector stays off while ANY thread captures: engines capture
# concurrently, and one capture's end must not re-enable it under another
_GC_LOCK = threading.Lock()
_GC_HOLDS = [0, False]         # active captures, whether we disabled it


def _hold_gc():
    with _GC_LOCK:
        if _GC_HOLDS[0] == 0:
            _GC_HOLDS[1] = gc.isenabled()
            gc.disable()
        _GC_HOLDS[0] += 1


def _release_gc():
    with _GC_LOCK:
        _GC_HOLDS[0] -= 1
        if _GC_HOLDS[0] == 0 and _GC_HOLDS[1]:
            gc.enable()


def _capture_stream(device):
    with torch.cuda.device(device):
        key = (device, torch.cuda.current_blas_handle())
    s = _CAPTURE_STREAMS.get(key)
    if s is None:
        s = _CAPTURE_STREAMS[key] = torch.cuda.Stream(device)
    return s


class Program:
    """``fn(*inputs) -> tuple`` (tensors or None) over static ``inputs``
    made from ``specs`` (``(shape, dtype)`` pairs) on ``device``.

    ``pool``: the ``torch.cuda.graph_pool_handle()`` the caller's graphs
    share; ``generator``: the ``torch.Generator`` the step draws from (it
    is registered with the graph); ``cost_fn``: ``() -> (flops, bytes)``
    of one step on copies of the state, for the perf table (never run on
    the dispatch path).  ``build_s`` / ``run_s`` / ``capture_s`` /
    ``pool_bytes`` describe the first run: the ``nvcc`` wall it waited
    out, the eager run (less that build) and the capture, and the bytes
    the capture reserved in the pool.  ``eager=True`` never captures:
    every run on the card is the eager step (a step whose collectives go
    through the host, which a graph cannot hold)."""

    def __init__(self, fn, specs, device, pool=None, generator=None,
                 cost_fn=None, eager=False):
        self.fn = fn
        self.device = torch.device(device)
        self.eager = bool(eager)
        self.graph = None
        self.outputs = None
        self.runs = 0
        self.build_s = self.run_s = self.capture_s = 0.0
        self.pool_bytes = None
        self._pool = pool
        self._gen = generator
        self._cost_fn = cost_fn
        self._deltas = {}
        cuda = self.device.type == "cuda"
        # plain tensors, not inference tensors: the buffers are written in
        # place from inside and outside inference mode
        with torch.inference_mode(False):
            self.inputs = [torch.zeros(s, dtype=d, device=self.device)
                           for s, d in specs]
            self._staging = [torch.zeros(s, dtype=d, pin_memory=True)
                             for s, d in specs] if cuda else None

    @property
    def captured(self):
        return self.graph is not None

    def feed(self, *arrays):
        """Copy host arrays into the static input buffers (in order);
        a :data:`KEEP` entry leaves its buffer as it is."""
        if self._staging is None:
            for buf, a in zip(self.inputs, arrays):
                if a is not KEEP:
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        for buf, stage, a in zip(self.inputs, self._staging, arrays):
            if a is KEEP:
                continue
            # the previous run ended in a host sync (its outputs' transfer),
            # so no copy out of this staging buffer is still pending
            stage.numpy()[...] = a
            buf.copy_(stage, non_blocking=True)

    def __call__(self):
        """Run the step: the eager run (and, on the card, the capture)
        the first time, a replay after that."""
        self.runs += 1
        if self.device.type != "cuda":
            return self.fn(*self.inputs)
        if self.graph is not None:
            global REPLAYS
            self.graph.replay()
            REPLAYS += 1
            _build.add_launches(self._deltas)
            return self.outputs
        if self.eager and self.runs > 1:
            return self.fn(*self.inputs)
        b0, t0 = _build.BUILD_SECONDS, time.perf_counter()
        out = self.fn(*self.inputs)
        # this stream only: a device-wide sync is illegal while another
        # engine's thread is capturing, and would invalidate its capture
        torch.cuda.current_stream(self.device).synchronize()
        self.build_s = _build.BUILD_SECONDS - b0
        self.run_s = time.perf_counter() - t0 - self.build_s
        if not self.eager:
            self._capture()
        return out

    def _capture(self):
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        g = torch.cuda.CUDAGraph()
        if self._gen is not None:
            g.register_generator_state(self._gen)
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(cur)
        # no garbage collection inside the capture: a collected graph's
        # destructor would call into CUDA from the capturing thread
        _hold_gc()
        try:
            with torch.cuda.stream(side), \
                    _build.recording_launches() as launched:
                # thread_local: other threads' CUDA calls (another engine,
                # a scrape reading the allocator) do not invalidate it
                g.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
                try:
                    outs = self.fn(*self.inputs)
                finally:
                    g.capture_end()
        finally:
            _release_gc()
        cur.wait_stream(side)
        # the capture launched nothing: its kernels run at each replay
        self._deltas = launched
        self.graph, self.outputs = g, outs
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0

    def cost(self):
        """``(flops, bytes, memory)`` of one step (see ``cost_fn``); the
        memory dict carries the graph pool's bytes."""
        if self._cost_fn is None:
            raise RuntimeError("this program has no cost function")
        flops, nbytes = self._cost_fn()
        mem = None
        if self.pool_bytes is not None:
            mem = {"argument_bytes": float(sum(
                       t.numel() * t.element_size() for t in self.inputs)),
                   "output_bytes": float(sum(
                       t.numel() * t.element_size()
                       for t in (self.outputs or ()) if t is not None)),
                   "temp_bytes": float(self.pool_bytes),
                   "peak_bytes": float(self.pool_bytes)}
        return flops, nbytes, mem
