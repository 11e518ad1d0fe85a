"""ReplicaPool — N :class:`~..engine.ServingEngine` replicas over one
model (data parallelism for inference; counterpart of
``paddle_tpu/serving/cluster/pool.py``).

Each replica is a full engine: its own scheduler thread, BlockManager and
page pools, ``replica=`` metric label and keyed ``/statusz`` provider.
The model and its program store are shared: the engines key the store by
(phase, batch shape, sampler), so same-shaped replicas reuse one minted
program family, and each captures its own CUDA graphs over its own pools.

Placement comes from torch: ``devices="auto"`` round-robins the replicas
over every visible ``cuda:i`` (and raises without a card, as
:func:`~...device.resolve_device` does); an explicit device list is taken
as given (``["cpu", "cpu"]`` on a machine without a card); the default
``devices=None`` leaves placement to the engine's ``device=`` (the card
unless ``device="cpu"`` is passed).  A replica on another device than the
model's serves a copy of the model made for that device, one per device.

Tensor-parallel replicas (dp x mp behind one router): ``mp=N`` carves
the device list (the visible cards by default) into contiguous N-sized
groups, one mesh engine each (``ServingEngine(mesh=...)``, one process per
shard); or ``devices=`` is a list of submeshes, each a device list.  On one
card, dp 2 x mp 2 is ``devices=["cuda:0"] * 4, mp=2``.  The divisibility
and the mixed forms raise ``ValueError``, as the reference's do.
"""

from __future__ import annotations

import copy
import os
import threading

import torch

def _auto_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "devices='auto' found no CUDA device; pass devices=['cpu', ...] "
            "or device='cpu' to run the port's plain paths on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _is_device(d):
    """A single device (vs a submesh list)."""
    return not isinstance(d, (list, tuple))


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class ReplicaPool:
    """Build and own N serving-engine replicas.

    ``replicas=None`` defaults to one per device (or per submesh) when
    ``devices`` / ``mp`` select placement, else 1.  ``replica_prefix`` namespaces the replica ids (metric labels,
    provider keys) when several pools share a process.  ``lora_store=``
    (in ``engine_kwargs``) picks the
    :class:`~..multitenant.MultiTenantEngine`; an explicit ``engine_cls``
    overrides.  ``warmup=`` (a
    :class:`~...observability.programs.WarmupManifest` or a saved path) is
    replayed by every engine before its scheduler starts, so a fresh
    replica's first request mints and captures nothing.  The remaining
    ``engine_kwargs`` go to every engine verbatim.
    """

    def __init__(self, model, replicas=None, devices=None, replica_prefix="",
                 engine_cls=None, mp=None, warmup=None, **engine_kwargs):
        from ..engine import ServingEngine

        if engine_cls is None:
            if "lora_store" in engine_kwargs:
                from ..multitenant import MultiTenantEngine

                engine_cls = MultiTenantEngine
            else:
                engine_cls = ServingEngine
        mp = int(mp) if mp else None
        if mp is not None and mp < 1:
            raise ValueError(f"mp must be >= 1, got {mp}")
        if devices == "auto":
            devices = _auto_devices()
        elif devices is not None:
            devices = list(devices)
            if not devices:
                raise ValueError("devices must be non-empty (or None/'auto')")
        # submesh placement: the caller's explicit submeshes (entries that
        # are device lists), or mp= carving a flat list into contiguous
        # mp-sized groups
        meshes = None
        if devices is not None and not all(_is_device(d) for d in devices):
            if mp is not None:
                raise ValueError(
                    "pass EITHER mp=N (carve a flat device list) OR "
                    "devices= as explicit submeshes, not both")
            if any(_is_device(d) for d in devices):
                raise ValueError(
                    "devices= mixes single devices and submeshes — use "
                    "1-element lists for single-device replicas")
            meshes = [[torch.device(d) for d in m] for m in devices]
            sizes = {len(m) for m in meshes}
            if len(sizes) > 1:
                raise ValueError(
                    f"submeshes must be same-sized (one program per family "
                    f"across replicas), got sizes {sorted(sizes)}")
        elif mp is not None and mp > 1:
            if devices is None:
                devices = _auto_devices()
            if len(devices) % mp:
                raise ValueError(
                    f"{len(devices)} devices not divisible by mp={mp}: a "
                    f"dp x mp pool needs len(devices) == replicas * mp "
                    f"(on one card repeat it: devices=['cuda:0'] * 4)")
            devices = [torch.device(d) for d in devices]
            meshes = [devices[i:i + mp] for i in range(0, len(devices), mp)]
        elif devices is not None:
            devices = [torch.device(d) for d in devices]
        if meshes is not None:
            if replicas is None:
                replicas = len(meshes)
            replicas = int(replicas)
            if replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {replicas}")
            if replicas > len(meshes):
                raise ValueError(
                    f"replicas={replicas} exceeds the {len(meshes)} "
                    f"available submeshes (need replicas * mp devices)")
        else:
            if replicas is None:
                replicas = len(devices) if devices is not None else 1
            replicas = int(replicas)
            if replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.model = model
        self.devices = devices
        self.meshes = meshes
        if isinstance(warmup, (str, os.PathLike)):
            from ...observability.programs import WarmupManifest

            warmup = WarmupManifest.load(warmup)
        self.warmup_manifest = warmup
        # elastic membership (AutoScaler): the build recipe is kept so
        # replicas can be added later; ids are monotonic (never reused),
        # so a replacement's labels and provider keys stay distinct
        self._engine_cls = engine_cls
        self._engine_kwargs = engine_kwargs
        self._replica_prefix = replica_prefix
        self._models = {}               # device -> the model served there
        self._mut = threading.RLock()
        self._next_idx = replicas
        self._pool_started = False
        self.engines = [self._build_engine(i) for i in range(replicas)]

    def _model_for(self, device):
        """The shared model, or (for a replica on another device than the
        model's) one copy of it per device."""
        try:
            home = next(self.model.parameters()).device
        except StopIteration:
            return self.model
        if _same_device(home, device):
            return self.model
        key = str(torch.device(device))
        if key not in self._models:
            self._models[key] = copy.deepcopy(self.model).to(device)
        return self._models[key]

    def _build_engine(self, i):
        kw = dict(self._engine_kwargs)
        model = self.model
        if self.meshes is not None:
            # a mesh engine shards the shared model itself, which stays
            # where it is
            kw["mesh"] = self.meshes[i % len(self.meshes)]
        elif self.devices is not None:
            kw["device"] = self.devices[i % len(self.devices)]
            model = self._model_for(kw["device"])
        return self._engine_cls(model, replica=f"{self._replica_prefix}{i}",
                                **kw)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        with self._mut:
            self._pool_started = True
            engines = list(self.engines)
        for e in engines:
            if self.warmup_manifest is not None and not e._started:
                e.warmup(self.warmup_manifest)
            e.start()
        return self

    def drain(self, timeout=600):
        for e in self.engines:
            e.drain(timeout=timeout)
        return True

    def stop(self, drain=False, drain_timeout=600):
        with self._mut:
            self._pool_started = False
        errors = []
        for e in list(self.engines):
            try:
                e.stop(drain=drain, drain_timeout=drain_timeout)
                if getattr(e, "_mesh", None) is not None:
                    e.close()   # joins its followers: none outlives it
            except Exception as exc:  # stop the rest before surfacing
                errors.append(exc)
        if errors:
            raise errors[0]

    # --------------------------------------------------- elastic membership
    def add_replica(self):
        """Grow the pool by one engine (autoscaler scale-up) and return it,
        started iff the pool is.  With a ``warmup=`` manifest the new
        engine replays it before its scheduler starts: the shared program
        store already holds every key, so growth mints nothing (on the
        card the engine still captures its own graphs over its pools)."""
        with self._mut:
            i = self._next_idx
            self._next_idx += 1
            e = self._build_engine(i)
            started = self._pool_started
            if not started:
                # replaced, not appended: readers iterate a consistent
                # snapshot without the pool lock
                self.engines = self.engines + [e]
        if started:
            # joins only once started: while it warms it reads "stopped",
            # and the autoscaler would reap it (and never stop its
            # scheduler, started after the reap)
            if self.warmup_manifest is not None:
                e.warmup(self.warmup_manifest)
            e.start()
            with self._mut:
                joined = self._pool_started
                if joined:
                    self.engines = self.engines + [e]
            if not joined:          # the pool stopped while it warmed
                e.stop()
        return e

    def remove_replica(self, engine):
        """Forget a retired or dead engine (the autoscaler stops it
        first)."""
        with self._mut:
            self.engines = [e for e in self.engines if e is not engine]
        if getattr(engine, "_mesh", None) is not None:
            engine.close()

    def snapshot_states(self):
        """One atomic ``(engines, states)`` pair: row ``i`` of ``states``
        describes ``engines[i]`` even if the pool resizes meanwhile."""
        with self._mut:
            engines = list(self.engines)
        return engines, self._states_of(engines)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def __len__(self):
        return len(self.engines)

    # -------------------------------------------------------------- insight
    @property
    def replica_ids(self):
        return [e.replica for e in self.engines]

    def states(self):
        """Router-input snapshots, one per replica (reads race the
        scheduler threads benignly: routing is a heuristic)."""
        return self._states_of(list(self.engines))

    @staticmethod
    def _states_of(engines):
        out = []
        for e in engines:
            hs = e.health_state()
            try:
                summ = e.prefix_index_summary()
            except AttributeError:      # a stand-in without a BlockManager
                summ = None
            out.append({
                "replica": e.replica,
                "state": hs["state"],
                "reasons": hs.get("reasons", []),
                "stalled": any("scheduler_stalled" in r
                               for r in hs.get("reasons", [])),
                "queue_depth": len(e._queue),
                "active": sum(1 for s in e._slots if s is not None),
                "num_slots": e.num_slots,
                "prefix_index": summ,
            })
        return out

    def stats(self):
        return {e.replica: e.stats() for e in self.engines}
