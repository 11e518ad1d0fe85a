"""Per-program roofline attribution (counterpart of
``paddle_tpu/observability/perf.py``): WHO spent the device time, and WHY.

- Every program family (``prefill/<bucket>``, ``prefill_chunk/<c>``,
  ``decode``, ``verify/k<k>`` — ``decode@flash`` on the card, where K3 /
  K4 bound each row's page sweep by its length, and ``@int8`` with int8
  pools — ``generate.decode`` and ``train_step/t<n>.v<i>``) accumulates
  **calls** and **device seconds** as the dispatch sites record them
  (the engine's step / prefill / chunk / verify dispatches, ``decode_loop``,
  ``TrainStep.__call__``).  Engine families are coarse, as in the
  reference: engines over one model share a family.
- Each family lazily attaches **flops and bytes per call**
  (:func:`jit_cost_thunk`: one eager step of the program's shapes on
  copies of its state, the aten ops counted under
  ``torch.utils.flop_counter.FlopCounterMode`` and by the bytes of their
  operands, plus each hand-written kernel's analytic operations and
  bytes, which the ctypes launches report to :func:`kernel_cost` — the
  flop counter cannot see them).  It runs on demand or on a background
  thread, never on the dispatch path and never inside a scrape.
- The table derives achieved TFLOP/s and GB/s, arithmetic intensity, the
  **roofline regime** against :func:`peak_flops` and :func:`hbm_ceiling`,
  and the fraction of the binding peak.

Exported three ways: ``perf.program.*`` metrics, the ``perf_programs``
section on ``/statusz`` (sorted by device time), and :func:`report`.

"Device seconds" are host-observed dispatch-to-sync walls at the
recording sites (each engine dispatch ends in its tokens' transfer), as
in the reference.

Ceilings (both axes): :func:`set_hbm_ceiling` / ``PADDLE_HBM_GBS`` /
the datasheet line for the visible card; ``PADDLE_PEAK_FLOPS`` / the
card's dense bf16 datasheet line.  On the CPU both are None.
"""

from __future__ import annotations

import os
import threading
import weakref
from time import perf_counter  # noqa: F401  (recording sites' clock)

# Dense bf16 tensor-core peak (FLOP/s) by card name, from NVIDIA's data
# sheets.  Override with PADDLE_PEAK_FLOPS.  TrainStep's MFU gauge reads
# the same table through peak_flops().
PEAK_BF16_FLOPS = {
    # NVIDIA H100 SXM5 80GB (torch.cuda.get_device_name: "NVIDIA H100 80GB
    # HBM3"): 989 TFLOP/s dense bf16, at the 700 W power limit
    "h100 80gb hbm3": 989e12,
}

# Device-memory bandwidth datasheet lines (bytes/s) by card name;
# PADDLE_HBM_GBS / set_hbm_ceiling() override them with a measured ceiling.
HBM_GBS = {
    # NVIDIA H100 SXM5 80GB: HBM3 at 3.35 TB/s
    "h100 80gb hbm3": 3.35e12,
}

_hbm_override = None  # set_hbm_ceiling() value (bytes/s)


def _device_kind():
    """The visible card's name, lower-cased (None without a card)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name().lower()
    except Exception:
        return None


def peak_flops():
    """Device peak FLOP/s: PADDLE_PEAK_FLOPS override, else the dense bf16
    datasheet number for the visible card, else None (the CPU)."""
    env = os.environ.get("PADDLE_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            return None  # malformed override must not kill the caller
    kind = _device_kind()
    if kind:
        for k, v in PEAK_BF16_FLOPS.items():
            if k in kind:
                return v
    return None


def hbm_ceiling():
    """Device-memory ceiling in bytes/s: set_hbm_ceiling() >
    PADDLE_HBM_GBS env > datasheet by card name > None."""
    if _hbm_override is not None:
        return _hbm_override
    env = os.environ.get("PADDLE_HBM_GBS")
    if env:
        try:
            return float(env) * 1e9
        except ValueError:
            return None
    kind = _device_kind()
    if kind:
        for k, v in HBM_GBS.items():
            if k in kind:
                return v
    return None


def set_hbm_ceiling(gbs):
    """Record a MEASURED memory ceiling (GB/s), overriding env/datasheet.
    ``None`` clears it."""
    global _hbm_override
    _hbm_override = None if gbs is None else float(gbs) * 1e9


def classify(flops_per_call, bytes_per_call, peak=None, hbm=None):
    """Roofline regime of a program: its arithmetic intensity (FLOP/byte)
    against the machine ridge point ``peak_flops / hbm_bytes_per_s``.
    Below the ridge the program cannot reach peak FLOP/s no matter how
    good the kernels are — HBM feeds it too slowly (bandwidth-bound);
    above it, compute is the wall."""
    peak = peak if peak is not None else peak_flops()
    hbm = hbm if hbm is not None else hbm_ceiling()
    if not flops_per_call or not bytes_per_call or not peak or not hbm:
        return "unknown"
    ridge = peak / hbm
    intensity = flops_per_call / bytes_per_call
    return "bandwidth-bound" if intensity < ridge else "compute-bound"


#: serving-engine program families whose bytes are dominated by the paged
#: KV cache — the ones int8 pools (kv_dtype="int8") directly shrink
_KV_BOUND_FAMILIES = ("decode", "prefill/", "prefill_chunk/", "verify/")


def is_quantized_family(family):
    """True for the quantized serving program families — the engine
    attributes its int8-pool programs as ``decode@int8``,
    ``prefill/<bucket>@int8``, ``verify/k<k>@int8``."""
    return "@int8" in family


def is_lora_family(family):
    """True for the multi-tenant LoRA program families — the engine
    attributes them as ``decode@lora-r<r>``, ``prefill/<bucket>@lora-r<r>``
    (rank-bucket suffix; adapter count never appears)."""
    return "@lora-r" in family


def is_encode_family(family):
    """True for the embed/score passthrough families
    (``prefill/<bucket>@embed`` / ``@score``)."""
    return "@embed" in family or "@score" in family


def is_flash_family(family):
    """True for the length-bounded flash-decode families — on the card
    the engine attributes its decode programs as ``decode@flash``
    (``decode@flash@int8`` when quantized): K3 / K4 stop each row's page
    sweep at its length, so dead pages are never read."""
    return "@flash" in family


def is_mp_family(family):
    """True for the tensor-parallel serving families — a mesh-sharded
    engine attributes its programs as ``decode@mp<N>``,
    ``prefill/<bucket>@mp<N>``, ``verify/k<k>@mp<N>`` (the suffix composes
    after ``@flash``/``@int8``: one SPMD program per family, dispatched
    over the ``model`` axis)."""
    return "@mp" in family


def mp_degree(family):
    """Model-parallel degree parsed from the ``@mp<N>`` suffix (1 when
    the family is unsharded)."""
    for part in family.split("@"):
        if part.startswith("mp") and part[2:].isdigit():
            return int(part[2:])
    return 1


def is_cached_prefill_family(family):
    """True for the prefix-cached prefill/encode families — the engine
    attributes a dispatch that reused ``p`` resident radix pages as
    ``prefill/<bucket>@cached<p>`` (``prefill/<bucket>@embed@cached<p>``
    for passthrough encodes): the family rides the chunked-prefill
    program shape but starts at the cached token offset, so its
    device-time per prompt token is already the minimum the cache can
    buy."""
    return "@cached" in family


def is_chunked_prefill_family(family):
    """True for the chunked-prefill ingestion families — the engine
    attributes them as ``prefill_chunk/<chunk_tokens>`` (plus the usual
    ``@int8`` / ``@lora-r<r>`` suffixes).  NOT a ``prefill/`` family:
    scratch is already O(chunk), so the 'chunk the prefill' capacity hint
    must never fire for these."""
    return family.split("@")[0].startswith("prefill_chunk/")


def _multi_chip_host():
    """More than one card visible — an unsharded serving family here is
    leaving capacity on the table, which flips the bandwidth-bound hint
    toward ``ServingEngine(mesh=...)``."""
    try:
        import torch

        return torch.cuda.is_available() and torch.cuda.device_count() > 1
    except Exception:
        return False


def candidate_hint(family, regime, temp_bytes=None, pool_bytes=None,
                   prefix_stats=None):
    """The regime-driven recommendation :meth:`ProgramTable.report` prints
    for a top device-time program.  Recognizes the quantized serving
    families: a bandwidth-bound UNQUANTIZED serving program's first lever
    is int8 KV pools (dequant fuses into the paged kernel — the
    serving.quant subsystem); an ``@int8`` family has already pulled it,
    so the hint points at the remaining byte traffic instead.  Also the
    multi-tenant families: ``@lora-r<r>`` programs carry the per-row
    paged adapter gather, ``@embed``/``@score`` are prefill-shaped
    one-shot encodes.

    Memory attribution (``temp_bytes`` from the family's
    ``memory_analysis``, ``pool_bytes`` = the ledger's KV pool total):
    a prefill family whose peak scratch dwarfs the whole paged cache is
    capacity-bound before it is time-bound — the hint becomes 'chunk the
    prefill', whatever the roofline regime says.

    Prefix-cache attribution (``prefix_stats`` = the registry's
    ``serving.prefix_cache_*`` / ``serving.kv_spill_*`` totals): a plain
    prefill family dominating device time while sharable pages mostly
    MISS means the workload recomputes prefixes the radix index would
    have kept resident — skipping the compute beats any bytes/flops
    lever, so that hint wins; a spill tier resurrecting pages about as
    fast as the cache hits is thrashing host<->device and wants a bigger
    ``PADDLE_KV_SPILL_BUDGET_BYTES``."""
    quant = is_quantized_family(family)
    flash = is_flash_family(family)
    mp = is_mp_family(family)
    serving = family.split("@")[0].startswith(_KV_BOUND_FAMILIES)
    if temp_bytes and pool_bytes \
            and is_chunked_prefill_family(family) \
            and temp_bytes > pool_bytes:
        return ("chunked prefill already active, yet peak temp bytes "
                f"({temp_bytes / 1e6:.1f} MB) still dwarf the paged KV "
                f"pools ({pool_bytes / 1e6:.1f} MB): lower "
                "prefill_chunk_tokens so per-chunk scratch shrinks "
                "further")
    if temp_bytes and pool_bytes \
            and family.split("@")[0].startswith("prefill/") \
            and temp_bytes > pool_bytes:
        return (f"prefill peak temp bytes ({temp_bytes / 1e6:.1f} MB) dwarf "
                f"the paged KV pools ({pool_bytes / 1e6:.1f} MB): chunk the "
                "prefill — ServingEngine(prefill_chunk_tokens=N) runs the "
                "prompt through the chunked cache variant in N-token "
                "slices so scratch stays O(chunk), and long prompts stop "
                "spiking HBM at admission")
    if prefix_stats:
        hits = int(prefix_stats.get("hits") or 0)
        misses = int(prefix_stats.get("misses") or 0)
        res = int(prefix_stats.get("resurrections") or 0)
        prefill_like = family.split("@")[0].startswith(
            ("prefill/", "prefill_chunk/"))
        if prefill_like and not is_cached_prefill_family(family) \
                and misses >= 8 and misses > 4 * max(hits, 1):
            return ("prefill dominates while sharable prefix pages miss "
                    f"{misses}:{hits} against the cache: enable the radix "
                    "prefix index (ServingEngine(prefix_cache=\"radix\")) "
                    "— partial-prefix matches reuse the longest shared "
                    "page run and prefill starts past the cached tokens, "
                    "skipping that compute entirely")
        if res >= 8 and res * 2 >= max(hits, 1):
            return ("KV spill tier is thrashing: "
                    f"{res} resurrections against {hits} cache hits "
                    "means hot prefix pages keep falling to host and "
                    "re-paging back — raise PADDLE_KV_SPILL_BUDGET_BYTES "
                    "(or shrink the working set) so resident prefixes "
                    "stay on-device")
    if regime == "bandwidth-bound":
        if is_lora_family(family):
            if quant:
                return ("HBM-bound int8 multi-LoRA program: KV dequant "
                        "fused; the remaining levers are the adapter "
                        "pools — fewer/lower rank buckets, fewer LoRA "
                        "targets, or bf16 adapter pools")
            return ("HBM-bound multi-LoRA serving program: the per-row "
                    "adapter gather rides the decode bytes — shrink rank "
                    "buckets / targets, then quantize the KV pools "
                    "(kv_dtype=\"int8\")")
        if is_encode_family(family):
            return ("HBM-bound embed/score encode: prefill-shaped one-shot "
                    "— batch more rows per dispatch or share prefix "
                    "compute with generate admissions")
        if mp and serving:
            n = mp_degree(family)
            if quant:
                return (f"HBM-bound mp{n} int8 serving program: KV pools "
                        "sharded over the model axis AND dequant fused — "
                        "per-shard bytes are the floor; remaining levers "
                        "are int8 weights (weight_dtype=\"int8\") and "
                        "batch occupancy")
            return (f"HBM-bound mp{n} serving program: already sharded "
                    "over the model axis, so each chip sweeps 1/"
                    f"{n} of the KV heads — cut the per-shard bytes next "
                    "with int8 pools (kv_dtype=\"int8\")")
        if flash:
            if quant:
                return ("HBM-bound int8 flash-decode program: the page "
                        "sweep is length-bounded and KV dequant is fused "
                        "— remaining levers are int8 weights "
                        "(weight_dtype=\"int8\") and batch occupancy "
                        "(more live slots per dispatch)")
            return ("HBM-bound flash-decode program: dead-page DMA is "
                    "already clamped by the length-bounded sweep — next "
                    "lever is int8 KV pools (kv_dtype=\"int8\"), then "
                    "int8 weights")
        if quant:
            return ("HBM-bound int8 serving program: KV dequant already "
                    "fused in-kernel — cut the remaining bytes (int8 "
                    "weights via weight_dtype, larger pages, more slots "
                    "per dispatch)")
        if serving and _multi_chip_host():
            return ("HBM-bound serving program with UNSHARDED pools on a "
                    "multi-chip host: shard the KV pools and weights over "
                    "the mesh (ServingEngine(mesh=...)) — each chip then "
                    "sweeps only its KV-head slice, ~1/mp the bytes/call "
                    "— then int8 pools (kv_dtype=\"int8\")")
        if serving:
            return ("HBM-bound serving program: quantize the KV pools "
                    "(kv_dtype=\"int8\" — dequant fuses into the paged "
                    "kernel, ~2x fewer cache bytes/call), fuse producers, "
                    "raise arithmetic intensity")
        return ("HBM-bound: cut bytes/call — fuse producers into the "
                "kernel, quantize operands, raise arithmetic intensity")
    if regime == "compute-bound":
        return ("compute-bound: raise matmul utilization — tile for the "
                "MXU, overlap with transfers")
    if quant:
        return ("regime unknown (resolve cost_analysis first); int8 "
                "serving program — KV dequant already fused in-kernel")
    return "regime unknown: resolve cost_analysis first"




class _ProgStats:
    __slots__ = ("family", "calls", "device_seconds", "flops_per_call",
                 "bytes_per_call", "memory_per_call", "cost_thunk",
                 "cost_error")

    def __init__(self, family):
        self.family = family
        self.calls = 0
        self.device_seconds = 0.0
        self.flops_per_call = None
        self.bytes_per_call = None
        self.memory_per_call = None  # memory dict (graph pool bytes) or None
        self.cost_thunk = None   # lazy () -> (flops, bytes[, memory])
        self.cost_error = None   # last thunk failure (kept, not retried)


class ProgramTable:
    """The live per-program attribution table (one per process by
    default — :func:`table`).  ``record`` is the hot-path entry: one dict
    lookup, two float adds under a per-table lock, two counter bumps."""

    def __init__(self, registry=None):
        from ..profiler import metrics as _metrics

        reg = registry if registry is not None else _metrics.get_registry()
        self._stats: dict[str, _ProgStats] = {}
        self._lock = threading.Lock()
        self._resolver = None
        self._m_calls = reg.counter(
            "perf.program.calls", "compiled-program dispatches, by family")
        self._m_seconds = reg.counter(
            "perf.program.device_seconds",
            "device seconds attributed to the family (dispatch-to-sync)")
        self._m_tflops = reg.gauge(
            "perf.program.achieved_tflops",
            "cost_analysis flops * calls / device seconds")
        self._m_gbs = reg.gauge(
            "perf.program.achieved_gbs",
            "cost_analysis bytes * calls / device seconds")
        self._m_frac = reg.gauge(
            "perf.program.frac_of_peak",
            "achieved rate over the BINDING peak (HBM when "
            "bandwidth-bound, FLOP/s when compute-bound)")
        # per-program memory attribution (memory_analysis, resolved off
        # the dispatch path exactly like the cost thunks)
        self._m_peak_bytes = reg.gauge(
            "perf.program.peak_bytes",
            "XLA memory_analysis peak bytes per call (argument + output "
            "+ temp - aliased)")
        self._m_temp_bytes = reg.gauge(
            "perf.program.temp_bytes",
            "XLA memory_analysis temp (scratch) bytes per call")

    # -------------------------------------------------------------- recording
    def _get(self, family):
        st = self._stats.get(family)
        if st is None:
            with self._lock:
                st = self._stats.setdefault(family, _ProgStats(family))
        return st

    def record(self, family, seconds, calls=1):
        """Attribute ``seconds`` of device time (``calls`` dispatches) to
        a program family.  Recording sites skip compile dispatches — a
        trace+compile wall is not device time."""
        st = self._get(family)
        with self._lock:
            st.calls += calls
            st.device_seconds += seconds
        self._m_calls.inc(calls, program=family)
        self._m_seconds.inc(seconds, program=family)

    def flops_per_call(self, family):
        """The family's resolved flops per call (None until resolved)."""
        st = self._stats.get(family)
        return None if st is None else st.flops_per_call

    def needs_cost(self, family):
        """True while the family has neither cost numbers nor a pending
        thunk — dispatch sites use this to capture arg shapes only once."""
        st = self._stats.get(family)
        return st is None or (st.flops_per_call is None
                              and st.cost_thunk is None
                              and st.cost_error is None)

    def set_cost(self, family, flops_per_call, bytes_per_call, memory=None):
        st = self._get(family)
        with self._lock:
            st.flops_per_call = float(flops_per_call)
            st.bytes_per_call = float(bytes_per_call)
            if memory is not None:
                st.memory_per_call = dict(memory)
            st.cost_thunk = None

    def register_cost_thunk(self, family, thunk):
        """Attach a lazy ``() -> (flops, bytes_accessed)`` (usually
        :func:`jit_cost_thunk`: one counted eager step of the program's
        shapes — real work, so it never runs here; see
        :meth:`resolve_costs`)."""
        st = self._get(family)
        with self._lock:
            if st.flops_per_call is None and st.cost_thunk is None:
                st.cost_thunk = thunk

    def resolve_costs(self):
        """Run every pending cost thunk SYNCHRONOUSLY (tests, report,
        bench).  A failing thunk records its error and is not retried."""
        for st in list(self._stats.values()):
            with self._lock:
                thunk = st.cost_thunk
            if thunk is None:
                continue
            try:
                res = thunk()
                # jit_cost_thunk returns (flops, bytes, memory);
                # external 2-tuple thunks stay valid
                mem = res[2] if len(res) > 2 else None
                self.set_cost(st.family, res[0], res[1], memory=mem)
            except Exception as e:  # cost analysis is best-effort
                with self._lock:
                    st.cost_error = repr(e)
                    st.cost_thunk = None

    def _resolve_costs_async(self):
        """Kick cost resolution on a daemon thread (telemetry scrapes must
        stay bounded — a scrape never compiles)."""
        with self._lock:
            if self._resolver is not None and self._resolver.is_alive():
                return
            if not any(st.cost_thunk is not None
                       for st in self._stats.values()):
                return
            self._resolver = threading.Thread(
                target=self.resolve_costs, name="paddle-perf-cost-resolver",
                daemon=True)
            self._resolver.start()

    # -------------------------------------------------------------- reading
    def snapshot(self, resolve=False):
        """Table rows sorted by total device time (descending), derived
        rates and roofline regime included; refreshes the ``perf.program``
        gauges.  ``resolve=True`` first runs pending cost thunks (slow —
        never from a scrape; the /statusz provider instead kicks the
        background resolver and shows what is already known)."""
        if resolve:
            self.resolve_costs()
        peak, hbm = peak_flops(), hbm_ceiling()
        rows = []
        with self._lock:
            stats = [(st.family, st.calls, st.device_seconds,
                      st.flops_per_call, st.bytes_per_call, st.cost_error,
                      st.cost_thunk is not None, st.memory_per_call)
                     for st in self._stats.values()]
        for family, calls, secs, flops, nbytes, err, pending, mem in stats:
            row = {"program": family, "calls": calls,
                   "device_seconds": secs,
                   "flops_per_call": flops, "bytes_per_call": nbytes,
                   "achieved_tflops": None, "achieved_gbs": None,
                   "intensity_flop_per_byte": None,
                   "regime": "unknown", "frac_of_peak": None,
                   "argument_bytes": None, "output_bytes": None,
                   "temp_bytes": None, "peak_bytes": None}
            if mem:
                for k in ("argument_bytes", "output_bytes", "temp_bytes",
                          "peak_bytes"):
                    row[k] = mem.get(k)
                if row["peak_bytes"] is not None:
                    self._m_peak_bytes.set(row["peak_bytes"], program=family)
                if row["temp_bytes"] is not None:
                    self._m_temp_bytes.set(row["temp_bytes"], program=family)
            if pending:
                row["cost"] = "pending"
            elif err is not None:
                row["cost"] = f"error: {err}"
            if flops and nbytes and secs > 0 and calls:
                fps = flops * calls / secs
                bps = nbytes * calls / secs
                row["achieved_tflops"] = fps / 1e12
                row["achieved_gbs"] = bps / 1e9
                row["intensity_flop_per_byte"] = flops / nbytes
                row["regime"] = classify(flops, nbytes, peak, hbm)
                if row["regime"] == "bandwidth-bound" and hbm:
                    row["frac_of_peak"] = bps / hbm
                elif row["regime"] == "compute-bound" and peak:
                    row["frac_of_peak"] = fps / peak
                self._m_tflops.set(row["achieved_tflops"], program=family)
                self._m_gbs.set(row["achieved_gbs"], program=family)
                if row["frac_of_peak"] is not None:
                    self._m_frac.set(row["frac_of_peak"], program=family)
            rows.append(row)
        rows.sort(key=lambda r: -r["device_seconds"])
        return rows

    def statusz(self):
        """/statusz ``perf_programs`` provider: the table plus the
        ceilings it was judged against.  A scrape NEVER compiles: with
        ``PADDLE_PERF_COST=1`` pending costs resolve on a background
        thread kicked here; otherwise they stay "pending" until someone
        calls :func:`resolve_costs` / ``report()`` explicitly (a hidden
        background XLA compile per scrape is real CPU stolen from the
        serving process — opt in deliberately)."""
        if os.environ.get("PADDLE_PERF_COST", "").lower() \
                not in ("", "0", "false", "no"):
            self._resolve_costs_async()
        peak, hbm = peak_flops(), hbm_ceiling()
        return {
            "peak_tflops": peak / 1e12 if peak else None,
            "hbm_gbs": hbm / 1e9 if hbm else None,
            "ridge_flop_per_byte": (peak / hbm) if peak and hbm else None,
            "programs": self.snapshot(resolve=False),
        }

    def report(self, top=3, resolve=True):
        """Profiler.summary()-style text table + the top fusion/kernel
        candidates (largest device-time programs, with the roofline-driven
        recommendation: cut bytes when bandwidth-bound, cut/overlap flops
        when compute-bound)."""
        rows = self.snapshot(resolve=resolve)
        head = (f"{'program':<24}{'calls':>8}{'dev s':>10}{'TFLOP/s':>10}"
                f"{'GB/s':>9}{'I(F/B)':>9}{'of peak':>9}{'peak MB':>9}"
                "  regime")
        lines = ["Per-program roofline attribution", head, "-" * len(head)]

        def fmt(v, nd=2):
            return f"{v:.{nd}f}" if v is not None else "-"

        for r in rows:
            peak_mb = r["peak_bytes"] / 1e6 \
                if r.get("peak_bytes") is not None else None
            lines.append(
                f"{r['program']:<24}{r['calls']:>8}"
                f"{r['device_seconds']:>10.3f}"
                f"{fmt(r['achieved_tflops']):>10}{fmt(r['achieved_gbs'], 1):>9}"
                f"{fmt(r['intensity_flop_per_byte'], 1):>9}"
                f"{fmt(r['frac_of_peak'], 3):>9}{fmt(peak_mb, 1):>9}"
                f"  {r['regime']}")
        cands = [r for r in rows if r["device_seconds"] > 0][:top]
        if cands:
            # the memory ledger's KV pool total is the denominator for the
            # chunk-the-prefill hint (best-effort: no ledger, no hint)
            try:
                from . import memory as _memory

                pool_bytes = _memory.ledger().kv_pool_bytes()
            except Exception:
                pool_bytes = None
            # prefix-cache workload evidence for the radix/spill hints
            # (best-effort: zero everywhere -> no evidence -> no hint)
            try:
                from ..profiler import metrics as _pm

                prefix_stats = {
                    "hits": _pm.counter(
                        "serving.prefix_cache_hits").total() or 0,
                    "misses": _pm.counter(
                        "serving.prefix_cache_misses").total() or 0,
                    "resurrections": _pm.counter(
                        "serving.kv_spill_resurrections").total() or 0,
                }
                if not any(prefix_stats.values()):
                    prefix_stats = None
            except Exception:
                prefix_stats = None
            lines.append("")
            lines.append("Top kernel/fusion candidates (by device time):")
            for i, r in enumerate(cands, 1):
                hint = candidate_hint(r["program"], r["regime"],
                                      temp_bytes=r.get("temp_bytes"),
                                      pool_bytes=pool_bytes,
                                      prefix_stats=prefix_stats)
                lines.append(f"  {i}. {r['program']} "
                             f"({r['device_seconds']:.3f}s over "
                             f"{r['calls']} calls) — {hint}")
        return "\n".join(lines)

    def drop_prefix(self, prefix):
        """Evict every family under ``prefix`` (``prefix`` itself or
        ``prefix.*``/``prefix/*``).  TrainStep registers this as a
        weakref finalizer on its per-instance tag, so a process that
        constructs TrainSteps in a loop does not grow the table without
        bound (already-rendered ``perf.program.*`` registry series stay,
        like any labelled metric's)."""
        with self._lock:
            for fam in [f for f in self._stats
                        if f == prefix or f.startswith(prefix + ".")
                        or f.startswith(prefix + "/")]:
                del self._stats[fam]

    def reset(self):
        with self._lock:
            self._stats.clear()


# ------------------------------------------------------- process-wide table
_TABLE = None
_TABLE_LOCK = threading.Lock()
_PROVIDER_REGISTERED = False


def table() -> ProgramTable:
    global _TABLE
    if _TABLE is None:
        with _TABLE_LOCK:
            if _TABLE is None:
                _TABLE = ProgramTable()
    return _TABLE


def _ensure_provider():
    """Register the /statusz ``perf_programs`` section once, lazily on
    first record — a process that never dispatches never grows the key."""
    global _PROVIDER_REGISTERED
    if _PROVIDER_REGISTERED:
        return
    with _TABLE_LOCK:
        if _PROVIDER_REGISTERED:
            return
        from . import telemetry as _telemetry

        _telemetry.add_status_provider("perf_programs",
                                       lambda: table().statusz())
        _PROVIDER_REGISTERED = True


def record(family, seconds, calls=1):
    """Module-level spelling of :meth:`ProgramTable.record` on the process
    table (the one dispatch sites use)."""
    _ensure_provider()
    table().record(family, seconds, calls)


def needs_cost(family):
    return table().needs_cost(family)


def register_cost_thunk(family, thunk):
    table().register_cost_thunk(family, thunk)


def snapshot(resolve=False):
    return table().snapshot(resolve=resolve)


def resolve_costs():
    table().resolve_costs()


def report(top=3, resolve=True):
    return table().report(top=top, resolve=resolve)


def reset():
    """Tests: drop accumulated attribution (the table object and its
    registered provider survive)."""
    if _TABLE is not None:
        _TABLE.reset()


def metric_quantile(name, q, **labels):
    """Reservoir quantile of one registry histogram child, or None when
    the series is absent or empty.  The read half of the latency-SLO
    story (bench arms and the QoS report use it for per-tier TTFT/ITL
    p95s): serving series carry ``replica=`` labels — and on QoS engines
    ``tier=`` — so the child is addressed by exact label match."""
    from ..profiler import metrics as _metrics

    h = _metrics.get_registry().get(name)
    c = h.labels(**labels) if h is not None else None
    return (c.quantile(q) if c is not None and c.count else None)



# ------------------------------------------------- cost-thunk construction
_COST = threading.local()


def kernel_cost(ops, nbytes):
    """Called by a hand-written kernel's wrapper when it launches: adds
    the launch's analytic operations and bytes to the cost being counted
    on this thread (a no-op outside :func:`jit_cost_thunk`)."""
    acc = getattr(_COST, "acc", None)
    if acc is not None:
        acc[0] += float(ops)
        acc[1] += float(nbytes)


def counting_kernels():
    """Whether this thread is counting a program's cost (wrappers compute
    their analytic cost only then: it may read lengths from the card)."""
    return getattr(_COST, "acc", None) is not None


def _nbytes(x):
    import torch

    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def count_cost(fn, inference=True, protect=()):
    """``(flops, bytes)`` of one ``fn()``: the aten ops under
    ``FlopCounterMode`` and by their operands' and results' bytes (an
    in-place op by its other operands, read and written), plus the
    launches that report to :func:`kernel_cost`.  ``inference=False`` lets
    ``fn`` run a backward.

    The count leaves no trace outside ``fn``'s own results: a seeded
    random op draws nothing from any generator (its result is zeros), and
    an op that writes into the storage of a ``protect`` tensor (a live KV
    pool, a parameter, a quantizer's buffer) does not write there — it is
    counted as if it had."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    moved = [0]
    guarded = {t.untyped_storage().data_ptr() for t in protect}

    class _Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = _side_effect_free(func, args, kwargs, guarded)
            pk = func._overloadpacket
            if pk in _VIEWS:
                return out
            if pk.__name__.endswith("_"):
                # in place (a pool write, a fill): the operands other than
                # the destination are read, and as many bytes written
                moved[0] += 2 * sum(map(_nbytes,
                                        tree_flatten((args[1:], kwargs))[0]))
            else:
                moved[0] += sum(map(_nbytes, tree_flatten((args, kwargs))[0]))
                moved[0] += sum(map(_nbytes, tree_flatten(out)[0]))
            return out

    _COST.acc = [0.0, 0.0]
    try:
        with FlopCounterMode(display=False) as fc, _Bytes(), \
                torch.inference_mode(inference):
            fn()
        acc = _COST.acc
    finally:
        _COST.acc = None
    return float(fc.get_total_flops()) + acc[0], float(moved[0]) + acc[1]


def _side_effect_free(func, args, kwargs, guarded):
    """Run one aten op of a counted step (:func:`count_cost`) with no
    effect beyond its results: a seeded random op's result is zeros of
    the shape its meta kernel gives (no generator advances); an op that
    writes a tensor whose storage is in ``guarded`` returns that tensor
    unwritten when it is the op's result (in place, ``out=``), and writes
    a copy of it otherwise."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_map

    schema = func._schema
    vals = [args[i] if i < len(args) else kwargs.get(a.name)
            for i, a in enumerate(schema.arguments)]
    ret = schema.returns[0].alias_info if len(schema.returns) == 1 else None
    ret = ret if ret is not None and ret.is_write else None
    # the argument the op returns written (in place, out=)
    dest = next((v for a, v in zip(schema.arguments, vals)
                 if ret is not None and a.alias_info is not None
                 and a.alias_info.before_set == ret.before_set), None)

    def hit(v):
        return any(isinstance(t, torch.Tensor) and t.numel()
                   and t.untyped_storage().data_ptr() in guarded
                   for t in tree_flatten(v)[0])

    if torch.Tag.nondeterministic_seeded in func.tags:
        if dest is not None:
            if not hit(dest):
                dest.zero_()
            return dest
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        device = kwargs.get("device") or (tensors[0].device if tensors
                                          else "cpu")

        def meta(x):
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device="meta") \
                if isinstance(x, torch.Tensor) else x

        mkw = tree_map(meta, kwargs)
        for k, v in (("generator", None), ("device", "meta")):
            if k in mkw:
                mkw[k] = v
        shaped = func(*tree_map(meta, args), **mkw)
        return tree_map(lambda o: torch.zeros(o.shape, dtype=o.dtype,
                                              device=device)
                        if isinstance(o, torch.Tensor) else o, shaped)
    if not guarded:
        return func(*args, **kwargs)
    if dest is not None and hit(dest):
        return dest
    written = {a.name for a, v in zip(schema.arguments, vals)
               if a.alias_info is not None and a.alias_info.is_write
               and hit(v)}
    if not written:
        return func(*args, **kwargs)
    copy = {}
    for i, a in enumerate(schema.arguments):
        if a.name in written:
            copy[i] = tree_map(lambda t: t.clone()
                               if isinstance(t, torch.Tensor) else t, vals[i])
    pos = {a.name: i for i, a in enumerate(schema.arguments)}
    return func(*[copy.get(i, v) for i, v in enumerate(args)],
                **{k: copy.get(pos[k], v) for k, v in kwargs.items()})


def _views():
    import torch

    a = torch.ops.aten
    return {a.view, a._unsafe_view, a.reshape, a.expand, a.permute,
            a.transpose, a.t, a.select, a.slice, a.unsqueeze, a.squeeze,
            a.as_strided, a.alias, a.detach, a.unbind, a.split,
            a.split_with_sizes, a.chunk, a.unfold, a.diagonal, a.view_as_real,
            a.lift_fresh}


class _LazyViews:
    """The aten view ops (they move no bytes), resolved on first use."""

    _set = None

    def __contains__(self, op):
        if self._set is None:
            _LazyViews._set = _views()
        return op in self._set


_VIEWS = _LazyViews()


def jit_cost_thunk(program, args=None):
    """A lazy cost thunk for ``program`` (a
    :class:`~paddle_tpu_torch.jit.graphs.Program`, or anything with a
    ``cost()`` method returning ``(flops, bytes[, memory])``): nothing
    runs now; resolving runs one counted eager step of the program's
    shapes on copies of its state.

    The program is held by WEAKREF: the process-wide table outlives any
    one engine or model, and a pending thunk must not pin a dead model's
    weights or pools."""
    ref = weakref.ref(program)

    def thunk():
        prog = ref()
        if prog is None:
            raise RuntimeError(
                "program was garbage-collected before its cost resolved")
        return prog.cost()

    return thunk


def jit_analysis_thunk(program, args=None):
    """The program ledger's per-row analysis: the first dispatch's stall
    split into ``backend_compile_s`` (the ``nvcc`` wall it waited out)
    and ``trace_s`` (the eager run and the capture), the graph pool's
    bytes (``executable_bytes``; None on the CPU), and the counted flops /
    bytes of one step.  Lazy and weakref'd like :func:`jit_cost_thunk`."""
    ref = weakref.ref(program)

    def thunk():
        prog = ref()
        if prog is None:
            raise RuntimeError(
                "program was garbage-collected before its analysis "
                "resolved")
        flops, nbytes, mem = prog.cost()
        return {"trace_s": prog.run_s + prog.capture_s,
                "backend_compile_s": prog.build_s,
                "flops": flops, "bytes_accessed": nbytes,
                "executable_bytes": prog.pool_bytes,
                "memory": mem}

    return thunk
