"""PyTorch port, the per-program roofline table on the CPU against the JAX
package's ``observability/perf.py``: ``classify``, the family predicates
and ``candidate_hint`` give the reference's exact strings over a grid of
families, regimes, memory and prefix-cache evidence (the multi-card
probe pinned to one answer in both packages); ``ProgramTable`` snapshots
(fields, values, ordering by device time), ``drop_prefix``, ``report``
and the ``PADDLE_PEAK_FLOPS`` / ``PADDLE_HBM_GBS`` / ``set_hbm_ceiling``
overrides equal the reference's for the same records; the peaks are None
on the CPU; TrainStep families are ``train_step/t<n>.v<i>`` and leave the
table with their TrainStep; the port's cost counting sees the aten flops
and the bytes moved.  Every comparison is exact."""

import gc
import re

import numpy as np
import pytest
import torch

from paddle_tpu.observability import memory as jmemory
from paddle_tpu.observability import perf as jperf
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu_torch.observability import memory
from paddle_tpu_torch.observability import perf
from paddle_tpu_torch.profiler import metrics

FAMILIES = [
    "decode", "decode@int8", "decode@flash", "decode@flash@int8",
    "decode@mp2", "decode@flash@int8@mp4", "prefill/64", "prefill/64@int8",
    "prefill/128@cached3", "prefill/64@embed", "prefill/64@score",
    "prefill/64@embed@cached2", "prefill_chunk/128", "prefill_chunk/128@int8",
    "verify/k4", "verify/k4@int8", "decode@lora-r8", "decode@lora-r8@int8",
    "generate.decode", "train_step/t0.v1", "something/else",
]
REGIMES = ["bandwidth-bound", "compute-bound", "unknown"]
MEMORY = [(None, None), (5e6, 1e6), (1e6, 5e6)]
PREFIX = [None, {"hits": 1, "misses": 20, "resurrections": 0},
          {"hits": 10, "misses": 2, "resurrections": 12}]


@pytest.fixture
def one_card(monkeypatch):
    """Pin both packages' multi-card probe (JAX's CPU mesh has 8 devices,
    a CPU-only host no card) to the same answer."""
    def pin(value):
        monkeypatch.setattr(jperf, "_multi_chip_host", lambda: value)
        monkeypatch.setattr(perf, "_multi_chip_host", lambda: value)
    pin(False)
    return pin


@pytest.mark.parametrize("multi", [False, True])
def test_candidate_hint_equals_the_reference(one_card, multi):
    one_card(multi)
    n = 0
    for fam in FAMILIES:
        for regime in REGIMES:
            for temp, pool in MEMORY:
                for pfx in PREFIX:
                    got = perf.candidate_hint(fam, regime, temp_bytes=temp,
                                              pool_bytes=pool,
                                              prefix_stats=pfx)
                    want = jperf.candidate_hint(fam, regime, temp_bytes=temp,
                                                pool_bytes=pool,
                                                prefix_stats=pfx)
                    assert got == want, (fam, regime, temp, pool, pfx)
                    n += 1
    assert n == len(FAMILIES) * 3 * 3 * 3


@pytest.mark.parametrize("pred", [
    "is_quantized_family", "is_lora_family", "is_encode_family",
    "is_flash_family", "is_mp_family", "mp_degree",
    "is_cached_prefill_family", "is_chunked_prefill_family"])
def test_family_predicates_equal_the_reference(pred):
    for fam in FAMILIES:
        assert getattr(perf, pred)(fam) == getattr(jperf, pred)(fam), fam


def test_classify_equals_the_reference():
    grid = [0, 1.0, 1e9, 3e12, 1e15]
    for f in grid:
        for b in grid:
            for peak, hbm in ((989e12, 3.35e12), (1e12, 1e12), (None, 1e9)):
                args = (f, b, peak, hbm)
                if peak is None:
                    # no peak: the reference falls back to its device table
                    # (the TPU's), the port to its card's — both None here
                    args = (f, b, 0, hbm)
                assert perf.classify(*args) == jperf.classify(*args), args


def _fill(mod, reg):
    t = mod.ProgramTable(registry=reg)
    t.record("decode", 0.25, calls=10)
    t.record("prefill/64", 0.5, calls=2)
    t.record("verify/k4", 0.125, calls=4)
    t.record("train_step/t3.v0", 0.75, calls=3)
    t.record("train_step/t3.v1", 0.01)
    t.set_cost("decode", 2e9, 1e9)
    t.set_cost("prefill/64", 4e12, 2e9,
               memory={"argument_bytes": 1.0, "output_bytes": 2.0,
                       "temp_bytes": 7e6, "peak_bytes": 1e7})
    t.register_cost_thunk("verify/k4", lambda: (3e9, 1e9))
    t.register_cost_thunk("train_step/t3.v0",
                          lambda: (_ for _ in ()).throw(ValueError("x")))
    return t


@pytest.mark.parametrize("env", [
    {"PADDLE_PEAK_FLOPS": "989e12", "PADDLE_HBM_GBS": "3350"},
    {"PADDLE_PEAK_FLOPS": "1e12", "PADDLE_HBM_GBS": "10"},
    {"PADDLE_PEAK_FLOPS": "not-a-number", "PADDLE_HBM_GBS": "10"}])
def test_program_table_snapshot_equals_the_reference(monkeypatch, one_card,
                                                     env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the KV pool total the report's hints read comes from each package's
    # process-wide memory ledger, which engines of other test files in
    # this worker may still be registered in: pin both to one value
    for mem in (memory, jmemory):
        monkeypatch.setattr(mem.ledger(), "kv_pool_bytes", lambda: 1e5)
    t = _fill(perf, metrics.MetricsRegistry())
    j = _fill(jperf, jmetrics.MetricsRegistry())
    for resolve in (False, True):
        got, want = t.snapshot(resolve=resolve), j.snapshot(resolve=resolve)
        for r in got + want:     # exception reprs differ only in module
            if "cost" in r and r["cost"].startswith("error"):
                r["cost"] = "error"
        assert got == want
        assert [r["program"] for r in got] == [
            "train_step/t3.v0", "prefill/64", "decode", "verify/k4",
            "train_step/t3.v1"]
    assert t.report(resolve=False) == j.report(resolve=False)
    assert t.statusz() == j.statusz()
    t.drop_prefix("train_step/t3")
    j.drop_prefix("train_step/t3")
    assert [r["program"] for r in t.snapshot()] == \
        [r["program"] for r in j.snapshot()] == \
        ["prefill/64", "decode", "verify/k4"]


def test_hbm_ceiling_overrides(monkeypatch):
    monkeypatch.delenv("PADDLE_HBM_GBS", raising=False)
    monkeypatch.delenv("PADDLE_PEAK_FLOPS", raising=False)
    for mod in (perf, jperf):
        mod.set_hbm_ceiling(100)
    try:
        assert perf.hbm_ceiling() == jperf.hbm_ceiling() == 100e9
    finally:
        for mod in (perf, jperf):
            mod.set_hbm_ceiling(None)
    monkeypatch.setenv("PADDLE_HBM_GBS", "2000")
    assert perf.hbm_ceiling() == jperf.hbm_ceiling() == 2000e9


def test_peaks_are_none_on_the_cpu(monkeypatch):
    monkeypatch.delenv("PADDLE_HBM_GBS", raising=False)
    monkeypatch.delenv("PADDLE_PEAK_FLOPS", raising=False)
    assert not torch.cuda.is_available()
    assert perf.peak_flops() is None and perf.hbm_ceiling() is None
    st = perf.ProgramTable(registry=metrics.MetricsRegistry()).statusz()
    assert st["peak_tflops"] is None and st["hbm_gbs"] is None
    # the H100 SXM datasheet lines, keyed on the card's name
    assert perf.PEAK_BF16_FLOPS == {"h100 80gb hbm3": 989e12}
    assert perf.HBM_GBS == {"h100 80gb hbm3": 3.35e12}


def test_trainstep_families_and_their_drop():
    from paddle_tpu_torch import jit, optimizer

    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh(),
                            torch.nn.Linear(8, 1))
    opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    step = jit.TrainStep(m, opt, loss_fn=lambda out, y: ((out - y) ** 2)
                         .mean())
    x, y = torch.randn(4, 8), torch.randn(4, 1)
    for _ in range(3):
        step(x, y)
    step(x[:2], y[:2])                       # a second signature
    step(x, y)
    tag = step._perf_tag
    assert re.fullmatch(r"train_step/t\d+", tag)
    rows = {r["program"]: r for r in perf.snapshot(resolve=True)
            if r["program"].startswith(tag + ".")}
    assert set(rows) == {tag + ".v0", tag + ".v1"}
    # steady intervals only, as the reference records them: v0's 2nd ->
    # 3rd call; the 4th call minted v1 and restarted the clock, so the 5th
    # records nothing
    assert rows[tag + ".v0"]["calls"] == 1
    assert rows[tag + ".v1"]["calls"] == 0
    # one forward + backward of Linear(8, 8), Linear(8, 1) at B=4 / 2:
    # the forward, both weight gradients, and the input gradient of the
    # second layer only (x needs none)
    for v, b in (("v0", 4), ("v1", 2)):
        assert rows[f"{tag}.{v}"]["flops_per_call"] == \
            2 * 2 * b * (64 + 8) + 2 * b * 8
    del step
    gc.collect()
    assert not [r for r in perf.snapshot()
                if r["program"].startswith(tag + ".")]


def test_trainstep_cost_leaves_the_training_state_alone():
    """Resolving a QAT TrainStep's cost (one forward + backward counted)
    changes nothing the training sees: the quantizers' scales, the
    parameters, the gradients (``None``) and the global RNG (the model
    has a dropout) are as they were, exactly."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch import quantization as tquant
    from paddle_tpu_torch.nn import Linear

    torch.manual_seed(0)
    m = tquant.QAT(tquant.QuantConfig()).quantize(torch.nn.Sequential(
        Linear(8, 8), torch.nn.Dropout(0.5), Linear(8, 1)))
    opt = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    step = jit.TrainStep(m, opt, loss_fn=lambda out, y: ((out - y) ** 2)
                         .mean())
    x, y = torch.randn(4, 8), torch.randn(4, 1)
    step(x, y)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    assert any(k.endswith("scale") for k in state)
    rng = torch.get_rng_state()
    rows = {r["program"]: r for r in perf.snapshot(resolve=True)}
    assert rows[step._perf_tag + ".v0"]["flops_per_call"] > 0
    after = m.state_dict()
    assert all(torch.equal(after[k], v) for k, v in state.items())
    assert all(p.grad is None for p in m.parameters())
    assert torch.equal(torch.get_rng_state(), rng)


def test_count_cost_sees_flops_and_bytes():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)
    flops, nbytes = perf.count_cost(lambda: a @ b)
    assert flops == 2 * 16 * 32 * 8
    assert nbytes == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    perf.kernel_cost(1e9, 1e9)           # outside a count: no effect
    flops, nbytes = perf.count_cost(lambda: perf.kernel_cost(10.0, 20.0))
    assert (flops, nbytes) == (10.0, 20.0)
    assert not perf.counting_kernels()


def test_metric_quantile_reads_a_histogram():
    h = metrics.histogram("t.perf_quantile_probe", "probe")
    for v in np.linspace(0.01, 0.1, 10):
        h.observe(float(v), replica="q")
    # the reservoir's median of 0.01 .. 0.10 is one of its two middle
    # samples
    q = perf.metric_quantile("t.perf_quantile_probe", 0.5, replica="q")
    assert min(abs(q - 0.05), abs(q - 0.06)) < 1e-12
    assert perf.metric_quantile("t.perf_quantile_probe", 0.5,
                                replica="none") is None
