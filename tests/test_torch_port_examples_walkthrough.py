"""PyTorch port, the walkthrough examples (``paddle_tpu_torch/examples/``:
numerics_debugging, serve_gpt_continuous, serve_gpt_speculative,
serve_gpt_prefix_cache, serve_gpt_quantized, observability_metrics,
observability_perf, serve_gpt_mp, observability_tracing), each run
through ``main(device="cpu")`` and held to the reference example's own
asserts.

Held against the JAX example (imported by path, ``examples/`` is not a
package) where that example runs in seconds on the CPU and its outputs
do not depend on weights the two packages draw differently:

- ``numerics_debugging``: the probed sites, the anomaly's kind and first
  offending layer, the supervisor's attempts and restart counts;
- ``serve_gpt_prefix_cache``: each arm's prefix-cache accounting (hits,
  misses, evictions, saved tokens) and the spill tier's counters, the JAX
  engines on replicas of their own;
- ``observability_tracing``: each request's spans, the decode iterations,
  the merged trace's events and the watchdog's flight record, against
  the reference script's printed results (run in a subprocess: it runs at
  import, on engine replica "0").

``serve_gpt_mp`` is held to what its reference prints (byte-identity,
the bytes-per-page ratio, ``shards``, one decode mint): the two packages
draw random weights differently.

The others are held to the port's invariants: greedy byte-identity
across arms (speculative, prefix cache), int8 top-1 agreement and pool
bytes (quantized), completed requests, freed pages and the predictor's
shape (continuous), the exported traces and metrics files
(observability_metrics), the SLO summary and /statusz table
(observability_perf).  Their reference examples train 150 steps and
serve through engines on the default replica, or run at import."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.observability import faults, flight_recorder, numerics
from paddle_tpu_torch.observability import telemetry
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the examples train and serve tiny models, where
    a pool of threads only adds spin-waits, and under a parallel test run
    (one worker process per core) an oversubscribed pool slowed the
    speculative example's 150 training steps tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def isolated_numerics(tmp_path):
    """Both packages' numerics state and flight-recorder dirs put back."""
    from paddle_tpu.observability import flight_recorder as jflight
    from paddle_tpu.observability import numerics as jnum

    recs = [flight_recorder.get_flight_recorder(),
            jflight.get_flight_recorder()]
    saved = [r.dir for r in recs]
    yield
    for r, d in zip(recs, saved):
        r.dir = d
    numerics.reset()
    jnum.reset()
    faults.clear("numerics.nan_inject")


def test_numerics_debugging_matches_reference(isolated_numerics):
    from paddle_tpu_torch.examples import numerics_debugging as ex

    got = ex.main(device="cpu")
    assert got["anomaly_kind"] == "nonfinite"
    assert got["restarts"] == {"transient": 0, "fatal": 0, "numeric": 1}
    assert len(got["attempts"]) == 2 and got["attempts"][1] >= 1
    assert np.isfinite(got["final_loss"])

    j = vars(_jax_example("numerics_debugging"))   # runs at import
    assert got["sites"] == list(j["table"]["sites"])
    assert (got["anomaly_kind"], got["anomaly_site"]) == (j["ep"].kind,
                                                          j["ep"].site)
    assert got["first_bad_tensor"] == j["worst"]["tensor"]
    assert got["attempts"] == j["attempts"]
    assert got["restarts"] == j["sup"].restarts


def test_serve_gpt_continuous():
    from paddle_tpu_torch.examples import serve_gpt_continuous as ex

    got = ex.main(device="cpu")
    assert {n: c for n, (c, _) in got["results"].items()} == {
        "client0": 12, "client1": 48, "client2": 24, "client3": 96}
    assert len(got["streamed"]) == 8
    assert got["pages_free"] == got["num_pages"]     # cancel freed them
    assert got["stats"]["active_slots"] == 0
    assert got["stats"]["queue_depth"] == 0
    assert got["predictor_shape"] == (3, 24)
    out, ids = got["predictor_out"], got["predictor_in"]
    for b, n in enumerate((16, 9, 12)):
        assert out[b, :n].tolist() == ids[b, :n].tolist()


def test_serve_gpt_speculative():
    from paddle_tpu_torch.examples import serve_gpt_speculative as ex

    got = ex.main(device="cpu")
    assert got["base"] == got["spec"]                # the example's assert
    assert all(len(o) == 96 for o in got["base"])
    st = got["speculative"]
    assert 0 < st["accepted"] <= st["proposed"]
    assert got["acceptance_rate"] == pytest.approx(
        st["accepted"] / st["proposed"])
    # the overfit model continues the cycle of its prompt
    for p, o in zip(got["prompts"], got["base"]):
        assert o[:8] == [(int(p[-1]) + i) % 8 + 1 for i in range(8)]


def test_serve_gpt_prefix_cache_matches_reference_accounting():
    from paddle_tpu_torch.examples import serve_gpt_prefix_cache as ex

    got = ex.main(device="cpu")
    assert got["legacy"] == got["radix"] == got["spill"]
    pc = got["prefix_cache"]
    assert pc["radix"]["saved_tokens"] == got["saved_tokens"] > 0
    assert pc["radix_spill"]["spill"]["spills"] > 0
    assert pc["radix_spill"]["spill"]["resurrections"] > 0
    assert "kv.spilled" in {r["owner"] for r in got["memory_owners"]}

    jex = _jax_example("serve_gpt_prefix_cache")
    model = jex.build_model()
    prompts, flush = jex.build_prompts()
    assert (prompts, flush) == ex.build_prompts()
    keys = ("hits", "misses", "evictions", "saved_tokens")
    arms = (("legacy", None, {"prefix_sharing": True}),
            ("radix", None, {"prefix_cache": "radix"}),
            ("radix_spill", flush, {"prefix_cache": "radix",
                                    "kv_spill": True, "num_pages": 8}))
    for arm, fl, kw in arms:
        _, st = jex.run_engine(model, prompts, flush=fl,
                               replica=f"port-walkthrough-{arm}", **kw)
        want = st["prefix_cache"]
        assert {k: pc[arm][k] for k in keys} == {k: want[k] for k in keys}, arm
        if arm == "radix_spill":
            for k in ("spills", "resurrections", "drops", "entries"):
                assert pc[arm]["spill"][k] == want["spill"][k], k


def test_serve_gpt_quantized():
    from paddle_tpu_torch.examples import serve_gpt_quantized as ex

    got = ex.main(device="cpu")
    assert got["calibration"]["top1_agreement"] >= 0.8
    assert got["agreement_kv"] >= 0.8 and got["agreement_full"] >= 0.8
    assert all(len(o) == ex.MAX_NEW for o in got["ref"])
    bpt_ref, bpt_q = got["kv_bytes_per_token"]
    assert bpt_ref == 4096 and bpt_q == 1088         # f32 pools vs int8 + scales
    assert got["slots"][1] > got["slots"][0]
    assert got["untracked_frac"] is None             # no allocator on the CPU


def test_observability_metrics(tmp_path, monkeypatch):
    from paddle_tpu_torch.examples import observability_metrics as ex

    monkeypatch.setenv("PADDLE_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("PADDLE_PROFILER_DIR", str(tmp_path / "trace"))
    got = ex.main(device="cpu")
    assert got["profile"]["events"] > 0
    assert got["profile"]["path"].startswith(str(tmp_path / "trace"))
    assert got["profile"]["cost"]["flops"] > 0
    assert got["metrics_dir"] == str(tmp_path / "metrics")
    for name in ("metrics.jsonl", "metrics.prom", "train_metrics.jsonl"):
        assert (tmp_path / "metrics" / name).is_file(), name
    with open(tmp_path / "metrics" / "train_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert rows[0]["train_step.compiles"] == 1 and rows[1]["steps"] == 8


def test_observability_perf():
    from paddle_tpu_torch.examples import observability_perf as ex

    before = telemetry.get_server()
    got = ex.main(device="cpu")
    assert [len(o) for o in got["outs"]] == [12, 8, 10]
    assert got["slo"]["evaluated"] == 3
    assert got["slo"]["lifetime_attainment"] == 1.0
    programs = {r["program"] for r in got["statusz_programs"]}
    assert "decode" in programs
    assert "Per-program roofline attribution" in got["report"]
    assert "train_step/" in got["report"]
    assert telemetry.get_server() is before         # stopped what it started


def test_serve_gpt_mp_matches_the_reference_claims():
    """What the reference example prints on its two forced host devices:
    greedy ids byte-identical to the unsharded engine, half the bytes per
    page (twice the pages at one budget), ``shards=2``, one decode mint,
    and a pool of one mp = 2 replica giving the same ids."""
    from paddle_tpu_torch.examples import serve_gpt_mp as ex

    got = ex.main(device="cpu")
    assert got["out"] == got["ref"] and got["mp"] == 2
    assert len({tuple(o) for o in got["ref"]}) > 1
    bpp1, bpp2 = got["bytes_per_page"]
    assert bpp1 == 2 * bpp2
    # a budget of 64 unsharded pages: 4 sequences of 16 pages unsharded
    assert got["shards"] == 2 and got["resident"] == 2 * (64 // 16)
    assert got["step_traces"] == 1
    assert got["pool"] == (1, 2) and got["pool_out"] == got["ref"][0]


def _reference_tracing_output(tmp_path):
    """The reference example's printed results (run as a script: it runs
    at import and forces its own host devices)."""
    import os
    import re
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "observability_tracing.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout

    def one(pattern):
        return re.search(pattern, out).group(1)

    return {
        "spans": {int(m.group(1)): eval(m.group(2)) for m in re.finditer(
            r"request (\d+): trace \S+ (\[.*\])", out)},
        "decode_steps": int(one(r"(\d+) decode iterations")),
        "merged_events": int(one(r"merged timeline events: (\d+)")),
        "op": one(r"watchdog fired: op=(\w+)"),
        "open_spans": eval(one(r"open spans at dump: (\[.*\])"))}


def test_observability_tracing_matches_reference(tmp_path):
    """The merged trace's events, each request's spans and the decode
    iterations equal the reference example's; the watchdog fires on the
    hung ``all_reduce`` (a world of one here: no rank is missing; the
    reference's single-controller world has 8) and the flight record
    holds the collective's open span, as there."""
    from paddle_tpu_torch.examples import observability_tracing as ex

    rec = flight_recorder.get_flight_recorder()
    saved, before = rec.dir, telemetry.get_server()
    try:
        got = ex.main(device="cpu", out_dir=str(tmp_path / "port"))
    finally:
        rec.dir = saved
    want = _reference_tracing_output(tmp_path)
    assert got["spans"] == want["spans"]
    assert got["decode_steps"] == want["decode_steps"]
    assert got["merged_events"] == want["merged_events"]
    assert got["watchdog"]["op"] == want["op"] == "all_reduce"
    assert got["watchdog"]["ranks_missing"] == []
    assert got["open_spans"] == want["open_spans"] \
        == ["collective.all_reduce"]
    assert got["routes"] == {"/healthz": 200, "/statusz": 200}
    assert got["all_reduce"] == [[1.0] * 4] * 8       # a world of one
    assert telemetry.get_server() is before
    assert not torch.distributed.is_initialized()
