"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,slice,profile

Phases, each printing one JSON line:

1. ``build``   — compile every CUDA kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), with ptxas's register / shared
   memory / spill report, the card's name and its power limit.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the served model's shapes, in bf16 (atol 2e-2) and f32
   (atol 2e-4, TF32 off); the paged decode kernel also with NaN in every
   dead page; then time kernel, plain version and (K1) PyTorch's own
   ``scaled_dot_product_attention`` with CUDA events.
3. ``slice``   — serve GPT-base (vocab 50304, 12 x 768, random weights from
   ``torch.manual_seed(0)``) through ``ServingEngine``: 12 requests, prompts
   of 17-900 tokens, 32 new tokens each.  float32 on the card must give
   the CPU engine's greedy ids; bf16 on the card is timed.  The kernels'
   launch counters are zeroed before each run and checked after it.
4. ``profile`` (only when asked for) — the bf16 slice again under
   ``torch.profiler``: device time by kernel and the device's idle share.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name / power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
raises, so the exit code is non-zero.  Without a card the script exits 2
and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 / fp16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
ATOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}

# the served model (GPT-base, the JAX package's GPTForCausalLM defaults)
LAYERS, HEADS, HEAD_DIM, PAGE, MAXLEN, SLOTS = 12, 12, 64, 16, 1024, 8
NP = MAXLEN // PAGE


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of one ``fn()`` on the card, by CUDA events over ``iters``
    launches after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------- build
def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build("flash_attention_fwd", "paged_flash_decode")
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in _build.BUILD_LOGS[n].splitlines()
                 if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                       or "Compiling entry" in ln)]
             for n in paths}
    emit({"phase": "build", "seconds": secs,
          "libraries": {n: str(p) for n, p in paths.items()},
          "ptxas": ptxas, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


# ----------------------------------------------------------------- kernels
def _k1_case(gen, dtype, sq, sk, d, causal, heads=HEADS):
    from paddle_tpu_torch.ops import flash_attention as fa

    def t(s):
        return torch.randn(1, s, heads, d, generator=gen, device="cuda").to(dtype)

    q, k, v = t(sq), t(sk), t(sk)
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    err = (o.float() - ref.float()).abs().max().item()
    lse_ref = fa.flash_attention_lse_ref(q, k, causal=causal)
    lse_err = (lse - lse_ref).abs().max().item()
    ok = err <= ATOL[dtype] and lse_err <= 1e-3 and bool(torch.isfinite(o).all())
    return {"sq": sq, "sk": sk, "d": d, "causal": causal,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "lse_max_abs_err": lse_err, "ok": ok}


def _k3_inputs(gen, dtype, lens, heads, kv_heads, d=HEAD_DIM):
    B = len(lens)
    pages = B * NP
    perm = torch.randperm(pages, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(B, NP).contiguous()
    kp = torch.randn(pages, PAGE, kv_heads, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(pages, PAGE, kv_heads, d, generator=gen, device="cuda").to(dtype)
    q = torch.randn(B, heads, d, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, ln


def _k3_case(gen, dtype, lens, heads, kv_heads):
    from paddle_tpu_torch.ops import paged_attention as pa

    q, kp, vp, table, ln = _k3_inputs(gen, dtype, lens, heads, kv_heads)
    o = pa.paged_attention(q, kp, vp, table, ln)
    ref = pa.paged_attention_ref(q, kp, vp, table, ln)
    err = (o.float() - ref.float()).abs().max().item()
    # poison: NaN in every page past each row's length must never be read
    kpn, vpn = kp.clone(), vp.clone()
    for b, n in enumerate(lens):
        dead = table[b, -(-n // PAGE):].long()
        kpn[dead] = float("nan")
        vpn[dead] = float("nan")
    o_p = pa.paged_attention(q, kpn, vpn, table, ln)
    torch.cuda.synchronize()
    poison_ok = bool(torch.isfinite(o_p).all()) and torch.equal(o_p, o)
    zero_ok = all(bool((o[b] == 0).all()) for b, n in enumerate(lens) if n == 0)
    ok = err <= ATOL[dtype] and poison_ok and zero_ok
    return {"B": len(lens), "heads": heads, "kv_heads": kv_heads,
            "lens": lens, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "dead_pages_poisoned_ok": poison_ok,
            "empty_rows_zero": zero_ok, "ok": ok}


def slice_requests():
    """The slice's 12 requests: prompt lengths spread over 17-900 tokens,
    random ids from a seed, requests 3 and 8 at temperature 0.8."""
    rs = np.random.RandomState(0)
    lens = np.linspace(17, 900, 12).astype(int)
    rs.shuffle(lens)
    prompts = [rs.randint(1, 50304, size=n).tolist() for n in lens]
    temps = [0.8 if i in (3, 8) else 0.0 for i in range(12)]
    return prompts, temps


def phase_kernels():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_shapes = [(s, s, 64, True) for s in (17, 256, 300, 512, 1024)]
    k1_shapes += [(64, 320, 64, True), (300, 300, 64, False),
                  (256, 256, 128, True)]
    k1 = [_k1_case(gen, dt, *sh) for dt in (torch.bfloat16, torch.float32)
          for sh in k1_shapes]
    lens = [0, 1, 15, 16, 17, 500, 1024, 777]
    k3 = [_k3_case(gen, dt, lens, HEADS, kvh)
          for dt in (torch.bfloat16, torch.float32) for kvh in (HEADS, 4)]

    # times at the served shapes, bf16: K1 at the longest prefill bucket,
    # K3 at a decode step of the slice's first 8 requests
    S = 1024
    q, k, v = (torch.randn(1, S, HEADS, HEAD_DIM, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o = fa.flash_attention_fn(q, k, v, causal=True)
    k1_err = (o.float() - fa.flash_attention_ref(q, k, v, causal=True).float()
              ).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2
    k1_bound, k1_by = bound(4 * HEADS * HEAD_DIM * pairs, 4 * q.numel() * 2)
    k1_time = {
        "kernel_ms": cuda_ms(lambda: fa.flash_attention_fn(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(qt, kt, vt,
                                                            is_causal=True)),
        "bound_ms": k1_bound, "bound_by": k1_by, "max_abs_err": k1_err}

    prompts, _ = slice_requests()
    dlens = [len(p) + 16 for p in prompts[:SLOTS]]
    qd, kp, vp, table, ln = _k3_inputs(gen, torch.bfloat16, dlens, HEADS, HEADS)
    od = pa.paged_attention(qd, kp, vp, table, ln)
    k3_err = (od.float() - pa.paged_attention_ref(qd, kp, vp, table, ln)
              .float()).abs().max().item()
    valid_pages = sum(-(-n // PAGE) for n in dlens)
    k3_bytes = (2 * valid_pages * PAGE * HEADS * HEAD_DIM * 2
                + 2 * qd.numel() * 2 + table.numel() * 4 + ln.numel() * 4)
    k3_bound, k3_by = bound(4 * sum(dlens) * HEADS * HEAD_DIM, k3_bytes)
    k3_time = {
        "kernel_ms": cuda_ms(lambda: pa.paged_attention(qd, kp, vp, table, ln)),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_ref(qd, kp, vp, table, ln)),
        "library_ms": None, "bound_ms": k3_bound, "bound_by": k3_by,
        "max_abs_err": k3_err, "lens": dlens}
    ok = all(c["ok"] for c in k1 + k3)
    emit({"phase": "kernels", "ok": ok, "k1_cases": k1, "k3_cases": k3,
          "k1_timed": {"shape": [1, S, HEADS, HEAD_DIM], "causal": True,
                       "dtype": "bfloat16", **k1_time},
          "k3_timed": {"B": SLOTS, "heads": HEADS, "page_size": PAGE,
                       "table_width": NP, "dtype": "bfloat16", **k3_time},
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("kernels phase: a kernel disagrees with its plain "
                         "version (see the k1_cases / k3_cases above)")
    return {"k1": k1_time, "k3": k3_time}


# ------------------------------------------------------------------- slice
def _serve(model, device, prompts, temps):
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, device=device, num_slots=SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eng:
        hs = [eng.submit(p, max_new_tokens=32, temperature=t)
              for p, t in zip(prompts, temps)]
        outs = [h.result(timeout=900) for h in hs]
        stats = eng.stats()
    if device != "cpu":
        torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, stats


def _counted_run(model, prompts, temps):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    fa.LAUNCHES = 0
    pa.LAUNCHES = 0
    outs, wall, stats = _serve(model, "cuda", prompts, temps)
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "paged_flash_decode": pa.LAUNCHES}
    want = {"flash_attention_fwd": LAYERS * stats["prefills"],
            "paged_flash_decode": LAYERS * stats["iteration"]}
    if counts != want or not all(counts.values()):
        raise SystemExit(f"launch counts {counts} != expected {want}: the "
                         f"main path did not run through the kernels")
    return outs, wall, stats, counts


def phase_slice():
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, temps = slice_requests()
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    ref, cpu_wall, _ = _serve(cpu_model, "cpu", prompts, temps)

    model = copy.deepcopy(cpu_model).to("cuda")
    outs32, wall32, st32, counts32 = _counted_run(model, prompts, temps)
    mismatches = []
    for i in greedy:
        a, b = outs32[i], ref[i]
        if a != b:
            pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
            mismatches.append({"request": i, "first_position": pos,
                               "cuda": a[pos:pos + 4], "cpu": b[pos:pos + 4]})

    model = model.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    outs16, wall16, st16, counts16 = _counted_run(model, prompts, temps)
    complete = all(len(o) == 32 for o in outs16)
    tokens = sum(len(o) for o in outs16)
    ok = not mismatches and complete and all(len(o) == 32 for o in outs32)
    emit({"phase": "slice", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "max_new_tokens": 32, "greedy_requests": len(greedy),
          "f32_greedy_mismatches": mismatches, "cpu_reference_wall_s": cpu_wall,
          "f32": {"wall_s": wall32, "prefills": st32["prefills"],
                  "decode_steps": st32["iteration"], "launches": counts32},
          "bf16": {"wall_s": wall16, "tokens": tokens,
                   "tokens_per_s": tokens / wall16,
                   "prefills": st16["prefills"],
                   "decode_steps": st16["iteration"],
                   "launches": counts16, "all_complete": complete,
                   "peak_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated()},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("slice phase failed: greedy ids differ from the CPU "
                         "engine or a request did not complete")
    return counts16


def phase_profile():
    """Where the bf16 slice's time goes: the same 12 requests under
    ``torch.profiler``, device time by kernel name and the device's idle
    share of the wall (not part of the default run)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    prompts, temps = slice_requests()
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    _serve(model, "cuda", prompts, temps)                 # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, stats = _serve(model, "cuda", prompts, temps)
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1 - busy_us / 1e6 / wall,
          "decode_steps": stats["iteration"], "prefills": stats["prefills"],
          "top_device_kernels": [{"name": k[:90], "calls": c,
                                  "device_ms": t / 1e3}
                                 for t, c, k in rows[:15]],
          "nvidia_smi": smi_line()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,slice")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        sys.exit(2)
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    times = launches = None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        times = phase_kernels()
    if "slice" in phases:
        launches = phase_slice()
    if "profile" in phases:
        phase_profile()
    if times is not None:
        rows = []
        for key, name, src, tpu in (
                ("k1", "flash_attention_fwd",
                 "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                 "paddle_tpu/ops/flash_attention.py:112"),
                ("k3", "paged_flash_decode",
                 "paddle_tpu_torch/csrc/paged_flash_decode.cu",
                 "paddle_tpu/ops/paged_attention.py:371")):
            t = times[key]
            rows.append({"name": name, "route": "cuda", "source": src,
                         "replaces": tpu,
                         "launches": launches[name] if launches else 0,
                         "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"],
                         "library_ms": t["library_ms"]})
        emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
