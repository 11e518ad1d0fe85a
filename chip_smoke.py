"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # build,kernels,slice,train,quant,custom_op,qat,generate,spec,prefix,resilience,observe,programs,llama,numerics,multitenant,cluster,finetune
    python3 chip_smoke.py --phases build,cluster,finetune
    python3 chip_smoke.py --phases build,numerics,multitenant
    python3 chip_smoke.py --phases build,programs
    python3 chip_smoke.py --phases build,kernels,llama
    python3 chip_smoke.py --phases build,kernels,observe
    python3 chip_smoke.py --phases build,kernels,prefix,resilience
    python3 chip_smoke.py --phases build,kernels,slice,train,quant,custom_op,qat,profile

Phases, each printing one JSON line and then its seconds:

1. ``build``   — compile every CUDA kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), with ptxas's register / shared
   memory / spill report, the card's name and its power limit.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card (TF32 off; max abs error within 2e-2 / 5e-3 / 2e-4 for bf16 / f16
   / f32, lse within 1e-3; the backward's max error over max |ref| within
   2e-2 / 5e-3 / 1e-4), the K1, K2 and paged-decode cases also bit-equal
   on a second launch: K1
   in bf16, f16 and f32 (its three bodies: 16-bit tensor cores, f32 on
   the tensor cores by 3xTF32, and the SIMT body above head_dim 128) over
   lengths 17-1024, causal and full, sq < sk, head_dim 17 / 32 / 40 / 64
   / 96 / 128 / 192 / 256, a misaligned layout (scalar staging), the
   model's strided qkv split and the training shape; the flash backward
   K2a / K2b over the same reach (head_dim to 256), with and without a
   g_lse term, and gradients through K1 + K2 against torch autograd
   through the plain forward; the split-K paged decode K3 (and K4 over int8 pools)
   at the slot-boundary lengths, one 1024-token row alone and a 256-slot
   table, also with NaN in every dead page (K3) or dead page's scale
   rows (K4), and the full-sweep twins K5a / K5b bit for bit against K3 /
   K4; the fused bias + GELU K6 in f32 / f16 / bf16 (bf16 x with a float32
   bias too) at the example's shape, GPT-base's MLP activation, an odd
   width and a non-contiguous x.  Then time kernel, plain version and
   PyTorch's own call with CUDA events: K1 at the longest prefill (B=1)
   and at the training shape (B=8) beside
   ``F.scaled_dot_product_attention``, K1's f32 body at the longest f32
   prefill (B=1) and at Llama-3-8B's prefill (B=8, S=512, 32 heads of
   128) beside SDPA in f32 (bound: 3 x the operations at the TF32 rate,
   the f32 rate's figure beside it), K3, K4 and K5a / K5b at a decode
   step (K1, K3-K6 and the library calls by CUDA-graph replay, with the
   eager time beside K1, K3, K4 and K6: eagerly a launch can take longer
   on the host than the kernel on the card), K2 at the training shape
   (bf16, and the f32 body) and at head_dim 256 (bf16 and f32), K6 at
   ``[8192, 3072]`` beside ``F.gelu(x + b)``; K3 / K4 through the chunk attend at the speculative
   verify shape (8 slots x 5 positions) and K3 at one 128-token prefill
   chunk, against the chunk attend's plain version.
3. ``slice``   — serve GPT-base (vocab 50304, 12 x 768, random weights from
   ``torch.manual_seed(0)``) through ``ServingEngine``: 12 requests, prompts
   of 17-900 tokens, 32 new tokens each.  float32 on the card must give
   the CPU engine's greedy ids; bf16 on the card is timed.  The kernels'
   launch counters are zeroed before each run and checked after it.
4. ``train``   — train GPT-base with ``jit.TrainStep`` (AdamW, global-norm
   clip 1.0): 3 steps in f32 on the card must give the CPU's losses; then
   12 bf16 O2 steps at B=8, S=1024 are timed, with K1 = K2a = K2b =
   12 launches per step checked, and every flash launch on its dtype's
   body (f32: 3xTF32 forward, SIMT backward; bf16: the 16-bit tensor
   cores); then GPT-tiny with attention dropout 0.1 trains 8 steps on the
   card (the plain attention with dropout, no flash launch; finite,
   falling losses) and its eval forward equals dropout 0's bit for bit.
5. ``quant``   — the slice's requests through
   ``ServingEngine(kv_dtype="int8")``: float32 on the card against the
   CPU int8 engine (the first 6 requests; greedy top-1 agreement >= 0.8,
   first tokens equal), then bf16 timed beside the native bf16 slice and
   beside ``weight_dtype="int8"``, with the pool bytes of both layouts and
   the launch counts (K4 = 12 x decode steps, K1 = 12 x prefills, K3 = 0).
6. ``custom_op`` — the custom-op + QAT example
   (``paddle_tpu_torch.examples.custom_op_and_quant``) on the card and on
   the CPU from the same seeded weights, float32: losses and scales rtol
   1e-4, and K6 launched exactly once per step (30).
7. ``qat``     — GPT-base wrapped by ``QAT(QuantConfig())``: 3 f32
   ``TrainStep``s on the card against the CPU (losses rtol 1e-3, the same
   scale keys; a CPU control run shows the fake-quant rounding's own
   spread); ``convert_to_int8`` into 48 ``Int8Linear``s with static
   activation scales, served with ``kv_dtype="int8"`` in f32 against the
   CPU (first 6 requests, top-1 agreement >= 0.8, K1 / K4 counts); the
   converted model in bf16 timed on the 12 requests in turns with the
   quant phase's dynamic-scale ``weight_dtype="int8"`` run (static,
   dynamic, dynamic, static); 12 bf16 O2 QAT training steps timed beside
   the ``train`` phase's plain step.
8. ``generate`` — GPT-base through ``model.generate()``: float32 greedy
   ids on the card equal the CPU's for the dense and paged caches (B=4,
   prompts of 64 and 256 tokens, 32 new tokens; dense equal to paged),
   ``use_cache=False`` and beam search, each call's launches checked (the
   paged cache: K1 per layer once, K3 through ``paged_decode_attend`` per
   layer per step; the dense cache: no kernel, its masked attention is the
   plain one, as in the TPU package); bf16 at B=8, prompts of 512, 128
   new tokens, dense and paged timed in turns.
9. ``spec``    — GPT-base through ``ServingEngine(speculative_k=4)`` on six
   motif-repeating prompts and ``ServingEngine(prefill_chunk_tokens=128)``
   on six prompts of 17-900 tokens: float32 ids equal the plain card
   engine's and the CPU engine's with native pools, and meet the int8
   rule against the CPU int8 engine with ``kv_dtype="int8"``, K3 / K4
   launched through ``paged_chunk_attend(_quant)``; bf16 tokens/s and
   acceptance in turns with the plain engine; bf16 TTFT of seven short
   requests behind a 900-token prompt, with and without chunking.
10. ``prefix``  — GPT-base through the hierarchical KV cache on the
   reference's Zipfian shared-prefix traffic (24 prompts of 512 tokens,
   4 shared 480-token prefixes at Zipf 1.2, 20% one-off prompts, seed 0;
   ``num_slots=4``, page 32, ``num_pages=72``, 16 new tokens, waves of
   4): float32 ids equal across the ``lru``, ``radix`` and
   ``radix_spill`` arms and equal the CPU ``lru`` engine's on the first 8
   requests, whose ``saved_tokens`` equal the CPU radix engine's; the
   spill tier spills and resurrects; K3 through ``paged_chunk_attend``
   once per layer per cached prefill; ``kv_dtype="int8"`` radix_spill
   under the int8 rule with K4 counted; bf16 TTFT p50 and tokens/s of the
   three arms in turns; K3 / K4 at the cached-tail shape (32 rows behind
   480 cached tokens).
11. ``resilience`` — GPT-base float32 on the card: a transient step
   crash restarts the engine (ids equal an uninterrupted run, the pools
   rebuilt on the card), a fatal one aborts, a NaN decode lane fails only
   its request under ``numeric_guard``, a realtime request preempts a
   batch one (ids unchanged), a 2 s wedge sheds ``deadline_unmeetable``
   and ``queue_full`` and fires the watchdog once; the host syncs of one
   decode step with the guard off and on.
12. ``observe`` — GPT-base through the engine's observability layer: the
   slice's requests in float32 with the sinks on (span tracer, flight
   recorder, telemetry on an ephemeral port, the numerics stream) give
   the ids of the sinks-off engine and the CPU engine, with /metrics,
   /healthz and /statusz scraped over localhost while they run and K1 /
   K3 (K4 with int8 pools) counted; ``PADDLE_HBM_BUDGET_BYTES`` at half
   the pages sheds requests without changing the admitted ids; the
   memory ledger against the pools and the CUDA allocator, a forced OOM
   recognized and dumped; 1 host sync per decode step with the sinks on;
   the sinks' cost in bf16 tokens/s, TTFT and ITL, in 3 rounds of turns.
   (Since the program layer, a decode step syncs once: its tokens'
   transfer; the eager step synced 4 times.)
13. ``programs`` — GPT-base through the program layer: every engine
   program (``serve_step``, ``serve_prefill/<bucket>``,
   ``serve_prefill_chunk/<c>``, ``verify/k4``) a CUDA graph captured at
   its first dispatch and replayed after.  A cold f32 engine on the
   slice's 12 requests (greedy ids equal the CPU engine's) captures its
   manifest; an engine over a fresh copy of the weights replays it with
   ``warmup()`` and serves the requests again: the same ids, 0 new mints,
   ``compile_s == 0``, every key a replayed graph, K1 / K3 counted per
   layer per prefill / step; the same with int8 pools (K4), with
   ``speculative_k=4`` (verify) and with ``prefill_chunk_tokens=128``
   (chunks); paged ``generate()`` replaying its captured step; the perf
   table's rows (share of peak <= 1.05); one sync per decode step; a
   warmed bf16 engine's wall, TTFT, inter-token p50 / p99, and under the
   port's ``Profiler`` the device trace's K1 and K3 and the card's idle
   share, beside PERF.md's eager figures (different calls, no A/B).
14. ``llama``  — Llama-3-8B (meta-llama/Meta-Llama-3-8B's config: vocab
   128256, 4096 wide, SwiGLU 14336, 32 heads over 8 kv heads of 128,
   rope_theta 500000; random weights from a card generator seeded with 0)
   through ``LlamaForCausalLM``: float32 at depth 2 (the depth cut, named
   in the output) against a CPU copy, greedy ids equal for the dense and
   paged caches (B=2, prompts of 64, 16 new tokens; dense equal to paged),
   ``use_cache=False`` and beam search (4 beams, 8 tokens), each
   call's launches checked; bf16 weights at the full depth 32, B=8,
   prompts of 512, 128 new tokens, paged and dense in turns (paged, dense,
   dense, paged) with K1 = 32 per paged call and K3 = 32 x 127, f32 logits
   (a bf16 Llama computes in f32, as in the TPU package) and the first new
   token of each row equal between the caches, each cache once under
   ``torch.profiler`` (16 new tokens); 3 f32 TrainSteps of a narrow
   head_dim-128 GQA config against the CPU (rtol 1e-4), 8 timed bf16 O2
   steps at the full width, depth 2, B=4, S=1024 (K1 = K2a = K2b = 2 per
   step; MFU against 989 TFLOP/s), two more under the profiler; then K1
   (f32 and bf16), K2a / K2b and K3's f32-query entry over bf16 pools at
   those shapes beside their plain versions and PyTorch's calls.
15. ``numerics`` — GPT-base numerics capture and TrainStep observability:
   3 f32 TrainSteps (B=2, S=256) with probes off and on from one init,
   losses byte-identical and K1 = K2a = K2b = 12 per step either way; the
   probed step's rows (one per module call, the loss, one per gradient)
   against the CPU's (same sites; absmax / rms rtol 1e-3, fractions 1e-3);
   a ``numerics.nan_inject`` trip giving exactly one flight dump naming
   the first layer; ``collect_operator_stats`` over an eval forward (114
   module calls); bf16 O1 with a ``GradScaler``: the ``train_step.*``
   series and, with one poisoned eager cycle, ``amp.*``; a step's host
   syncs with probes off (0) and on; the probed bf16 O2 step at B=8,
   S=1024 against the plain one in turns (plain, probed, probed, plain).
16. ``multitenant`` — GPT-base through ``MultiTenantEngine`` (8 slots,
   page 16, length 1024) with a ``LoRAStore`` of ranks (8, 16) over
   ``qkv`` / ``out_proj`` and 4 seeded adapters: one mixed batch (3
   adapters over both buckets, a base row, a JSON-schema row, an embed
   and a score request) in f32 on the card against the CPU (greedy ids
   equal, embeddings and logprobs within 1e-3), each generate row against
   a dedicated engine (byte-equal, f32 and bf16; the base row against a
   plain ``ServingEngine``), the schema row parsing and equal with
   ``speculative_k=4``, embed / score allocating no page, a hot swap
   during serving (0 mints, 0 recaptures, pools written in place), int8
   pools (K4, no K3), exact K1 / K3 / K4 counts, one host sync per decode
   step with a LoRA and a constrained row live, the grammar's host cost at
   the full vocabulary, and bf16 tokens/s, TTFT and ITL of a plain and a
   multi-tenant engine in turns with the card's idle share.
17. ``cluster`` — GPT-base through ``ServingCluster``: the example's
   traffic (3 templates of 256 tokens x 3 requests, 32 new) on two
   replicas of 4 slots in f32 against the same cluster on the CPU (ids
   and replica histories equal, each template on its affine replica, K1
   / K3 counted), one host sync per decode step on each replica, a
   replica stopped mid-decode (f32 ids equal the uninterrupted run's);
   in bf16 the cluster against one 8-slot engine in turns over 384
   requests of the same templates (tokens/s, TTFT p50, each replica's
   request count) and the failover's token agreement (reported); an
   ``AutoScaler`` cluster warmed from a manifest: a
   ``cluster.replica_preempt@<r>`` trip mid-traffic reaped and replaced
   (0 mints, the CPU's ids), then a burst of 24 requests scaling to 3
   replicas and draining back to 2; an int8-pool cluster (K4, no K3); a
   ``lora_store=`` cluster keeping adapter affinity with a dedicated
   engine's ids; the card's allocated memory over three add_replica /
   reap cycles: the first sets the baseline, no later one grows it.
18. ``finetune`` — the Llama fine-tune recipe
   (``paddle_tpu_torch.examples.finetune_llama``): at its tiny default
   with AMP off, losses, EMA weights and greedy ids under ``ema.apply()``
   on the card against the CPU (rtol 1e-4); ``LookAhead(AdamW)`` under
   ``TrainStep`` against the CPU; at Llama-3-8B's widths in bf16 O2
   (depth 2, B=8, S=1024, accumulate 2, EMA): finite losses, K1 = K2a =
   K2b = 4 per step, step ms, tokens/s, peak memory; a recomputed
   Llama-3-8B-wide decoder layer's bf16 gradients bit-equal to the plain
   run's with K1 launched twice, and a GPT-base decoder layer's with
   dropout 0.1 (the plain attention, no K1) under one seed.
19. ``profile`` (only when asked for) — the bf16 slice, the bf16 int8 slice
   (native, dynamic and static int8 weights) and bf16 training steps
   (plain and QAT) under the port's ``Profiler`` (a ``torch.profiler``
   device trace): device time by kernel and the device's idle share.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name / power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Each phase
prints its wall seconds on a line of its own.  Any failure
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
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 2e-4}
# K1's f32 body on the tensor cores (3xTF32, head_dim <= 128), beside
# ATOL: a one-pass TF32 body fails it (tests/test_torch_port_cuda.py,
# test_flash_f32_one_pass_tf32_fails_the_tight_check)
K1_F32_TC_ATOL = 2e-5
BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3,      # max err / max |ref|
           torch.float32: 1e-4}

# the served model (GPT-base, the JAX package's GPTForCausalLM defaults)
LAYERS, HEADS, HEAD_DIM, PAGE, MAXLEN, SLOTS = 12, 12, 64, 16, 1024, 8
NP = MAXLEN // PAGE
VOCAB, HIDDEN = 50304, 768
# generate(): batch and new tokens of the f32 checks and of the timed bf16
# runs (prompts of GEN_BF16_S); the speculative engine's draft length and
# the chunked prefill's chunk
GEN_B, GEN_NEW = 4, 32
GEN_BF16_B, GEN_BF16_S, GEN_BF16_NEW = 8, 512, 128
SPEC_K, CHUNK_TOKENS = 4, 128
# the training run: batch x sequence of the timed bf16 steps, and of the
# f32 steps held against the CPU
TRAIN_B, TRAIN_S, PARITY_B, PARITY_S = 8, 1024, 2, 256
WARMUP_STEPS, TIMED_STEPS, PARITY_STEPS = 2, 10, 3
# the observe phase's cost turns: rounds of (off, on, on, off); one call's
# host-bound walls spread ~5-15% from turn to turn, so one round cannot
# resolve a cost of a few percent
COST_ROUNDS = 3
# f32 QAT losses, card against CPU: fake-quant turns last-bit differences
# of the GEMMs into whole grid steps at rounding ties, so the losses move
# by ~1e-4 where a plain run agrees to ~1e-7 (the phase's control run
# measures this on the CPU alone)
QAT_RTOL = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters=20, warmup=3, graph=False):
    """Mean time of one ``fn()`` on the card, by CUDA events over ``iters``
    launches after ``warmup``.  ``graph=True`` captures the ``iters`` calls
    in one CUDA graph and times its replay: the device's time for a call
    whose host-side launch would take longer than the kernel (what a
    captured decode step pays)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def k1_bounds(dtype, ops, nbytes):
    """K1's bound for ``ops`` operations and ``nbytes`` moved: bf16 / f16
    at the 16-bit tensor-core rate; f32 runs three TF32 products for each
    product (3xTF32), so 3 x ``ops`` at the TF32 rate, with the f32 SIMT
    rate's figure beside it (labelled: a 3xTF32 kernel may beat it)."""
    if dtype != torch.float32:
        ms, by = bound(ops, nbytes)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = bound(3 * ops, nbytes, PEAK_TF32_FLOPS)
    f32_ms, f32_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    return {"bound_ms": ms, "bound_by": by,
            "bound_rule": "max(3 ops / 495e12, bytes / 3.35e12)",
            "bound_f32_rate_ms": f32_ms, "bound_f32_rate_by": f32_by}


# ------------------------------------------------------------------- build
def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build("flash_attention_fwd", "flash_attention_bwd",
                         "paged_flash_decode", "paged_flash_decode_q",
                         "bias_gelu")
    secs = time.perf_counter() - t0
    # per kernel: its entry, registers, and stack / spill bytes (the
    # spill line carries no "ptxas" prefix)
    ptxas = {n: [ln.strip() for ln in _build.BUILD_LOGS[n].splitlines()
                 if "spill" in ln or ("ptxas" in ln and (
                     "registers" in ln or "Compiling entry" in ln))]
             for n in paths}
    emit({"phase": "build", "seconds": secs,
          "libraries": {n: str(p) for n, p in paths.items()},
          "ptxas": ptxas, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


# ----------------------------------------------------------------- kernels
def _k1_case(gen, dtype, sq, sk, d, causal, b=1, layout="contiguous"):
    """K1 against its plain version (o within ATOL, the 3xTF32 body within
    K1_F32_TC_ATOL; lse within 1e-3) and a second launch bit-equal to the
    first.  ``layout``: "contiguous";
    "unaligned", each tensor a view one element into rows of d + 1 (the
    scalar staging); "qkv", the model's head-major split of one
    ``[b, S, HEADS, 3, d]`` tensor."""
    from paddle_tpu_torch.ops import flash_attention as fa

    if layout == "qkv":
        q, k, v = torch.randn(b, sq, HEADS, 3, d, generator=gen,
                              device="cuda").to(dtype).unbind(3)
    else:
        w = d + 1 if layout == "unaligned" else d
        q, k, v = (torch.randn(b, s, HEADS, w, generator=gen, device="cuda")
                   .to(dtype)[..., w - d:] for s in (sq, sk, sk))
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    o2, lse2 = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    err = (o.float() - ref.float()).abs().max().item()
    lse_ref = fa.flash_attention_lse_ref(q, k, causal=causal)
    lse_err = (lse - lse_ref).abs().max().item()
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    tol = K1_F32_TC_ATOL if dtype == torch.float32 and d <= 128 \
        else ATOL[dtype]
    ok = (err <= tol and lse_err <= 1e-3 and same
          and bool(torch.isfinite(o).all()))
    return {"b": b, "sq": sq, "sk": sk, "d": d, "causal": causal,
            "layout": layout, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "bit_equal_relaunch": same, "ok": ok}


def _k1_timed(gen, b, S=1024, dtype=torch.bfloat16, heads=HEADS,
              d=HEAD_DIM):
    """K1, its plain version and ``F.scaled_dot_product_attention`` at
    ``[b, S, heads, d]``, causal, by CUDA-graph replay (and K1 eagerly).
    Bound (``k1_bounds``): 4 D operations per visible (query, key) pair
    against q, k, v read and o written once."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(b, S, heads, d, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    o = fa.flash_attention_fn(q, k, v, causal=True)
    err = (o.float() - fa.flash_attention_ref(q, k, v, causal=True).float()
           ).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = b * S * (S + 1) // 2
    out = {"shape": [b, S, heads, d], "causal": True,
           "dtype": str(dtype).split(".")[-1], "rows": b * S,
           "kernel_ms": cuda_ms(lambda: fa.flash_attention_fn(q, k, v,
                                                              causal=True),
                                graph=True),
           "eager_ms": cuda_ms(lambda: fa.flash_attention_fn(q, k, v,
                                                             causal=True)),
           "plain_ms": cuda_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                              causal=True),
                               iters=5),
           "library_ms": cuda_ms(lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     qt, kt, vt, is_causal=True), graph=True),
           **k1_bounds(dtype, 4 * heads * d * pairs,
                       4 * q.numel() * q.element_size()),
           "max_abs_err": err, "ok": err <= ATOL[dtype]}
    del q, k, v, qt, kt, vt, o
    return out


def _rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _k2_inputs(gen, dtype, b, sq, sk, d, causal, g_lse, layout="contiguous",
               heads=HEADS):
    """q, k, v, g ``[b, S, heads, d]`` and the kernel forward's lse with
    the row correction r = delta (- g_lse).  ``layout``: "contiguous";
    "unaligned", each tensor a view one element into rows of d + 1 (no
    16-byte copies: the kernels' scalar staging); "qkv", q / k / v the
    model's head-major split of one ``[b, S, HEADS, 3, d]`` tensor."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def t(s, width=d):
        return torch.randn(b, s, heads, width, generator=gen,
                           device="cuda").to(dtype)

    if layout == "qkv":
        q, k, v = torch.randn(b, sq, heads, 3, d, generator=gen,
                              device="cuda").to(dtype).unbind(3)
        g = t(sq)
    elif layout == "unaligned":
        q, k, v, g = (t(s, d + 1)[..., 1:] for s in (sq, sk, sk, sq))
    else:
        q, k, v, g = t(sq), t(sk), t(sk), t(sq)
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    r = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(-1, sq)
    if g_lse:
        r = r - torch.randn(r.shape, generator=gen, device="cuda")
    return q, k, v, g, lse, r.contiguous()


def _k2_case(gen, dtype, sq, sk, d, causal, g_lse, b=1, layout="contiguous"):
    """K2a + K2b against the plain backward (max error over max |ref|),
    and a second launch on the same inputs bit-equal to the first."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, g, lse, r = _k2_inputs(gen, dtype, b, sq, sk, d, causal, g_lse,
                                    layout)
    scale = d ** -0.5
    got = fa._bwd_kernels(q, k, v, g, lse, r, scale, causal)
    again = fa._bwd_kernels(q, k, v, g, lse, r, scale, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, causal)
    errs = {n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return {"b": b, "sq": sq, "sk": sk, "d": d, "causal": causal,
            "g_lse": g_lse, "layout": layout,
            "dtype": str(dtype).split(".")[-1], "rel_err": errs,
            "bit_equal_relaunch": same,
            "ok": finite and same and max(errs.values()) <= BWD_TOL[dtype]}


def _k2_autograd_case(gen):
    """Gradients through K1 + K2 (the autograd Function), from the model's
    strided head-major qkv split, against torch autograd through the plain
    forward; f32."""
    from paddle_tpu_torch.ops import flash_attention as fa

    qkv = torch.randn(2, 300, HEADS, 3, HEAD_DIM, generator=gen, device="cuda")
    g = torch.randn(2, 300, HEADS, HEAD_DIM, generator=gen, device="cuda")
    a = qkv.clone().requires_grad_()
    b = qkv.clone().requires_grad_()
    fa.flash_attention_fn(*a.unbind(3), causal=True).backward(g)
    fa.flash_attention_ref(*b.unbind(3), causal=True).backward(g)
    err = _rel_err(a.grad, b.grad)
    return {"shape": [2, 300, HEADS, HEAD_DIM], "causal": True,
            "dtype": "float32", "rel_err": err, "ok": err <= BWD_TOL[torch.float32]}


def _library_bwd(q, k, v, g):
    """One PyTorch call computing dq, dk, dv (causal) on the outputs of its
    own forward (``[B, H, S, D]`` views): the flash-attention backward ATen
    op for bf16 / f16, which takes 16-bit inputs only; for f32 the
    memory-efficient one (CUTLASS, 3xTF32 on sm80+: the family of f32
    SDPA, K1 f32's yardstick)."""
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    if q.dtype == torch.float32:
        out, lse, seed, offset = torch.ops.aten \
            ._scaled_dot_product_efficient_attention(qt, kt, vt, None, True,
                                                     0.0, True)
        return lambda: torch.ops.aten \
            ._scaled_dot_product_efficient_attention_backward(
                gt, qt, kt, vt, None, out, lse, seed, offset, 0.0,
                [True, True, True, False], True)
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        gt, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset)


def _k2_timed(gen, B=TRAIN_B, S=TRAIN_S, H=HEADS, D=HEAD_DIM, tag=""):
    """K2a, K2b, the plain backward and the library backward
    (``_library_bwd``) at ``[B, S, H, D]``, causal, in bf16 (keys
    ``k2a<tag>``, ``k2b<tag>``) and f32 (``*_f32``); by default the
    training shape.  Bound: 8 D (K2a) and 6 D
    (K2b) operations per visible (query, key) pair at the input dtype's
    rate (f32: the SIMT rate), q, k, v, g, lse, r read and the outputs
    written once."""
    from paddle_tpu_torch.ops import flash_attention as fa

    scale = D ** -0.5
    pairs = B * H * S * (S + 1) // 2
    out = {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        q, k, v, g, lse, r = _k2_inputs(gen, dtype, B, S, S, D, True, False,
                                        heads=H)
        dk, dv = fa._bwd_dkdv_kernel(q, k, v, g, lse, r, scale, True)
        dq = fa._bwd_dq_kernel(q, k, v, g, lse, r, scale, True)
        rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, True)
        es = q.element_size()
        elems = q.numel()                               # B*S*H*D
        reads = 4 * elems * es + 2 * B * H * S * 4      # q,k,v,g + lse,r
        peak = PEAK_FLOPS if es == 2 else PEAK_F32_FLOPS
        a_bound, a_by = bound(8 * D * pairs, reads + 2 * elems * es, peak)
        b_bound, b_by = bound(6 * D * pairs, reads + elems * es, peak)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, g, lse, r, scale, True), iters=5)
        library_ms = cuda_ms(_library_bwd(q, k, v, g))
        shape = {"shape": [B, S, H, D], "causal": True,
                 "dtype": str(dtype).split(".")[-1], "rows": B * S,
                 "plain_and_library_ms_are_for_the_pair": True,
                 "plain_ms": plain_ms, "library_ms": library_ms}
        out["k2a" + tag + suffix] = {
            **shape, "kernel_ms": cuda_ms(lambda: fa._bwd_dkdv_kernel(
                q, k, v, g, lse, r, scale, True)),
            "bound_ms": a_bound, "bound_by": a_by,
            "max_abs_err": max((dk.float() - rk.float()).abs().max().item(),
                               (dv.float() - rv.float()).abs().max().item()),
            "ok": max(_rel_err(dk, rk), _rel_err(dv, rv)) <= BWD_TOL[dtype]}
        out["k2b" + tag + suffix] = {
            **shape, "kernel_ms": cuda_ms(lambda: fa._bwd_dq_kernel(
                q, k, v, g, lse, r, scale, True)),
            "bound_ms": b_bound, "bound_by": b_by,
            "max_abs_err": (dq.float() - rq.float()).abs().max().item(),
            "ok": _rel_err(dq, rq) <= BWD_TOL[dtype]}
        del q, k, v, g, lse, r, dk, dv, dq, rq, rk, rv
    return out


# K2 at head_dim 256: the SIMT body with 32-row tiles (no model of the
# repository trains there; the TPU package's limit)
K2_WIDE_B, K2_WIDE_S, K2_WIDE_H, K2_WIDE_D = 2, 1024, 8, 256


def _k3_inputs(gen, dtype, lens, heads, kv_heads, d=HEAD_DIM, np_=NP,
               ps=PAGE):
    B = len(lens)
    pages = B * np_
    perm = torch.randperm(pages, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(B, np_).contiguous()
    kp = torch.randn(pages, ps, kv_heads, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(pages, ps, kv_heads, d, generator=gen, device="cuda").to(dtype)
    q = torch.randn(B, heads, d, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, ln


def _k3_case(gen, dtype, lens, heads, kv_heads, np_=NP):
    """K3 against its plain version, a second launch bit-equal to the
    first, NaN in every dead page changing no bit, K5a bit-equal to K3."""
    from paddle_tpu_torch.ops import paged_attention as pa

    q, kp, vp, table, ln = _k3_inputs(gen, dtype, lens, heads, kv_heads,
                                      np_=np_)
    o = pa.paged_attention(q, kp, vp, table, ln)
    relaunch_ok = torch.equal(pa.paged_attention(q, kp, vp, table, ln), o)
    ref = pa.paged_attention_ref(q, kp, vp, table, ln)
    err = (o.float() - ref.float()).abs().max().item()
    # poison: NaN in every page past each row's length must never be read
    kpn, vpn = kp.clone(), vp.clone()
    for b, n in enumerate(lens):
        dead = table[b, -(-n // PAGE):].long()
        kpn[dead] = float("nan")
        vpn[dead] = float("nan")
    o_p = pa.paged_attention(q, kpn, vpn, table, ln)
    # K5a, the full sweep: stages the poisoned dead pages, uses none
    o5 = pa._paged_full_sweep(q, kp, vp, table, ln)
    o5_p = pa._paged_full_sweep(q, kpn, vpn, table, ln)
    torch.cuda.synchronize()
    poison_ok = bool(torch.isfinite(o_p).all()) and torch.equal(o_p, o)
    zero_ok = all(bool((o[b] == 0).all()) for b, n in enumerate(lens) if n == 0)
    k5a_ok = torch.equal(o5, o) and torch.equal(o5_p, o)
    ok = (err <= ATOL[dtype] and poison_ok and zero_ok and k5a_ok
          and relaunch_ok)
    return {"B": len(lens), "heads": heads, "kv_heads": kv_heads,
            "lens": lens, "table_width": np_,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "bit_equal_relaunch": relaunch_ok,
            "dead_pages_poisoned_ok": poison_ok,
            "empty_rows_zero": zero_ok, "k5a_bit_equal_k3": k5a_ok, "ok": ok}


def _k4_inputs(gen, dtype, lens, heads, kv_heads, d=HEAD_DIM, np_=NP,
               ps=PAGE):
    """q in ``dtype`` and int8 pools with their float32 scale pools,
    quantized from normal K / V on the pool grid."""
    from paddle_tpu_torch.ops import paged_attention as pa

    B = len(lens)
    pages = B * np_
    perm = torch.randperm(pages, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(B, np_).contiguous()
    kq, ks = pa.quantize_kv(torch.randn(pages, ps, kv_heads, d,
                                        generator=gen, device="cuda"))
    vq, vs = pa.quantize_kv(torch.randn(pages, ps, kv_heads, d,
                                        generator=gen, device="cuda"))
    q = torch.randn(B, heads, d, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kq, vq, ks.contiguous(), vs.contiguous(), table, ln


def _k4_case(gen, dtype, lens, heads, kv_heads, np_=NP):
    """K4 against its plain version and a second launch bit-equal to the
    first; K4 and K5b with NaN in every dead page's scale rows (an int8
    payload cannot hold NaN): K4 never reads them and K5b stages them, and
    neither may let them reach the output; K5b bit-equal to K4."""
    from paddle_tpu_torch.ops import paged_attention as pa

    q, kq, vq, ks, vs, table, ln = _k4_inputs(gen, dtype, lens, heads,
                                              kv_heads, np_=np_)
    o = pa.paged_attention_quantized(q, kq, vq, ks, vs, table, ln)
    relaunch_ok = torch.equal(
        pa.paged_attention_quantized(q, kq, vq, ks, vs, table, ln), o)
    ref = pa.paged_attention_quantized_ref(q, kq, vq, ks, vs, table, ln)
    err = (o.float() - ref.float()).abs().max().item()
    ksn, vsn = ks.clone(), vs.clone()
    for b, n in enumerate(lens):
        dead = table[b, -(-n // PAGE):].long()
        ksn[dead] = float("nan")
        vsn[dead] = float("nan")
    o_p = pa.paged_attention_quantized(q, kq, vq, ksn, vsn, table, ln)
    o5 = pa._paged_q_full_sweep(q, kq, vq, ks, vs, table, ln)
    o5_p = pa._paged_q_full_sweep(q, kq, vq, ksn, vsn, table, ln)
    torch.cuda.synchronize()
    poison_ok = bool(torch.isfinite(o_p).all()) and torch.equal(o_p, o)
    zero_ok = all(bool((o[b] == 0).all()) for b, n in enumerate(lens) if n == 0)
    k5b_ok = torch.equal(o5, o) and torch.equal(o5_p, o)
    ok = (err <= ATOL[dtype] and poison_ok and zero_ok and k5b_ok
          and relaunch_ok)
    return {"B": len(lens), "heads": heads, "kv_heads": kv_heads,
            "lens": lens, "table_width": np_,
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "bit_equal_relaunch": relaunch_ok,
            "dead_scale_rows_poisoned_ok": poison_ok,
            "empty_rows_zero": zero_ok, "k5b_bit_equal_k4": k5b_ok, "ok": ok}


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
    # K1 on its three bodies: head_dim 17-128 on the tensor cores, bf16 /
    # f16 by 16-bit products and f32 by 3xTF32 (zero-padded to 64 / 128;
    # 17 and a misaligned base take the scalar staging), 192 and 256 on the
    # SIMT body
    k1_shapes = [(s, s, 64, True) for s in (17, 256, 300, 512, 1024)]
    k1_shapes += [(64, 320, 64, True), (300, 300, 64, False),
                  (1024, 1024, 64, False), (256, 256, 128, True),
                  (300, 300, 32, True), (200, 256, 40, True),
                  (129, 129, 96, False), (100, 100, 17, True),
                  (70, 70, 256, True), (160, 200, 192, True),
                  (1, 513, 128, True),
                  (300, 300, 64, True, 1, "unaligned"),
                  (1024, 1024, 64, True, 2, "qkv"),
                  (TRAIN_S, TRAIN_S, HEAD_DIM, True, TRAIN_B)]
    k1 = [_k1_case(gen, dt, *sh)
          for dt in (torch.bfloat16, torch.float16, torch.float32)
          for sh in k1_shapes]
    lens = [0, 1, 15, 16, 17, 500, 1024, 777]
    # the split-K decode: the slot-boundary lengths above (table of 64),
    # one row of 1024 tokens alone (the most splits), a table of 256 slots
    k3_rows = [(lens, NP), ([1024], NP), ([4096, 1, 2000, 0], 4 * NP)]
    pa.FULL_SWEEP_LAUNCHES = pa.QUANT_FULL_SWEEP_LAUNCHES = 0
    k3 = [_k3_case(gen, dt, ln_, HEADS, kvh, np_)
          for dt in (torch.bfloat16, torch.float32) for kvh in (HEADS, 4)
          for ln_, np_ in k3_rows]
    k4 = [_k4_case(gen, dt, ln_, HEADS, kvh, np_)
          for dt in (torch.bfloat16, torch.float32) for kvh in (HEADS, 4)
          for ln_, np_ in k3_rows]
    # K5a / K5b have no path (only tests call them in the TPU package too):
    # their launches are these checks'
    k5_launches = {"k5a": pa.FULL_SWEEP_LAUNCHES,
                   "k5b": pa.QUANT_FULL_SWEEP_LAUNCHES}
    k2_shapes = [(s, s, 64, c, gl) for s in (17, 256, 300, 1024)
                 for c in (True, False) for gl in (False, True)]
    k2_shapes += [(64, 320, 64, True, False), (200, 512, 64, True, True),
                  (256, 256, 128, True, False), (300, 300, 128, False, True),
                  (1024, 1024, 128, True, True)]
    # the tensor-core body's reach: head_dim 32 / 40 / 96 (zero-padded in
    # shared memory), rows that take no 16-byte copies (head_dim 17, a
    # misaligned base), the model's strided qkv split, the training shape
    k2_shapes += [(300, 300, 32, True, False), (200, 256, 40, True, True),
                  (129, 129, 96, False, True), (100, 100, 17, True, False),
                  (300, 300, 64, True, False, 1, "unaligned"),
                  (1024, 1024, 64, True, False, 2, "qkv"),
                  (TRAIN_S, TRAIN_S, HEAD_DIM, True, False, TRAIN_B)]
    # head_dim 129-256: the SIMT body with 32-row tiles in every dtype,
    # ragged lengths, sq < sk, a g_lse term
    k2_shapes += [(160, 160, 192, True, False), (129, 200, 192, False, True),
                  (300, 300, 256, True, True), (64, 257, 256, True, False),
                  (200, 200, 256, False, False, 1, "unaligned")]
    k2 = [_k2_case(gen, dt, *sh)
          for dt in (torch.bfloat16, torch.float16, torch.float32)
          for sh in k2_shapes]
    k2.append(_k2_autograd_case(gen))

    # times at the served shapes, bf16: K1 at the longest prefill bucket
    # (B=1) and at the training shape (B=8), K3 at a decode step of the
    # slice's first 8 requests; K1's f32 body (3xTF32) at the longest f32
    # prefill of the GPT phases and at Llama-3-8B's prefill (B=8, S=512,
    # 32 heads of 128: its rotated q / k are f32)
    k1_time = _k1_timed(gen, 1)
    k1_train_time = _k1_timed(gen, TRAIN_B)
    k1_time["other_shapes"] = {
        "k1_train_shape": k1_train_time,
        "k1_f32_gpt": _k1_timed(gen, 1, dtype=torch.float32),
        "k1_f32_llama_prefill": _k1_timed(
            gen, LL_BF16_B, LL_BF16_S, torch.float32, LL_HEADS, LL_HEAD_DIM)}

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
        "kernel_ms": cuda_ms(lambda: pa.paged_attention(qd, kp, vp, table, ln),
                             graph=True),
        "eager_ms": cuda_ms(lambda: pa.paged_attention(qd, kp, vp, table, ln)),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_ref(qd, kp, vp, table, ln)),
        "library_ms": None, "bound_ms": k3_bound, "bound_by": k3_by,
        "max_abs_err": k3_err, "lens": dlens}
    # K5a: K3's function over the same rows, every table page staged
    o5a = pa._paged_full_sweep(qd, kp, vp, table, ln)
    k5a_time = {
        "kernel_ms": cuda_ms(lambda: pa._paged_full_sweep(qd, kp, vp, table, ln),
                             graph=True),
        "plain_ms": k3_time["plain_ms"], "library_ms": None,
        "bound_ms": k3_bound, "bound_by": k3_by,
        "max_abs_err": (o5a.float() - pa.paged_attention_ref(
            qd, kp, vp, table, ln).float()).abs().max().item(),
        "bit_equal_k3": torch.equal(o5a, od),
        "launches": k5_launches["k5a"], "lens": dlens}
    k4_time, k5b_time = _k4_timed(gen, dlens, k3_time["kernel_ms"],
                                  k5_launches["k5b"])
    chunk_time = _chunk_timed(gen, dlens)
    k2_time = _k2_timed(gen)
    k2_wide_time = _k2_timed(gen, K2_WIDE_B, K2_WIDE_S, K2_WIDE_H,
                             K2_WIDE_D, tag="_d256")
    k6 = _k6_cases(gen)
    k6_time = _k6_timed(gen)
    ok = all(c["ok"] for c in k1 + k2 + k3 + k4 + k6
             + list(chunk_time.values()) + list(k2_time.values())
             + list(k2_wide_time.values())
             + list(k1_time["other_shapes"].values()))
    emit({"phase": "kernels", "ok": ok, "k1_cases": k1, "k2_cases": k2,
          "k3_cases": k3, "k4_cases": k4, "k6_cases": k6,
          "k1_timed": k1_time,
          "k2_timed": {"shape": [TRAIN_B, TRAIN_S, HEADS, HEAD_DIM],
                       "causal": True,
                       "dtype": "bfloat16 (k2a, k2b), float32 (*_f32)",
                       "plain_and_library_ms_are_for_the_pair": True,
                       **k2_time},
          "k2_timed_d256": k2_wide_time,
          "k3_timed": {"B": SLOTS, "heads": HEADS, "page_size": PAGE,
                       "table_width": NP, "dtype": "bfloat16", **k3_time},
          "k4_timed": {"B": SLOTS, "heads": HEADS, "page_size": PAGE,
                       "table_width": NP, "q_dtype": "bfloat16",
                       "pools": "int8 + float32 scales", **k4_time},
          "k5a_timed": {"dtype": "bfloat16", **k5a_time},
          "k5b_timed": {"q_dtype": "bfloat16", **k5b_time},
          "chunk_timed": chunk_time,
          "k6_timed": k6_time,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("kernels phase: a kernel disagrees with its plain "
                         "version (see the k1 / k2 / k3 / k4 / k6 cases above)")
    k3_time["other_shapes"] = {k: v for k, v in chunk_time.items()
                               if k.startswith("k3")}
    k4_time["other_shapes"] = {"k4_verify": chunk_time["k4_verify"]}
    for key in ("k2a", "k2b"):
        k2_time[key]["other_shapes"] = {
            n: v for n, v in list(k2_time.items()) + list(k2_wide_time.items())
            if n.startswith(key) and n != key}
    return {"k1": k1_time, "k3": k3_time, "k4": k4_time, "k5a": k5a_time,
            "k5b": k5b_time, "k6": k6_time["bfloat16"], **k2_time}


def _k6_cases(gen):
    """K6 against its plain version: f32 / f16 / bf16, a bf16 x with a
    float32 bias (an f32 bias parameter under AMP), at the example's shape
    ``[128, 64]``, GPT-base's MLP activation at B=8, S=1024
    ``[8192, 3072]``, an odd width ``[37, 1001]`` and a non-contiguous x."""
    from paddle_tpu_torch.ops import bias_gelu as bg

    cases = []
    for xd, bd in ((torch.float32, torch.float32), (torch.float16, torch.float16),
                   (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)):
        for shape, strided in (((128, 64), False), ((TRAIN_B * TRAIN_S, 3072), False),
                               ((37, 1001), False), ((64, 128), True)):
            x = torch.randn(shape[::-1] if strided else shape, generator=gen,
                            device="cuda").mul_(3).to(xd)
            x = x.t() if strided else x
            b = torch.randn(x.shape[-1], generator=gen, device="cuda").to(bd)
            y = bg.bias_gelu(x, b)
            torch.cuda.synchronize()
            err = (y.float() - bg.bias_gelu_ref(x, b).float()).abs().max().item()
            cases.append({"shape": list(x.shape), "contiguous": x.is_contiguous(),
                          "x_dtype": str(xd).split(".")[-1],
                          "b_dtype": str(bd).split(".")[-1], "max_abs_err": err,
                          "ok": err <= ATOL[xd] and y.dtype == xd
                          and bool(torch.isfinite(y).all())})
    return cases


def _k6_timed(gen):
    """K6, its plain version and ``F.gelu(x + b)`` (two PyTorch calls; no
    single call adds a bias inside the GELU) at ``[8192, 3072]``, bf16 x
    with a float32 bias and float32 throughout; K6 and the two calls by
    CUDA-graph replay and eagerly.  Bound: x and b read once,
    y written once; 6 operations per element (erf counted as one) at the
    float32 rate, far below the bytes' time."""
    from paddle_tpu_torch.ops import bias_gelu as bg

    out = {}
    for xd in (torch.bfloat16, torch.float32):
        x = torch.randn(TRAIN_B * TRAIN_S, 3072, generator=gen, device="cuda").to(xd)
        b = torch.randn(3072, generator=gen, device="cuda")
        y = bg.bias_gelu(x, b)
        err = (y.float() - bg.bias_gelu_ref(x, b).float()).abs().max().item()
        nbytes = 2 * x.numel() * x.element_size() + b.numel() * 4
        k6_bound, k6_by = bound(6 * x.numel(), nbytes, PEAK_F32_FLOPS)
        bx = b.to(xd)
        out[str(xd).split(".")[-1]] = {
            "shape": list(x.shape), "b_dtype": "float32",
            "kernel_ms": cuda_ms(lambda: bg.bias_gelu(x, b), graph=True),
            "eager_ms": cuda_ms(lambda: bg.bias_gelu(x, b)),
            "plain_ms": cuda_ms(lambda: bg.bias_gelu_ref(x, b)),
            "library_ms": None,
            "library_note": "no single PyTorch call adds a bias inside the GELU",
            "two_call_ms": cuda_ms(lambda: torch.nn.functional.gelu(x + bx),
                                   graph=True),
            "two_call_eager_ms": cuda_ms(
                lambda: torch.nn.functional.gelu(x + bx)),
            "two_call": "torch.nn.functional.gelu(x + b), b in x's dtype",
            "bound_ms": k6_bound, "bound_by": k6_by, "bytes": nbytes,
            "max_abs_err": err}
    return out


def _k4_timed(gen, dlens, k3_ms, k5b_launches):
    """K4, its plain version and K5b at the slice's decode rows (bf16 q,
    int8 pools, 12 heads), with K3's time on the same rows over bf16
    pools beside it.  Bound: the valid pages' int8 K and V with their
    float32 scales, q and o; 4 D operations per valid key per head."""
    from paddle_tpu_torch.ops import paged_attention as pa

    q, kq, vq, ks, vs, table, ln = _k4_inputs(gen, torch.bfloat16, dlens,
                                              HEADS, HEADS)
    args = (q, kq, vq, ks, vs, table, ln)
    o = pa.paged_attention_quantized(*args)
    ref = pa.paged_attention_quantized_ref(*args)
    err = (o.float() - ref.float()).abs().max().item()
    o5 = pa._paged_q_full_sweep(*args)
    valid_pages = sum(-(-n // PAGE) for n in dlens)
    nbytes = (2 * valid_pages * PAGE * HEADS * (HEAD_DIM + 4)
              + 2 * q.numel() * 2 + table.numel() * 4 + ln.numel() * 4)
    k4_bound, k4_by = bound(4 * sum(dlens) * HEADS * HEAD_DIM, nbytes)
    plain_ms = cuda_ms(lambda: pa.paged_attention_quantized_ref(*args))
    k4 = {"kernel_ms": cuda_ms(lambda: pa.paged_attention_quantized(*args),
                               graph=True),
          "eager_ms": cuda_ms(lambda: pa.paged_attention_quantized(*args)),
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call dequantizes paged pools",
          "bound_ms": k4_bound, "bound_by": k4_by, "max_abs_err": err,
          "k3_same_rows_bf16_pools_ms": k3_ms, "lens": dlens}
    k5b = {"kernel_ms": cuda_ms(lambda: pa._paged_q_full_sweep(*args),
                                graph=True),
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": k4_bound,
           "bound_by": k4_by,
           "max_abs_err": (o5.float() - ref.float()).abs().max().item(),
           "bit_equal_k4": torch.equal(o5, o),
           "launches": k5b_launches, "lens": dlens}
    return k4, k5b


def _chunk_timed(gen, dlens, cases=None):
    """K3 through ``paged_chunk_attend`` at the speculative verify shape
    (the slice's 8 decode rows, k + 1 = 5 positions each: 40 rows) and at
    one prefill chunk (one slot, 128 positions at 512-639: 128 rows), and
    K4 through ``paged_chunk_attend_quant`` at the verify shape; bf16 q,
    12 heads, against the plain version, by CUDA-graph replay (and
    eagerly).  ``cases`` replaces that list: ``(name, lens, positions,
    int8, page size, table width)``.  Bound: each slot's valid pages read
    once (K4: int8 with float32 scales), q read and o written once; 4 D
    operations per (position, visible key) per head.  The kernel re-reads
    a slot's pages once per row of the expansion, as the TPU design
    does."""
    from paddle_tpu_torch.ops import paged_attention as pa

    out = {}
    for name, lens, C, quant, ps, np_ in cases or (
            ("k3_verify", dlens, SPEC_K + 1, False, PAGE, NP),
            ("k3_chunk", [512], CHUNK_TOKENS, False, PAGE, NP),
            ("k4_verify", dlens, SPEC_K + 1, True, PAGE, NP)):
        B = len(lens)
        if quant:
            _, *pools, table, ln = _k4_inputs(gen, torch.bfloat16, lens,
                                              HEADS, HEADS, np_=np_, ps=ps)
            fn, ref_fn = pa.paged_chunk_attend_quant, pa.paged_chunk_attend_quant_ref
            per_key = 2 * HEADS * (HEAD_DIM + 4)
        else:
            _, *pools, table, ln = _k3_inputs(gen, torch.bfloat16, lens,
                                              HEADS, HEADS, np_=np_, ps=ps)
            fn, ref_fn = pa.paged_chunk_attend, pa.paged_chunk_attend_ref
            per_key = 2 * HEADS * HEAD_DIM * 2
        q = torch.randn(B, C, HEADS, HEAD_DIM, generator=gen,
                        device="cuda").to(torch.bfloat16)
        args = (q, *pools, table, ln)
        o = fn(*args)
        err = (o.float() - ref_fn(*args).float()).abs().max().item()
        seen = np.minimum(np.asarray(lens)[:, None] + 1 + np.arange(C),
                          np_ * ps)
        pages = int(sum(-(-int(r.max()) // ps) for r in seen))
        nbytes = (pages * ps * per_key + 2 * q.numel() * 2
                  + table.numel() * 4 + ln.numel() * 4)
        b_ms, b_by = bound(4 * int(seen.sum()) * HEADS * HEAD_DIM, nbytes)
        out[name] = {
            "slots": B, "positions": C, "rows": B * C, "lens": list(lens),
            "page_size": ps, "table_width": np_,
            "splits": pa._splits(B * C, HEADS, np_),
            "kernel_ms": cuda_ms(lambda: fn(*args), graph=True),
            "eager_ms": cuda_ms(lambda: fn(*args)),
            "plain_ms": cuda_ms(lambda: ref_fn(*args)), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "ok": err <= ATOL[torch.bfloat16]}
    return out


# ------------------------------------------------------------------- slice
def _serve(model, device, prompts, temps, **engine_kw):
    """Serve ``prompts`` (32 new tokens each) through a fresh engine;
    returns the ids, the wall seconds and the engine's stats, with the
    bytes of its page pools (scale pools included) as ``pool_bytes``."""
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, device=device, num_slots=SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN, **engine_kw)
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
    wall = time.perf_counter() - t0
    stats["pool_bytes"] = sum(p.numel() * p.element_size() for p in eng._pools)
    stats["ttft_s"] = [h.ttft for h in hs]
    return outs, wall, stats


def _counted_run(model, prompts, temps, **engine_kw):
    """``_serve`` on the card with every kernel counter zeroed just before
    and read just after: K1 must run once per layer per prefill, and the
    paged decode kernel of the pool layout (K3 native, K4 int8) once per
    layer per decode step, the other one never."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    fa.LAUNCHES = 0
    pa.LAUNCHES = pa.QUANT_LAUNCHES = 0
    outs, wall, stats = _serve(model, "cuda", prompts, temps, **engine_kw)
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "paged_flash_decode": pa.LAUNCHES,
              "paged_flash_decode_q": pa.QUANT_LAUNCHES}
    decode = "paged_flash_decode_q" if stats["kv_dtype"] == "int8" \
        else "paged_flash_decode"
    want = dict.fromkeys(counts, 0)
    want["flash_attention_fwd"] = LAYERS * stats["prefills"]
    want[decode] = LAYERS * stats["iteration"]
    if counts != want or not (counts["flash_attention_fwd"] and counts[decode]):
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
    return {"launches": counts16, "cpu_ref": ref}


# ------------------------------------------------------------------- quant
def _first_divergence(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_quant():
    """The int8 serving slice: ``ServingEngine(kv_dtype="int8")`` on the
    slice's requests.  f32 on the card against the CPU int8 engine on the
    first 6 requests (the CPU run of GPT-base bounds the count): int8
    rounding ties flip on last-bit differences between cuBLAS and the CPU,
    so the gate is equal first tokens (prefill is full precision) and
    greedy top-1 agreement >= 0.8.  Then bf16, after one untimed warm-up
    of each configuration: timed in turns with the native bf16 slice
    (int8, native, native, int8), and once more with
    ``weight_dtype="int8"``."""
    from paddle_tpu_torch.serving.quant import top1_agreement
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, temps = slice_requests()
    n_par = 6
    greedy = [i for i, t in enumerate(temps[:n_par]) if t == 0.0]
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    ref, cpu_wall, _ = _serve(cpu_model, "cpu", prompts[:n_par],
                              temps[:n_par], kv_dtype="int8")
    model = copy.deepcopy(cpu_model).to("cuda")
    del cpu_model
    outs32, wall32, st32, counts32 = _counted_run(
        model, prompts[:n_par], temps[:n_par], kv_dtype="int8")
    divergence = {i: _first_divergence(outs32[i], ref[i]) for i in greedy}
    first_ok = all(outs32[i][0] == ref[i][0] for i in greedy)
    agree32 = top1_agreement([ref[i] for i in greedy],
                             [outs32[i] for i in greedy])

    model = model.to(torch.bfloat16)
    # one untimed warm-up of each configuration (first-launch costs)
    for kv in ("int8", "native"):
        _serve(model, "cuda", prompts[:2], temps[:2], kv_dtype=kv)
    runs = {}
    for kv in ("int8", "native", "native", "int8"):
        torch.cuda.reset_peak_memory_stats()
        outs, wall, st, counts = _counted_run(model, prompts, temps,
                                              kv_dtype=kv)
        runs.setdefault(kv, []).append({
            "wall_s": wall, "tokens": sum(len(o) for o in outs),
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "prefills": st["prefills"], "decode_steps": st["iteration"],
            "launches": counts, "all_complete": all(len(o) == 32 for o in outs),
            "pool_bytes": st["pool_bytes"],
            "bytes_per_page": st["bytes_per_page"],
            "kv_bytes_per_token": st["kv_bytes_per_token"],
            "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "outs": outs})
    w8_model = copy.deepcopy(model)          # converted in place below
    del model
    w8 = {"kv_dtype": "int8", "weight_dtype": "int8"}
    _serve(w8_model, "cuda", prompts[:2], temps[:2], **w8)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    outs_w8, wall_w8, st_w8, counts_w8 = _counted_run(w8_model, prompts,
                                                      temps, **w8)
    peak_w8 = torch.cuda.max_memory_allocated()
    del w8_model
    q_outs = runs["int8"][0]["outs"]
    bf16_greedy = [i for i, t in enumerate(temps) if t == 0.0]
    agree_w8 = top1_agreement([q_outs[i] for i in bf16_greedy],
                              [outs_w8[i] for i in bf16_greedy])
    pool_q, pool_n = runs["int8"][0]["pool_bytes"], runs["native"][0]["pool_bytes"]
    ratio_ok = pool_q * 2 * HEAD_DIM == pool_n * (HEAD_DIM + 4)
    complete = all(r["all_complete"] for rs in runs.values() for r in rs) \
        and all(len(o) == 32 for o in outs_w8 + outs32)
    for rs in runs.values():
        for r in rs:
            del r["outs"]
    ok = first_ok and agree32 >= 0.8 and ratio_ok and complete
    emit({"phase": "quant", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "engine": {"kv_dtype": "int8", "num_slots": SLOTS,
                     "page_size": PAGE, "max_model_len": MAXLEN},
          "requests": len(prompts), "max_new_tokens": 32,
          "f32_vs_cpu_int8": {
              "requests": n_par, "why_6": "the first 6 of the slice's 12 "
              "requests: the CPU engine's GPT-base run bounds the count",
              "greedy_requests": greedy,
              "first_divergent_position": divergence,
              "first_tokens_equal": first_ok, "top1_agreement": agree32,
              "gate": "first tokens equal and top-1 agreement >= 0.8",
              "cpu_reference_wall_s": cpu_wall, "card_wall_s": wall32,
              "prefills": st32["prefills"], "decode_steps": st32["iteration"],
              "launches": counts32},
          "bf16_int8_kv": runs["int8"], "bf16_native": runs["native"],
          "bf16_order": "int8, native, native, int8",
          "pool_bytes_int8_over_native": pool_q / pool_n,
          "pool_bytes_ratio_exact_68_over_128": ratio_ok,
          "bf16_int8_kv_int8_weights": {
              "wall_s": wall_w8, "tokens": sum(len(o) for o in outs_w8),
              "tokens_per_s": sum(len(o) for o in outs_w8) / wall_w8,
              "all_complete": all(len(o) == 32 for o in outs_w8),
              "prefills": st_w8["prefills"], "decode_steps": st_w8["iteration"],
              "launches": counts_w8, "peak_memory_allocated_bytes": peak_w8,
              "top1_agreement_with_int8_kv_run": agree_w8,
              "agreement_gated": False},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("quant phase failed: first tokens differ from the "
                         "CPU int8 engine, agreement < 0.8, the pool bytes "
                         "ratio is not 68/128, or a request did not complete")
    return {"launches": runs["int8"][0]["launches"]}


# ------------------------------------------------------------------- train
def _trainer(model, amp_level=None):
    from paddle_tpu_torch import jit, optimizer

    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    return jit.TrainStep(model, opt, loss_fn=None, amp_level=amp_level)


def _train_flops_per_token(model):
    """6 N + 6 L S d: N counts the decoder layers, the final norm and the
    LM-head matmul (vocab x hidden, tied to the embedding); the second term
    is the causal attention products (QK^T and PV, forward and backward,
    half of the S x S square)."""
    n = sum(p.numel() for p in model.gpt.layers.parameters())
    n += sum(p.numel() for p in model.gpt.final_ln.parameters())
    n += VOCAB * HIDDEN
    return 6 * n + 6 * LAYERS * TRAIN_S * HIDDEN


def _zero_bodies():
    from paddle_tpu_torch.ops import flash_attention as fa

    for d in (fa.FWD_BODY_LAUNCHES, fa.BWD_BODY_LAUNCHES):
        d.update(dict.fromkeys(d, 0))


def _read_bodies():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {"fwd": dict(fa.FWD_BODY_LAUNCHES), "bwd": dict(fa.BWD_BODY_LAUNCHES)}


def _want_bodies(n, fwd, bwd):
    """n forward launches all on body ``fwd``, 2 n backward launches (K2a
    and K2b) all on ``bwd``."""
    from paddle_tpu_torch.ops import flash_attention as fa

    want = {"fwd": dict.fromkeys(fa.FWD_BODY_LAUNCHES, 0),
            "bwd": dict.fromkeys(fa.BWD_BODY_LAUNCHES, 0)}
    want["fwd"][fwd], want["bwd"][bwd] = n, 2 * n
    return want


# GPT-tiny with attention dropout: the config, its dropout, the steps
DROPOUT_CFG = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=2, max_position_embeddings=64)
DROPOUT_P, DROPOUT_STEPS = 0.1, 8


def _dropout_check():
    """GPT-tiny with ``attention_probs_dropout_prob=0.1`` on the card:
    TrainSteps (AdamW lr 1e-3) run its attention as the plain attention
    with dropout, as the TPU package does (no flash launch), with finite
    and falling losses; in eval mode its forward equals, bit for bit, the
    same weights' forward at dropout 0, both through K1."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda",
                           attention_probs_dropout_prob=DROPOUT_P,
                           **DROPOUT_CFG)
    plain = GPTForCausalLM(device="cuda", **DROPOUT_CFG)
    plain.load_state_dict(model.state_dict())
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, DROPOUT_CFG["vocab_size"], (4, 48))).to("cuda")
    model.eval()
    plain.eval()
    n0 = fa.LAUNCHES
    with torch.no_grad():
        eval_equal = torch.equal(model(ids), plain(ids))
    eval_launches = fa.LAUNCHES - n0
    model.train()
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = jit.TrainStep(model, opt, loss_fn=None)
    n0 = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    losses = [step({"input_ids": ids, "labels": ids}).item()
              for _ in range(DROPOUT_STEPS)]
    train_launches = [fa.LAUNCHES - n0[0], fa.BWD_DKDV_LAUNCHES - n0[1],
                      fa.BWD_DQ_LAUNCHES - n0[2]]
    layers = DROPOUT_CFG["num_hidden_layers"]
    ok = (eval_equal and eval_launches == 2 * layers
          and train_launches == [0, 0, 0]
          and bool(np.isfinite(losses).all()) and losses[-1] < losses[0])
    return {"config": DROPOUT_CFG, "attention_probs_dropout_prob": DROPOUT_P,
            "steps": DROPOUT_STEPS, "losses": losses,
            "train_flash_launches": train_launches,
            "eval_equal_dropout_0": eval_equal,
            "eval_flash_launches": eval_launches, "ok": ok}


def phase_train():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(0)

    # parity: f32 on the card against a CPU copy of the same model; K1 runs
    # its 3xTF32 body, K2 its f32 SIMT body
    ids = torch.from_numpy(rs.randint(0, VOCAB, (PARITY_B, PARITY_S)))
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    losses = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        step, x = _trainer(model), ids.to(dev)
        _zero_bodies()
        losses[dev] = [step({"input_ids": x, "labels": x}).item()
                       for _ in range(PARITY_STEPS)]
    f32_bodies = _read_bodies()
    del cpu_model, card_model
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    parity_ok = rel <= 1e-4 and f32_bodies == _want_bodies(
        LAYERS * PARITY_STEPS, fwd="3xtf32", bwd="simt")

    # timed: bf16 O2 at the full training shape, one fixed batch
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda")              # f32 masters
    step = _trainer(model, amp_level="O2")
    x = torch.from_numpy(rs.randint(0, VOCAB, (TRAIN_B, TRAIN_S))).to("cuda")
    batch = {"input_ids": x, "labels": x}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    _zero_bodies()
    out = [step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += [step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
              "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
    steps = WARMUP_STEPS + TIMED_STEPS
    if counts != dict.fromkeys(counts, LAYERS * steps):
        raise SystemExit(f"launch counts {counts} != {LAYERS} x {steps} steps: "
                         f"the training path did not run through the kernels")
    # bf16 at head_dim 64: the 16-bit tensor-core bodies, forward and back
    bf16_bodies = _read_bodies()
    bodies_ok = bf16_bodies == _want_bodies(LAYERS * steps, fwd="tc16",
                                            bwd="tc16")
    bf16_losses = [l.item() for l in out]
    tokens = TRAIN_B * TRAIN_S
    flops = _train_flops_per_token(model) * tokens
    step_s = wall / TIMED_STEPS
    del model, step, batch
    dropout = _dropout_check()
    ok = (parity_ok and bf16_losses[-1] < bf16_losses[0]
          and all(np.isfinite(bf16_losses)) and bodies_ok and dropout["ok"])
    emit({"phase": "train", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "optimizer": "AdamW lr 1e-4 wd 0.01, ClipGradByGlobalNorm(1.0)",
          "f32_parity": {"B": PARITY_B, "S": PARITY_S, "steps": PARITY_STEPS,
                         "cpu_losses": losses["cpu"],
                         "cuda_losses": losses["cuda"],
                         "max_rel_diff": rel, "rtol": 1e-4,
                         "launches_by_body": f32_bodies, "ok": parity_ok},
          "bf16_O2": {"B": TRAIN_B, "S": TRAIN_S, "warmup_steps": WARMUP_STEPS,
                      "timed_steps": TIMED_STEPS, "step_ms": step_s * 1e3,
                      "tokens_per_s": tokens / step_s,
                      "flops_per_step": flops,
                      "flops_formula": "(6 N + 6 L S d) per token, N = layer "
                                       "+ final-norm params + vocab x hidden",
                      "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS,
                      "peak_memory_allocated_bytes":
                          torch.cuda.max_memory_allocated(),
                      "first_loss": bf16_losses[0], "last_loss": bf16_losses[-1],
                      "losses": bf16_losses, "launches": counts,
                      "launches_by_body": bf16_bodies, "bodies_ok": bodies_ok},
          "attention_dropout": dropout,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("train phase failed: f32 losses differ from the CPU "
                         "run beyond rtol 1e-4, the bf16 loss did not fall, "
                         "a flash call took another body than its dtype's, "
                         "or the attention-dropout check failed")
    return {"launches": counts, "step_ms": step_s * 1e3}


# --------------------------------------------------------------- custom_op
def phase_custom_op():
    """The custom-op + QAT example: ``main`` on the card and on the CPU,
    both from the seeded init (drawn on the CPU), float32.  K6's counter
    is zeroed just before the card run and read just after: one launch per
    step."""
    from paddle_tpu_torch.examples import custom_op_and_quant as example
    from paddle_tpu_torch.ops import bias_gelu as bg

    torch.backends.cuda.matmul.allow_tf32 = False
    steps = 30
    cpu_losses, cpu_scales = example.main("cpu", steps=steps)
    bg.LAUNCHES = 0
    t0 = time.perf_counter()
    losses, scales = example.main("cuda", steps=steps)
    wall = time.perf_counter() - t0
    launches = bg.LAUNCHES
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    keys_ok = set(scales) == set(cpu_scales)
    scale_rel = max(abs(scales[k] - v) / abs(v) for k, v in cpu_scales.items()) \
        if keys_ok else float("inf")
    ok = (launches == steps and loss_rel <= 1e-4 and scale_rel <= 1e-4
          and keys_ok and losses[-1] < losses[0])
    emit({"phase": "custom_op", "ok": ok,
          "example": "paddle_tpu_torch.examples.custom_op_and_quant",
          "steps": steps, "cuda_losses": losses, "cpu_losses": cpu_losses,
          "loss_max_rel_diff": loss_rel, "scales": scales,
          "scale_max_rel_diff": scale_rel, "rtol": 1e-4,
          "bias_gelu_launches": launches, "expected_launches": steps,
          "cuda_wall_s": wall, "nvidia_smi": smi_line()})
    if launches != steps:
        raise SystemExit(f"custom_op phase: K6 launched {launches} times in "
                         f"{steps} steps: the example did not run through it")
    if not ok:
        raise SystemExit("custom_op phase failed: card losses or scales differ "
                         "from the CPU run beyond rtol 1e-4")
    return {"launches": {"bias_gelu": launches}}


# --------------------------------------------------------------------- qat
def _qat_gpt(device):
    """GPT-base from ``torch.manual_seed(0)``, wrapped by ``QAT``."""
    from paddle_tpu_torch.quantization import QAT, QuantConfig
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.manual_seed(0)
    return QAT(QuantConfig()).quantize(GPTForCausalLM(device=device))


def phase_qat(train_step_ms=None):
    """GPT-base through quantization-aware training into int8 serving:

    1. parity: 3 f32 QAT ``TrainStep``s on the card and on a CPU copy
       (the ``train`` phase's optimizer and shape), losses rtol
       ``QAT_RTOL`` and the same ``extract_scales`` keys, beside a CPU
       control run from a rounding-sized perturbation of the init;
    2. deploy: ``convert_to_int8`` both (48 ``Int8Linear``s with static
       activation scales) and serve the slice's first 6 requests in f32
       with ``kv_dtype="int8"``: greedy top-1 agreement >= 0.8 against the
       CPU, first tokens equal, K1 once per layer per prefill, K4 per
       layer per decode step, K3 never;
    3. timed serving: the converted card model in bf16 on the 12 requests,
       in turns with the quant phase's dynamic-scale
       ``weight_dtype="int8"`` run of the seeded GPT-base (static, dynamic,
       dynamic, static), after one warm-up of each;
    4. timed training: 2 warm-up and 10 timed bf16 O2 QAT steps at
       B=8, S=1024, beside the ``train`` phase's plain step."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.quantization import (Int8Linear, convert_to_int8,
                                               extract_scales)
    from paddle_tpu_torch.serving.quant import top1_agreement
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(0)

    # 1. parity, with a control: the CPU run again from the init perturbed
    # by 1e-7 relative (rounding-sized noise), which shows how far the
    # fake-quant rounding ties alone move the losses
    ids = torch.from_numpy(rs.randint(0, VOCAB, (PARITY_B, PARITY_S)))
    cpu_model = _qat_gpt("cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    control = copy.deepcopy(cpu_model)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in control.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    losses = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model),
                       ("cpu_control", control)):
        step, x = _trainer(model), ids.to(model.gpt.word_embeddings.weight.device)
        losses[dev] = [step({"input_ids": x, "labels": x}).item()
                       for _ in range(PARITY_STEPS)]
    del control
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    rel_control = max(abs(a - b) / abs(b)
                      for a, b in zip(losses["cpu_control"], losses["cpu"]))
    scales = {d: extract_scales(m) for d, m in (("cpu", cpu_model),
                                                ("cuda", card_model))}
    keys_ok = (set(scales["cpu"]) == set(scales["cuda"])
               and len(scales["cpu"]) == 8 * LAYERS)
    scale_rel = max(abs(scales["cuda"][k] - v) / abs(v)
                    for k, v in scales["cpu"].items()) if keys_ok else float("inf")
    parity_ok = rel <= QAT_RTOL and keys_ok

    # 2. deploy: static-scale int8 in f32, card against the CPU
    for m in (cpu_model, card_model):
        convert_to_int8(m.eval())
    n_int8 = sum(isinstance(m, Int8Linear) for m in card_model.modules())
    prompts, temps = slice_requests()
    n_par = 6
    greedy = [i for i, t in enumerate(temps[:n_par]) if t == 0.0]
    ref, cpu_wall, _ = _serve(cpu_model, "cpu", prompts[:n_par], temps[:n_par],
                              kv_dtype="int8")
    del cpu_model
    outs32, wall32, st32, counts32 = _counted_run(
        card_model, prompts[:n_par], temps[:n_par], kv_dtype="int8")
    divergence = {i: _first_divergence(outs32[i], ref[i]) for i in greedy}
    first_ok = all(outs32[i][0] == ref[i][0] for i in greedy)
    agree32 = top1_agreement([ref[i] for i in greedy], [outs32[i] for i in greedy])

    # 3. timed serving: static scales (the converted model) against the
    # dynamic-scale int8 weights of the quant phase, bf16, in turns
    static = card_model.to(torch.bfloat16)
    torch.manual_seed(0)
    dynamic = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    runs_of = {"static": (static, {"kv_dtype": "int8"}),
               "dynamic": (dynamic, {"kv_dtype": "int8", "weight_dtype": "int8"})}
    for name, (m, kw) in runs_of.items():            # warm-up (and convert)
        _serve(m, "cuda", prompts[:2], temps[:2], **kw)
    runs = {}
    for name in ("static", "dynamic", "dynamic", "static"):
        m, kw = runs_of[name]
        torch.cuda.reset_peak_memory_stats()
        outs, wall, st, counts = _counted_run(m, prompts, temps, **kw)
        tokens = sum(len(o) for o in outs)
        runs.setdefault(name, []).append({
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefills": st["prefills"], "decode_steps": st["iteration"],
            "launches": counts, "all_complete": all(len(o) == 32 for o in outs),
            "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del static, dynamic, runs_of, card_model
    tps = {k: [r["tokens_per_s"] for r in v] for k, v in runs.items()}
    ratio = sum(tps["static"]) / sum(tps["dynamic"])

    # 4. timed training: bf16 O2 QAT steps at the training shape
    model = _qat_gpt("cuda")
    step = _trainer(model, amp_level="O2")
    x = torch.from_numpy(rs.randint(0, VOCAB, (TRAIN_B, TRAIN_S))).to("cuda")
    batch = {"input_ids": x, "labels": x}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    out = [step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += [step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = {"flash_attention_fwd": fa.LAUNCHES,
                    "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
                    "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
    steps = WARMUP_STEPS + TIMED_STEPS
    if train_counts != dict.fromkeys(train_counts, LAYERS * steps):
        raise SystemExit(f"launch counts {train_counts} != {LAYERS} x {steps} "
                         f"steps: the QAT training path missed the kernels")
    qat_losses = [l.item() for l in out]
    step_ms = wall / TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    bf16_scales_f32 = {str(b.dtype) for b in model.buffers()} == {"torch.float32"}
    del model, step

    complete = all(r["all_complete"] for rs_ in runs.values() for r in rs_) \
        and all(len(o) == 32 for o in outs32)
    ok = (parity_ok and n_int8 == 4 * LAYERS and first_ok and agree32 >= 0.8
          and complete and bf16_scales_f32 and all(np.isfinite(qat_losses))
          and qat_losses[-1] < qat_losses[0])
    emit({"phase": "qat", "ok": ok, "model": "GPT-base 12x768 vocab 50304, "
          "QAT(QuantConfig()): 48 wrapped Linears",
          "optimizer": "AdamW lr 1e-4 wd 0.01, ClipGradByGlobalNorm(1.0)",
          "f32_parity": {"B": PARITY_B, "S": PARITY_S, "steps": PARITY_STEPS,
                         "cpu_losses": losses["cpu"], "cuda_losses": losses["cuda"],
                         "max_rel_diff": rel, "rtol": QAT_RTOL,
                         "cpu_control_losses": losses["cpu_control"],
                         "control_max_rel_diff": rel_control,
                         "control": "the CPU run from the init x (1 + 1e-7 N(0, 1))",
                         "scale_keys": len(scales["cpu"]), "scale_keys_equal": keys_ok,
                         "scale_max_rel_diff": scale_rel, "ok": parity_ok},
          "f32_int8_static_vs_cpu": {
              "int8_linears": n_int8, "requests": n_par, "greedy_requests": greedy,
              "first_divergent_position": divergence,
              "first_tokens_equal": first_ok, "top1_agreement": agree32,
              "gate": "first tokens equal and top-1 agreement >= 0.8",
              "cpu_reference_wall_s": cpu_wall, "card_wall_s": wall32,
              "prefills": st32["prefills"], "decode_steps": st32["iteration"],
              "launches": counts32},
          "bf16_static_int8": runs["static"], "bf16_dynamic_int8": runs["dynamic"],
          "bf16_order": "static, dynamic, dynamic, static",
          "static_over_dynamic_tokens_per_s": ratio,
          "bf16_O2_qat_train": {
              "B": TRAIN_B, "S": TRAIN_S, "warmup_steps": WARMUP_STEPS,
              "timed_steps": TIMED_STEPS, "step_ms": step_ms,
              "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
              "plain_train_step_ms_same_call": train_step_ms,
              "qat_over_plain_step": (step_ms / train_step_ms
                                      if train_step_ms else None),
              "peak_memory_allocated_bytes": peak,
              "scale_buffers_float32": bf16_scales_f32,
              "first_loss": qat_losses[0], "last_loss": qat_losses[-1],
              "launches": train_counts},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit(f"qat phase failed: f32 QAT losses differ from the CPU "
                         f"beyond rtol {QAT_RTOL}, the conversion or the int8 "
                         f"serving check failed, or the QAT loss did not fall")
    return {"launches": counts32}


# ---------------------------------------------------------------- generate
KERNEL_COUNTERS = ("flash_attention_fwd", "paged_flash_decode",
                   "paged_flash_decode_q")
COUNTERS = KERNEL_COUNTERS + ("via_paged_decode_attend",
                              "via_paged_chunk_attend",
                              "via_paged_chunk_attend_quant")


def _zero_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    fa.LAUNCHES = 0
    pa.LAUNCHES = pa.QUANT_LAUNCHES = pa.DECODE_ATTEND_LAUNCHES = 0
    pa.CHUNK_LAUNCHES = pa.QUANT_CHUNK_LAUNCHES = 0


def _read_counts():
    """K1, K3, K4 launches and the K3 / K3 / K4 launches made through
    ``paged_decode_attend`` / ``paged_chunk_attend(_quant)``."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    return dict(zip(COUNTERS, (fa.LAUNCHES, pa.LAUNCHES, pa.QUANT_LAUNCHES,
                               pa.DECODE_ATTEND_LAUNCHES, pa.CHUNK_LAUNCHES,
                               pa.QUANT_CHUNK_LAUNCHES)))


def _gen_ids(b, s, seed, vocab=VOCAB):
    return torch.from_numpy(np.random.RandomState(seed).randint(1, vocab,
                                                                (b, s)))


def _gen_want(kind, n, layers=LAYERS):
    """Launches a generate() call of ``n`` new tokens must make: the paged
    cache runs K1 once per layer (prefill) and K3 through
    ``paged_decode_attend`` once per layer per decode step; the dense cache
    runs no kernel (masked plain attention, as in the TPU package); the
    no-cache loop and beam search run K1 once per layer per forward."""
    want = dict.fromkeys(COUNTERS, 0)
    if kind == "paged":
        want["flash_attention_fwd"] = layers
        want["paged_flash_decode"] = want["via_paged_decode_attend"] = \
            layers * (n - 1)
    elif kind in ("no_cache", "beam"):
        want["flash_attention_fwd"] = layers * n
    return want


def phase_generate():
    """GPT-base through ``model.generate()``: float32 on the card against
    the same model on the CPU, greedy ids equal for the dense and paged
    caches (B=4, prompts of 64 and 256 tokens, 32 new tokens; dense equal
    to paged too), ``use_cache=False`` (B=1, 8 tokens) and beam search (B=1,
    4 beams, a prompt of 32, 8 tokens), each call's launches checked; then
    bf16 at B=8, prompts of 512, 128 new tokens, dense and paged in turns
    (dense, paged, paged, dense) after an untimed warm-up: tokens/s, peak
    memory and launches."""
    from paddle_tpu_torch.serving.quant import top1_agreement
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    model = copy.deepcopy(cpu_model).to("cuda")
    cases, outs = [], {}
    for kind, S, B, n, kw in (
            ("dense", 64, GEN_B, GEN_NEW, {}),
            ("paged", 64, GEN_B, GEN_NEW, dict(cache_impl="paged",
                                               page_size=PAGE)),
            ("dense", 256, GEN_B, GEN_NEW, {}),
            ("paged", 256, GEN_B, GEN_NEW, dict(cache_impl="paged",
                                                page_size=PAGE)),
            ("no_cache", 64, 1, 8, dict(use_cache=False)),
            ("beam", 32, 1, 8, dict(decode_strategy="beam_search",
                                    num_beams=4))):
        ids = _gen_ids(B, S, S + B)
        _zero_counts()
        got = model.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        counts = _read_counts()
        got = got.cpu()
        t0 = time.perf_counter()
        want = cpu_model.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        outs[(kind, S)] = got
        cases.append({
            "case": kind, "B": B, "prompt": S, "new_tokens": n,
            "equal_cpu": torch.equal(got, want),
            "first_divergence": [_first_divergence(a.tolist(), b.tolist())
                                 for a, b in zip(got, want)],
            "launches": counts, "launches_ok": counts == _gen_want(kind, n),
            "cpu_s": time.perf_counter() - t0})
    dense_eq_paged = all(torch.equal(outs[("dense", S)], outs[("paged", S)])
                         for S in (64, 256))
    del cpu_model

    model = model.to(torch.bfloat16)
    ids = _gen_ids(GEN_BF16_B, GEN_BF16_S, 7)
    for impl in ("dense", "paged"):       # untimed warm-up
        model.generate(ids[:, :64], max_new_tokens=4, temperature=0.0,
                       cache_impl=impl, page_size=PAGE)
    runs = {}
    for impl in ("dense", "paged", "paged", "dense"):
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_BF16_NEW, temperature=0.0,
                             cache_impl=impl, page_size=PAGE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        tokens = GEN_BF16_B * GEN_BF16_NEW
        runs.setdefault(impl, []).append({
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts,
            "launches_ok": counts == _gen_want(impl, GEN_BF16_NEW),
            "out": out[:, GEN_BF16_S:].cpu()})
    agree = top1_agreement(runs["dense"][0]["out"].tolist(),
                           runs["paged"][0]["out"].tolist())
    for rs in runs.values():
        for r in rs:
            del r["out"]
    ok = (all(c["equal_cpu"] and c["launches_ok"] for c in cases)
          and dense_eq_paged
          and all(r["launches_ok"] for rs in runs.values() for r in rs))
    emit({"phase": "generate", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "f32_vs_cpu": cases, "f32_dense_equal_paged": dense_eq_paged,
          "bf16": {"B": GEN_BF16_B, "prompt": GEN_BF16_S,
                   "new_tokens": GEN_BF16_NEW, "order": "dense, paged, paged, "
                   "dense", "dense": runs["dense"], "paged": runs["paged"],
                   "top1_agreement_dense_paged": agree,
                   "agreement_gated": False},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("generate phase failed: greedy ids differ from the "
                         "CPU, dense differs from paged, or the launch counts "
                         "show a path that did not run through its kernels")
    # the kernels line counts the first timed run of each cache
    return {"launches": {k: runs["dense"][0]["launches"][k]
                         + runs["paged"][0]["launches"][k]
                         for k in KERNEL_COUNTERS}}


# -------------------------------------------------------------------- spec
def spec_requests():
    """Six prompts of 64-384 tokens, each repeating its own 16-token motif
    (random ids from a seed), so the drafter finds matches."""
    rs = np.random.RandomState(1)
    return [rs.randint(1, VOCAB, 16).tolist() * (n // 16)
            for n in (64, 96, 128, 192, 256, 384)]


def chunk_requests():
    """Six prompts of 17-900 tokens (random ids from a seed); five are
    longer than one chunk of ``CHUNK_TOKENS``."""
    rs = np.random.RandomState(2)
    return [rs.randint(1, VOCAB, size=n).tolist()
            for n in np.linspace(17, 900, 6).astype(int)]


def _counted_spec_run(model, prompts, **engine_kw):
    """``_serve`` on the card (greedy) with every counter zeroed just
    before and read just after: K1 once per layer per monolithic prefill;
    the chunk attend (K3, or K4 over int8 pools) once per layer per verify
    step and per prefill chunk; the decode kernel of the pool layout once
    per layer per decode step (plain or verify) and per chunk; nothing
    else."""
    _zero_counts()
    outs, wall, st = _serve(model, "cuda", prompts, [0.0] * len(prompts),
                            **engine_kw)
    counts = _read_counts()
    chunk = engine_kw.get("prefill_chunk_tokens")
    n_chunked = sum(1 for p in prompts if chunk and len(p) > chunk)
    quant = st["kv_dtype"] == "int8"
    decode = "paged_flash_decode_q" if quant else "paged_flash_decode"
    via = "via_paged_chunk_attend_quant" if quant else "via_paged_chunk_attend"
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = LAYERS * (st["prefills"] - n_chunked)
    want[via] = LAYERS * (st["verify_steps"] + st["prefill_chunks"])
    want[decode] = LAYERS * (st["iteration"] + st["prefill_chunks"])
    if counts != want or not counts[via]:
        raise SystemExit(f"launch counts {counts} != expected {want}: the "
                         f"speculative / chunked path did not run through "
                         f"the chunk attend's kernel")
    return outs, wall, st, counts


def _ttft_summary(st):
    """Time to first token of the first request (the long prompt) and of
    the short ones queued behind it."""
    t = st["ttft_s"]
    return {"long_ttft_s": t[0], "short_ttft_mean_s": float(np.mean(t[1:])),
            "short_ttft_max_s": max(t[1:])}


def phase_spec():
    """GPT-base through ``ServingEngine(num_slots=8, page_size=16,
    max_model_len=1024)`` with ``speculative_k=4`` (six greedy requests
    whose prompts repeat a 16-token motif) and, separately, with
    ``prefill_chunk_tokens=128`` (six prompts of 17-900 tokens), 32 new
    tokens each:

    1. float32 on the card, native pools: the ids must equal the plain
       card engine's and the CPU engine's with the same arguments; with
       ``kv_dtype="int8"``, against the CPU int8 engine with the same
       arguments: first tokens equal and greedy top-1 agreement >= 0.8.
       Every run's launches checked (``_counted_spec_run``).
    2. bf16, after an untimed warm-up, in turns (plain, spec, spec, plain)
       on the speculative requests: tokens/s and the acceptance rate.
    3. bf16 time to first token of seven short requests (17-120 tokens)
       queued behind a 900-token prompt, without and with chunked prefill
       in turns (plain, chunked, chunked, plain)."""
    from paddle_tpu_torch.serving.quant import top1_agreement
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    model = copy.deepcopy(cpu_model).to("cuda")
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)   # the f32 card runs
    f32, ok = {}, True
    for label, prompts, kw in (
            ("spec", spec_requests(), {"speculative_k": SPEC_K}),
            ("chunk", chunk_requests(),
             {"prefill_chunk_tokens": CHUNK_TOKENS})):
        zeros = [0.0] * len(prompts)
        plain, _, _ = _serve(model, "cuda", prompts, zeros)
        for kv in ("native", "int8"):
            got, wall, st, counts = _counted_spec_run(model, prompts,
                                                      kv_dtype=kv, **kw)
            for k in KERNEL_COUNTERS:
                launches[k] += counts[k]
            ref, cpu_wall, cpu_st = _serve(cpu_model, "cpu", prompts, zeros,
                                           kv_dtype=kv, **kw)
            agree = top1_agreement(ref, got)
            case = {"prompt_lens": [len(p) for p in prompts],
                    "card_wall_s": wall, "cpu_wall_s": cpu_wall,
                    "equal_cpu": got == ref, "equal_plain_card": got == plain,
                    "first_tokens_equal": [g[0] for g in got]
                    == [r[0] for r in ref],
                    "top1_agreement_cpu": agree,
                    "first_divergence_cpu": [_first_divergence(g, r)
                                             for g, r in zip(got, ref)],
                    "decode_steps": st["iteration"],
                    "verify_steps": st["verify_steps"],
                    "prefill_chunks": st["prefill_chunks"],
                    "spec_proposed": st["spec_proposed"],
                    "spec_accepted": st["spec_accepted"],
                    "cpu_spec_accepted": cpu_st["spec_accepted"],
                    "launches": counts}
            if kv == "native":
                case["gate"] = "ids equal the CPU engine's and the plain card engine's"
                case["ok"] = case["equal_cpu"] and case["equal_plain_card"]
            else:
                case["gate"] = "first tokens equal and top-1 agreement >= 0.8 (CPU int8)"
                case["ok"] = case["first_tokens_equal"] and agree >= 0.8
            ok = ok and case["ok"]
            f32[f"{label}_{kv}"] = case
    del cpu_model

    model = model.to(torch.bfloat16)
    prompts = spec_requests()
    zeros = [0.0] * len(prompts)
    for kw in ({}, {"speculative_k": SPEC_K}):      # untimed warm-up
        _serve(model, "cuda", prompts[:2], zeros[:2], **kw)
    timed = {}
    for mode in ("plain", "spec", "spec", "plain"):
        kw = {"speculative_k": SPEC_K} if mode == "spec" else {}
        outs, wall, st = _serve(model, "cuda", prompts, zeros, **kw)
        tokens = sum(len(o) for o in outs)
        timed.setdefault(mode, []).append({
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "decode_steps": st["iteration"], "verify_steps": st["verify_steps"],
            "spec_proposed": st["spec_proposed"],
            "spec_accepted": st["spec_accepted"],
            "acceptance_rate": (st["spec_accepted"] / st["spec_proposed"]
                                if st["spec_proposed"] else None),
            "outs": outs})
    bf16_agree = top1_agreement(timed["plain"][0]["outs"],
                                timed["spec"][0]["outs"])
    bf16_equal = sum(a == b for a, b in zip(timed["plain"][0]["outs"],
                                            timed["spec"][0]["outs"]))
    for rs in timed.values():
        for r in rs:
            del r["outs"]

    rs = np.random.RandomState(3)
    ttft_prompts = [chunk_requests()[-1]] + [
        rs.randint(1, VOCAB, size=n).tolist()
        for n in np.linspace(17, 120, SLOTS - 1).astype(int)]
    zeros = [0.0] * len(ttft_prompts)
    _serve(model, "cuda", ttft_prompts[:2], zeros[:2],      # warm-up
           prefill_chunk_tokens=CHUNK_TOKENS)
    ttft = {}
    for mode in ("plain", "chunked", "chunked", "plain"):
        if mode == "chunked":
            outs, wall, st, counts = _counted_spec_run(
                model, ttft_prompts, prefill_chunk_tokens=CHUNK_TOKENS)
        else:
            outs, wall, st, counts = _counted_run(model, ttft_prompts, zeros)
        ttft.setdefault(mode, []).append({
            "wall_s": wall, **_ttft_summary(st),
            "prefill_chunks": st["prefill_chunks"], "launches": counts})
    ok = ok and all(len(o) == 32 for o in outs)
    emit({"phase": "spec", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "engine": {"num_slots": SLOTS, "page_size": PAGE,
                     "max_model_len": MAXLEN, "speculative_k": SPEC_K,
                     "prefill_chunk_tokens": CHUNK_TOKENS},
          "max_new_tokens": 32, "f32": f32,
          "bf16_spec": {"order": "plain, spec, spec, plain", **timed,
                        "top1_agreement_spec_vs_plain": bf16_agree,
                        "requests_equal_spec_vs_plain": bf16_equal,
                        "agreement_gated": False},
          "bf16_ttft_behind_900_tokens": {
              "prompt_lens": [len(p) for p in ttft_prompts],
              "order": "plain, chunked, chunked, plain", **ttft},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("spec phase failed: speculative or chunked ids differ "
                         "from the CPU engine or the plain card engine "
                         "(native), or miss the int8 rule")
    return {"launches": launches}


# ------------------------------------------------------------------ prefix
# the reference's shared-prefix traffic and engine (bench.py
# _zipf_prefix_workload, _measure_serving_prefix)
PFX_REQUESTS, PFX_GROUPS, PFX_ZIPF_S, PFX_ONEOFF = 24, 4, 1.2, 0.2
PFX_S0, PFX_PAGE, PFX_SLOTS, PFX_PAGES, PFX_NEW = 512, 32, 4, 72, 16
PFX_MAXLEN = PFX_S0 + PFX_NEW
PFX_CPU_REQUESTS = 8        # the CPU references serve the first 8
PFX_ARMS = {"lru": {"prefix_sharing": True},
            "radix": {"prefix_cache": "radix"},
            "radix_spill": {"prefix_cache": "radix", "kv_spill": True}}


def prefix_requests():
    """24 prompts of 512 tokens: 4 shared prefixes of 480 tokens with
    Zipf(1.2) popularity, each followed by a fresh 32-token tail, and 20%
    one-off prompts of 512 fresh tokens (ids 1-499, seed 0)."""
    rs = np.random.RandomState(0)
    shared_len = (PFX_S0 // PFX_PAGE - 1) * PFX_PAGE
    tail = PFX_S0 - shared_len
    pz = 1.0 / np.arange(1, PFX_GROUPS + 1, dtype="float64") ** PFX_ZIPF_S
    pz /= pz.sum()
    shared = [rs.randint(1, 500, (shared_len,)) for _ in range(PFX_GROUPS)]
    groups = rs.choice(PFX_GROUPS, size=PFX_REQUESTS, p=pz)
    oneoff = rs.rand(PFX_REQUESTS) < PFX_ONEOFF
    return [rs.randint(1, 500, (PFX_S0,)).tolist() if oneoff[i] else
            np.concatenate([shared[g], rs.randint(1, 500, (tail,))]).tolist()
            for i, g in enumerate(groups)]


def _prefix_serve(model, device, prompts, **engine_kw):
    """Serve ``prompts`` in waves of ``PFX_SLOTS`` (each wave drained
    before the next, so shared prefixes go idle between waves and one-off
    prompts can evict them), 16 greedy tokens each; returns the ids, the
    wall seconds, the stats, the prefix-cache counters after each wave
    and the requests' TTFTs."""
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, device=device, num_slots=PFX_SLOTS,
                        page_size=PFX_PAGE, max_model_len=PFX_MAXLEN,
                        num_pages=PFX_PAGES, **engine_kw)
    ids, ttft, waves = [], [], {}
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eng:
        for w in range(0, len(prompts), PFX_SLOTS):
            hs = [eng.submit(p, max_new_tokens=PFX_NEW)
                  for p in prompts[w:w + PFX_SLOTS]]
            ids += [h.result(timeout=900) for h in hs]
            ttft += [h.ttft for h in hs]
            waves[w + len(hs)] = copy.deepcopy(eng.stats()["prefix_cache"])
        st = eng.stats()
    if device != "cpu":
        torch.cuda.synchronize()
    return ids, time.perf_counter() - t0, st, waves, ttft


def _prefix_want(st, quant):
    """Launches a prefix-cache run must make: K1 once per layer per full
    prefill; the pool layout's decode kernel once per layer per decode
    step and per cached prefill, the latter through the chunk attend."""
    decode = "paged_flash_decode_q" if quant else "paged_flash_decode"
    via = "via_paged_chunk_attend_quant" if quant else "via_paged_chunk_attend"
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = LAYERS * (st["prefills"]
                                            - st["cached_prefills"])
    want[decode] = LAYERS * (st["iteration"] + st["cached_prefills"])
    want[via] = LAYERS * st["cached_prefills"]
    return want


def phase_prefix():
    """GPT-base through the hierarchical KV cache on the reference's
    Zipfian shared-prefix traffic (``prefix_requests``) with its engine
    (``num_slots=4``, page 32, ``max_model_len=528``, ``num_pages=72``,
    undersized so idle prefixes are evicted), three arms: ``lru`` (exact-
    key sharing), ``radix`` (partial-prefix hits prefill only the tail:
    one chunk dispatch, K3 through ``paged_chunk_attend``) and
    ``radix_spill`` (plus the host tier).

    1. float32 on the card: ids equal across the three arms, and equal the
       CPU ``lru`` engine's on the first 8 requests; the radix arm's
       ``saved_tokens`` after those 8 equal the CPU radix engine's;
       ``radix_spill`` spills and resurrects; each arm's launches checked
       (``_prefix_want``).  ``kv_dtype="int8"`` ``radix_spill`` against
       the CPU int8 engine on the first 8 requests: first tokens equal and
       top-1 agreement >= 0.8, K4 through ``paged_chunk_attend_quant``.
    2. bf16, after an untimed warm-up, the three arms in turns (lru,
       radix, radix_spill, radix_spill, radix, lru): TTFT p50 and
       tokens/s.
    3. K3 and K4 at the cached-tail shape (one slot, a 32-row tail behind
       480 cached tokens, page 32) against their plain versions."""
    from paddle_tpu_torch.serving.quant import top1_agreement
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts = prefix_requests()
    n_cpu = PFX_CPU_REQUESTS
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    model = copy.deepcopy(cpu_model).to("cuda")
    launches = dict.fromkeys(KERNEL_COUNTERS, 0)   # the f32 card runs
    f32, ok = {}, True
    for arm, kw in PFX_ARMS.items():
        _zero_counts()
        ids, wall, st, waves, _ = _prefix_serve(model, "cuda", prompts, **kw)
        counts = _read_counts()
        for k in KERNEL_COUNTERS:
            launches[k] += counts[k]
        pc = st["prefix_cache"]
        f32[arm] = {"ids": ids, "wall_s": wall, "prefills": st["prefills"],
                    "cached_prefills": st["cached_prefills"],
                    "decode_steps": st["iteration"],
                    "prefix_cache": {k: v for k, v in pc.items()
                                     if k != "index"},
                    "saved_tokens_first_8": waves[n_cpu]["saved_tokens"],
                    "launches": counts,
                    "launches_ok": counts == _prefix_want(st, False)}
        ok = ok and f32[arm]["launches_ok"]
    t0 = time.perf_counter()
    cpu_lru, _, _, _, _ = _prefix_serve(cpu_model, "cpu", prompts[:n_cpu],
                                        **PFX_ARMS["lru"])
    cpu_radix, _, cpu_st, _, _ = _prefix_serve(
        cpu_model, "cpu", prompts[:n_cpu], **PFX_ARMS["radix"])
    cpu_s = time.perf_counter() - t0
    ids = {arm: r.pop("ids") for arm, r in f32.items()}
    spill = f32["radix_spill"]["prefix_cache"]
    checks = {
        "arms_equal": ids["lru"] == ids["radix"] == ids["radix_spill"],
        "equal_cpu_lru_first_8": ids["lru"][:n_cpu] == cpu_lru,
        "cpu_radix_equal_cpu_lru": cpu_radix == cpu_lru,
        "saved_tokens_first_8_equal_cpu_radix":
            f32["radix"]["saved_tokens_first_8"]
            == cpu_st["prefix_cache"]["saved_tokens"],
        "cpu_radix_saved_tokens": cpu_st["prefix_cache"]["saved_tokens"],
        "spills_and_resurrections":
            spill["spill"]["spills"] > 0 and spill["resurrections"] > 0,
        "cached_prefills": f32["radix"]["cached_prefills"] > 0}
    ok = ok and all(v for k, v in checks.items()
                    if k != "cpu_radix_saved_tokens")

    # int8 pools, radix + spill, against the CPU int8 engine
    _zero_counts()
    got8, wall8, st8, _, _ = _prefix_serve(model, "cuda", prompts,
                                           kv_dtype="int8",
                                           **PFX_ARMS["radix_spill"])
    counts8 = _read_counts()
    for k in KERNEL_COUNTERS:
        launches[k] += counts8[k]
    t0 = time.perf_counter()
    ref8, _, _, _, _ = _prefix_serve(cpu_model, "cpu", prompts[:n_cpu],
                                     kv_dtype="int8",
                                     **PFX_ARMS["radix_spill"])
    cpu_s += time.perf_counter() - t0
    int8 = {"wall_s": wall8, "cached_prefills": st8["cached_prefills"],
            "prefix_cache": {k: v for k, v in st8["prefix_cache"].items()
                             if k != "index"},
            "first_tokens_equal_cpu": [g[0] for g in got8[:n_cpu]]
            == [r[0] for r in ref8],
            "top1_agreement_cpu": top1_agreement(ref8, got8[:n_cpu]),
            "first_divergence_cpu": [_first_divergence(g, r)
                                     for g, r in zip(got8, ref8)],
            "launches": counts8,
            "launches_ok": counts8 == _prefix_want(st8, True),
            "gate": "first tokens equal and top-1 agreement >= 0.8 (CPU int8)"}
    ok = ok and int8["first_tokens_equal_cpu"] \
        and int8["top1_agreement_cpu"] >= 0.8 and int8["launches_ok"] \
        and st8["cached_prefills"] > 0
    del cpu_model

    model = model.to(torch.bfloat16)
    _prefix_serve(model, "cuda", prompts[:PFX_SLOTS],       # warm-up
                  **PFX_ARMS["radix_spill"])
    timed = {}
    for arm in ("lru", "radix", "radix_spill", "radix_spill", "radix", "lru"):
        outs, wall, st, _, ttft = _prefix_serve(model, "cuda", prompts,
                                                **PFX_ARMS[arm])
        tokens = sum(len(o) for o in outs)
        timed.setdefault(arm, []).append({
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)),
            "ttft_p90_s": float(np.percentile(ttft, 90)),
            "cached_prefills": st["cached_prefills"],
            "saved_tokens": st["prefix_cache"]["saved_tokens"],
            "outs": outs})
    bf16_equal = [sum(a == b for a, b in zip(timed["lru"][0]["outs"],
                                             timed[arm][0]["outs"]))
                  for arm in ("radix", "radix_spill")]
    for rs in timed.values():
        for r in rs:
            del r["outs"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tail = _chunk_timed(gen, None, cases=(
        ("k3_cached_tail", [PFX_S0 - PFX_PAGE], PFX_PAGE, False, PFX_PAGE,
         -(-PFX_MAXLEN // PFX_PAGE)),
        ("k4_cached_tail", [PFX_S0 - PFX_PAGE], PFX_PAGE, True, PFX_PAGE,
         -(-PFX_MAXLEN // PFX_PAGE))))
    ok = ok and all(c["ok"] for c in tail.values())
    emit({"phase": "prefix", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "engine": {"num_slots": PFX_SLOTS, "page_size": PFX_PAGE,
                     "max_model_len": PFX_MAXLEN, "num_pages": PFX_PAGES,
                     "max_new_tokens": PFX_NEW},
          "traffic": {"requests": PFX_REQUESTS, "groups": PFX_GROUPS,
                      "zipf_s": PFX_ZIPF_S, "oneoff_frac": PFX_ONEOFF,
                      "prompt_tokens": PFX_S0, "seed": 0},
          "f32": f32, "f32_checks": checks, "cpu_reference_s": cpu_s,
          "int8_radix_spill": int8,
          "bf16": {"order": "lru, radix, radix_spill, radix_spill, radix, "
                   "lru", **timed,
                   "requests_equal_lru_radix_radix_spill": bf16_equal,
                   "agreement_gated": False},
          "cached_tail_timed": tail, "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("prefix phase failed: the arms' f32 ids differ from "
                         "each other or the CPU, saved tokens differ from the "
                         "CPU radix engine, the spill tier never resurrected, "
                         "int8 misses its rule, a cached-tail kernel "
                         "disagrees, or the launches show a path that did "
                         "not run through its kernels")
    return {"launches": launches, "cached_tail": tail}


# -------------------------------------------------------------- resilience
def _held_submit(eng, faults, reqs, arm=None):
    """Submit ``reqs`` [(prompt, new tokens, kwargs)] while the scheduler
    sits in a ``serving.scheduler_wedge`` (so one admission pass sees them
    all), call ``arm()`` (a fault), then release it."""
    site = f"serving.scheduler_wedge@{eng.replica}"
    faults.inject(site, seconds=60.0, times=1)
    t0 = time.monotonic()
    while faults.trip_count(site) < 1:
        if time.monotonic() - t0 > 60:
            raise SystemExit("resilience phase: the scheduler never reached "
                             "its wedge site")
        time.sleep(0.005)
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    if arm is not None:
        arm()
    faults.clear(site)
    return hs


def _step_syncs(model, prompts, guard, tag="syncs", **engine_kw):
    """Host syncs of ONE plain decode step of two slots, counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: the step is run from this
    thread while the scheduler sits in a wedge, after one uncounted step
    (a thread's first CUDA work syncs once more, setting up its
    handles)."""
    import warnings

    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=2, page_size=PAGE,
                        max_model_len=MAXLEN, numeric_guard=guard,
                        replica=f"{tag}-{int(guard)}", **engine_kw)
    with eng:
        eng.generate(prompts[0][:32], max_new_tokens=2, timeout=300)
        site = f"serving.scheduler_wedge@{eng.replica}"
        faults.inject(site, seconds=60.0, times=1)
        while faults.trip_count(site) < 1:
            time.sleep(0.005)
        hs = [eng.submit(p, max_new_tokens=4) for p in prompts[:2]]
        with torch.inference_mode():
            eng._admit()
            active = [i for i, s in enumerate(eng._slots) if s is not None]
            eng._plain_step(active)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng._plain_step(active)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        faults.clear(site)
        for h in hs:
            h.result(timeout=300)
    sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in rec
             if "called a synchronizing CUDA operation" in str(w.message)]
    return {"active": len(active), "syncs": len(sites), "sites": sites,
            "other_warnings": [str(w.message)[:120] for w in rec
                               if "called a synchronizing" not in
                               str(w.message)]}


def phase_resilience():
    """GPT-base float32 on the card through the engine's robustness paths,
    each against an uninterrupted card run of the same requests (greedy,
    prompts of 100-300 tokens):

    - restart: a ``TransientError`` from ``serving.step_crash`` at the
      4th decode step with 2 requests in flight (admitted together, held
      at a wedge): ids equal, one restart, 2 requeues, the rebuilt pools
      on the card, launches checked (K1 per layer per prefill,
      re-admissions included; K3 per layer per decode step);
    - fatal: a ``ValueError`` at the first step fails the request and the
      engine rejects new submits;
    - numeric guard: a NaN injected into decode lane 0: only that request
      fails (NumericFault), the other's ids equal the unguarded run's;
    - QoS: two ``batch`` requests fill ``num_slots=2``, a ``realtime`` one
      preempts one of them; every request's ids equal;
    - wedge: a 2 s ``serving.scheduler_wedge`` with ``max_queue=2`` and a
      0.5 s watchdog: submits shed ``deadline_unmeetable`` and
      ``queue_full``, health reads degraded, then healthy, and the
      watchdog fires once;
    - the host syncs of one decode step, numeric guard off and on."""
    from paddle_tpu_torch.observability import faults, numerics
    from paddle_tpu_torch.resilience import NumericFault, TransientError
    from paddle_tpu_torch.serving import (RequestRejectedError,
                                          ServingEngine)
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda")           # GPT-base defaults
    rs = np.random.RandomState(4)
    P = [rs.randint(1, VOCAB, size=n).tolist() for n in (100, 200, 300)]
    N = 24

    def engine(**kw):
        kw.setdefault("num_slots", 2)
        return ServingEngine(model, page_size=PAGE, max_model_len=MAXLEN,
                             **kw)

    with engine(replica="ref") as eng:
        ref = [eng.generate(p, max_new_tokens=n, timeout=300)
               for p, n in ((P[0], N), (P[1], N), (P[0], 2 * N),
                            (P[1], 2 * N), (P[2], 8))]
    out, ok = {}, True

    def boom():
        raise TransientError("injected decode crash")

    eng = engine(replica="restart")
    with eng:
        eng.generate(P[2][:32], max_new_tokens=2, timeout=300)
        st0 = eng.stats()
        _zero_counts()
        hs = _held_submit(eng, faults, [(P[0], N, {}), (P[1], N, {})],
                          arm=lambda: faults.inject("serving.step_crash",
                                                    fn=boom, at_trips={4}))
        got = [h.result(timeout=300) for h in hs]
        counts = _read_counts()
        faults.clear()
        st = eng.stats()
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_attention_fwd"] = LAYERS * (st["prefills"]
                                                - st0["prefills"])
        want["paged_flash_decode"] = LAYERS * (st["iteration"]
                                               - st0["iteration"])
        out["restart"] = {
            "equal_uninterrupted": got == ref[:2],
            "engine_restarts": st["engine_restarts"],
            "requests_requeued": st["requests_requeued"],
            "pools_on_card": all(p.device.type == "cuda" for p in eng._pools),
            "launches": counts, "launches_ok": counts == want}
    r = out["restart"]
    ok = ok and r["equal_uninterrupted"] and r["engine_restarts"] == 1 \
        and r["requests_requeued"] == 2 and r["pools_on_card"] \
        and r["launches_ok"]

    eng = engine(replica="fatal")
    with eng:
        eng.generate(P[2][:32], max_new_tokens=2, timeout=300)

        def bug():
            raise ValueError("a real scheduler bug")

        faults.inject("serving.step_crash", fn=bug, at_trips={1})
        h = eng.submit(P[0], max_new_tokens=N)
        try:
            h.result(timeout=300)
            raised = False
        except RuntimeError:
            raised = True
        faults.clear()
        health = eng.health
    try:
        eng.submit(P[0], max_new_tokens=2)
        rejects = False
    except RuntimeError:
        rejects = True
    out["fatal"] = {"request_failed": raised, "status": h.status,
                    "health": health, "rejects_submits": rejects,
                    "engine_restarts": eng.stats()["engine_restarts"]}
    ok = ok and raised and h.status == "error" and health == "error" \
        and rejects and out["fatal"]["engine_restarts"] == 0

    eng = engine(replica="guard", numeric_guard=True)
    with eng:
        eng.generate(P[2][:32], max_new_tokens=2, timeout=300)
        numerics.set_nan_inject_row(0)
        h0 = eng.submit(P[0], max_new_tokens=N)
        h1 = eng.submit(P[1], max_new_tokens=N)
        it0, it1 = h0.stream(), h1.stream()
        next(it0)
        next(it1)
        faults.inject("numerics.nan_inject", times=1)
        try:
            h0.result(timeout=300)
            fault = None
        except NumericFault as e:
            fault = e.site
        other = h1.result(timeout=300)
        faults.clear()
        out["numeric_guard"] = {
            "poisoned_status": h0.status, "fault_site": fault,
            "other_status": h1.status, "other_equal_unguarded": other == ref[1],
            "numeric_faults": eng.stats()["numeric_faults"]}
    g = out["numeric_guard"]
    ok = ok and g["poisoned_status"] == "error" and g["fault_site"] == "logits" \
        and g["other_status"] == "completed" and g["other_equal_unguarded"] \
        and g["numeric_faults"] == 1

    eng = engine(replica="qos", qos=True)
    with eng:
        b1 = eng.submit(P[0], max_new_tokens=2 * N, tier="batch")
        b2 = eng.submit(P[1], max_new_tokens=2 * N, tier="batch")
        t0 = time.monotonic()
        while sum(s is not None for s in eng._slots) < 2:
            if time.monotonic() - t0 > 60:
                raise SystemExit("resilience phase: slots never filled")
            time.sleep(0.002)
        rt = eng.submit(P[2], max_new_tokens=8, tier="realtime")
        got = [rt.result(timeout=300), b1.result(timeout=300),
               b2.result(timeout=300)]
        out["qos"] = {"equal_uninterrupted": got == [ref[4], ref[2], ref[3]],
                      "preemptions": [rt.preemptions, b1.preemptions,
                                      b2.preemptions],
                      "stats_preemptions": eng.stats()["preemptions"]}
    q = out["qos"]
    ok = ok and q["equal_uninterrupted"] and sum(q["preemptions"]) == 1 \
        and q["preemptions"][0] == 0

    eng = engine(replica="wedge", num_slots=1, max_queue=2,
                 degraded_stall_s=0.2, watchdog_s=0.5)
    with eng:
        eng.generate(P[2][:32], max_new_tokens=2, timeout=300)
        healthy0 = eng.health
        faults.inject("serving.scheduler_wedge", seconds=2.0, times=1)
        t0 = time.monotonic()
        while time.monotonic() - eng._progress_t < 0.6:
            if time.monotonic() - t0 > 60:
                raise SystemExit("resilience phase: the wedge never held")
            time.sleep(0.005)
        reasons = []
        h1 = eng.submit(P[0][:64], max_new_tokens=4)
        for kw in ({"deadline_s": 0.05}, None, {}):
            if kw is None:
                h2 = eng.submit(P[1][:64], max_new_tokens=4)
                continue
            try:
                eng.submit(P[2][:64], max_new_tokens=4, **kw)
                reasons.append(None)
            except RequestRejectedError as e:
                reasons.append(e.reason)
        during = eng.health_state()
        done = [len(h1.result(timeout=300)), len(h2.result(timeout=300))]
        t0 = time.monotonic()
        while eng.health != "healthy" and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        faults.clear()
        out["wedge"] = {"healthy_before": healthy0 == "healthy",
                        "shed": reasons, "during": during,
                        "completed_after": done, "health_after": eng.health,
                        "load_shed": eng.stats()["load_shed"],
                        "watchdog_fires": len(eng.watchdog.fired),
                        "watchdog_age_s": [f["age_s"]
                                           for f in eng.watchdog.fired]}
    w = out["wedge"]
    ok = ok and w["healthy_before"] \
        and w["shed"] == ["deadline_unmeetable", "queue_full"] \
        and w["during"]["state"] == "degraded" and w["completed_after"] == [4, 4] \
        and w["health_after"] == "healthy" and w["watchdog_fires"] == 1

    out["step_syncs"] = {"guard_off": _step_syncs(model, P, False),
                         "guard_on": _step_syncs(model, P, True)}
    s = out["step_syncs"]
    ok = ok and s["guard_on"]["syncs"] == s["guard_off"]["syncs"] \
        and s["guard_off"]["active"] == 2
    emit({"phase": "resilience", "ok": ok,
          "model": "GPT-base 12x768 vocab 50304, float32",
          "engine": {"num_slots": 2, "page_size": PAGE,
                     "max_model_len": MAXLEN},
          "prompt_lens": [len(p) for p in P], **out,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("resilience phase failed: see the restart / fatal / "
                         "numeric_guard / qos / wedge / step_syncs results")
    return {"launches": {k: r["launches"][k] for k in KERNEL_COUNTERS}}


# ----------------------------------------------------------------- observe
def _scrape(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _observed_run(model, prompts, temps, replica, on, flight_dir,
                  scrape=False, **engine_kw):
    """Serve ``prompts`` (32 new tokens each) with the observability sinks
    on — a span ``Tracer``, the flight recorder, telemetry on an ephemeral
    port, the numeric guard's numerics stream — or off (the metrics
    registry counts either way); the kernel counters zeroed just before
    and read just after.  The wall runs from the engine's start to the
    last token.  ``scrape``: GET /metrics, /healthz and /statusz
    over localhost while the requests run.  Returns the run's record and
    the (stopped) engine."""
    from paddle_tpu_torch.observability import flight_recorder, tracing
    from paddle_tpu_torch.serving import ServingEngine

    tr = None
    if on:
        tr = tracing.Tracer().start()
        flight_recorder.enable(dir=flight_dir)
        engine_kw.update(telemetry_port=0, numeric_guard=True)
    eng = ServingEngine(model, num_slots=SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN, replica=replica, **engine_kw)
    scrapes = None
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with eng:
            hs = [eng.submit(p, max_new_tokens=32, temperature=t)
                  for p, t in zip(prompts, temps)]
            if scrape:
                srv = eng.telemetry
                if srv is None:
                    raise SystemExit("observe phase: the telemetry server "
                                     "did not start")
                scrapes = {path: _scrape(srv.url + path)
                           for path in ("/metrics", "/healthz", "/statusz")}
                scrapes["while_running"] = sum(not h.done for h in hs)
            outs = [h.result(timeout=900) for h in hs]
            # the serving wall ends with the last token, before stop():
            # stopping the telemetry server waits out its 0.5 s poll
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = eng.stats()
        counts = dict(zip(KERNEL_COUNTERS,
                          (_read_counts()[k] for k in KERNEL_COUNTERS)))
    finally:
        if tr is not None:
            tr.stop()
            flight_recorder.disable()
    ttft = [h.ttft for h in hs]
    itl = [b - a for h in hs for a, b in zip(h.token_times, h.token_times[1:])]
    run = {"outs": outs, "wall_s": wall, "stats": stats, "launches": counts,
           "scrapes": scrapes, "ttft": ttft, "itl": itl,
           "spans": len(tr.spans) if tr is not None else 0,
           "span_names": sorted({sp.name for sp in tr.spans})
           if tr is not None else []}
    return run, eng


def _launch_check(run):
    """K1 once per layer per prefill, the pool layout's decode kernel (K3
    native, K4 int8) once per layer per decode step, the other never."""
    st = run["stats"]
    decode = "paged_flash_decode_q" if st["kv_dtype"] == "int8" \
        else "paged_flash_decode"
    want = dict.fromkeys(KERNEL_COUNTERS, 0)
    want["flash_attention_fwd"] = LAYERS * st["prefills"]
    want[decode] = LAYERS * st["iteration"]
    got = run["launches"]
    return got == want and got["flash_attention_fwd"] > 0 \
        and got[decode] > 0, want


def _q(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def phase_observe(cpu_ref=None):
    """GPT-base through the engine's observability layer on the card:

    - float32, the slice's 12 requests, the sinks on (span tracer, flight
      recorder, telemetry on an ephemeral port, the numeric guard's
      numerics stream): greedy ids equal the same engine with the sinks
      off and the CPU engine; /metrics, /healthz and /statusz scraped over
      localhost while the requests run; K1 = 12 x prefills, K3 = 12 x
      decode steps; again with ``kv_dtype="int8"``: K4 counted, K3 = 0;
    - ``PADDLE_HBM_BUDGET_BYTES`` at the weights plus half the pages the
      12 requests need (admission held at a wedge): the shed count, and
      the admitted greedy ids equal the unbudgeted run's;
    - memory: the ledger's pool bytes equal the pools' and ``stats()``'s
      pages x bytes per page; untracked = ``torch.cuda.memory_allocated()``
      - the registered card bytes >= 0; a forced OOM (one oversized
      ``torch.empty``) is recognized and dumped;
    - the host syncs of one decode step with the sinks on, guard off and
      on (4 each);
    - the cost: bf16 tokens/s, TTFT p50, ITL p50 / p99, sinks off and on in
      turns (off, on, on, off, ``COST_ROUNDS`` times) after an uncounted
      bf16 run, each arm's medians, the wall-measured quantiles (the
      handles' stamps) beside the registry histograms'.  The registry
      counts in both arms.  Printed, not gated."""
    import os
    import tempfile

    from paddle_tpu_torch.observability import faults, memory
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.serving import RequestRejectedError, ServingEngine
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, temps = slice_requests()
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")       # GPT-base defaults
    if cpu_ref is None:
        cpu_ref = _serve(cpu_model, "cpu", prompts, temps)[0]
    model = copy.deepcopy(cpu_model).to("cuda")
    del cpu_model
    flight_dir = tempfile.mkdtemp(prefix="observe_flight_")
    out, ok = {}, True

    # f32: sinks off, then on with the scrapes; ids, launches, spans
    off, _ = _observed_run(model, prompts, temps, "obs-f32-off", False,
                           flight_dir)
    on, eng = _observed_run(model, prompts, temps, "obs-f32-on", True,
                            flight_dir, scrape=True)
    mism = [i for i in greedy
            if not on["outs"][i] == off["outs"][i] == cpu_ref[i]]
    lc_on, want_on = _launch_check(on)
    sc = on["scrapes"]
    fams = sorted({ln.split(" ")[2] for ln in sc["/metrics"][1].splitlines()
                   if ln.startswith("# TYPE serving_")})
    hz = json.loads(sc["/healthz"][1])
    sz = json.loads(sc["/statusz"][1])
    sec = sz.get("serving/obs-f32-on", {})
    scrape_ok = all(sc[p][0] == 200 for p in ("/metrics", "/healthz",
                                              "/statusz")) \
        and "serving_ttft_seconds" in fams and hz["status"] == "ok" \
        and sec.get("num_slots") == SLOTS and "memory" in sz
    out["f32"] = {
        "greedy_mismatches_vs_off_and_cpu": mism,
        "off": {"wall_s": off["wall_s"], "launches": off["launches"]},
        "on": {"wall_s": on["wall_s"], "launches": on["launches"],
               "launches_expected": want_on, "spans": on["spans"],
               "span_names": on["span_names"]},
        "scrapes": {"codes": {p: sc[p][0] for p in ("/metrics", "/healthz",
                                                     "/statusz")},
                    "requests_in_flight_at_scrape": sc["while_running"],
                    "metrics_bytes": len(sc["/metrics"][1]),
                    "serving_families": len(fams),
                    "healthz_status": hz["status"],
                    "statusz_sections": sorted(sz)}}
    ok = ok and not mism and lc_on and scrape_ok and on["spans"] > 0

    # memory: the ledger against the pools and the allocator, then an OOM
    led = memory.ledger()
    rows = led.owner_rows(replica="obs-f32-on")
    ledger_pool = sum(r["bytes"] for r in rows
                      if r["owner"] in ("kv.pages", "kv.scales"))
    pool_bytes = sum(p.numel() * p.element_size() for p in eng._pools)
    st = on["stats"]
    stats_pool = (st["num_pages"] + 1) * st["bytes_per_page"]
    rep = led.report()
    try:
        torch.empty(1 << 46, dtype=torch.uint8, device="cuda")
        oom = None
    except Exception as e:      # the allocator's refusal, examined below
        oom = e
    is_oom = oom is not None and memory.is_oom_error(oom)
    path = memory.oom_dump(oom, replica="obs-f32-on") if is_oom else None
    doc = json.load(open(path)) if path else {}
    out["memory"] = {
        "owners": [{k: r[k] for k in ("owner", "bytes", "arrays")}
                   for r in rows],
        "ledger_pool_bytes": ledger_pool, "pool_bytes": pool_bytes,
        "stats_pages_x_bytes_per_page": stats_pool,
        "fixed_bytes": eng._fixed_bytes,
        "tracked_bytes": rep["tracked_bytes"],
        "cuda_memory_allocated": rep["live_bytes"],
        "untracked_bytes": rep["untracked_bytes"],
        "oom": {"type": type(oom).__name__, "recognized": is_oom,
                "dump_reason": doc.get("reason"),
                "dump_owner_rows": len(doc.get("extra", {})
                                       .get("memory", {}).get("owners", []))}}
    ok = ok and ledger_pool == pool_bytes == stats_pool \
        and rep["untracked_bytes"] is not None \
        and rep["untracked_bytes"] >= 0 and is_oom \
        and doc.get("reason") == "oom"
    del eng

    # int8 pools, sinks on: K4 counted, K3 never
    q, _ = _observed_run(model, prompts, temps, "obs-int8-on", True,
                         flight_dir, kv_dtype="int8")
    lc_q, want_q = _launch_check(q)
    out["int8"] = {"wall_s": q["wall_s"], "launches": q["launches"],
                   "launches_expected": want_q}
    ok = ok and lc_q

    # the HBM pre-flight: half the pages the requests need
    eng = ServingEngine(model, num_slots=SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN, replica="obs-hbm")
    need = [-(-(len(p) + 32) // PAGE) for p in prompts]
    budget = eng._fixed_bytes + (sum(need) // 2) * eng._bytes_per_page
    os.environ["PADDLE_HBM_BUDGET_BYTES"] = str(budget)
    try:
        with eng:
            site = "serving.scheduler_wedge@obs-hbm"
            faults.inject(site, seconds=60.0, times=1)
            t0 = time.monotonic()
            while faults.trip_count(site) < 1:
                if time.monotonic() - t0 > 60:
                    raise SystemExit("observe phase: the scheduler never "
                                     "reached its wedge site")
                time.sleep(0.005)
            hs = {}
            for i, (p, t) in enumerate(zip(prompts, temps)):
                try:
                    hs[i] = eng.submit(p, max_new_tokens=32, temperature=t)
                except RequestRejectedError as e:
                    if e.reason != "hbm_budget":
                        raise
            committed = eng._committed_pages
            faults.clear(site)
            got = {i: h.result(timeout=900) for i, h in hs.items()}
            after = eng._committed_pages
    finally:
        del os.environ["PADDLE_HBM_BUDGET_BYTES"]
    shed = sorted(set(range(len(prompts))) - set(got))
    bad = [i for i in got if i in greedy and got[i] != off["outs"][i]]
    out["hbm_budget"] = {"budget_bytes": budget,
                         "pages_needed": sum(need),
                         "pages_budgeted": sum(need) // 2,
                         "committed_while_held": committed,
                         "committed_after": after, "shed": shed,
                         "admitted": sorted(got),
                         "admitted_greedy_mismatches": bad}
    ok = ok and bool(shed) and not bad and after == 0 \
        and committed <= sum(need) // 2
    del eng

    # host syncs of one decode step with the sinks on
    from paddle_tpu_torch.observability import flight_recorder, tracing

    tr = tracing.Tracer().start()
    flight_recorder.enable(dir=flight_dir)
    try:
        out["step_syncs"] = {
            g: _step_syncs(model, [p[:200] for p in prompts[:2]], guard,
                           tag="obs-syncs", telemetry_port=0)
            for g, guard in (("guard_off", False), ("guard_on", True))}
    finally:
        tr.stop()
        flight_recorder.disable()
    # one sync per step: the packed tokens' transfer (the host rows reach
    # the captured step through pinned staging buffers, non_blocking)
    ok = ok and all(v["syncs"] == 1 and v["active"] == 2
                    for v in out["step_syncs"].values())

    # the cost, bf16, in turns, after one uncounted bf16 run (the first
    # bf16 run of a process pays cuBLAS's heuristics for the new dtype)
    model = model.to(torch.bfloat16)
    _observed_run(model, prompts[:4], temps[:4], "obs-bf16-warm", False,
                  flight_dir)
    reg = metrics.get_registry()
    cost = []
    for i, arm in enumerate(("off", "on", "on", "off") * COST_ROUNDS):
        rep_name = f"obs-bf16-{arm}-{i}"
        r, _ = _observed_run(model, prompts, temps, rep_name, arm == "on",
                             flight_dir)
        tok = sum(len(o) for o in r["outs"])
        hist_ttft = reg.get("serving.ttft_seconds").labels(replica=rep_name)
        hist_itl = reg.get("serving.inter_token_seconds").labels(
            replica=rep_name)
        cost.append({
            "arm": arm, "wall_s": r["wall_s"], "tokens": tok,
            "tokens_per_s": tok / r["wall_s"],
            "ttft_p50_s": _q(r["ttft"], 50),
            "itl_p50_s": _q(r["itl"], 50), "itl_p99_s": _q(r["itl"], 99),
            "hist_ttft_p50_s": hist_ttft.quantile(0.5),
            "hist_itl_p50_s": hist_itl.quantile(0.5),
            "hist_itl_p99_s": hist_itl.quantile(0.99),
            "hist_counts": {"ttft": hist_ttft.count, "itl": hist_itl.count}})
    summary = {}
    for a in ("off", "on"):
        arm_turns = [c for c in cost if c["arm"] == a]
        summary[a] = {k: float(np.median([c[k] for c in arm_turns]))
                      for k in ("tokens_per_s", "ttft_p50_s", "itl_p50_s",
                                "itl_p99_s")}
        tps = [c["tokens_per_s"] for c in arm_turns]
        summary[a]["tokens_per_s_min_max"] = [min(tps), max(tps)]
    out["cost_bf16"] = {"turns": cost, "median": summary,
                        "tokens_per_s_on_over_off":
                            summary["on"]["tokens_per_s"]
                            / summary["off"]["tokens_per_s"]}
    emit({"phase": "observe", "ok": ok,
          "model": "GPT-base 12x768 vocab 50304",
          "requests": len(prompts), "max_new_tokens": 32, **out,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("observe phase failed: see the f32 / memory / int8 "
                         "/ hbm_budget / step_syncs results")
    return {"launches": {k: on["launches"][k] + q["launches"][k]
                         for k in KERNEL_COUNTERS}}


# ---------------------------------------------------------------- programs
# PERF.md section 5's profiled bf16 serving of the 12 slice requests with
# eager steps, before the program layer (a different call, on its own
# card): printed beside this phase's figures, no A/B claimed
EAGER_SERVE_BF16 = {"source": "PERF.md section 5: the profile phase's "
                              "bf16 serving run, eager steps",
                    "wall_s": 1.3847, "device_busy_s": 0.1231,
                    "device_idle_share": 0.911, "host_syncs_per_step": 4}


def _program_run(model, prompts, temps, replica, manifest=None,
                 profile=False, **engine_kw):
    """Serve ``prompts`` (32 new tokens each) through one engine, warmed
    from ``manifest`` first when given, the kernel counters zeroed just
    before the requests and read just after; with ``profile`` the requests
    run under the port's ``Profiler``.  Returns the run's record and the
    (stopped) engine: ids, wall, counts, the programs minted during the
    requests, each request's ``compile_s``, and per program kind the keys,
    captures and replays of this engine."""
    from paddle_tpu_torch.profiler import Profiler
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, num_slots=SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN, replica=replica, **engine_kw)
    warm = eng.warmup(manifest) if manifest is not None else None
    n0 = eng.program_traces()
    prof = Profiler() if profile else None
    torch.cuda.synchronize()
    _zero_counts()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    with eng:
        hs = [eng.submit(p, max_new_tokens=32, temperature=t)
              for p, t in zip(prompts, temps)]
        outs = [h.result(timeout=900) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = eng.stats()
    if prof is not None:
        prof.stop()
    every = _read_counts()
    counts = {k: every[k] for k in KERNEL_COUNTERS}
    kinds = {}
    for key, prog in eng._graphs.items():
        k = kinds.setdefault(key[0], {"keys": 0, "captured": 0,
                                      "replays": 0})
        k["keys"] += 1
        k["captured"] += prog.captured
        k["replays"] += prog.runs - 1 if prog.captured else 0
    run = {"outs": outs, "wall_s": wall, "stats": stats, "launches": counts,
           "launches_all": every, "mints": eng.program_traces() - n0,
           "compile_s": [h.compile_s for h in hs],
           "ttft": [h.ttft for h in hs],
           "itl": [b - a for h in hs
                   for a, b in zip(h.token_times, h.token_times[1:])],
           "kinds": kinds, "warmup": warm,
           "eager_keys": [repr(k) for k, p in eng._graphs.items()
                          if not p.captured],
           "graph_pool_bytes": eng.graph_pool_bytes()}
    if prof is not None:
        run["profile"] = _device_share(prof, wall)
    return run, eng


def _device_share(prof, wall):
    """Busy time of the card (the union of its kernels' and copies'
    intervals in the Profiler's device trace) over the run's wall, and
    the port's kernels by name."""
    ivs = sorted((t0, t1) for _, t0, t1 in prof.device_events())
    busy, end = 0.0, None
    for t0, t1 in ivs:
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    names = sorted({n for n, _, _ in prof.device_events()
                    if "flash" in n or "paged" in n})
    busy_s = busy / 1e6
    return {"device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
            "port_kernels": [n[:80] for n in names],
            "k1_in_trace": any("flash_fwd" in n for n in names),
            "k3_in_trace": any("paged_flash_decode_kernel" in n
                               and "signed char" not in n for n in names),
            "k4_in_trace": any("paged_flash_decode_kernel" in n
                               and "signed char" in n for n in names)}


def _program_launch_check(run, prompts, chunk=None):
    """The counts a run of these programs must show, replays included
    (the rule of ``_counted_spec_run``): K1 once per layer per monolithic
    prefill; the pool layout's decode kernel once per layer per decode
    step (plain or verify) and per prefill chunk; the chunk attend once
    per layer per verify step and per chunk; nothing else."""
    st = run["stats"]
    quant = st["kv_dtype"] == "int8"
    decode = "paged_flash_decode_q" if quant else "paged_flash_decode"
    via = "via_paged_chunk_attend_quant" if quant \
        else "via_paged_chunk_attend"
    n_chunked = sum(1 for p in prompts if chunk and len(p) > chunk)
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = LAYERS * (st["prefills"] - n_chunked)
    want[via] = LAYERS * (st["verify_steps"] + st["prefill_chunks"])
    want[decode] = LAYERS * (st["iteration"] + st["prefill_chunks"])
    got = run["launches_all"]
    return got == want and got[decode] > 0, got, want


def _cold_warm(model, fresh, prompts, temps, tag, resolve=False,
               **engine_kw):
    """A cold engine over ``model``, then a warm one over ``fresh`` (the
    same weights, a fresh program store) warmed from the cold engine's
    manifest: its ids equal the cold ids, it mints nothing, its requests
    pay no stall, every key it ran is a replayed graph.  ``resolve``: the
    perf table's costs are resolved while the cold engine's programs
    live (one counted eager step of each program's shapes)."""
    from paddle_tpu_torch.observability import perf

    cold, eng = _program_run(model, prompts, temps, f"prog-{tag}-cold",
                             **engine_kw)
    manifest = eng.capture_manifest()
    if resolve:
        perf.resolve_costs()
    del eng
    warm, eng = _program_run(fresh, prompts, temps, f"prog-{tag}-warm",
                             manifest=manifest, **engine_kw)
    chunk = engine_kw.get("prefill_chunk_tokens")
    lc_cold, _, _ = _program_launch_check(cold, prompts, chunk)
    lc_warm, got, want = _program_launch_check(warm, prompts, chunk)
    ok = (warm["outs"] == cold["outs"] and warm["mints"] == 0
          and lc_cold and lc_warm
          and all(c == 0.0 for c in warm["compile_s"])
          and not warm["eager_keys"] and not cold["eager_keys"]
          and all(k["captured"] == k["keys"] and k["replays"] > 0
                  for k in warm["kinds"].values()))
    rec = {"ok": ok, "manifest_keys": len(manifest),
           "warmup": warm["warmup"], "cold_mints": cold["mints"],
           "warm_mints": warm["mints"],
           "cold_compile_s_first": cold["compile_s"][0],
           "warm_compile_s_max": max(warm["compile_s"]),
           "ids_equal": warm["outs"] == cold["outs"],
           "kinds_warm": warm["kinds"], "eager_keys": warm["eager_keys"],
           "launch_check_cold": lc_cold, "launch_check_warm": lc_warm,
           "launches_warm": got, "launches_expected_warm": want,
           "graph_pool_bytes": warm["graph_pool_bytes"],
           "prefills": warm["stats"]["prefills"],
           "decode_steps": warm["stats"]["iteration"]}
    return rec, cold, warm, eng


def phase_programs(cpu_ref=None):
    """GPT-base at full width through the program layer on the card: each
    engine program (``serve_step``, ``serve_prefill/<bucket>``,
    ``serve_prefill_chunk/<c>``, ``verify/k4``) a CUDA graph captured at
    its first dispatch and replayed after.

    - f32: a cold engine serves the slice's 12 requests (greedy ids equal
      the CPU engine's) and captures its manifest; an engine over a fresh
      copy of the weights replays the manifest with ``warmup()`` before
      ``start()`` and serves them again: the same ids (sampled rows too),
      0 new mints, ``compile_s == 0`` for every request, every key a
      captured, replayed graph, K1 / K3 counted as the eager engines count
      them (K1 once per layer per prefill, K3 per layer per step);
    - the same with ``kv_dtype="int8"`` (K4), with ``speculative_k=4`` on
      the spec phase's requests (verify: K3 through the chunk attend) and
      with ``prefill_chunk_tokens=128`` on the chunk phase's (chunks), every
      engine's launches counted as ``_counted_spec_run`` counts them;
    - ``generate()`` paged: a second call with the first's key gives its
      ids, replays its captured step 14 times (15 steps: the first eager
      and captured) and leaves no device memory behind;
    - the perf table's rows (costs resolved while the engines live), each
      row's share of peak <= 1.05; host syncs of one decode step (guard
      off and on);
    - bf16: a warmed engine's wall, TTFT and inter-token p50 / p99 on the
      12 requests, then one more warmed run under the port's ``Profiler``:
      its device trace names K1 and K3, and the card's idle share.  Printed
      beside PERF.md's eager figures: different calls, no A/B claimed."""
    from paddle_tpu_torch.observability import perf
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompts, temps = slice_requests()
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")
    if cpu_ref is None:
        cpu_ref = _serve(cpu_model, "cpu", prompts, temps)[0]
    model = copy.deepcopy(cpu_model).to("cuda")
    fresh = copy.deepcopy(cpu_model).to("cuda")
    perf.reset()
    out, ok = {}, True

    f32, cold, warm, eng = _cold_warm(model, fresh, prompts, temps, "f32",
                                      resolve=True)
    mism = [i for i in greedy if cold["outs"][i] != cpu_ref[i]]
    rows = perf.table().statusz()["programs"]
    f32.update(greedy_mismatches_vs_cpu=mism)
    ok = ok and f32["ok"] and not mism
    out["f32"] = f32
    launches = {k: cold["launches"][k] + warm["launches"][k]
                for k in KERNEL_COUNTERS}
    del eng

    for tag, reqs, tmp, kw, kind in (
            ("int8", prompts, temps, {"kv_dtype": "int8"}, "serve_step"),
            ("spec", spec_requests(), [0.0] * 6,
             {"speculative_k": SPEC_K}, "verify"),
            ("chunk", chunk_requests(), [0.0] * 6,
             {"prefill_chunk_tokens": CHUNK_TOKENS}, "serve_prefill_chunk")):
        rec, cold, warm, eng = _cold_warm(model, fresh, reqs, tmp, tag, **kw)
        rec["kind_checked"] = kind
        ok = ok and rec["ok"] and warm["kinds"].get(kind, {}).get(
            "replays", 0) > 0
        out[tag] = rec
        del eng

    # generate(): each call captures its step and replays it for the rest
    # of its tokens; the cache and the graph go with the call
    from paddle_tpu_torch.jit import graphs

    ids = _gen_ids(GEN_B, 64, 3)
    a = model.generate(ids, max_new_tokens=16, temperature=0.0,
                       cache_impl="paged", page_size=PAGE)
    torch.cuda.synchronize()
    mem0, rep0 = torch.cuda.memory_allocated(), graphs.REPLAYS
    _zero_counts()
    b = model.generate(ids, max_new_tokens=16, temperature=0.0,
                       cache_impl="paged", page_size=PAGE)
    gen_counts = _read_counts()
    ids_equal = bool(torch.equal(a, b))
    del b   # the ids it returned: all that may outlive the call
    torch.cuda.synchronize()
    replays = graphs.REPLAYS - rep0
    held = torch.cuda.memory_allocated() - mem0
    gen_ok = ids_equal and replays == 14 and held == 0 \
        and gen_counts["flash_attention_fwd"] == LAYERS \
        and gen_counts["via_paged_decode_attend"] == LAYERS * 15
    out["generate_paged"] = {"ok": gen_ok, "ids_equal": ids_equal,
                             "step_replays": replays,
                             "bytes_held_after_call": held,
                             "launches": gen_counts}
    ok = ok and gen_ok

    fracs = [r["frac_of_peak"] for r in rows if r["frac_of_peak"] is not None]
    out["perf_programs"] = [{k: r.get(k) for k in (
        "program", "calls", "device_seconds", "flops_per_call",
        "bytes_per_call", "regime", "frac_of_peak", "cost")} for r in rows]
    ok = ok and bool(fracs) and max(fracs) <= 1.05

    syncs = {g: _step_syncs(model, [p[:200] for p in prompts[:2]], guard,
                            tag="prog-syncs")
             for g, guard in (("guard_off", False), ("guard_on", True))}
    out["step_syncs"] = syncs
    ok = ok and all(v["syncs"] == 1 and v["active"] == 2
                    for v in syncs.values())
    del model, fresh

    # bf16: a cold engine (uncounted: it builds the bf16 programs), then
    # warmed engines from its manifest — one timed, one profiled
    torch.manual_seed(0)
    m16 = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    f16 = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    f16.load_state_dict(m16.state_dict())
    _, eng = _program_run(m16, prompts, temps, "prog-bf16-cold")
    manifest = eng.capture_manifest()
    del eng
    timed, eng = _program_run(f16, prompts, temps, "prog-bf16-warm",
                              manifest=manifest)
    del eng
    prof, eng = _program_run(f16, prompts, temps, "prog-bf16-prof",
                             manifest=manifest, profile=True)
    del eng
    tokens = sum(len(o) for o in timed["outs"])
    out["bf16_warm"] = {
        "wall_s": timed["wall_s"], "tokens": tokens,
        "tokens_per_s": tokens / timed["wall_s"],
        "ttft_p50_s": _q(timed["ttft"], 50),
        "itl_p50_s": _q(timed["itl"], 50), "itl_p99_s": _q(timed["itl"], 99),
        "mints": timed["mints"], "kinds": timed["kinds"],
        "profiled": {"wall_s": prof["wall_s"], **prof["profile"]},
        "eager_reference_different_call": EAGER_SERVE_BF16}
    pr = prof["profile"]
    ok = ok and timed["mints"] == 0 and pr["k1_in_trace"] \
        and pr["k3_in_trace"]
    emit({"phase": "programs", "ok": ok,
          "model": "GPT-base 12x768 vocab 50304", "requests": len(prompts),
          "max_new_tokens": 32, **out, "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("programs phase failed: see the f32 / int8 / spec "
                         "/ chunk / generate_paged / perf_programs / "
                         "step_syncs / bf16_warm results")
    return {"launches": launches}


# ----------------------------------------------------------------- profile
# ------------------------------------------------------------------- llama
# Llama-3-8B: meta-llama/Meta-Llama-3-8B config.json (8,030,261,248
# parameters; GQA group 4, head_dim 128, untied head)
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=8, rope_theta=500000.0, rms_norm_eps=1e-5,
                 max_position_embeddings=8192, tie_word_embeddings=False)
LL_HEADS, LL_KV_HEADS, LL_HEAD_DIM = 32, 8, 128
# f32 parity against the CPU at the full width, the depth cut to 2: batch,
# prompt and new tokens (beam search reruns the whole prefix of every beam
# per token, on the CPU too, so it takes fewer)
LL_PARITY_LAYERS, LL_B, LL_S, LL_NEW = 2, 2, 64, 16
LL_EAGER_NEW, LL_BEAM_NEW, LL_BEAMS = 16, 8, 4
# bf16 weights at the full depth: the timed generate() calls, and the new
# tokens of the profiled ones
LL_BF16_B, LL_BF16_S, LL_BF16_NEW, LL_PROFILE_NEW = 8, 512, 128, 16
# training: 3 f32 steps of a narrow head_dim-128 GQA config against the CPU,
# then bf16 O2 steps at the full width, the depth cut to 2
LL_NARROW = dict(vocab_size=32000, hidden_size=512, intermediate_size=1376,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, rope_theta=500000.0,
                 rms_norm_eps=1e-5, max_position_embeddings=8192)
LL_NARROW_B, LL_NARROW_S = 2, 128
LL_TRAIN_LAYERS, LL_TRAIN_B, LL_TRAIN_S, LL_TRAIN_STEPS = 2, 4, 1024, 8


def _llama(layers, dtype=None):
    """Llama-3-8B at ``layers`` deep on the card, its weights drawn there
    from a card generator seeded with 0 (no host copy, no download)."""
    from paddle_tpu_torch.text.models import LlamaForCausalLM

    gen = torch.Generator(device="cuda").manual_seed(0)
    return LlamaForCausalLM(device="cuda", dtype=dtype, generator=gen,
                            **dict(LLAMA3_8B, num_hidden_layers=layers))


def _free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _llama_parity():
    """Greedy ids of the f32 card model against a CPU copy: dense, paged,
    no cache, beam; each card call's launches checked."""
    card = _llama(LL_PARITY_LAYERS)
    cpu = copy.deepcopy(card).to("cpu")
    vocab = LLAMA3_8B["vocab_size"]
    cases, outs = [], {}
    for kind, n, kw in (
            ("dense", LL_NEW, {}),
            ("paged", LL_NEW, dict(cache_impl="paged", page_size=PAGE)),
            ("no_cache", LL_EAGER_NEW, dict(use_cache=False)),
            ("beam", LL_BEAM_NEW, dict(decode_strategy="beam_search",
                                       num_beams=LL_BEAMS))):
        ids = _gen_ids(LL_B, LL_S, 11, vocab)
        _zero_counts()
        t0 = time.perf_counter()
        got = card.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = _read_counts()
        got = got.cpu()
        t0 = time.perf_counter()
        want = cpu.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        outs[kind] = got
        cases.append({
            "case": kind, "B": LL_B, "prompt": LL_S, "new_tokens": n,
            "equal_cpu": torch.equal(got, want),
            "first_divergence": [_first_divergence(a.tolist(), b.tolist())
                                 for a, b in zip(got, want)],
            "launches": counts,
            "launches_ok": counts == _gen_want(kind, n, LL_PARITY_LAYERS),
            "card_s": card_s, "cpu_s": time.perf_counter() - t0})
    del card, cpu
    _free_card()
    return cases, torch.equal(outs["dense"], outs["paged"])


def _llama_generate_bf16():
    """The full-depth bf16 model: generate() paged and dense in turns,
    then each cache once under the profiler."""
    from paddle_tpu_torch.serving.quant import top1_agreement

    t0 = time.perf_counter()
    model = _llama(LLAMA3_8B["num_hidden_layers"], torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    L = LLAMA3_8B["num_hidden_layers"]
    ids = _gen_ids(LL_BF16_B, LL_BF16_S, 7, LLAMA3_8B["vocab_size"])
    with torch.no_grad():
        logits_dtype = str(model(ids[:1, :16].to("cuda")).dtype)
    for impl in ("paged", "dense"):       # untimed warm-up
        model.generate(ids[:, :64], max_new_tokens=4, temperature=0.0,
                       cache_impl=impl, page_size=PAGE)
    runs = {}
    for impl in ("paged", "dense", "dense", "paged"):
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=LL_BF16_NEW, temperature=0.0,
                             cache_impl=impl, page_size=PAGE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        tokens = LL_BF16_B * LL_BF16_NEW
        runs.setdefault(impl, []).append({
            "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts,
            "launches_ok": counts == _gen_want(impl, LL_BF16_NEW, L),
            "out": out[:, LL_BF16_S:].cpu()})
    paged, dense = runs["paged"][0]["out"], runs["dense"][0]["out"]
    first_equal = torch.equal(paged[:, 0], dense[:, 0])
    agree = {"ids_equal": int((paged == dense).sum()),
             "ids": paged.numel(),
             "top1_agreement": top1_agreement(dense.tolist(), paged.tolist()),
             "first_token_equal_every_row": first_equal}
    for r in runs["paged"] + runs["dense"]:
        del r["out"]

    def gen(impl):
        def run():
            model.generate(ids, max_new_tokens=LL_PROFILE_NEW,
                           temperature=0.0, cache_impl=impl, page_size=PAGE)
            return {"B": LL_BF16_B, "prompt": LL_BF16_S,
                    "new_tokens": LL_PROFILE_NEW}
        return run

    profile = {impl: _profiled(gen(impl)) for impl in ("paged", "dense")}
    del model
    _free_card()
    return {"layers": L, "parameters": n_params, "build_s": build_s,
            "B": LL_BF16_B, "prompt": LL_BF16_S, "new_tokens": LL_BF16_NEW,
            "order": "paged, dense, dense, paged", "logits_dtype": logits_dtype,
            "paged": runs["paged"], "dense": runs["dense"],
            "paged_vs_dense": agree, "profile": profile}


def _llama_train():
    """3 f32 TrainSteps of the narrow config on the card against the CPU,
    then bf16 O2 steps of the full-width model at depth 2, timed, and two
    more under the profiler."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models import LlamaForCausalLM

    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, LL_NARROW["vocab_size"],
                                      (LL_NARROW_B, LL_NARROW_S)))
    cpu = LlamaForCausalLM(device="cpu", generator=torch.Generator()
                           .manual_seed(0), **LL_NARROW)
    card = copy.deepcopy(cpu).to("cuda")
    losses = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        step, x = _trainer(model), ids.to(dev)
        losses[dev] = [step({"input_ids": x, "labels": x}).item()
                       for _ in range(PARITY_STEPS)]
    del cpu, card
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))

    model = _llama(LL_TRAIN_LAYERS)                    # f32 masters
    step = _trainer(model, amp_level="O2")
    x = torch.from_numpy(rs.randint(0, LLAMA3_8B["vocab_size"],
                                    (LL_TRAIN_B, LL_TRAIN_S))).to("cuda")
    batch = {"input_ids": x, "labels": x}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    out = [step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += [step(batch) for _ in range(LL_TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
              "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
    steps = WARMUP_STEPS + LL_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in model.llama.layers.parameters())
    n += model.llama.norm.weight.numel() + model.lm_head.weight.numel()
    hidden = LLAMA3_8B["hidden_size"]
    flops = (6 * n + 6 * LL_TRAIN_LAYERS * LL_TRAIN_S * hidden) \
        * LL_TRAIN_B * LL_TRAIN_S
    step_s = wall / LL_TRAIN_STEPS
    o2_losses = [l.item() for l in out]

    def two_steps():
        for _ in range(2):
            step(batch)
        return {"steps": 2, "B": LL_TRAIN_B, "S": LL_TRAIN_S}

    profile = _profiled(two_steps)
    del model, step
    _free_card()
    return {
        "f32_parity": {"config": LL_NARROW, "B": LL_NARROW_B,
                       "S": LL_NARROW_S, "steps": PARITY_STEPS,
                       "cpu_losses": losses["cpu"],
                       "cuda_losses": losses["cuda"], "max_rel_diff": rel,
                       "rtol": 1e-4, "ok": rel <= 1e-4},
        "bf16_O2": {"layers": LL_TRAIN_LAYERS, "parameters_counted": n,
                    "B": LL_TRAIN_B, "S": LL_TRAIN_S,
                    "warmup_steps": WARMUP_STEPS,
                    "timed_steps": LL_TRAIN_STEPS, "step_ms": step_s * 1e3,
                    "tokens_per_s": LL_TRAIN_B * LL_TRAIN_S / step_s,
                    "flops_per_step": flops,
                    "flops_formula": "(6 N + 6 L S d) per token, N = layer "
                                     "+ final-norm + LM-head params",
                    "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS,
                    "peak_memory_allocated_bytes": peak,
                    "losses": o2_losses, "launches": counts,
                    "launches_ok": counts == dict.fromkeys(
                        counts, LL_TRAIN_LAYERS * steps),
                    "loss_fell": o2_losses[-1] < o2_losses[0]
                    and bool(np.isfinite(o2_losses).all())},
        "profile_bf16_O2": profile}


def _llama_kernel_times(gen, launches):
    """The kernels at Llama-3-8B's shapes (32 heads of 128; TF32 off):
    K1 bf16 and K2a / K2b at the O2 step's shape (B=4, S=1024) beside SDPA
    and its backward, and K3's f32-query entry
    over bf16 pools at a decode step of the bf16 run (B=8, 8 kv heads,
    lengths 512-639), by CUDA-graph replay.  Bounds: K1 4 D operations per
    visible (query, key) pair (``k1_bounds``: f32 as 3xTF32), K2a 8 D, K2b
    6 D, K3 4 D per (head, valid key), other f32 work at the f32 rate;
    bytes each input read and each output written once.  (K1 f32 at the
    bf16 model's prefill, B=8, S=512, is timed in the kernels phase.)"""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    H, D = LL_HEADS, LL_HEAD_DIM
    out = {"k1_llama_bf16": _k1_timed(gen, LL_TRAIN_B, LL_TRAIN_S,
                                      torch.bfloat16, H, D)}
    out["k1_llama_bf16"]["launches"] = launches["k1_bf16"]

    B, S = LL_TRAIN_B, LL_TRAIN_S
    scale = D ** -0.5
    q, k, v, g, lse, r = _k2_inputs(gen, torch.bfloat16, B, S, S, D, True,
                                    False, heads=H)
    dk, dv = fa._bwd_dkdv_kernel(q, k, v, g, lse, r, scale, True)
    dq = fa._bwd_dq_kernel(q, k, v, g, lse, r, scale, True)
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, True)
    pairs = B * H * S * (S + 1) // 2
    elems = q.numel()
    reads = 4 * elems * 2 + 2 * B * H * S * 4
    a_ms, a_by = bound(8 * D * pairs, reads + 2 * elems * 2)
    b_ms, b_by = bound(6 * D * pairs, reads + elems * 2)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(
        q, k, v, g, lse, r, scale, True), iters=3)
    library_ms = cuda_ms(_library_bwd(q, k, v, g))
    shape = {"shape": [B, S, H, D], "dtype": "bfloat16", "rows": B * S,
             "plain_and_library_ms_are_for_the_pair": True}
    err_a = max((dk.float() - rk.float()).abs().max().item(),
                (dv.float() - rv.float()).abs().max().item())
    err_b = (dq.float() - rq.float()).abs().max().item()
    out["k2a_llama"] = {
        **shape, "kernel_ms": cuda_ms(lambda: fa._bwd_dkdv_kernel(
            q, k, v, g, lse, r, scale, True)),
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": a_ms,
        "bound_by": a_by, "max_abs_err": err_a,
        "rel_err": _rel_err(dk, rk), "launches": launches["k2a"],
        "ok": max(_rel_err(dk, rk), _rel_err(dv, rv)) <= BWD_TOL[torch.bfloat16]}
    out["k2b_llama"] = {
        **shape, "kernel_ms": cuda_ms(lambda: fa._bwd_dq_kernel(
            q, k, v, g, lse, r, scale, True)),
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": err_b, "rel_err": _rel_err(dq, rq),
        "launches": launches["k2b"],
        "ok": _rel_err(dq, rq) <= BWD_TOL[torch.bfloat16]}
    del q, k, v, g, lse, r, dk, dv, dq, rq, rk, rv

    # K3: an f32 q over bf16 pools, 8 rows at lengths 512-639
    lens = [int(x) for x in np.linspace(LL_BF16_S, LL_BF16_S
                                        + LL_BF16_NEW - 1, LL_BF16_B)]
    np_ = -(-(LL_BF16_S + LL_BF16_NEW) // PAGE)
    _, kp, vp, table, ln = _k3_inputs(gen, torch.bfloat16, lens, H,
                                      LL_KV_HEADS, d=D, np_=np_)
    qd = torch.randn(len(lens), H, D, generator=gen, device="cuda")
    od = pa.paged_attention(qd, kp, vp, table, ln)
    err = (od - pa.paged_attention_ref(qd, kp, vp, table, ln)
           ).abs().max().item()
    valid_pages = sum(-(-n // PAGE) for n in lens)
    nbytes = (2 * valid_pages * PAGE * LL_KV_HEADS * D * 2
              + 2 * qd.numel() * 4 + table.numel() * 4 + ln.numel() * 4)
    k3_ms, k3_by = bound(4 * sum(lens) * H * D, nbytes, PEAK_F32_FLOPS)
    out["k3_llama_f32q"] = {
        "B": len(lens), "heads": H, "kv_heads": LL_KV_HEADS, "head_dim": D,
        "q_dtype": "float32", "pools": "bfloat16", "lens": lens,
        "rows": len(lens), "page_size": PAGE, "table_width": np_,
        "splits": pa._splits(len(lens), LL_KV_HEADS, np_),
        "kernel_ms": cuda_ms(lambda: pa.paged_attention(qd, kp, vp, table, ln),
                             graph=True),
        "eager_ms": cuda_ms(lambda: pa.paged_attention(qd, kp, vp, table, ln)),
        "plain_ms": cuda_ms(lambda: pa.paged_attention_ref(qd, kp, vp, table,
                                                           ln)),
        "library_ms": None, "bound_ms": k3_ms, "bound_by": k3_by,
        "max_abs_err": err, "launches": launches["k3"],
        "ok": err <= ATOL[torch.float32]}
    # the same pools under a bf16 q (K3's bf16 entry): what the f32 query
    # costs beside it
    qb = qd.to(torch.bfloat16)
    out["k3_llama_f32q"]["bf16_q_kernel_ms"] = cuda_ms(
        lambda: pa.paged_attention(qb, kp, vp, table, ln), graph=True)
    return out


def phase_llama():
    """Llama-3-8B (vocab 128256, 4096 wide, 32 heads over 8 kv heads of 128,
    SwiGLU 14336, rope_theta 500000; random weights from a card generator
    seeded with 0) through ``LlamaForCausalLM``: float32 at depth 2 (the
    cut) against a CPU copy, greedy ids equal for the dense and paged
    caches (dense equal to paged too), ``use_cache=False`` and beam search,
    each call's launches checked; bf16 weights at the full depth 32,
    generate() B=8, prompts of 512, 128 new tokens, paged and dense in
    turns (its activations are f32, as in the TPU package: K1's f32 body,
    K3's f32-query entry over the bf16 pools), the first new token of each
    row equal between the caches, each cache once under the profiler; 3
    f32 TrainSteps of a narrow head_dim-128 GQA config against the CPU
    (rtol 1e-4) and bf16 O2 TrainSteps at the full width, depth 2, B=4,
    S=1024, with K1 = K2a = K2b = 2 launches per step; then the kernels at
    these shapes beside their plain versions and PyTorch's calls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = {}
    t0 = time.perf_counter()
    cases, dense_eq_paged = _llama_parity()
    secs["f32_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf16 = _llama_generate_bf16()
    secs["bf16_generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = _llama_train()
    secs["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paged0, dense0 = bf16["paged"][0], bf16["dense"][0]
    o2 = train["bf16_O2"]["launches"]
    times = _llama_kernel_times(
        torch.Generator(device="cuda").manual_seed(0),
        {"k1_bf16": o2["flash_attention_fwd"],
         "k2a": o2["flash_attention_bwd_dkdv"],
         "k2b": o2["flash_attention_bwd_dq"],
         "k3": paged0["launches"]["paged_flash_decode"]})
    secs["kernel_times"] = time.perf_counter() - t0
    ok = (all(c["equal_cpu"] and c["launches_ok"] for c in cases)
          and dense_eq_paged and bf16["logits_dtype"] == "torch.float32"
          and all(r["launches_ok"] for r in bf16["paged"] + bf16["dense"])
          and bf16["paged_vs_dense"]["first_token_equal_every_row"]
          and train["f32_parity"]["ok"] and train["bf16_O2"]["launches_ok"]
          and train["bf16_O2"]["loss_fell"]
          and all(t["ok"] for t in times.values()))
    emit({"phase": "llama", "ok": ok,
          "model": "Llama-3-8B (meta-llama/Meta-Llama-3-8B config.json), "
                   "random weights",
          "config": LLAMA3_8B,
          "depth_cut": {"f32_parity_layers": LL_PARITY_LAYERS,
                        "bf16_generate_layers":
                            LLAMA3_8B["num_hidden_layers"],
                        "o2_train_layers": LL_TRAIN_LAYERS},
          "f32_vs_cpu": cases, "f32_dense_equal_paged": dense_eq_paged,
          "bf16": bf16, "train": train, "kernel_times": times,
          "seconds": secs, "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("llama phase failed: greedy ids differ from the CPU, "
                         "dense differs from paged, a launch count shows a "
                         "path off its kernels, the f32 training losses "
                         "differ from the CPU's, or a kernel disagrees with "
                         "its plain version at the Llama shapes")
    # the kernels line counts the first timed bf16 paged generate() (K1,
    # K3) and the O2 steps (K1, K2a, K2b)
    launches = {k: paged0["launches"][k] + dense0["launches"][k]
                for k in KERNEL_COUNTERS}
    launches["flash_attention_fwd"] += o2["flash_attention_fwd"]
    launches["flash_attention_bwd_dkdv"] = o2["flash_attention_bwd_dkdv"]
    launches["flash_attention_bwd_dq"] = o2["flash_attention_bwd_dq"]
    return {"launches": launches, "kernel_shapes": times,
            "k1_f32_prefill_launches": paged0["launches"][
                "flash_attention_fwd"]}


PROFILE_CATEGORIES = (   # device kernel name fragments, first match wins
    # K1: the tensor-core body (flash_fwd_tc_kernel) and the SIMT body
    ("K1 flash_fwd", ("flash_fwd_",)),
    ("K2a flash_bwd_dkdv", ("flash_bwd_dkdv_",)),
    ("K2b flash_bwd_dq", ("flash_bwd_dq_",)),
    # K3 / K4: the split kernel and its merge, told apart by the pools'
    # type (int8_t is "signed char")
    ("K4 paged_flash_decode_q", tuple(f"{k}<{t}, signed char"
                                      for k in ("paged_flash_decode_kernel",
                                                "paged_decode_merge_kernel")
                                      for t in ("float", "__half",
                                                "__nv_bfloat16"))),
    ("K3 paged_flash_decode", ("paged_flash_decode_kernel",
                               "paged_decode_merge_kernel")),
    ("K6 bias_gelu", ("bias_gelu_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax", ("SoftMax",)),
    ("copies and casts", ("copy_kernel", "direct_copy")),
)


# ---------------------------------------------------------------- numerics
def _probed_table(stream):
    """The newest resolved probe table of ``stream``: (sites, [n, 6])."""
    from paddle_tpu_torch.observability import numerics

    numerics.poll()
    ent = numerics.latest(stream)
    return ent["sites"], ent["table"]


def _train_syncs(step, batch):
    """Host syncs of ONE TrainStep call, counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` after an uncounted call."""
    import warnings

    step(batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in rec
            if "called a synchronizing CUDA operation" in str(w.message)]


# probe rows, card against CPU: the activation / gradient absmax and rms
# of two f32 runs (K1 3xTF32 and K2's SIMT body against the plain CPU
# attention) within rtol 1e-3; the fractions within 1e-3 (the qkv bias
# gradients' zero fraction excepted: their key slice is zero in exact
# arithmetic and rounding noise on either device)
PROBE_RTOL, PROBE_FRAC_ATOL = 1e-3, 1e-3
PROBE_STEPS, PROBE_TURN_STEPS = 3, 5


def _probe_rows_agree(card, cpu):
    sites, t = card
    csites, c = cpu
    if tuple(sites) != tuple(csites):
        return False, "site lists differ"
    t, c = np.array(t), np.array(c)
    noise = [i for i, s in enumerate(sites) if s.endswith("qkv.bias")]
    t[noise, 3] = c[noise, 3] = 0.0
    if not np.array_equal(t[:, 0], c[:, 0]):
        return False, "nonfinite counts differ"
    rel = np.abs(t[:, 1:3] - c[:, 1:3]) / np.maximum(np.abs(c[:, 1:3]), 1e-30)
    frac = np.abs(t[:, 3:] - c[:, 3:])
    return (bool(rel.max() <= PROBE_RTOL and frac.max() <= PROBE_FRAC_ATOL),
            {"max_rel_absmax_rms": float(rel.max()),
             "max_abs_fraction": float(frac.max())})


def phase_numerics():
    """Numerics capture and TrainStep observability on GPT-base: f32
    TrainSteps with probes off and on (losses byte-identical, K1 / K2 per
    layer per step), the probed step's rows against the CPU's, one
    ``numerics.nan_inject`` dump naming the first layer, the operator-stats
    collector over every module call, the ``train_step.*`` and ``amp.*``
    series under bf16 O1 with a ``GradScaler``, a step's host syncs with
    probes off and on, and the probed step's cost in turns (bf16 O2 at the
    training shape)."""
    import tempfile

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.observability import (faults, flight_recorder,
                                                numerics)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler import metrics
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    numerics.reset()
    faults.clear()
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, VOCAB, (PARITY_B, PARITY_S)))
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")

    def counted_steps(model, probed, steps=PROBE_STEPS):
        step = _trainer(model)
        x = ids.to(next(model.parameters()).device)
        fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
        losses, tables = [], []
        for _ in range(steps):
            losses.append(step({"input_ids": x, "labels": x}))
            if probed:
                tables.append(_probed_table(step._perf_tag))
        counts = {"flash_attention_fwd": fa.LAUNCHES,
                  "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
                  "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
        return step, torch.stack(losses), tables, counts

    numerics.disable_tensor_checker()
    _, off, _, off_counts = counted_steps(
        copy.deepcopy(cpu_model).to("cuda"), False)
    numerics.enable_tensor_checker(level="warn")
    card_step, on, card_tables, on_counts = counted_steps(
        copy.deepcopy(cpu_model).to("cuda"), True)
    want = dict.fromkeys(on_counts, LAYERS * PROBE_STEPS)
    byte_identical = torch.equal(on, off)
    # the CPU's first probed step, from the same init
    _, cpu_loss, cpu_tables, _ = counted_steps(cpu_model, True, steps=1)
    rows_ok, rows_err = _probe_rows_agree(card_tables[0], cpu_tables[0])
    loss_rel = abs(on[0].item() - cpu_loss[0].item()) / abs(cpu_loss[0].item())
    n_sites = len(card_tables[0][0])
    del cpu_model

    # numerics.nan_inject: one dump naming the first layer
    flight_dir = tempfile.mkdtemp(prefix="numerics_flight_")
    rec = flight_recorder.get_flight_recorder()
    rec.dir = flight_dir
    numerics.enable_tensor_checker(level="dump")
    x = ids.to("cuda")
    card_step({"input_ids": x, "labels": x})
    numerics.poll()
    faults.inject("numerics.nan_inject", times=1)
    card_step({"input_ids": x, "labels": x})
    numerics.poll()
    card_step({"input_ids": x, "labels": x})
    numerics.poll()
    import glob
    import os

    dumps = sorted(glob.glob(os.path.join(flight_dir,
                                          "flight_pid*_numerics_*.json")))
    doc = json.load(open(dumps[0])) if dumps else {"extra": {}}
    first_site = card_tables[0][0][0]
    inject_ok = len(dumps) == 1 and doc["extra"].get("site") == first_site
    faults.clear()
    numerics.disable_tensor_checker()
    del card_step

    # collect_operator_stats over an eval forward: every module call
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda").eval()
    with numerics.collect_operator_stats(model) as col, torch.no_grad():
        model(x)
    called = list(col._cap.sites)
    modules = {n for n, m in model.named_modules()
               if n and not isinstance(m, torch.nn.ModuleList)} \
        | {"gptforcausallm"}
    per_layer = 9           # ln1 qkv out_proj dropout ln2 ffn1 ffn2 dropout
    want_calls = 3 + LAYERS * per_layer + 3   # + layer; embeds+drop; ln, gpt, top
    collect_ok = set(called) == modules and len(called) == want_calls \
        and all(s["nonfinite"] == 0 for s in col.summary().values())

    # bf16 O1 with a GradScaler: the train_step.* and amp.* series
    reg = metrics.get_registry()

    def total(name):
        m = reg.get(name)
        return m.total() if m is not None else None

    before = {n: total(n) or 0 for n in ("train_step.compiles",
                                         "amp.found_inf", "amp.scale_decr")}
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    from paddle_tpu_torch import jit

    model.train()
    step = jit.TrainStep(model, opt, loss_fn=None, amp_level="O1",
                         scaler=amp.GradScaler(init_loss_scaling=2.0 ** 15))
    o1_losses = [step({"input_ids": x, "labels": x}).item()
                 for _ in range(4)]
    step.sync()
    cost = step.cost_analysis()
    steps_seconds = reg.get("train_step.step_seconds").labels()
    syncs_off = _train_syncs(step, {"input_ids": x, "labels": x})
    numerics.enable_tensor_checker(level="warn")
    syncs_on = _train_syncs(step, {"input_ids": x, "labels": x})
    numerics.disable_tensor_checker()
    # the eager scaler: one cycle with a poisoned gradient
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    opt.clear_grad()
    with amp.auto_cast(level="O1"):
        loss = model(x, labels=x)
    sc.scale(loss).backward()
    next(p for p in model.parameters() if p.grad is not None).grad.fill_(
        float("inf"))
    sc.step(opt)
    sc.update()
    opt.clear_grad()
    series = {
        "train_step.compiles": total("train_step.compiles")
        - before["train_step.compiles"],
        "train_step.retraces": total("train_step.retraces"),
        "train_step.compile_seconds": reg.get(
            "train_step.compile_seconds").get(),
        "train_step.step_seconds_count": steps_seconds.count,
        "train_step.donated_bytes": reg.get("train_step.donated_bytes").get(),
        "train_step.flops_per_step": reg.get(
            "train_step.flops_per_step").get(),
        "train_step.achieved_tflops": reg.get(
            "train_step.achieved_tflops").get(),
        "train_step.mfu": reg.get("train_step.mfu").get(),
        "amp.loss_scale": reg.get("amp.loss_scale").get(),
        "amp.found_inf": total("amp.found_inf") - before["amp.found_inf"],
        "amp.scale_decr": total("amp.scale_decr") - before["amp.scale_decr"],
    }
    series_ok = (series["train_step.compiles"] >= 2
                 and series["train_step.compile_seconds"] > 0
                 and series["train_step.step_seconds_count"] > 0
                 and series["train_step.donated_bytes"] > 0
                 and (series["train_step.flops_per_step"] or 0) > 0
                 and series["amp.loss_scale"] is not None
                 and series["amp.found_inf"] == 1
                 and series["amp.scale_decr"] == 1
                 and all(np.isfinite(o1_losses)))
    del step, opt, model

    # the probed step's cost in turns: bf16 O2 at the training shape
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda")
    step = _trainer(model, amp_level="O2")
    xt = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (TRAIN_B, TRAIN_S))).to("cuda")
    batch = {"input_ids": xt, "labels": xt}

    def turn(probed):
        if probed:
            numerics.enable_tensor_checker(level="warn")
        else:
            numerics.disable_tensor_checker()
        step(batch)                          # the variant's first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROBE_TURN_STEPS):
            step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / PROBE_TURN_STEPS * 1e3

    turns = [("plain", turn(False)), ("probed", turn(True)),
             ("probed", turn(True)), ("plain", turn(False))]
    numerics.disable_tensor_checker()
    numerics.poll()
    plain_ms = [t for k, t in turns if k == "plain"]
    probed_ms = [t for k, t in turns if k == "probed"]
    del step, model
    syncs_ok = not syncs_off
    ok = (byte_identical and on_counts == want and off_counts == want
          and rows_ok and loss_rel <= 1e-4 and inject_ok
        and collect_ok and series_ok and syncs_ok)
    emit({"phase": "numerics", "ok": ok,
          "model": "GPT-base 12x768 vocab 50304, f32, AdamW",
          "probes_off_vs_on": {"B": PARITY_B, "S": PARITY_S,
                               "steps": PROBE_STEPS,
                               "losses_off": off.tolist(),
                               "losses_on": on.tolist(),
                               "byte_identical": byte_identical,
                               "launches_on": on_counts,
                               "launches_off_one_step": off_counts},
          "probe_rows_vs_cpu": {"sites": n_sites, "ok": rows_ok,
                                "detail": rows_err,
                                "rtol_absmax_rms": PROBE_RTOL,
                                "atol_fractions": PROBE_FRAC_ATOL,
                                "loss_rel_diff": loss_rel,
                                "first_sites": list(card_tables[0][0][:4])},
          "nan_inject": {"dumps": len(dumps),
                         "site": doc["extra"].get("site"),
                         "want_site": first_site, "ok": inject_ok},
          "collect_operator_stats": {"calls": len(called),
                                     "want_calls": want_calls,
                                     "distinct_sites": len(set(called)),
                                     "modules": len(modules),
                                     "ok": collect_ok},
          "bf16_O1_scaler": {"losses": o1_losses, "series": series,
                             "cost_analysis": cost, "ok": series_ok},
          "host_syncs_per_step": {"probes_off": len(syncs_off),
                                  "probes_off_sites": syncs_off,
                                  "probes_on": len(syncs_on),
                                  "probes_on_sites": syncs_on},
          "probe_cost_bf16_O2": {"B": TRAIN_B, "S": TRAIN_S,
                                 "steps_per_turn": PROBE_TURN_STEPS,
                                 "turns_ms": turns,
                                 "plain_ms_mean": float(np.mean(plain_ms)),
                                 "probed_ms_mean": float(np.mean(probed_ms)),
                                 "probed_over_plain": float(
                                     np.mean(probed_ms) / np.mean(plain_ms))},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("numerics phase failed: probed losses differ from "
                         "the unprobed ones, launch counts, probe rows vs "
                         "the CPU, the nan-inject dump, the collector, the "
                         "train_step / amp series or the host syncs")
    return {"launches": on_counts}


# ------------------------------------------------------------- multitenant
MT_RANKS = (8, 16)
MT_TARGETS = ("qkv", "out_proj")
MT_ADAPTERS = (("tenant-a", 4, 31), ("tenant-b", 8, 32),
               ("tenant-c", 12, 33), ("tenant-d", 16, 34))
# the adapters' draw scale.  Random GPT-base weights leave the residual
# stream to the N(0, 1) embeddings, so greedy ids barely move with an
# adapter: that the tenants bite is read off their embeddings instead
MT_SCALE, MT_NEW, MT_CAPACITY = 0.1, 24, 8
# a tenant's embedding against the base model's on the same prompt
MT_BITE_MIN = 1e-3
MT_SCHEMA = {"type": "object",
             "properties": {"tag": {"enum": ["x", "y"]},
                            "ok": {"type": "boolean"}}}
MT_TURN_REQS = 8
# embeddings and score logprobs, card (f32, K1's 3xTF32 body) against CPU
MT_VALUE_ATOL = 1e-3


def _mt_vocab():
    """A JSON-spellable synthetic vocabulary of GPT-base's 50,304 tokens
    (the reference tests' recipe): characters and literals first, filler,
    EOS last."""
    chars = list("0123456789{}[]\",:-abcdefghijklmnopqrstuvwxyz. _")
    vocab = ["<pad>"] + chars + ["true", "false", "null", '"x"', '"y"']
    vocab += [f"<u{i}>" for i in range(VOCAB - 1 - len(vocab))]
    return vocab + ["<eos>"]


def _mt_store(model):
    from paddle_tpu_torch.serving.multitenant import LoRAAdapter, LoRAStore

    store = LoRAStore(model, capacity=MT_CAPACITY, ranks=MT_RANKS,
                      targets=MT_TARGETS)
    for name, rank, seed in MT_ADAPTERS:
        store.register(LoRAAdapter.random(model, name, rank=rank, seed=seed,
                                          scale=MT_SCALE))
    return store


def _mt_prompts(n=7, seed=21):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 40000, (int(s),)).tolist()
            for s in rs.randint(24, 160, (n,))]


def _mt_rows(grammar):
    """The mixed batch: three adapters (two rank buckets), a base row, a
    JSON-schema row, an embed and a score request."""
    p = _mt_prompts()
    return [("tenant-a", p[0], {"adapter": "tenant-a"}),
            ("tenant-b", p[1], {"adapter": "tenant-b"}),
            ("tenant-c", p[2], {"adapter": "tenant-c"}),
            ("base", p[3], {}),
            ("schema", p[4], {"grammar": grammar}),
            ("embed", p[5], {"mode": "embed"}),
            ("score", p[6], {"mode": "score"})]


def _mt_engine(model, store, device="cuda", **kw):
    from paddle_tpu_torch.serving.multitenant import MultiTenantEngine

    kw.setdefault("num_slots", SLOTS)
    return MultiTenantEngine(model, lora_store=store, device=device,
                             page_size=PAGE, max_model_len=MAXLEN, **kw)


def _mt_serve(eng, rows, new=MT_NEW):
    """Submit ``rows`` at once through a started engine; returns the
    results by row name (ids, or embed / score arrays) and the handles."""
    hs = {name: eng.submit(p, max_new_tokens=new, **kw)
          for name, p, kw in rows}
    out = {}
    for name, h in hs.items():
        r = h.result(timeout=900)
        out[name] = np.asarray(r) if h.mode != "generate" else list(r)
    return out, hs


def _mt_counted(eng, rows, new=MT_NEW):
    """``_mt_serve`` with the kernel counters zeroed just before and read
    just after, held to exact counts: K1 once per layer per prefill and
    per embed / score dispatch, the decode kernel of the pool layout once
    per layer per decode step (and per verify step through the chunk
    attend), the other one never."""
    _zero_counts()
    st0 = eng.stats()
    n_pass = sum(1 for _, _, kw in rows if kw.get("mode") in ("embed",
                                                                "score"))
    with eng:
        out, hs = _mt_serve(eng, rows, new)
        st = eng.stats()
    counts = _read_counts()
    d = {k: st[k] - st0[k] for k in ("prefills", "iteration",
                                      "verify_steps")}
    quant = st["kv_dtype"] == "int8"
    decode = "paged_flash_decode_q" if quant else "paged_flash_decode"
    via = "via_paged_chunk_attend_quant" if quant \
        else "via_paged_chunk_attend"
    want = dict.fromkeys(COUNTERS, 0)
    want["flash_attention_fwd"] = LAYERS * (d["prefills"] + n_pass)
    want[decode] = LAYERS * d["iteration"]
    want[via] = LAYERS * d["verify_steps"]
    if counts != want or not counts[decode]:
        raise SystemExit(f"multitenant: launch counts {counts} != expected "
                         f"{want}: the path did not run through the kernels")
    return out, hs, counts, d


def _mt_syncs(eng, prompts, grammar):
    """Host syncs of ONE multi-tenant decode step with a LoRA row and a
    constrained row live (the mask rows are fed that step), counted as
    ``_step_syncs`` counts them, after one uncounted step."""
    import warnings

    from paddle_tpu_torch.observability import faults

    site = f"serving.scheduler_wedge@{eng.replica}"
    with eng:
        eng.generate(prompts[0][:32], max_new_tokens=2, timeout=300)
        faults.inject(site, seconds=60.0, times=1)
        while faults.trip_count(site) < 1:
            time.sleep(0.005)
        hs = [eng.submit(prompts[0], max_new_tokens=6, adapter="tenant-a"),
              eng.submit(prompts[1], max_new_tokens=6, grammar=grammar)]
        with torch.inference_mode():
            eng._admit()
            active = [i for i, s in enumerate(eng._slots) if s is not None]
            eng._plain_step(active)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng._plain_step(active)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        faults.clear(site)
        for h in hs:
            h.result(timeout=300)
    sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in rec
             if "called a synchronizing CUDA operation" in str(w.message)]
    return {"active": len(active), "syncs": len(sites), "sites": sites}


def _mt_parses(out, vocab, grammar):
    text = "".join(vocab[t] for t in out if t != grammar.eos_token_id)
    try:
        doc = json.loads(text)
    except ValueError:
        return False, text
    return (out[-1] == grammar.eos_token_id and grammar.matches(out)
            and set(doc) == set(MT_SCHEMA["properties"])), text


def _mt_dedicated(model, store, rows):
    """Each generate row of ``rows`` alone: adapter / schema rows on a
    dedicated multi-tenant engine, the base row on a plain engine, all
    with ``num_slots`` = 8."""
    from paddle_tpu_torch.serving import ServingEngine

    out = {}
    for name, p, kw in rows:
        if kw.get("mode") in ("embed", "score"):
            continue
        eng = ServingEngine(model, num_slots=SLOTS, page_size=PAGE,
                            max_model_len=MAXLEN) if name == "base" \
            else _mt_engine(model, store)
        with eng:
            out[name] = eng.generate(p, max_new_tokens=MT_NEW, timeout=900,
                                     **kw)
    return out


def _mt_bites(eng, prompt, names):
    """Max |embedding(tenant) - embedding(base)| on ``prompt`` per
    tenant: an adapter that changes nothing reads 0."""
    hs = {n: eng.submit(prompt, mode="embed", adapter=n)
          for n in (None, *names)}
    emb = {n: np.asarray(h.result(timeout=900)) for n, h in hs.items()}
    return {n: float(np.abs(emb[n] - emb[None]).max()) for n in names}


def _mt_wave(eng, prompts, names):
    """One timed wave through a warm engine: ``prompts`` at once, 32 new
    tokens each (``names``: each row's adapter, None = base)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=32,
                     **({"adapter": n} if n else {}))
          for p, n in zip(prompts, names)]
    outs = [h.result(timeout=900) for h in hs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    itl = [b - a for h in hs for a, b in zip(h.token_times, h.token_times[1:])]
    toks = sum(len(o) for o in outs)
    return {"wall_s": wall, "tokens_per_s": toks / wall,
            "ttft_p50_s": _q([h.ttft for h in hs], 50),
            "itl_p50_s": _q(itl, 50), "itl_p99_s": _q(itl, 99)}, outs


def phase_multitenant():
    """Multi-tenant serving on GPT-base (12 x 768, 12 heads, vocab 50,304,
    page 16, length 1024, 8 slots): a ``LoRAStore`` of ranks (8, 16) over
    ``qkv`` / ``out_proj`` with 4 seeded adapters; one mixed batch (3
    adapters, a base row, a JSON-schema row, an embed and a score
    request) in f32 on the card against the CPU, each generate row against
    a dedicated engine in f32 and bf16; the grammar row with speculative
    k=4; embed / score allocating no page; a hot swap during serving with
    no mint and no recapture; int8 pools (K4, no K3); exact launch
    counts; a decode step's host syncs; the bf16 cost against a plain
    engine in turns, with the card's idle share; and the grammar's host
    cost at the full vocabulary."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.multitenant import (LoRAAdapter,
                                                      compile_json_schema)
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    vocab = _mt_vocab()
    t0 = time.perf_counter()
    grammar = compile_json_schema(MT_SCHEMA, vocab, VOCAB - 1)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grammar.allowed(grammar.start)
    first_state_ms = (time.perf_counter() - t0) * 1e3
    expand = {"states": 0, "seconds": 0.0}
    inner = grammar._expand_locked

    def timed_expand(sid):
        if grammar._tok_trans[sid] is None:
            t = time.perf_counter()
            inner(sid)
            expand["states"] += 1
            expand["seconds"] += time.perf_counter() - t
        else:
            inner(sid)

    grammar._expand_locked = timed_expand
    rows = _mt_rows(grammar)
    prompts = [p for _, p, _ in rows]

    # f32: the card against the CPU, one mixed batch each
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")
    model = copy.deepcopy(cpu_model).to("cuda")
    store = _mt_store(model)
    eng = _mt_engine(model, store, replica="mt-f32")
    card, hs, counts_f32, d_f32 = _mt_counted(eng, rows)
    t0 = time.perf_counter()
    with _mt_engine(cpu_model, _mt_store(cpu_model), device="cpu",
                    replica="mt-cpu") as ceng:
        cpu, _ = _mt_serve(ceng, rows)
    cpu_s = time.perf_counter() - t0
    del cpu_model, ceng
    gen_rows = [n for n, _, kw in rows if kw.get("mode") is None]
    ids_equal = all(card[n] == cpu[n] for n in gen_rows)
    value_err = {n: float(np.abs(card[n] - cpu[n]).max())
                 for n in ("embed", "score")}
    values_ok = all(v <= MT_VALUE_ATOL for v in value_err.values()) and \
        card["embed"].shape == (HIDDEN,) and \
        len(card["score"]) == len(prompts[6]) - 1
    schema_ok, schema_text = _mt_parses(card["schema"], vocab, grammar)
    grammar_wall = hs["schema"].finished_at - hs["schema"].submitted_at
    no_pages = eng.block_manager.used_pages == 0

    # each generate row alone on a dedicated engine: byte-equal, f32
    dedicated = _mt_dedicated(model, store, rows)
    f32_equal = all(dedicated[n] == card[n] for n in gen_rows)

    # embed / score alone: one dispatch each, no page ever allocated
    peng = _mt_engine(model, store, replica="mt-pass")
    with peng:
        _mt_serve(peng, rows[5:])
        # every tenant moves the hidden states away from the base model's
        bites = _mt_bites(peng, prompts[5], [n for n, _, _ in MT_ADAPTERS])
        pass_pages = peng.block_manager.used_pages
        pass_prefills = peng.stats()["prefills"]
        pass_alloc = peng.block_manager.stats()
    tenants_differ = min(bites.values()) > MT_BITE_MIN
    passthrough_ok = pass_pages == 0 and pass_prefills == 0

    # the schema row with speculative k=4: the same ids
    seng = _mt_engine(model, store, speculative_k=SPEC_K, replica="mt-spec")
    spec, _, counts_spec, d_spec = _mt_counted(seng, rows[4:5] + rows[:1])
    spec_equal = spec["schema"] == card["schema"] and \
        spec["tenant-a"] == card["tenant-a"]

    # hot swap while serving: no mint, no recapture, pools written in place
    heng = _mt_engine(model, store, replica="mt-hot")
    with heng:
        _mt_serve(heng, rows[:4])                       # warm every program
        mints0 = heng.program_traces()
        graphs0 = {k: id(p.graph) for k, p in heng._graphs.items()}
        ptrs0 = [p.data_ptr() for p in store.device_args()]
        long = heng.submit(prompts[0], max_new_tokens=MT_NEW,
                           adapter="tenant-a")
        store.register(LoRAAdapter.random(model, "tenant-e", rank=8,
                                          seed=35, scale=MT_SCALE))
        hot = heng.submit(prompts[1], max_new_tokens=MT_NEW,
                          adapter="tenant-e")
        long.result(timeout=900)
        hot_ids = hot.result(timeout=900)
        hot_mints = heng.program_traces() - mints0
        graphs1 = {k: id(p.graph) for k, p in heng._graphs.items()}
        recaptures = sum(1 for k in graphs1 if graphs0.get(k) != graphs1[k])
        hot_bite = _mt_bites(heng, prompts[5], ["tenant-e"])["tenant-e"]
    in_place = [p.data_ptr() for p in store.device_args()] == ptrs0
    # the swapped-in tenant serves what a dedicated engine serves for it
    with _mt_engine(model, store, replica="mt-hot-ded") as deng:
        hot_ded = deng.generate(prompts[1], max_new_tokens=MT_NEW,
                                adapter="tenant-e", timeout=900)
    hot_ok = hot_mints == 0 and recaptures == 0 and in_place and \
        hot_ids == hot_ded and hot_bite > MT_BITE_MIN

    # int8 pools: K4, no K3
    qeng = _mt_engine(model, store, kv_dtype="int8", replica="mt-int8")
    qout, _, counts_int8, d_int8 = _mt_counted(qeng, rows)
    int8_ok = counts_int8["paged_flash_decode_q"] > 0 and \
        counts_int8["paged_flash_decode"] == 0
    int8_first = sum(qout[n][0] == card[n][0] for n in gen_rows)

    # a decode step's host syncs (a LoRA row and a constrained row live)
    syncs = _mt_syncs(_mt_engine(model, store, num_slots=2,
                                 replica="mt-syncs"), prompts, grammar)
    del model, store, eng, peng, seng, heng, qeng
    torch.cuda.empty_cache()

    # bf16: the mixed batch against dedicated engines, then the cost
    torch.manual_seed(0)
    bmodel = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    bstore = _mt_store(bmodel)
    with _mt_engine(bmodel, bstore, replica="mt-bf16") as beng:
        bf16, _ = _mt_serve(beng, rows)
    bdedicated = _mt_dedicated(bmodel, bstore, rows)
    bf16_equal = all(bdedicated[n] == bf16[n] for n in gen_rows)
    bschema_ok, _ = _mt_parses(bf16["schema"], vocab, grammar)

    turn_prompts = _mt_prompts(MT_TURN_REQS, seed=22)
    names = [("tenant-a", "tenant-b", "tenant-c", None)[i % 4]
             for i in range(MT_TURN_REQS)]
    plain = ServingEngine(bmodel, num_slots=SLOTS, page_size=PAGE,
                          max_model_len=MAXLEN, replica="mt-plain-turns")
    mt = _mt_engine(bmodel, bstore, replica="mt-turns")
    arms = {"plain": (plain, [None] * MT_TURN_REQS), "mt": (mt, names)}
    turns = []
    with plain, mt:
        for arm in ("plain", "mt"):                    # warm both
            _mt_wave(arms[arm][0], turn_prompts, arms[arm][1])
        for arm in ("plain", "mt", "mt", "plain"):
            r, _ = _mt_wave(arms[arm][0], turn_prompts, arms[arm][1])
            turns.append(dict(r, arm=arm))
        from paddle_tpu_torch.profiler import Profiler

        idle = {}
        for arm in ("plain", "mt"):
            prof = Profiler()
            prof.start()
            r, _ = _mt_wave(arms[arm][0], turn_prompts, arms[arm][1])
            prof.stop()
            idle[arm] = _device_share(prof, r["wall_s"])
        steps = {arm: arms[arm][0].stats()["iteration"] for arm in arms}
    mean = {arm: float(np.mean([t["tokens_per_s"] for t in turns
                                if t["arm"] == arm])) for arm in arms}
    del bmodel, bstore, plain, mt
    torch.cuda.empty_cache()

    launches = {k: counts_f32.get(k, 0) + counts_int8.get(k, 0)
                + counts_spec.get(k, 0) for k in KERNEL_COUNTERS}
    ok = (ids_equal and values_ok and tenants_differ and schema_ok
          and no_pages and f32_equal and passthrough_ok and spec_equal
          and hot_ok and int8_ok and syncs["syncs"] == 1 and bf16_equal
          and bschema_ok)
    emit({"phase": "multitenant", "ok": ok,
          "model": "GPT-base 12x768 vocab 50304, page 16, length 1024, "
                   "8 slots",
          "store": {"ranks": MT_RANKS, "targets": MT_TARGETS,
                    "capacity": MT_CAPACITY,
                    "adapters": [{"name": n, "rank": r, "seed": s}
                                 for n, r, s in MT_ADAPTERS],
                    "scale": MT_SCALE},
          "f32_card_vs_cpu": {"ids_equal": ids_equal,
                              "value_max_abs_err": value_err,
                              "value_atol": MT_VALUE_ATOL,
                              "values_ok": values_ok,
                              "tenants_differ": tenants_differ,
                              "embedding_vs_base_max_abs": bites,
                              "launches": counts_f32, "steps": d_f32,
                              "cpu_reference_s": cpu_s},
          "schema_row": {"parses": schema_ok, "text": schema_text,
                         "bf16_parses": bschema_ok},
          "dedicated_byte_equal": {"f32": f32_equal, "bf16": bf16_equal},
          "embed_score_pages": {"used_pages": pass_pages,
                                "prefills": pass_prefills,
                                "kv_cache": {k: pass_alloc[k] for k in
                                             ("used_pages", "free_pages")
                                             if k in pass_alloc},
                                "ok": passthrough_ok},
          "speculative_k4": {"ids_equal": spec_equal,
                             "launches": counts_spec, "steps": d_spec},
          "hot_swap": {"new_mints": hot_mints, "recaptures": recaptures,
                       "pools_in_place": in_place,
                       "ids_equal_dedicated": hot_ids == hot_ded,
                       "embedding_vs_base_max_abs": hot_bite,
                       "ok": hot_ok},
          "int8_pools": {"ok": int8_ok, "launches": counts_int8,
                         "steps": d_int8,
                         "first_tokens_equal_native": int8_first},
          "host_syncs_per_decode_step": syncs,
          "grammar_full_vocab": {"vocab": VOCAB, "compile_s": compile_s,
                                 "first_state_expansion_ms": first_state_ms,
                                 "states_expanded_in_run": expand["states"],
                                 "expansion_s_in_run": expand["seconds"],
                                 "schema_request_wall_s": grammar_wall,
                                 "expansion_share_of_that_wall":
                                     expand["seconds"] / grammar_wall},
          "bf16_cost_in_turns": {"requests": MT_TURN_REQS, "new_tokens": 32,
                                 "mt_rows": names, "turns": turns,
                                 "tokens_per_s_mean": mean,
                                 "mt_over_plain": mean["mt"] / mean["plain"],
                                 "idle_share": {a: idle[a].get(
                                     "device_idle_share") for a in idle},
                                 "profiled": idle,
                                 "decode_steps_total": steps},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("multitenant phase failed: see the line above")
    return {"launches": launches}


# ----------------------------------------------------------------- cluster
# the example's traffic at GPT-base: templates x requests each, prompts of
# CL_PROMPT tokens (a template's first CL_PROMPT - 6 tokens + 6 of its own),
# CL_NEW new tokens; 2 replicas of CL_SLOTS slots (one engine of SLOTS
# slots in the bf16 turns: the same total)
CL_TEMPLATES, CL_PER, CL_PROMPT, CL_NEW, CL_SLOTS = 3, 3, 256, 32, 4
CL_AUTOSCALE = {"min_replicas": 2, "max_replicas": 3, "scale_up_queue": 1.0,
                "stable_s": 0.1, "cooldown_s": 0.3, "interval_s": 0.05}
CL_BURST = 24
# the bf16 record's window: the same templates, CL_RECORD_PER requests each
CL_RECORD_PER = 128
# add_replica / reap cycles of the memory check (the first sets the
# baseline)
CL_MEM_CYCLES = 3


def cluster_requests(per=CL_PER):
    """(template id, prompt) pairs: CL_TEMPLATES shared prefixes, ``per``
    requests each (the example's traffic at CL_PROMPT tokens), drawn from
    the first seed whose templates reach both replicas (with seed 0 all
    three hash to one), so both replicas serve in every run."""
    from paddle_tpu_torch.serving.cluster import PrefixAffinityRouter

    router = PrefixAffinityRouter(2, affinity_tokens=2 * PAGE)
    for seed in range(100):
        rs = np.random.RandomState(seed)
        temps = [rs.randint(1, VOCAB, (CL_PROMPT - 6,)).tolist()
                 for _ in range(CL_TEMPLATES)]
        if len({router.affine_index(t) for t in temps}) == 2:
            return [(g, t + rs.randint(1, VOCAB, (6,)).tolist())
                    for g, t in enumerate(temps) for _ in range(per)]
    raise SystemExit("cluster phase: no seed spreads the templates")


def _cluster(model, name, device=None, **kw):
    from paddle_tpu_torch.serving import ServingCluster

    kw.setdefault("replicas", 2)
    kw.setdefault("num_slots", CL_SLOTS)
    if device is not None:
        kw["device"] = device
    return ServingCluster(model, page_size=PAGE, max_model_len=MAXLEN,
                          name=name, replica_prefix=f"{name}/", **kw)


def _cluster_serve(cl, prompts, new=None, **submit_kw):
    """Submit every prompt at once (``new`` tokens each, CL_NEW by
    default); the ids, each request's replica history, TTFT and the
    wall."""
    new = new or CL_NEW
    t0 = time.perf_counter()
    hs = [cl.submit(p, max_new_tokens=new, **submit_kw) for p in prompts]
    outs = [h.result(timeout=900) for h in hs]
    if next(cl.engines[0]._model.parameters()).is_cuda:
        _stream_sync()
    return {"outs": outs, "history": [h.replica_history for h in hs],
            "ttft": [h.ttft for h in hs], "wall_s": time.perf_counter() - t0}


def _replica(cl, replica):
    return next(e for e in cl.engines if e.replica == replica)


def _indices(histories):
    """Replica histories without the cluster's name."""
    return [[r.rsplit("/", 1)[-1] for r in h] for h in histories]


def _summed_stats(engines):
    st = {"prefills": 0, "cached_prefills": 0, "iteration": 0}
    for e in engines:
        s = e.stats()
        for k in st:
            st[k] += s[k]
    return st


def _stream_sync():
    """Wait for this thread's stream only: a device-wide synchronize while
    an engine thread captures a graph (a replica warming up) is illegal
    and would invalidate that capture."""
    torch.cuda.current_stream().synchronize()


def _card_bytes():
    """Allocated card memory, garbage collected, with no engine running."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _engine_step_syncs(eng, prompts):
    """Host syncs of ONE plain decode step of a live engine (see
    ``_step_syncs``): the step is run from this thread while the
    scheduler sits in a wedge, after one uncounted step."""
    import warnings

    from paddle_tpu_torch.observability import faults

    site = f"serving.scheduler_wedge@{eng.replica}"
    faults.inject(site, seconds=60.0, times=1)
    while faults.trip_count(site) < 1:
        time.sleep(0.005)
    hs = [eng.submit(p, max_new_tokens=4) for p in prompts[:2]]
    with torch.inference_mode():
        eng._admit()
        active = [i for i, s in enumerate(eng._slots) if s is not None]
        eng._plain_step(active)
        _stream_sync()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng._plain_step(active)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    faults.clear(site)
    for h in hs:
        h.result(timeout=300)
    return {"replica": eng.replica, "active": len(active),
            "syncs": sum(1 for w in rec if "called a synchronizing CUDA "
                         "operation" in str(w.message))}


def _wait_for(cond, what, budget=120.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > budget:
            raise SystemExit(f"cluster phase: {what} did not happen within "
                             f"{budget:.0f}s")
        time.sleep(0.01)


def phase_cluster():
    """Cluster serving on GPT-base (12 x 768, vocab 50,304, random weights
    from ``torch.manual_seed(0)``): the example's traffic (3 templates of
    256 tokens x 3 requests, 32 new) through a two-replica
    ``ServingCluster`` on the card in f32 against the same cluster on the
    CPU (ids equal, each template on its affine replica, K1 / K3 counted;
    the gated clusters run without the prefix cache, whose cached-tail
    prefill rounds differently from a full one, so the ids compare one
    path); the bf16 turns run it, as the example does;
    a replica stopped mid-decode (f32 ids equal the uninterrupted run's;
    bf16 agreement reported); ``cluster.replica_preempt@<r>`` reaped and
    replaced by the ``AutoScaler`` from a warmup manifest (0 mints) while
    the survivor serves, then a burst scaling up to 3 and draining back;
    an int8-pool cluster (K4, no K3); a ``lora_store=`` cluster keeping
    adapter affinity; one host sync per decode step; the card's memory
    flat over add_replica / reap cycles after the first (no cuBLAS
    workspace cleared); and bf16 tokens/s and TTFT p50 of the cluster
    against one engine of the same total slots, in turns over
    CL_RECORD_PER requests of each template, with each replica's
    request count."""
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.multitenant import (LoRAAdapter, LoRAStore,
                                                      MultiTenantEngine)
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = cluster_requests()
    prompts = [p for _, p in reqs]
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")
    model = copy.deepcopy(cpu_model).to("cuda")
    base_bytes = _card_bytes()
    checks, out = {}, {}

    # 1. the traffic, CPU cluster against the card's
    cpu_cl = _cluster(cpu_model, "cl-cpu", device="cpu", saturation_queue=32)
    with cpu_cl:
        ref = _cluster_serve(cpu_cl, prompts)
    del cpu_cl
    cl = _cluster(model, "cl-f32", saturation_queue=32)
    _zero_counts()
    with cl:
        run = _cluster_serve(cl, prompts)
        every = _read_counts()
        st = _summed_stats(cl.engines)
        affine = [cl.router.affine_index(p) for p in prompts]
        syncs = [_engine_step_syncs(e, prompts) for e in cl.engines]
        # a replica stopped mid-decode: one template's requests
        lost = list(range(CL_PER))
        hs = [cl.submit(prompts[i], max_new_tokens=CL_NEW) for i in lost]
        _wait_for(lambda: all(len(h.token_ids) >= 4 for h in hs),
                  "tokens before the stop")
        victim = _replica(cl, hs[0].replica_history[0])
        victim.stop()
        fail_outs = [h.result(timeout=900) for h in hs]
        fail_hist = [h.replica_history for h in hs]
        manifest = cl.engines[0].capture_manifest()
    counts = {k: every[k] for k in KERNEL_COUNTERS}
    want = _prefix_want(st, quant=False)
    checks["f32_ids_equal_cpu"] = run["outs"] == ref["outs"]
    checks["f32_history_equal_cpu"] = _indices(run["history"]) \
        == _indices(ref["history"])
    checks["each_template_on_its_affine_replica"] = all(
        h == [f"cl-f32/{a}"] for h, a in zip(run["history"], affine))
    checks["launches_match"] = every == want and counts[
        "flash_attention_fwd"] > 0 and counts["paged_flash_decode"] > 0
    checks["failover_f32_ids_equal"] = fail_outs == [ref["outs"][i]
                                                     for i in lost]
    checks["failover_rerouted"] = all(len(h) == 2 for h in fail_hist)
    checks["one_sync_per_decode_step"] = all(s["syncs"] == 1 for s in syncs)
    out["f32"] = {"wall_s": run["wall_s"], "cpu_wall_s": ref["wall_s"],
                  "history": run["history"], "affine": affine,
                  "stats": st, "launches": counts, "want": want,
                  "failover_history": fail_hist, "syncs": syncs}
    launches = dict(counts)
    del cl, victim, hs

    # 2. bf16: failover agreement (not gated); the record, cluster against
    # one engine of the same total slots in turns, over a window of
    # CL_RECORD_PER requests of each template, all submitted at once
    window = [p for _, p in cluster_requests(CL_RECORD_PER)]
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    c16 = _cluster(model16, "cl-bf16", prefix_sharing=True)
    e16 = ServingEngine(model16, num_slots=2 * CL_SLOTS, page_size=PAGE,
                        max_model_len=MAXLEN, prefix_sharing=True,
                        replica="cl-bf16-one")
    turns = []
    with c16, e16:
        _cluster_serve(c16, prompts)                     # warm both
        hs = [e16.submit(p, max_new_tokens=CL_NEW) for p in prompts]
        [h.result(timeout=900) for h in hs]
        for arm in ("cluster", "engine", "engine", "cluster"):
            by_replica = None
            if arm == "cluster":
                r = _cluster_serve(c16, window)
                by_replica = {}
                for h in _indices(r["history"]):
                    by_replica[h[-1]] = by_replica.get(h[-1], 0) + 1
            else:
                t0 = time.perf_counter()
                hs = [e16.submit(p, max_new_tokens=CL_NEW) for p in window]
                outs = [h.result(timeout=900) for h in hs]
                _stream_sync()
                r = {"outs": outs, "ttft": [h.ttft for h in hs],
                     "wall_s": time.perf_counter() - t0}
            toks = sum(len(o) for o in r["outs"])
            turns.append({"arm": arm, "requests": len(window),
                          "tokens": toks, "wall_s": r["wall_s"],
                          "tokens_per_s": toks / r["wall_s"],
                          "ttft_p50_ms": 1e3 * float(np.median(r["ttft"])),
                          "requests_by_replica": by_replica})
        un16 = _cluster_serve(c16, [prompts[i] for i in lost])["outs"]
        hs = [c16.submit(prompts[i], max_new_tokens=CL_NEW) for i in lost]
        _wait_for(lambda: all(len(h.token_ids) >= 4 for h in hs),
                  "bf16 tokens before the stop")
        _replica(c16, hs[0].replica_history[0]).stop()
        f16 = [h.result(timeout=900) for h in hs]
    agree = [sum(a == b for a, b in zip(x, y)) / max(len(y), 1)
             for x, y in zip(f16, un16)]
    rate = {a: np.mean([t["tokens_per_s"] for t in turns if t["arm"] == a])
            for a in ("cluster", "engine")}
    out["bf16"] = {"turns": turns,
                   "cluster_over_engine_tokens_per_s":
                       float(rate["cluster"] / rate["engine"]),
                   "failover_token_agreement": agree,
                   "failover_ids_equal": f16 == un16}
    del c16, e16, model16
    _free_card()

    # 3. replica loss + AutoScaler (warm replacement), then a burst
    rc = _cluster(model, "cl-scale", warmup=manifest, autoscale=CL_AUTOSCALE)
    with rc:
        n0 = rc.engines[0].program_traces()
        victim = rc.pool.engines[0].replica
        hs = [rc.submit(p, max_new_tokens=CL_NEW) for p in prompts[:6]]
        faults.inject(f"cluster.replica_preempt@{victim}", times=1)
        try:
            reap_outs = [h.result(timeout=900) for h in hs]
        finally:
            faults.clear()
        _wait_for(lambda: victim not in [e.replica for e in rc.engines]
                  and len(rc.engines) >= 2, "the reap and replacement")
        fresh = rc.engines[-1]
        _wait_for(lambda: fresh._started, "the replacement's start")
        # the replacement serves (its affine traffic) with the CPU's ids
        mine = [i for i, p in enumerate(prompts)
                if rc.router.affine_index(p) == len(rc.engines) - 1][:2] \
            or [0]
        after = [rc.generate(prompts[i], max_new_tokens=CL_NEW, timeout=900)
                 for i in mine]
        mints = rc.engines[0].program_traces() - n0
        # a burst: the pool grows to 3 while the others replay (sustained
        # pressure, in waves of CL_BURST until the autoscaler adds one),
        # and drains back to 2
        burst, which, t0 = [], [], time.monotonic()
        while [r["event"] for r in rc.autoscaler.timeline()].count("up") < 2:
            if time.monotonic() - t0 > 120:
                raise SystemExit("cluster phase: no scale-up under the burst")
            which += [i % len(prompts) for i in range(CL_BURST)]
            burst += [rc.submit(prompts[i % len(prompts)],
                                max_new_tokens=CL_NEW)
                      for i in range(CL_BURST)]
            time.sleep(0.05)
        burst_outs = [h.result(timeout=900) for h in burst]
        _wait_for(lambda: len(rc.engines) == 2
                  and rc.autoscaler.retiring is None
                  and "down" in [r["event"] for r in
                                 rc.autoscaler.timeline()],
                  "the scale-down")
        events = [r["event"] for r in rc.autoscaler.timeline()]
        peak_replicas = max(r["replicas"] for r in rc.autoscaler.timeline())
    checks["reap_ids_equal_cpu"] = reap_outs == ref["outs"][:6]
    checks["replacement_ids_equal_cpu"] = after == [ref["outs"][i]
                                                    for i in mine]
    checks["replacement_warm_zero_mints"] = mints == 0 \
        and bool(fresh._warmed and fresh._warmed["warmed"])
    checks["burst_scaled_to_3_and_back"] = peak_replicas == 3 \
        and events.index("reap") < events.index("drain") \
        < events.index("down")
    checks["burst_ids_equal_cpu"] = burst_outs == [ref["outs"][i]
                                                   for i in which]
    out["autoscale"] = {"timeline": events, "peak_replicas": peak_replicas,
                        "mints": mints, "warmup": fresh._warmed,
                        "burst_requests": len(burst),
                        "burst_replicas": sorted({h.replica_history[-1]
                                                  for h in burst}),
                        "victim": victim,
                        "replacement": fresh.replica}
    del rc, fresh, hs, burst

    # 4. int8 pools: K4 only
    qc = _cluster(model, "cl-int8", kv_dtype="int8")
    _zero_counts()
    with qc:
        qrun = _cluster_serve(qc, prompts[:6])
        qevery = _read_counts()
        qst = _summed_stats(qc.engines)
    qcounts = {k: qevery[k] for k in KERNEL_COUNTERS}
    checks["int8_launches"] = qevery == _prefix_want(qst, quant=True) \
        and qcounts["paged_flash_decode_q"] > 0 \
        and qcounts["paged_flash_decode"] == 0
    out["int8"] = {"launches": qcounts, "stats": qst,
                   "complete": all(len(o) == CL_NEW for o in qrun["outs"])}
    launches["flash_attention_fwd"] += qcounts["flash_attention_fwd"]
    launches["paged_flash_decode_q"] = qcounts["paged_flash_decode_q"]
    del qc

    # the card's memory over add_replica / reap cycles, with no workspace
    # cleared: each cycle warms two replicas from the manifest, adds a
    # third that captures while the two replay, preempts one mid-decode
    # (the autoscaler reaps it) and stops.  cuBLAS keeps a workspace per
    # (handle, stream) for the process's life, and a capture stream per
    # handle (jit/graphs.py): the first cycle may add workspaces for new
    # handles and sets the baseline; no later cycle may grow it.
    cycle_bytes, cycle_ok = [], []
    for c in range(CL_MEM_CYCLES):
        mc = _cluster(model, f"cl-mem{c}", warmup=manifest,
                      autoscale=dict(CL_AUTOSCALE, scale_up_queue=1e9,
                                     stable_s=1e9))
        # pace the schedulers (3 ms a step) so the preempt lands mid-decode
        faults.inject("serving.step_crash", fn=lambda: time.sleep(0.003))
        try:
            with mc:
                hs = [mc.submit(p, max_new_tokens=CL_NEW)
                      for p in prompts[:6]]
                third = mc.pool.add_replica()
                _wait_for(lambda: all(len(h.token_ids) >= 2 for h in hs),
                          "tokens before the preempt")
                victim = hs[0].replica_history[0]
                faults.inject(f"cluster.replica_preempt@{victim}", times=1)
                outs = [h.result(timeout=900) for h in hs]
                _wait_for(lambda: victim not in [e.replica
                                                 for e in mc.engines],
                          "the reap")
                cycle_ok.append({
                    "ids_equal_cpu": outs == ref["outs"][:6],
                    "third_warmed": bool(third._warmed["warmed"]),
                    "replicas": [e.replica for e in mc.engines],
                    "timeline": [r["event"]
                                 for r in mc.autoscaler.timeline()]})
        finally:
            faults.clear()
        del mc, hs, third
        cycle_bytes.append(_card_bytes())
    checks["memory_cycles_ids_equal_cpu"] = all(
        c["ids_equal_cpu"] and c["third_warmed"] and c["timeline"] == ["reap"]
        and len(c["replicas"]) == 2 for c in cycle_ok)
    checks["memory_flat_after_first_cycle"] = all(
        b == cycle_bytes[0] for b in cycle_bytes[1:])
    out["memory"] = {"before_the_clusters_bytes": base_bytes,
                     "after_each_cycle_bytes": cycle_bytes,
                     "cycles": cycle_ok}

    # 5. lora_store=: adapter affinity
    store = LoRAStore(model, capacity=4, ranks=(8,),
                      targets=("qkv", "out_proj"))
    for i in range(2):
        store.register(LoRAAdapter.random(model, f"t{i}", rank=8,
                                          seed=31 + i, scale=0.1))
    ded = MultiTenantEngine(model, lora_store=store, num_slots=CL_SLOTS,
                            page_size=PAGE, max_model_len=MAXLEN,
                            replica="cl-lora-one")
    with ded:
        lref = [ded.generate(p, max_new_tokens=8, adapter="t0", timeout=900)
                for p in prompts[:3]]
    lc = _cluster(model, "cl-lora", lora_store=store)
    with lc:
        target = lc.router.affine_index([], adapter="t0")
        lh = []
        for p in prompts[:3]:
            h = lc.submit(p, max_new_tokens=8, adapter="t0")
            h.result(timeout=900)
            lh.append(h)
    checks["lora_adapter_affinity"] = all(
        h.replica_history == [f"cl-lora/{target}"] for h in lh)
    checks["lora_ids_equal_dedicated"] = [h.result() for h in lh] == lref
    del lc, ded, store, lh
    ok = all(checks.values())
    emit({"phase": "cluster", "ok": ok, "checks": checks,
          "model": "GPT-base 12x768 vocab 50304",
          "traffic": {"templates": CL_TEMPLATES, "per_template": CL_PER,
                      "prompt_tokens": CL_PROMPT, "new_tokens": CL_NEW,
                      "replicas": 2, "slots_per_replica": CL_SLOTS},
          **out, "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit(f"cluster phase failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    del model, cpu_model
    _free_card()
    return {"launches": launches}


# ---------------------------------------------------------------- finetune
# the recipe's tiny default (examples/finetune_llama.py's flags), and its
# run at Llama-3-8B's widths cut to FT_LAYERS deep
FT_TINY_STEPS = 30
FT_LAYERS, FT_B, FT_S, FT_ACCUM, FT_STEPS = 2, 8, 1024, 2, 4


def _rel_norm(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def phase_finetune():
    """The Llama fine-tune recipe (``paddle_tpu_torch.examples
    .finetune_llama``): at its tiny default with AMP off, the card's
    losses, EMA weights and greedy ids under ``ema.apply()`` against a CPU
    run (rtol 1e-4); at Llama-3-8B's widths in bf16 O2 (depth 2, B=8,
    S=1024, accumulate 2, EMA): finite losses, K1 = K2a = K2b = 4 per
    step, step ms, tokens/s and peak memory; ``LookAhead(AdamW)`` under
    ``TrainStep`` against the CPU; a recomputed Llama decoder layer's bf16
    gradients bit-equal to the plain run's with K1 launched twice, and a
    recomputed GPT-base decoder layer's with dropout 0.1 under one seed."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.examples import finetune_llama as ft
    from paddle_tpu_torch.incubate import LookAhead
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.text.models.gpt import GPTDecoderLayer
    from paddle_tpu_torch.text.models.llama import (LlamaDecoderLayer,
                                                    _rope_cos_sin)

    torch.backends.cuda.matmul.allow_tf32 = False
    checks, out = {}, {}

    # 1. the tiny default in f32: card against the CPU
    cpu = LlamaForCausalLM(ft.tiny_config(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda")
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        runs[dev] = ft.finetune(m, steps=FT_TINY_STEPS, amp_dtype="float32",
                                log=None)
    rel_loss = max(abs(a - b) / abs(b) for a, b in
                   zip(runs["cuda"]["losses"], runs["cpu"]["losses"]))
    shadows = [(k, runs["cuda"]["ema"]._shadow[k],
                runs["cpu"]["ema"]._shadow[k])
               for k in runs["cpu"]["ema"]._shadow]
    rel_ema = max(_rel_norm(a, b) for _, a, b in shadows)
    checks["tiny_f32_losses_rtol_1e-4"] = rel_loss <= 1e-4
    checks["tiny_f32_ema_rtol_1e-4"] = rel_ema <= 1e-4
    checks["tiny_f32_greedy_equal"] = \
        runs["cuda"]["greedy"] == runs["cpu"]["greedy"]
    out["tiny_f32"] = {"steps": FT_TINY_STEPS, "max_rel_loss": rel_loss,
                       "max_rel_ema_norm": rel_ema,
                       "cuda_losses": runs["cuda"]["losses"][:5],
                       "cpu_losses": runs["cpu"]["losses"][:5],
                       "greedy": runs["cuda"]["greedy"],
                       "cuda_wall_s": runs["cuda"]["seconds"]}
    del cpu, card, runs, shadows

    # 2. LookAhead(AdamW) under TrainStep: card against the CPU
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, LL_NARROW["vocab_size"],
                                      (LL_NARROW_B, LL_NARROW_S)))
    cpu = LlamaForCausalLM(device="cpu", generator=torch.Generator()
                           .manual_seed(0), **LL_NARROW)
    card = copy.deepcopy(cpu).to("cuda")
    la = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        o = LookAhead(optimizer.AdamW(learning_rate=1e-3,
                                      parameters=m.parameters()),
                      alpha=0.5, k=2)
        step, x = jit.TrainStep(m, o, loss_fn=None), ids.to(dev)
        la[dev] = [step({"input_ids": x, "labels": x}).item()
                   for _ in range(4)]
    la_rel = max(abs(a - b) / abs(b) for a, b in zip(la["cuda"], la["cpu"]))
    la_w = max(_rel_norm(a, b) for a, b in zip(card.parameters(),
                                               cpu.parameters()))
    checks["lookahead_losses_rtol_1e-4"] = la_rel <= 1e-4
    checks["lookahead_weights_rtol_1e-4"] = la_w <= 1e-4
    out["lookahead"] = {"cuda_losses": la["cuda"], "cpu_losses": la["cpu"],
                        "max_rel_loss": la_rel, "max_rel_weight_norm": la_w}
    del cpu, card

    # 3. Llama-3-8B widths, bf16 O2, depth 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlamaForCausalLM(device="cuda", generator=gen,
                             **dict(LLAMA3_8B, num_hidden_layers=FT_LAYERS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    res = ft.finetune(model, steps=FT_STEPS, batch_size=FT_B, seq_len=FT_S,
                      accum=FT_ACCUM, amp_dtype="bfloat16", log=None,
                      on_step=on_step)
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
              "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    # K1 also runs in the closing generate()'s prefill (dense cache: none)
    per_step = FT_LAYERS * FT_ACCUM
    step_s = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    checks["8b_losses_finite"] = bool(np.isfinite(res["losses"]).all())
    checks["8b_launches_4_per_step"] = counts == dict.fromkeys(
        counts, per_step * FT_STEPS)
    out["llama3_8b_bf16_O2"] = {
        "layers": FT_LAYERS, "B": FT_B, "S": FT_S, "accumulate": FT_ACCUM,
        "steps": FT_STEPS, "losses": res["losses"],
        "step_ms": step_s * 1e3, "tokens_per_s": FT_B * FT_S / step_s,
        "peak_memory_allocated_bytes": peak, "launches": counts,
        "greedy": res["greedy"]}
    launches = dict(counts)
    del model, res
    _free_card()

    # 4. recompute in bf16: one Llama-3-8B-wide decoder layer (K1 in the
    # forward and again in the replay), then one GPT-base decoder layer
    # with dropout 0.1 on its attention and residuals (the plain
    # attention: the replay must draw the forward's masks)
    def llama_layer():
        cfg = LlamaConfig(**dict(LLAMA3_8B, num_hidden_layers=1))
        layer = LlamaDecoderLayer(cfg)
        rope = _rope_cos_sin(torch.arange(FT_S),
                             cfg.hidden_size // cfg.num_attention_heads,
                             cfg.rope_theta)
        return layer, cfg.hidden_size, (rope,)

    def gpt_layer():
        layer = GPTDecoderLayer(768, 12, 3072, dropout=0.1, attn_dropout=0.1)
        return layer, 768, ()

    rec = {}
    for name, make in (("llama3_8b_layer", llama_layer),
                       ("gpt_base_layer_dropout_0.1", gpt_layer)):
        torch.manual_seed(0)
        with torch.device("cuda"):
            layer, hidden, extra = make()
            layer = layer.to(torch.bfloat16).train()
            x0 = torch.randn(2, FT_S, hidden, dtype=torch.bfloat16)
        grads, k1 = {}, {}
        for mode in ("plain", "recompute"):
            layer.zero_grad()
            x = x0.clone().requires_grad_()
            torch.manual_seed(7)
            fa.LAUNCHES = 0
            y = layer(x, *extra) if mode == "plain" \
                else fleet.recompute(layer, x, *extra)
            y.float().square().mean().backward()
            torch.cuda.synchronize()
            k1[mode] = fa.LAUNCHES
            grads[mode] = [x.grad] + [p.grad for p in layer.parameters()]
        equal = all(torch.equal(a, b) for a, b in
                    zip(grads["plain"], grads["recompute"]))
        rec[name] = {"grads_bit_equal": equal, "k1_launches": k1}
        checks[f"recompute_{name}_bit_equal"] = equal
        if name == "llama3_8b_layer":
            checks["recompute_k1_doubled"] = k1 == {"plain": 1,
                                                    "recompute": 2}
            launches["flash_attention_fwd"] += k1["plain"] + k1["recompute"]
        else:   # training dropout runs the plain attention, no K1
            checks["recompute_dropout_no_k1"] = k1 == {"plain": 0,
                                                       "recompute": 0}
        del layer, grads, x0, extra
        _free_card()
    out["recompute"] = rec
    ok = all(checks.values())
    emit({"phase": "finetune", "ok": ok, "checks": checks, **out,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit(f"finetune phase failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"launches": launches}


def _profiled(fn):
    """``fn()`` under the port's ``Profiler`` (its device trace is a
    ``torch.profiler`` session over the CPU and the card): wall, device
    busy time and idle share, and the top kernels by device time."""
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    torch.cuda.synchronize()
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU])
    with prof:
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.device_profile().key_averages():
        # device-side events only: a CPU op's row repeats the device time
        # of the kernels it launched
        if "CUDA" not in str(e.device_type):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    by_category = {}
    for t, _, k in rows:
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(x in k for x in keys)),
                   "other")
        # a kernel of the port's own that no row claims would hide in
        # "other": a renamed kernel must be given its row
        if cat == "other" and any(x in k for x in ("flash_", "paged_",
                                                   "bias_gelu")):
            raise SystemExit(f"profile: the port's kernel {k[:120]!r} matches "
                             f"no row of PROFILE_CATEGORIES")
        by_category[cat] = by_category.get(cat, 0.0) + t / 1e3
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1 - busy_us / 1e6 / wall, **extra,
            "device_ms_by_category": by_category,
            "top_device_kernels": [{"name": k[:90], "calls": c,
                                    "device_ms": t / 1e3}
                                   for t, c, k in rows[:20]]}


def _profiled_train(model):
    """3 bf16 O2 ``TrainStep``s of ``model`` at B=8, S=1024 under the
    profiler, after the warm-up steps."""
    step = _trainer(model, amp_level="O2")
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (TRAIN_B, TRAIN_S))).to("cuda")
    for _ in range(WARMUP_STEPS):
        step({"input_ids": x, "labels": x})

    def train():
        for _ in range(3):
            step({"input_ids": x, "labels": x})
        return {"steps": 3, "B": TRAIN_B, "S": TRAIN_S}

    return _profiled(train)


def _profiled_serve(model, **engine_kw):
    """The bf16 slice's 12 requests under the profiler, after a warm-up."""
    prompts, temps = slice_requests()
    _serve(model, "cuda", prompts, temps, **engine_kw)

    def serve():
        _, _, stats = _serve(model, "cuda", prompts, temps, **engine_kw)
        return {"decode_steps": stats["iteration"], "prefills": stats["prefills"]}

    return _profiled(serve)


def _profiled_generate(model, impl):
    """The generate phase's timed bf16 call (B=8, prompts of 512, 128 new
    tokens) under the profiler, after a short warm-up."""
    ids = _gen_ids(GEN_BF16_B, GEN_BF16_S, 7)
    model.generate(ids[:, :64], max_new_tokens=4, temperature=0.0,
                   cache_impl=impl, page_size=PAGE)

    def gen():
        model.generate(ids, max_new_tokens=GEN_BF16_NEW, temperature=0.0,
                       cache_impl=impl, page_size=PAGE)
        return {"B": GEN_BF16_B, "prompt": GEN_BF16_S,
                "new_tokens": GEN_BF16_NEW}

    return _profiled(gen)


def _profiled_engine(model, prompts, **engine_kw):
    """Greedy ``prompts`` through an engine under the profiler, after a
    warm-up on the first two."""
    zeros = [0.0] * len(prompts)
    _serve(model, "cuda", prompts[:2], zeros[:2], **engine_kw)

    def serve():
        _, _, st = _serve(model, "cuda", prompts, zeros, **engine_kw)
        return {k: st[k] for k in ("iteration", "verify_steps", "prefills",
                                   "prefill_chunks", "spec_proposed",
                                   "spec_accepted")}

    return _profiled(serve)


def _profiled_prefix(model, arm):
    """The prefix phase's 24 requests through one arm under the profiler,
    after a warm-up on the first wave."""
    prompts = prefix_requests()
    _prefix_serve(model, "cuda", prompts[:PFX_SLOTS], **PFX_ARMS[arm])

    def serve():
        _, _, st, _, ttft = _prefix_serve(model, "cuda", prompts,
                                          **PFX_ARMS[arm])
        return {"prefills": st["prefills"],
                "cached_prefills": st["cached_prefills"],
                "decode_steps": st["iteration"],
                "ttft_p50_s": float(np.median(ttft))}

    return _profiled(serve)


def phase_profile():
    """Where the time goes (not part of the default run), each under
    ``torch.profiler`` after a warm-up: the bf16 slice's 12 requests with
    native and with int8 pools, bf16 ``generate()`` with each cache, the
    speculative engine on the spec phase's requests beside the plain
    engine on them, the chunked engine on the chunk requests, the prefix
    phase's traffic through its lru, radix and radix_spill arms, 3 bf16 O2
    training steps at B=8, S=1024, the same steps of the QAT-wrapped model,
    and that model converted by ``convert_to_int8`` (static scales, bf16)
    serving the 12 requests with int8 pools, beside the dynamic-scale
    ``weight_dtype="int8"`` run."""
    from paddle_tpu_torch.quantization import convert_to_int8
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    native = _profiled_serve(model, kv_dtype="native")
    int8_kv = _profiled_serve(model, kv_dtype="int8")
    gen_dense = _profiled_generate(model, "dense")
    gen_paged = _profiled_generate(model, "paged")
    spec_plain = _profiled_engine(model, spec_requests())
    spec = _profiled_engine(model, spec_requests(), speculative_k=SPEC_K)
    chunked = _profiled_engine(model, chunk_requests(),
                               prefill_chunk_tokens=CHUNK_TOKENS)
    prefix = {arm: _profiled_prefix(model, arm) for arm in PFX_ARMS}
    # weight_dtype="int8" converts the model's Linears in place: last
    int8_dynamic = _profiled_serve(model, kv_dtype="int8", weight_dtype="int8")
    del model
    torch.manual_seed(0)
    train = _profiled_train(GPTForCausalLM(device="cuda"))
    qat_model = _qat_gpt("cuda")
    qat_train = _profiled_train(qat_model)
    convert_to_int8(qat_model.eval())
    int8_static = _profiled_serve(qat_model.to(torch.bfloat16), kv_dtype="int8")
    emit({"phase": "profile", "serving_bf16": native,
          "serving_bf16_int8_kv": int8_kv,
          "serving_bf16_int8_kv_dynamic_int8_weights": int8_dynamic,
          "serving_bf16_int8_kv_static_int8_weights": int8_static,
          "generate_bf16_dense": gen_dense, "generate_bf16_paged": gen_paged,
          "spec_requests_bf16_plain": spec_plain,
          "spec_requests_bf16_speculative": spec,
          "chunk_requests_bf16_chunked": chunked,
          "prefix_bf16": prefix,
          "train_bf16_O2": train, "train_bf16_O2_qat": qat_train,
          "nvidia_smi": smi_line()})


KERNELS = (  # key, name, source, TPU kernel it replaces, path that runs it
    ("k1", "flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
     "paddle_tpu/ops/flash_attention.py:112",
     "serving prefill (full prefills, radix misses), training (probed too), "
     "generate() (paged prefill, no cache, beam), multi-tenant prefill, "
     "embed and score, cluster replicas' prefill and re-prefill, the "
     "fine-tune recipe, recompute's replay"),
    ("k2a", "flash_attention_bwd_dkdv", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/flash_attention.py:276",
     "training (probed too), the fine-tune recipe"),
    ("k2b", "flash_attention_bwd_dq", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/flash_attention.py:307",
     "training (probed too), the fine-tune recipe"),
    ("k3", "paged_flash_decode", "paddle_tpu_torch/csrc/paged_flash_decode.cu",
     "paddle_tpu/ops/paged_attention.py:371",
     "serving decode, generate() paged decode, speculative verify, chunked "
     "prefill, the radix cache's cached-tail prefill, multi-tenant decode "
     "and verify, cluster replicas' decode"),
    ("k4", "paged_flash_decode_q", "paddle_tpu_torch/csrc/paged_flash_decode_q.cu",
     "paddle_tpu/ops/paged_attention.py:870",
     "int8 serving decode, int8 speculative verify, chunked prefill and "
     "cached-tail prefill, multi-tenant decode over int8 pools, the "
     "int8-pool cluster's decode"),
    # the full-sweep twins have no path, in the TPU package either
    ("k5a", "paged_full_sweep", "paddle_tpu_torch/csrc/paged_flash_decode.cu",
     "paddle_tpu/ops/paged_attention.py:128", None),
    ("k5b", "paged_q_full_sweep", "paddle_tpu_torch/csrc/paged_flash_decode_q.cu",
     "paddle_tpu/ops/paged_attention.py:782", None),
    ("k6", "bias_gelu", "paddle_tpu_torch/csrc/bias_gelu.cu",
     "examples/custom_op_and_quant.py:37", "custom-op + QAT example"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="build,kernels,slice,train,quant,"
                    "custom_op,qat,generate,spec,prefix,resilience,observe,"
                    "programs,llama,numerics,multitenant,cluster,finetune")
    phases = ap.parse_args().phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        sys.exit(2)
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    results = {}
    for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                     ("slice", phase_slice), ("train", phase_train),
                     ("quant", phase_quant), ("custom_op", phase_custom_op),
                     ("qat", lambda: phase_qat(
                         (results.get("train") or {}).get("step_ms"))),
                     ("generate", phase_generate), ("spec", phase_spec),
                     ("prefix", phase_prefix),
                     ("resilience", phase_resilience),
                     ("observe", lambda: phase_observe(
                         (results.get("slice") or {}).get("cpu_ref"))),
                     ("programs", lambda: phase_programs(
                         (results.get("slice") or {}).get("cpu_ref"))),
                     ("llama", phase_llama), ("numerics", phase_numerics),
                     ("multitenant", phase_multitenant),
                     ("cluster", phase_cluster), ("finetune", phase_finetune),
                     ("profile", phase_profile)):
        if name in phases:
            t0 = time.perf_counter()
            results[name] = fn()
            emit({"phase_seconds": {name: time.perf_counter() - t0}})
    times = results.get("kernels")
    if times is not None:
        # launches: each counted run of the path that uses the kernel (the
        # bf16 slice for K1 and K3, the bf16 training steps for K1 and K2,
        # the first bf16 int8 slice for K1 and K4, the example's card run
        # for K6, the f32 static-scale int8 run for K1 and K4, the first
        # timed bf16 dense and paged generate() for K1 and K3, the f32
        # speculative and chunked card runs for K1, K3 and K4, the f32
        # prefix-cache arms for K1, K3 and K4, the resilience phase's
        # restart run for K1 and K3, the observe phase's f32 and int8
        # sinks-on runs for K1, K3 and K4, the programs phase's cold and
        # warm f32 runs for K1 and K3, the llama phase's first timed
        # bf16 paged and dense generate() for K1 and K3 and its O2 steps
        # for K1 and K2, the numerics phase's probed f32 steps for K1 and
        # K2, the multitenant phase's f32, k=4 and int8 mixed batches for
        # K1, K3 and K4, the cluster phase's f32 run for K1 and K3 and its
        # int8-pool run for K4, the finetune phase's Llama-3-8B-wide O2
        # steps for K1 and K2 and its recompute check for K1); K5a / K5b:
        # the kernels phase's checks
        launches = {}
        for name in ("slice", "train", "quant", "custom_op", "qat",
                     "generate", "spec", "prefix", "resilience", "observe",
                     "programs", "llama", "numerics", "multitenant",
                     "cluster", "finetune"):
            for k, n in (results.get(name) or {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
        # other shapes: the cached-tail prefill's (K3, K4) and Llama-3-8B's
        # (K1, K2a, K2b, K3)
        shapes = dict((results.get("prefix") or {}).get("cached_tail", {}))
        llama = results.get("llama") or {}
        shapes.update(llama.get("kernel_shapes", {}))
        if "k1_f32_prefill_launches" in llama:     # that run's K1 f32 body
            times["k1"]["other_shapes"]["k1_f32_llama_prefill"][
                "launches"] = llama["k1_f32_prefill_launches"]
        for key in ("k1", "k2a", "k2b", "k3", "k4"):
            times[key].setdefault("other_shapes", {}).update(
                {k: v for k, v in shapes.items()
                 if k.split("_")[0] == key})
        rows = []
        for key, name, src, tpu, path in KERNELS:
            t = times[key]
            rows.append({"name": name, "route": "cuda", "source": src,
                         "replaces": tpu, "path": path,
                         "launches": t.get("launches", launches.get(name, 0)),
                         "max_abs_err": t["max_abs_err"], "ms": t["kernel_ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"],
                         "library_ms": t["library_ms"]})
            if t.get("other_shapes"):   # chunk rows, Llama shapes
                rows[-1]["other_shapes"] = {
                    k: {f: v[f] for f in ("shape", "dtype", "rows",
                                          "launches", "kernel_ms", "eager_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "bound_f32_rate_ms", "library_ms",
                                          "max_abs_err")
                        if f in v}
                    for k, v in t["other_shapes"].items()}
        emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
