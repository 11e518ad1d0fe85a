"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py                  # build,kernels,slice,train,quant,custom_op,qat
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,slice,train,quant,custom_op,qat,profile

Phases, each printing one JSON line and then its seconds:

1. ``build``   — compile every CUDA kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), with ptxas's register / shared
   memory / spill report, the card's name and its power limit.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card, in bf16 and f32 (TF32 off): K1 and K3 at the served model's
   shapes (atol 2e-2 / 2e-4), the paged decode kernel also with NaN in
   every dead page; the flash backward K2a / K2b over lengths 17-1024,
   causal and full, sq < sk, head_dim 64 / 128, with and without a g_lse
   term (max error over max |ref| <= 2e-2 / 1e-4), and gradients through
   K1 + K2 against torch autograd through the plain forward; K4 (paged
   decode over int8 pools) against its plain version, also with NaN in
   every dead page's scale rows, and the full-sweep twins K5a / K5b bit
   for bit against K3 / K4; the fused bias + GELU K6 in f32 / f16 / bf16
   (bf16 x with a float32 bias too) at the example's shape, GPT-base's MLP
   activation, an odd width and a non-contiguous x.  Then time kernel,
   plain version and PyTorch's own call with CUDA events: K1 at the
   longest prefill, K3, K4 and K5a / K5b at a decode step, K2 at the
   training shape, K6 at ``[8192, 3072]`` beside ``F.gelu(x + b)``.
3. ``slice``   — serve GPT-base (vocab 50304, 12 x 768, random weights from
   ``torch.manual_seed(0)``) through ``ServingEngine``: 12 requests, prompts
   of 17-900 tokens, 32 new tokens each.  float32 on the card must give
   the CPU engine's greedy ids; bf16 on the card is timed.  The kernels'
   launch counters are zeroed before each run and checked after it.
4. ``train``   — train GPT-base with ``jit.TrainStep`` (AdamW, global-norm
   clip 1.0): 3 steps in f32 on the card must give the CPU's losses; then
   12 bf16 O2 steps at B=8, S=1024 are timed, with K1 = K2a = K2b =
   12 launches per step checked.
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
8. ``profile`` (only when asked for) — the bf16 slice, the bf16 int8 slice
   (native, dynamic and static int8 weights) and bf16 training steps
   (plain and QAT) under ``torch.profiler``: device time by kernel and the
   device's idle share.

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
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 2e-4}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # max err / max |ref|

# the served model (GPT-base, the JAX package's GPTForCausalLM defaults)
LAYERS, HEADS, HEAD_DIM, PAGE, MAXLEN, SLOTS = 12, 12, 64, 16, 1024, 8
NP = MAXLEN // PAGE
VOCAB, HIDDEN = 50304, 768
# the training run: batch x sequence of the timed bf16 steps, and of the
# f32 steps held against the CPU
TRAIN_B, TRAIN_S, PARITY_B, PARITY_S = 8, 1024, 2, 256
WARMUP_STEPS, TIMED_STEPS, PARITY_STEPS = 2, 10, 3
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


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------------- build
def phase_build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build("flash_attention_fwd", "flash_attention_bwd",
                         "paged_flash_decode", "paged_flash_decode_q",
                         "bias_gelu")
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


def _rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _k2_inputs(gen, dtype, b, sq, sk, d, causal, g_lse):
    """q, k, v, g ``[b, S, HEADS, d]`` and the kernel forward's lse with
    the row correction r = delta (- g_lse)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    def t(s):
        return torch.randn(b, s, HEADS, d, generator=gen, device="cuda").to(dtype)

    q, k, v, g = t(sq), t(sk), t(sk), t(sq)
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    r = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(-1, sq)
    if g_lse:
        r = r - torch.randn(r.shape, generator=gen, device="cuda")
    return q, k, v, g, lse, r.contiguous()


def _k2_case(gen, dtype, sq, sk, d, causal, g_lse):
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, g, lse, r = _k2_inputs(gen, dtype, 1, sq, sk, d, causal, g_lse)
    scale = d ** -0.5
    dk, dv = fa._bwd_dkdv_kernel(q, k, v, g, lse, r, scale, causal)
    dq = fa._bwd_dq_kernel(q, k, v, g, lse, r, scale, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, causal)
    errs = {n: _rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                  (dq, dk, dv), ref)}
    finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    return {"sq": sq, "sk": sk, "d": d, "causal": causal, "g_lse": g_lse,
            "dtype": str(dtype).split(".")[-1], "rel_err": errs,
            "ok": finite and max(errs.values()) <= BWD_TOL[dtype]}


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
    """One PyTorch call computing dq, dk, dv: the flash-attention backward
    ATen op on the outputs of its own forward (``[B, H, S, D]`` views)."""
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        gt, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset)


def _k2_timed(gen):
    """K2a, K2b, the plain backward and the library backward at the
    training shape (B=8, S=1024, 12 heads, D=64, causal, bf16)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S = TRAIN_B, TRAIN_S
    q, k, v, g, lse, r = _k2_inputs(gen, torch.bfloat16, B, S, S, HEAD_DIM,
                                    True, False)
    scale = HEAD_DIM ** -0.5
    dk, dv = fa._bwd_dkdv_kernel(q, k, v, g, lse, r, scale, True)
    dq = fa._bwd_dq_kernel(q, k, v, g, lse, r, scale, True)
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, True)
    pairs = B * HEADS * S * (S + 1) // 2
    elems = q.numel()                                   # B*S*H*D, bf16
    reads = 4 * elems * 2 + 2 * B * HEADS * S * 4       # q,k,v,g + lse,r
    a_bound, a_by = bound(8 * HEAD_DIM * pairs, reads + 2 * elems * 2)
    b_bound, b_by = bound(6 * HEAD_DIM * pairs, reads + elems * 2)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, g, lse, r,
                                                          scale, True), iters=5)
    library_ms = cuda_ms(_library_bwd(q, k, v, g))
    return {
        "k2a": {"kernel_ms": cuda_ms(lambda: fa._bwd_dkdv_kernel(
                    q, k, v, g, lse, r, scale, True)),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": a_bound, "bound_by": a_by,
                "max_abs_err": max((dk.float() - rk.float()).abs().max().item(),
                                   (dv.float() - rv.float()).abs().max().item())},
        "k2b": {"kernel_ms": cuda_ms(lambda: fa._bwd_dq_kernel(
                    q, k, v, g, lse, r, scale, True)),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": b_bound, "bound_by": b_by,
                "max_abs_err": (dq.float() - rq.float()).abs().max().item()}}


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
    # K5a, the full sweep: stages the poisoned dead pages, uses none
    o5 = pa._paged_full_sweep(q, kp, vp, table, ln)
    o5_p = pa._paged_full_sweep(q, kpn, vpn, table, ln)
    torch.cuda.synchronize()
    poison_ok = bool(torch.isfinite(o_p).all()) and torch.equal(o_p, o)
    zero_ok = all(bool((o[b] == 0).all()) for b, n in enumerate(lens) if n == 0)
    k5a_ok = torch.equal(o5, o) and torch.equal(o5_p, o)
    ok = err <= ATOL[dtype] and poison_ok and zero_ok and k5a_ok
    return {"B": len(lens), "heads": heads, "kv_heads": kv_heads,
            "lens": lens, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "dead_pages_poisoned_ok": poison_ok,
            "empty_rows_zero": zero_ok, "k5a_bit_equal_k3": k5a_ok, "ok": ok}


def _k4_inputs(gen, dtype, lens, heads, kv_heads, d=HEAD_DIM):
    """q in ``dtype`` and int8 pools with their float32 scale pools,
    quantized from normal K / V on the pool grid."""
    from paddle_tpu_torch.ops import paged_attention as pa

    B = len(lens)
    pages = B * NP
    perm = torch.randperm(pages, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(B, NP).contiguous()
    kq, ks = pa.quantize_kv(torch.randn(pages, PAGE, kv_heads, d,
                                        generator=gen, device="cuda"))
    vq, vs = pa.quantize_kv(torch.randn(pages, PAGE, kv_heads, d,
                                        generator=gen, device="cuda"))
    q = torch.randn(B, heads, d, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kq, vq, ks.contiguous(), vs.contiguous(), table, ln


def _k4_case(gen, dtype, lens, heads, kv_heads):
    """K4 against its plain version; K4 and K5b with NaN in every dead
    page's scale rows (an int8 payload cannot hold NaN): K4 never reads
    them and K5b stages them, and neither may let them reach the output;
    K5b bit-equal to K4."""
    from paddle_tpu_torch.ops import paged_attention as pa

    q, kq, vq, ks, vs, table, ln = _k4_inputs(gen, dtype, lens, heads, kv_heads)
    o = pa.paged_attention_quantized(q, kq, vq, ks, vs, table, ln)
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
    ok = err <= ATOL[dtype] and poison_ok and zero_ok and k5b_ok
    return {"B": len(lens), "heads": heads, "kv_heads": kv_heads,
            "lens": lens, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "dead_scale_rows_poisoned_ok": poison_ok,
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
    k1_shapes = [(s, s, 64, True) for s in (17, 256, 300, 512, 1024)]
    k1_shapes += [(64, 320, 64, True), (300, 300, 64, False),
                  (256, 256, 128, True)]
    k1 = [_k1_case(gen, dt, *sh) for dt in (torch.bfloat16, torch.float32)
          for sh in k1_shapes]
    lens = [0, 1, 15, 16, 17, 500, 1024, 777]
    pa.FULL_SWEEP_LAUNCHES = pa.QUANT_FULL_SWEEP_LAUNCHES = 0
    k3 = [_k3_case(gen, dt, lens, HEADS, kvh)
          for dt in (torch.bfloat16, torch.float32) for kvh in (HEADS, 4)]
    k4 = [_k4_case(gen, dt, lens, HEADS, kvh)
          for dt in (torch.bfloat16, torch.float32) for kvh in (HEADS, 4)]
    # K5a / K5b have no path (only tests call them in the TPU package too):
    # their launches are these checks'
    k5_launches = {"k5a": pa.FULL_SWEEP_LAUNCHES,
                   "k5b": pa.QUANT_FULL_SWEEP_LAUNCHES}
    k2_shapes = [(s, s, 64, c, gl) for s in (17, 256, 300, 1024)
                 for c in (True, False) for gl in (False, True)]
    k2_shapes += [(64, 320, 64, True, False), (200, 512, 64, True, True),
                  (256, 256, 128, True, False), (300, 300, 128, False, True),
                  (1024, 1024, 128, True, True)]
    k2 = [_k2_case(gen, dt, *sh) for dt in (torch.bfloat16, torch.float32)
          for sh in k2_shapes]
    k2.append(_k2_autograd_case(gen))

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
    # K5a: K3's function over the same rows, every table page staged
    o5a = pa._paged_full_sweep(qd, kp, vp, table, ln)
    k5a_time = {
        "kernel_ms": cuda_ms(lambda: pa._paged_full_sweep(qd, kp, vp, table, ln)),
        "plain_ms": k3_time["plain_ms"], "library_ms": None,
        "bound_ms": k3_bound, "bound_by": k3_by,
        "max_abs_err": (o5a.float() - pa.paged_attention_ref(
            qd, kp, vp, table, ln).float()).abs().max().item(),
        "bit_equal_k3": torch.equal(o5a, od),
        "launches": k5_launches["k5a"], "lens": dlens}
    k4_time, k5b_time = _k4_timed(gen, dlens, k3_time["kernel_ms"],
                                  k5_launches["k5b"])
    k2_time = _k2_timed(gen)
    k6 = _k6_cases(gen)
    k6_time = _k6_timed(gen)
    ok = all(c["ok"] for c in k1 + k2 + k3 + k4 + k6)
    emit({"phase": "kernels", "ok": ok, "k1_cases": k1, "k2_cases": k2,
          "k3_cases": k3, "k4_cases": k4, "k6_cases": k6,
          "k1_timed": {"shape": [1, S, HEADS, HEAD_DIM], "causal": True,
                       "dtype": "bfloat16", **k1_time},
          "k2_timed": {"shape": [TRAIN_B, TRAIN_S, HEADS, HEAD_DIM],
                       "causal": True, "dtype": "bfloat16",
                       "plain_and_library_ms_are_for_the_pair": True,
                       **k2_time},
          "k3_timed": {"B": SLOTS, "heads": HEADS, "page_size": PAGE,
                       "table_width": NP, "dtype": "bfloat16", **k3_time},
          "k4_timed": {"B": SLOTS, "heads": HEADS, "page_size": PAGE,
                       "table_width": NP, "q_dtype": "bfloat16",
                       "pools": "int8 + float32 scales", **k4_time},
          "k5a_timed": {"dtype": "bfloat16", **k5a_time},
          "k5b_timed": {"q_dtype": "bfloat16", **k5b_time},
          "k6_timed": k6_time,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("kernels phase: a kernel disagrees with its plain "
                         "version (see the k1 / k2 / k3 / k4 / k6 cases above)")
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
    with a float32 bias and float32 throughout.  Bound: x and b read once,
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
            "kernel_ms": cuda_ms(lambda: bg.bias_gelu(x, b)),
            "plain_ms": cuda_ms(lambda: bg.bias_gelu_ref(x, b)),
            "library_ms": None,
            "library_note": "no single PyTorch call adds a bias inside the GELU",
            "two_call_ms": cuda_ms(lambda: torch.nn.functional.gelu(x + bx)),
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
    k4 = {"kernel_ms": cuda_ms(lambda: pa.paged_attention_quantized(*args)),
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call dequantizes paged pools",
          "bound_ms": k4_bound, "bound_by": k4_by, "max_abs_err": err,
          "k3_same_rows_bf16_pools_ms": k3_ms, "lens": dlens}
    k5b = {"kernel_ms": cuda_ms(lambda: pa._paged_q_full_sweep(*args)),
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": k4_bound,
           "bound_by": k4_by,
           "max_abs_err": (o5.float() - ref.float()).abs().max().item(),
           "bit_equal_k4": torch.equal(o5, o),
           "launches": k5b_launches, "lens": dlens}
    return k4, k5b


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
    return {"launches": counts16}


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


def phase_train():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(0)

    # parity: f32 on the card against a CPU copy of the same model
    ids = torch.from_numpy(rs.randint(0, VOCAB, (PARITY_B, PARITY_S)))
    torch.manual_seed(0)
    cpu_model = GPTForCausalLM(device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    losses = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        step, x = _trainer(model), ids.to(dev)
        losses[dev] = [step({"input_ids": x, "labels": x}).item()
                       for _ in range(PARITY_STEPS)]
    del cpu_model, card_model
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    parity_ok = rel <= 1e-4

    # timed: bf16 O2 at the full training shape, one fixed batch
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda")              # f32 masters
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
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "flash_attention_bwd_dkdv": fa.BWD_DKDV_LAUNCHES,
              "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES}
    steps = WARMUP_STEPS + TIMED_STEPS
    if counts != dict.fromkeys(counts, LAYERS * steps):
        raise SystemExit(f"launch counts {counts} != {LAYERS} x {steps} steps: "
                         f"the training path did not run through the kernels")
    bf16_losses = [l.item() for l in out]
    tokens = TRAIN_B * TRAIN_S
    flops = _train_flops_per_token(model) * tokens
    step_s = wall / TIMED_STEPS
    ok = (parity_ok and bf16_losses[-1] < bf16_losses[0]
          and all(np.isfinite(bf16_losses)))
    emit({"phase": "train", "ok": ok, "model": "GPT-base 12x768 vocab 50304",
          "optimizer": "AdamW lr 1e-4 wd 0.01, ClipGradByGlobalNorm(1.0)",
          "f32_parity": {"B": PARITY_B, "S": PARITY_S, "steps": PARITY_STEPS,
                         "cpu_losses": losses["cpu"],
                         "cuda_losses": losses["cuda"],
                         "max_rel_diff": rel, "rtol": 1e-4, "ok": parity_ok},
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
                      "losses": bf16_losses, "launches": counts},
          "nvidia_smi": smi_line()})
    if not ok:
        raise SystemExit("train phase failed: f32 losses differ from the CPU "
                         "run beyond rtol 1e-4, or the bf16 loss did not fall")
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


# ----------------------------------------------------------------- profile
PROFILE_CATEGORIES = (   # device kernel name fragments, first match wins
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2a flash_bwd_dkdv", ("flash_bwd_dkdv_kernel",)),
    ("K2b flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K4 paged_flash_decode_q", tuple(f"paged_flash_decode_kernel<{t}, signed char"
                                      for t in ("float", "__half",
                                                "__nv_bfloat16"))),
    ("K3 paged_flash_decode", ("paged_flash_decode_kernel",)),
    ("K6 bias_gelu", ("bias_gelu_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax", ("SoftMax",)),
    ("copies and casts", ("copy_kernel", "direct_copy")),
)


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: wall, device busy time and idle
    share, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
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


def phase_profile():
    """Where the time goes (not part of the default run), each under
    ``torch.profiler`` after a warm-up: the bf16 slice's 12 requests with
    native and with int8 pools, 3 bf16 O2 training steps at B=8, S=1024,
    the same steps of the QAT-wrapped model, and that model converted by
    ``convert_to_int8`` (static scales, bf16) serving the 12 requests with
    int8 pools, beside the dynamic-scale ``weight_dtype="int8"`` run."""
    from paddle_tpu_torch.quantization import convert_to_int8
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda", dtype=torch.bfloat16)
    native = _profiled_serve(model, kv_dtype="native")
    int8_kv = _profiled_serve(model, kv_dtype="int8")
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
          "train_bf16_O2": train, "train_bf16_O2_qat": qat_train,
          "nvidia_smi": smi_line()})


KERNELS = (  # key, name, source, TPU kernel it replaces, path that runs it
    ("k1", "flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
     "paddle_tpu/ops/flash_attention.py:112", "serving prefill, training"),
    ("k2a", "flash_attention_bwd_dkdv", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/flash_attention.py:276", "training"),
    ("k2b", "flash_attention_bwd_dq", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/flash_attention.py:307", "training"),
    ("k3", "paged_flash_decode", "paddle_tpu_torch/csrc/paged_flash_decode.cu",
     "paddle_tpu/ops/paged_attention.py:371", "serving decode"),
    ("k4", "paged_flash_decode_q", "paddle_tpu_torch/csrc/paged_flash_decode_q.cu",
     "paddle_tpu/ops/paged_attention.py:870", "int8 serving decode"),
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
    ap.add_argument("--phases",
                    default="build,kernels,slice,train,quant,custom_op,qat")
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
        # for K6, the f32 static-scale int8 run for K1 and K4); K5a / K5b:
        # the kernels phase's checks
        launches = {}
        for name in ("slice", "train", "quant", "custom_op", "qat"):
            for k, n in (results.get(name) or {}).get("launches", {}).items():
                launches[k] = launches.get(k, 0) + n
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
        emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
