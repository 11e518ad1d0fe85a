"""PyTorch port on the card: each hand-written CUDA kernel held against its
plain PyTorch version on CUDA tensors (K1 over both of its bodies, the
split-K decode also bit for bit against a second launch, and the
full-sweep K5a / K5b bit for bit against K3 / K4; K2 to head_dim 256; each
dtype's flash body by the per-body counters), attention with dropout
(eval mode is K1, training mode the plain attention's keep rate and
scale, masked, GPT-tiny training), Int8Linear's torch._int_mm against the CPU, the
tiny-GPT serving engine on the card (native and int8 pools) against the
same engine on the CPU, tiny-GPT training through the flash kernels
forward and backward, the fused bias + GELU kernel (K6) and fake-quant on
the card against the CPU, and the serving engine's observability on the
card (the sinks add no host sync, the ledger against the CUDA allocator,
an OOM recognized, the HBM pre-flight), and Llama: K3's f32-query entry
over bf16 / f16 pools, K1's f32 body at head_dim 128, a small GQA Llama's
card ids against the CPU's and its O2 step through K1 / K2; and the
program layer (each captured engine program's replay bit-equal to the
eager step on cloned pools, generate() replaying its graphs, a restart
keeping the graphs); the multi-tenant engine's captured ``mt_*``
programs against the eager adapter calls, an in-place hot swap with no
recapture, the mask buffers after a constrained row retires, memory after
``evict``, and a probed TrainStep against the unprobed one.  Marked ``cuda``; every test
skips (from the ``cuda`` fixture) where no card is present.  Run on a
machine with an NVIDIA Hopper card (``--noconftest``: these tests need no
JAX, and that machine may have none):

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

import copy
import shutil
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch import quantization as quant
from paddle_tpu_torch.ops import bias_gelu as bg
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.models import GPTForCausalLM

pytestmark = pytest.mark.cuda

ATOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 2e-4}
#: K1's f32 body on the tensor cores (3xTF32, head_dim <= 128) against its
#: plain version, beside ATOL: a body that dropped the split's cross terms
#: (one TF32 product per product) fails it, see
#: test_flash_f32_one_pass_tf32_fails_the_tight_check
F32_TC_ATOL = 2e-5
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _fwd_inputs(gen, dtype, b, h, sq, sk, d, layout):
    """q, k, v ``[b, S, h, d]``: "contiguous"; "unaligned", each a view
    one element into rows of d + 1 (no 16-byte copies: the scalar
    staging); "qkv", the model's head-major split of ``[b, S, h, 3, d]``
    (sq == sk)."""
    if layout == "qkv":
        return torch.randn(b, sq, h, 3, d, generator=gen,
                           device="cuda").to(dtype).unbind(3)

    def t(s):
        w = d + 1 if layout == "unaligned" else d
        x = torch.randn(b, s, h, w, generator=gen, device="cuda").to(dtype)
        return x[..., 1:] if layout == "unaligned" else x

    return t(sq), t(sk), t(sk)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,layout", [
    (2, 3, 17, 17, 64, True, "contiguous"),
    (2, 3, 300, 300, 64, True, "contiguous"),
    (2, 3, 64, 320, 64, True, "contiguous"),
    (2, 3, 300, 300, 64, False, "contiguous"),
    (2, 3, 256, 256, 128, True, "contiguous"),
    (2, 3, 33, 33, 256, False, "contiguous"),
    # head_dim 17 / 32 / 40 / 96 (tensor cores in bf16 / f16, zero-padded
    # to 64 or 128) and 256 (the SIMT body in every dtype)
    (2, 3, 100, 100, 17, True, "contiguous"),
    (2, 3, 300, 300, 32, True, "contiguous"),
    (2, 3, 200, 256, 40, True, "contiguous"),
    (2, 3, 129, 129, 96, False, "contiguous"),
    (1, 2, 70, 70, 256, True, "contiguous"),
    (2, 2, 160, 200, 192, True, "contiguous"),
    # lengths to 1024, causal and full, sq < sk
    (1, 12, 17, 17, 64, False, "contiguous"),
    (1, 12, 1024, 1024, 64, True, "contiguous"),
    (1, 12, 1024, 1024, 64, False, "contiguous"),
    (2, 3, 64, 1000, 64, True, "contiguous"),
    (2, 3, 1, 513, 128, True, "contiguous"),
    # a misaligned layout, the model's strided qkv split, the training shape
    (2, 3, 300, 300, 64, True, "unaligned"),
    (2, 12, 512, 512, 64, True, "qkv"),
    (8, 12, 1024, 1024, 64, True, "contiguous")])
def test_flash_kernel_matches_plain(cuda, dtype, b, h, sq, sk, d, causal,
                                    layout):
    """K1 against its plain version (o within ATOL, lse within 1e-3) over
    the reach of its three bodies (f32 at head_dim <= 128 on the tensor
    cores by 3xTF32); a second launch is bit-equal to the first."""
    q, k, v = _fwd_inputs(cuda, dtype, b, h, sq, sk, d, layout)
    n0 = fa.LAUNCHES
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    o2, lse2 = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    assert fa.LAUNCHES == n0 + 2
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    if dtype == torch.float32 and d <= 128:         # the 3xTF32 body
        torch.testing.assert_close(o, ref, atol=F32_TC_ATOL, rtol=0)
    torch.testing.assert_close(lse, fa.flash_attention_lse_ref(q, k, causal=causal),
                               atol=1e-3, rtol=0)


def test_flash_kernel_reads_strided_qkv(cuda):
    """The model's head-major qkv split hands the kernel strided views."""
    qkv = torch.randn(1, 77, 4, 3, 64, generator=cuda, device="cuda")
    q, k, v = qkv.unbind(3)
    o = fa.flash_attention_fn(q, k, v, causal=True)
    ref = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(o, ref, atol=2e-4, rtol=0)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 4, 64, device="cuda")
    kv = torch.randn(1, 8, 2, 64, device="cuda")
    with pytest.raises(NotImplementedError):
        fa.flash_attention_fn(q, kv, kv, causal=True)          # GQA
    long_q = torch.randn(1, 16, 4, 64, device="cuda")
    with pytest.raises(NotImplementedError):
        fa.flash_attention_fn(long_q, q, q, causal=True)       # sq > sk


def test_kernels_refuse_calls_that_need_a_gradient(cuda):
    """Paged decode has no backward: a call autograd would differentiate
    raises instead of returning an output without a gradient.  Flash
    attention has one (K2), but refuses in the forward, before any launch,
    a gradient it cannot take (head_dim > 256); at 256 it takes one.
    Under no_grad both run."""
    q = torch.randn(1, 8, 2, 64, device="cuda", requires_grad=True)
    wide = torch.randn(1, 8, 2, 256, device="cuda", requires_grad=True)
    too_wide = torch.randn(1, 8, 2, 257, device="cuda", requires_grad=True)
    n0 = fa.LAUNCHES
    with pytest.raises(NotImplementedError, match="needs_grad=True"):
        fa.flash_attention_fn(too_wide, too_wide, too_wide, causal=True)
    assert fa.LAUNCHES == n0
    n = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    fa.flash_attention_fn(wide, wide, wide, causal=True).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    pool = torch.randn(4, 8, 2, 64, device="cuda")
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    ln = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    qd = q[0, :2]                                  # [B=2, H=2, D=64]
    with pytest.raises(NotImplementedError, match="inference-only"):
        pa.paged_attention(qd, pool, pool, table, ln)
    with torch.no_grad():
        fa.flash_attention_fn(wide, wide, wide, causal=True)
        pa.paged_attention(qd, pool, pool, table, ln)


@pytest.mark.parametrize("dtype,d,fwd_body,bwd_body", [
    (torch.bfloat16, 64, "tc16", "tc16"), (torch.float16, 128, "tc16", "tc16"),
    (torch.float32, 64, "3xtf32", "simt"), (torch.float32, 128, "3xtf32", "simt"),
    (torch.bfloat16, 192, "simt", "simt"), (torch.float32, 256, "simt", "simt")])
def test_flash_calls_reach_their_dtypes_bodies(cuda, dtype, d, fwd_body,
                                               bwd_body):
    """The C entries' body rule, by the per-body launch counters: bf16 /
    f16 at head_dim <= 128 stay on the 16-bit tensor cores forward and
    backward, f32 takes 3xTF32 forward and the SIMT backward, head_dim
    129-256 the SIMT bodies; one forward and one K2a + K2b per call."""
    q, k, v = _fwd_inputs(cuda, dtype, 2, 3, 100, 100, d, "contiguous")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fwd0, bwd0 = dict(fa.FWD_BODY_LAUNCHES), dict(fa.BWD_BODY_LAUNCHES)
    fa.flash_attention_fn(q, k, v, causal=True).float().sum().backward()
    fwd = {n: c - fwd0[n] for n, c in fa.FWD_BODY_LAUNCHES.items()}
    bwd = {n: c - bwd0[n] for n, c in fa.BWD_BODY_LAUNCHES.items()}
    assert fwd == {n: int(n == fwd_body) for n in fwd}
    assert bwd == {n: 2 * int(n == bwd_body) for n in bwd}


def test_flash_f32_keys_are_not_symmetric(cuda):
    """K1's 3xTF32 body takes the keys of each 8-wide step in a permuted
    order (2t, 2t + 1 per lane): V that rises with the key index and a q.k
    that favours late keys would show any mismatch between the P and V
    fragments, at the f32 tolerance."""
    b, h, s, d = 2, 4, 200, 96
    q = torch.randn(b, s, h, d, generator=cuda, device="cuda")
    k = torch.randn(b, s, h, d, generator=cuda, device="cuda") \
        + torch.linspace(0, 1, s, device="cuda")[None, :, None, None]
    v = torch.arange(s * d, dtype=torch.float32, device="cuda").reshape(
        1, s, 1, d).expand(b, s, h, d).contiguous() / (s * d)
    for causal in (True, False):
        o = fa.flash_attention_fn(q, k, v, causal=causal)
        torch.testing.assert_close(
            o, fa.flash_attention_ref(q, k, v, causal=causal),
            atol=ATOL[torch.float32], rtol=0)


def test_flash_f32_one_pass_tf32_fails_the_tight_check(cuda, tmp_path,
                                                       monkeypatch):
    """The control for F32_TC_ATOL: K1 built from a copy of the sources
    whose TF32 product lacks the 3xTF32 split's two cross terms (one TF32
    product per product, the precision 3xTF32 exists to avoid) errs past
    F32_TC_ATOL on f32 cases where the committed body stays within it.
    The copy is built into this test's own directory and unloaded after."""
    from paddle_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    cross = ("  mma1688_tf32(c, a.small, p0.big, p1.big);\n"
             "  mma1688_tf32(c, a.big, p0.small, p1.small);\n")
    text = (src / "mma.cuh").read_text()
    assert text.count(cross) == 1
    (src / "mma.cuh").write_text(text.replace(cross, ""))
    cases = [_fwd_inputs(cuda, torch.float32, b, h, sq, sk, d, "contiguous")
             + (causal,) for b, h, sq, sk, d, causal in (
                 (2, 3, 300, 300, 64, True), (2, 3, 256, 256, 128, True),
                 (1, 4, 512, 512, 128, False), (2, 3, 200, 256, 40, True))]

    def errs():
        return [(fa.flash_attention_fn(q, k, v, causal=c)
                 - fa.flash_attention_ref(q, k, v, causal=c)).abs().max()
                .item() for q, k, v, c in cases]

    three = errs()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_SECONDS", _build.BUILD_SECONDS)
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(_build._libs, "flash_attention_fwd", raising=False)
    one = errs()
    print(f"K1 f32 max |err| per case: 3xTF32 {three}; one-pass TF32 {one} "
          f"(ATOL {ATOL[torch.float32]}, F32_TC_ATOL {F32_TC_ATOL})")
    assert max(three) <= F32_TC_ATOL < min(one)


def _rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


def _bwd_inputs(gen, dtype, b, h, sq, sk, d, causal, g_lse, layout):
    """q, k, v, g ``[b, S, h, d]``, the kernel forward's lse and the row
    correction r.  ``layout``: "contiguous"; "unaligned", each tensor a
    view one element into rows of d + 1 (the kernels' scalar staging);
    "qkv", q / k / v the model's head-major split of ``[b, S, h, 3, d]``."""
    def t(s, width=d):
        return torch.randn(b, s, h, width, generator=gen, device="cuda").to(dtype)

    if layout == "qkv":
        q, k, v = torch.randn(b, sq, h, 3, d, generator=gen,
                              device="cuda").to(dtype).unbind(3)
        g = t(sq)
    elif layout == "unaligned":
        q, k, v, g = (t(s, d + 1)[..., 1:] for s in (sq, sk, sk, sq))
    else:
        q, k, v, g = t(sq), t(sk), t(sk), t(sq)
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(-1, sq)
    r = delta - (torch.randn(delta.shape, generator=gen, device="cuda")
                 if g_lse else 0.0)
    return q, k, v, g, lse, r.contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,g_lse,layout", [
    (2, 3, 17, 17, 64, True, False, "contiguous"),
    (2, 3, 300, 300, 64, True, False, "contiguous"),
    (2, 3, 64, 320, 64, True, True, "contiguous"),
    (2, 3, 300, 300, 64, False, True, "contiguous"),
    (2, 3, 256, 256, 128, True, False, "contiguous"),
    (2, 3, 33, 70, 128, False, False, "contiguous"),
    # the training shape
    (8, 12, 1024, 1024, 64, True, False, "contiguous"),
    # head_dim zero-padded to 64 / 128 in shared memory
    (2, 3, 300, 300, 32, True, False, "contiguous"),
    (2, 3, 200, 256, 40, True, True, "contiguous"),
    (2, 3, 129, 129, 96, False, True, "contiguous"),
    # rows that take no 16-byte copies: head_dim 17, a misaligned base
    (2, 3, 100, 100, 17, True, False, "contiguous"),
    (2, 3, 300, 300, 64, True, False, "unaligned"),
    # the model's strided head-major qkv split, read in place
    (2, 12, 512, 512, 64, True, False, "qkv"),
    # head_dim 129-256: the SIMT body with 32-row tiles in every dtype,
    # causal and not, ragged lengths, sq < sk
    (2, 2, 160, 160, 192, True, False, "contiguous"),
    (2, 2, 129, 200, 192, False, True, "contiguous"),
    (2, 2, 160, 160, 256, False, False, "contiguous"),
    (1, 3, 77, 300, 256, True, True, "contiguous"),
    (1, 2, 100, 100, 256, True, False, "unaligned")])
def test_flash_bwd_kernels_match_plain(cuda, dtype, b, h, sq, sk, d, causal,
                                       g_lse, layout):
    """K2a (dk, dv) and K2b (dq) against flash_attention_bwd_ref on the
    same inputs and the kernel forward's lse; error over max |ref|."""
    q, k, v, g, lse, r = _bwd_inputs(cuda, dtype, b, h, sq, sk, d, causal,
                                     g_lse, layout)
    scale = d ** -0.5
    n = fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    got = fa._bwd_kernels(q, k, v, g, lse, r, scale, causal)
    assert (fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == (n[0] + 1, n[1] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and a.is_contiguous()
        assert _rel_err(a, b) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype, layout):
    """Two launches of K2a + K2b on the same inputs give bit-equal dq, dk
    and dv: no atomics, every sum in a fixed order."""
    args = _bwd_inputs(cuda, dtype, 2, 4, 700, 700, 64, True, True, layout)
    first = fa._bwd_kernels(*args, 0.125, True)
    second = fa._bwd_kernels(*args, 0.125, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_matches_torch_autograd(cuda):
    """Gradients through K1 + K2 (the autograd Function) against torch
    autograd through flash_attention_ref, f32, from the model's strided
    head-major qkv split; error over max |ref| <= 1e-4."""
    qkv = torch.randn(2, 200, 4, 3, 64, generator=cuda, device="cuda")
    g = torch.randn(2, 200, 4, 64, generator=cuda, device="cuda")
    a = qkv.clone().requires_grad_()
    b = qkv.clone().requires_grad_()
    n = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    fa.flash_attention_fn(*a.unbind(3), causal=True).backward(g)
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    fa.flash_attention_ref(*b.unbind(3), causal=True).backward(g)
    assert _rel_err(a.grad, b.grad) <= 1e-4


def test_gpt_tiny_trains_on_card_through_the_kernels(cuda):
    """Tiny GPT, f32: 3 TrainSteps on the card give the CPU's losses
    (rtol 1e-4), and every step ran K1, K2a and K2b once per layer."""
    cfg = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    cpu = GPTForCausalLM(device="cpu", **cfg)
    card = GPTForCausalLM(device="cpu", **cfg)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 96, (2, 48)))

    def train(model, device):
        o = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters(),
                            grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
        step = jit.TrainStep(model, o)
        x = ids.to(device)
        return [step({"input_ids": x, "labels": x}).item() for _ in range(3)]

    want = train(cpu, "cpu")
    n = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    got = train(card, "cuda")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (fa.LAUNCHES - n[0], fa.BWD_DKDV_LAUNCHES - n[1],
            fa.BWD_DQ_LAUNCHES - n[2]) == (2 * 3,) * 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,hkv,ps", [(12, 12, 16), (12, 4, 16), (8, 1, 8),
                                      (4, 2, 32)])
def test_paged_kernel_matches_plain(cuda, dtype, h, hkv, ps):
    NP, d = 12, 64
    lens = [0, 1, ps - 1, ps, ps + 1, NP * ps, 5 * ps + 3, NP * ps + 9]
    B = len(lens)
    table = torch.randperm(B * NP, generator=cuda, device="cuda")
    table = table.to(torch.int32).reshape(B, NP)
    kp = torch.randn(B * NP, ps, hkv, d, generator=cuda, device="cuda").to(dtype)
    vp = torch.randn(B * NP, ps, hkv, d, generator=cuda, device="cuda").to(dtype)
    q = torch.randn(B, h, d, generator=cuda, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n0 = pa.LAUNCHES
    o = pa.paged_attention(q, kp, vp, table, ln)
    assert pa.LAUNCHES == n0 + 1
    ref = pa.paged_attention_ref(q, kp, vp, table, ln)
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    assert bool((o[0] == 0).all())
    # NaN in every dead page: never read, so the output is unchanged
    for b, n in enumerate(lens):
        dead = table[b, -(-n // ps):].long()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
    o2 = pa.paged_attention(q, kp, vp, table, ln)
    torch.cuda.synchronize()
    assert torch.equal(o2, o)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lens,h,hkv,ps,NP", [
    ([1024], 12, 12, 16, 64),                      # one long row: many splits
    ([4096, 1, 2000, 0], 12, 4, 16, 256),          # a table of 256 slots
    ([2048, 77, 1999], 8, 1, 8, 256),
    ([514, 916, 354, 835, 193, 675, 113, 594], 12, 12, 16, 64),  # the slice's
    ([31, 33, 95, 96], 4, 2, 32, 3)])              # ragged tiles, few slots
def test_paged_split_kernels(cuda, dtype, quant, lens, h, hkv, ps, NP):
    """The split-K decode (K3, or K4 with int8 pools) against its plain
    version; a second launch bit-equal to the first; the full sweep (K5a /
    K5b) bit-equal to it; NaN in every dead page (K3) or dead scale row
    (K4) changes no bit of either."""
    B, d = len(lens), 64
    table = torch.randperm(B * NP, generator=cuda, device="cuda")
    table = table.to(torch.int32).reshape(B, NP)
    q = torch.randn(B, h, d, generator=cuda, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if quant:
        pools = _quant_pools(cuda, B * NP, ps, hkv, d)
        fn, full, ref_fn = (pa.paged_attention_quantized,
                            pa._paged_q_full_sweep,
                            pa.paged_attention_quantized_ref)
    else:
        pools = tuple(torch.randn(B * NP, ps, hkv, d, generator=cuda,
                                  device="cuda").to(dtype) for _ in range(2))
        fn, full, ref_fn = (pa.paged_attention, pa._paged_full_sweep,
                            pa.paged_attention_ref)
    o = fn(q, *pools, table, ln)
    again = fn(q, *pools, table, ln)
    o5 = full(q, *pools, table, ln)
    ref = ref_fn(q, *pools, table, ln)
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    assert torch.equal(again, o) and torch.equal(o5, o)
    assert all(bool((o[i] == 0).all()) for i, n in enumerate(lens) if n == 0)
    poisoned = [x.clone() for x in pools]
    for i, n in enumerate(lens):
        dead = table[i, -(-n // ps):].long()
        for x in (poisoned[2:] if quant else poisoned):
            x[dead] = float("nan")
    o_p = fn(q, *poisoned, table, ln)
    o5_p = full(q, *poisoned, table, ln)
    torch.cuda.synchronize()
    assert torch.equal(o_p, o) and torch.equal(o5_p, o)


def test_paged_kernel_reads_strided_q(cuda):
    qkv = torch.randn(4, 6, 3, 32, generator=cuda, device="cuda")
    q = qkv[:, :, 0]
    kp = torch.randn(9, 8, 6, 32, generator=cuda, device="cuda")
    vp = torch.randn(9, 8, 6, 32, generator=cuda, device="cuda")
    table = torch.arange(8, dtype=torch.int32, device="cuda").reshape(4, 2)
    ln = torch.tensor([3, 16, 9, 1], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(pa.paged_attention(q, kp, vp, table, ln),
                               pa.paged_attention_ref(q, kp, vp, table, ln),
                               atol=2e-4, rtol=0)


def test_engine_on_card_matches_cpu_engine(cuda):
    """Tiny random GPT, float32: the card engine's greedy ids equal the CPU
    engine's, and every prefill / decode step went through the kernels."""
    cfg = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    cpu = GPTForCausalLM(device="cpu", **cfg)
    card = GPTForCausalLM(device="cpu", **cfg)
    card.load_state_dict(cpu.state_dict())
    prompts = [np.random.RandomState(i).randint(1, 96, n).tolist()
               for i, n in enumerate((3, 8, 13, 16, 40))]

    def serve(model, device):
        with ServingEngine(model, device=device, num_slots=3, page_size=8,
                           max_model_len=64) as eng:
            hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
            return [h.result(timeout=120) for h in hs], eng.stats()

    want, _ = serve(cpu, "cpu")
    k1, k3 = fa.LAUNCHES, pa.LAUNCHES
    got, st = serve(card, "cuda")
    assert got == want
    assert fa.LAUNCHES - k1 == 2 * st["prefills"] > 0
    assert pa.LAUNCHES - k3 == 2 * st["iteration"] > 0


# --------------------------------------------------------- int8 serving
def _quant_pools(gen, pages, ps, hkv, d):
    kq, ks = pa.quantize_kv(torch.randn(pages, ps, hkv, d, generator=gen,
                                        device="cuda"))
    vq, vs = pa.quantize_kv(torch.randn(pages, ps, hkv, d, generator=gen,
                                        device="cuda"))
    return kq, vq, ks.contiguous(), vs.contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,hkv,ps", [(12, 12, 16), (12, 4, 16), (8, 1, 8),
                                      (4, 2, 32)])
def test_quant_paged_kernel_matches_plain(cuda, dtype, h, hkv, ps):
    """K4 against paged_attention_quantized_ref; K5b bit-equal to K4; NaN
    in every dead page's scale rows changes neither (K4 never reads them,
    K5b stages them and must not use them); empty rows are zeros."""
    NP, d = 12, 64
    lens = [0, 1, ps - 1, ps, ps + 1, NP * ps, 5 * ps + 3, NP * ps + 9]
    B = len(lens)
    table = torch.randperm(B * NP, generator=cuda, device="cuda")
    table = table.to(torch.int32).reshape(B, NP)
    kq, vq, ks, vs = _quant_pools(cuda, B * NP, ps, hkv, d)
    q = torch.randn(B, h, d, generator=cuda, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = pa.QUANT_LAUNCHES, pa.QUANT_FULL_SWEEP_LAUNCHES
    o = pa.paged_attention_quantized(q, kq, vq, ks, vs, table, ln)
    o5 = pa._paged_q_full_sweep(q, kq, vq, ks, vs, table, ln)
    assert (pa.QUANT_LAUNCHES, pa.QUANT_FULL_SWEEP_LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    ref = pa.paged_attention_quantized_ref(q, kq, vq, ks, vs, table, ln)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    assert bool((o[0] == 0).all())
    assert torch.equal(o5, o)
    for b, n_ in enumerate(lens):
        dead = table[b, -(-n_ // ps):].long()
        ks[dead] = float("nan")
        vs[dead] = float("nan")
    o_p = pa.paged_attention_quantized(q, kq, vq, ks, vs, table, ln)
    o5_p = pa._paged_q_full_sweep(q, kq, vq, ks, vs, table, ln)
    torch.cuda.synchronize()
    assert torch.equal(o_p, o) and torch.equal(o5_p, o)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,hkv,ps", [(12, 12, 16), (12, 4, 16), (4, 2, 32)])
def test_full_sweep_kernel_equals_k3(cuda, dtype, h, hkv, ps):
    """K5a stages every table page, NaN-poisoned dead pages included, and
    still gives K3's output bit for bit (and the plain version's)."""
    NP, d = 12, 64
    lens = [0, 1, ps - 1, ps + 1, NP * ps, 5 * ps + 3]
    B = len(lens)
    table = torch.randperm(B * NP, generator=cuda, device="cuda")
    table = table.to(torch.int32).reshape(B, NP)
    kp = torch.randn(B * NP, ps, hkv, d, generator=cuda, device="cuda").to(dtype)
    vp = torch.randn(B * NP, ps, hkv, d, generator=cuda, device="cuda").to(dtype)
    q = torch.randn(B, h, d, generator=cuda, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o = pa.paged_attention(q, kp, vp, table, ln)
    n0 = pa.FULL_SWEEP_LAUNCHES
    o5 = pa._paged_full_sweep(q, kp, vp, table, ln)
    assert pa.FULL_SWEEP_LAUNCHES == n0 + 1
    assert torch.equal(o5, o)
    ref = pa.paged_attention_ref(q, kp, vp, table, ln)
    torch.testing.assert_close(o5.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    for b, n in enumerate(lens):
        dead = table[b, -(-n // ps):].long()
        kp[dead] = float("nan")
        vp[dead] = float("nan")
    o5_p = pa._paged_full_sweep(q, kp, vp, table, ln)
    torch.cuda.synchronize()
    assert torch.equal(o5_p, o)


def test_quant_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(2, 4, 64, device="cuda")
    kq = torch.zeros(4, 8, 2, 64, dtype=torch.int8, device="cuda")
    sc = torch.ones(4, 8, 2, device="cuda")
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    ln = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):                       # f32 pools
        pa.paged_attention_quantized(q, kq.float(), kq.float(), sc, sc, table, ln)
    with pytest.raises(TypeError):                       # f16 scales
        pa.paged_attention_quantized(q, kq, kq, sc.half(), sc.half(), table, ln)
    with pytest.raises(ValueError):                      # scale shape
        pa.paged_attention_quantized(q, kq, kq, sc[:, :4], sc[:, :4], table, ln)
    with pytest.raises(ValueError):                      # not contiguous
        pa.paged_attention_quantized(q, kq, kq, sc.transpose(0, 1),
                                     sc.transpose(0, 1), table, ln)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_grid_on_card_equals_cpu(cuda, dtype):
    """quantize_kv on the card gives the CPU's int8 bytes and float32
    scales exactly: every division is a true float32 division there too."""
    x = (torch.randn(64, 16, 12, 64, generator=cuda, device="cuda") * 3).to(dtype)
    qc, sc = pa.quantize_kv(x)
    qh, sh = pa.quantize_kv(x.cpu())
    assert torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh)


@pytest.mark.parametrize("rows", [1, 5, 8, 16, 17, 33])
def test_int8_linear_on_card_equals_cpu(cuda, rows):
    """torch._int_mm on the card (rows padded to what it takes) gives the
    CPU's exact int32 product: the outputs agree to float rounding."""
    from paddle_tpu_torch.nn.layers.common import Linear
    from paddle_tpu_torch.quantization import Int8Linear

    torch.manual_seed(rows)
    lin = Linear(768, 2304)
    cpu = Int8Linear(lin, float(lin.weight.detach().abs().max()) / 127)
    card = Int8Linear(copy.deepcopy(lin).to("cuda"), cpu.w_scale)
    assert torch.equal(card.weight_int8.cpu(), cpu.weight_int8)
    x = torch.randn(2, rows, 768)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to("cuda"))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-6)


def _top1(ref, got):
    match = sum(sum(a == b for a, b in zip(r, g)) for r, g in zip(ref, got))
    return match / sum(max(len(r), len(g)) for r, g in zip(ref, got))


def test_int8_engine_on_card_matches_cpu_engine(cuda):
    """Tiny random GPT, float32, kv_dtype="int8": the card engine against
    the CPU engine (first tokens equal: prefill is full precision; greedy
    agreement >= 0.8: int8 rounding ties may flip on last-bit differences),
    K4 once per layer per decode step and K3 never; then with
    weight_dtype="int8" too (torch._int_mm in every Linear)."""
    cfg = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    base = GPTForCausalLM(device="cpu", **cfg)
    prompts = [np.random.RandomState(i).randint(1, 96, n).tolist()
               for i, n in enumerate((3, 8, 13, 16, 40))]

    def serve(device, **kw):
        model = GPTForCausalLM(device="cpu", **cfg)
        model.load_state_dict(base.state_dict())
        with ServingEngine(model, device=device, num_slots=3, page_size=8,
                           max_model_len=64, kv_dtype="int8", **kw) as eng:
            hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
            return [h.result(timeout=120) for h in hs], eng.stats()

    for kw in ({}, {"weight_dtype": "int8"}):
        want, _ = serve("cpu", **kw)
        k1, k3, k4 = fa.LAUNCHES, pa.LAUNCHES, pa.QUANT_LAUNCHES
        got, st = serve("cuda", **kw)
        assert [g[0] for g in got] == [w[0] for w in want], kw
        assert _top1(want, got) >= 0.8, kw
        assert fa.LAUNCHES - k1 == 2 * st["prefills"] > 0
        assert pa.QUANT_LAUNCHES - k4 == 2 * st["iteration"] > 0
        assert pa.LAUNCHES == k3


# ------------------------------------------------------------ K6 bias_gelu
K6_SHAPES = [(128, 64), (8192, 3072), (37, 1001), (3, 5, 7), (1, 3), (6,)]


@pytest.mark.parametrize("x_dtype,b_dtype", [
    (torch.float32, torch.float32), (torch.float16, torch.float16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", K6_SHAPES)
def test_bias_gelu_kernel_matches_plain(cuda, x_dtype, b_dtype, shape):
    """K6 against its plain version: the chip_smoke shapes (the example's,
    GPT-base's MLP activation at B=8, S=1024, an odd N) and small ragged
    ones that take the scalar tail; both round once from float32."""
    x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(x_dtype)
    b = torch.randn(shape[-1], generator=cuda, device="cuda").to(b_dtype)
    n0 = bg.LAUNCHES
    y = bg.bias_gelu(x, b)
    assert bg.LAUNCHES == n0 + 1
    assert y.dtype == x_dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), bg.bias_gelu_ref(x, b).float(),
                               atol=ATOL[x_dtype], rtol=0)


def test_bias_gelu_kernel_on_strided_and_unaligned_x(cuda):
    """A non-contiguous x is made contiguous; an x 2 elements into its
    storage is not 16-byte aligned and takes the scalar loop."""
    base = torch.randn(64, 130, generator=cuda, device="cuda")
    b = torch.randn(64, generator=cuda, device="cuda")
    for x in (base[:, :128].t(), base.reshape(-1)[2:2 + 64 * 100].reshape(100, 64)):
        torch.testing.assert_close(bg.bias_gelu(x, b), bg.bias_gelu_ref(x, b),
                                   atol=2e-4, rtol=0)


def test_bias_gelu_autograd_on_card_matches_cpu(cuda):
    x = torch.randn(33, 64, generator=cuda, device="cuda", requires_grad=True)
    b = torch.randn(64, generator=cuda, device="cuda", requires_grad=True)
    g = torch.randn(33, 64, generator=cuda, device="cuda")
    bg.bias_gelu(x, b).backward(g)
    xc = x.detach().cpu().requires_grad_()
    bc = b.detach().cpu().requires_grad_()
    bg.bias_gelu(xc, bc).backward(g.cpu())
    torch.testing.assert_close(x.grad.cpu(), xc.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b.grad.cpu(), bc.grad, atol=1e-4, rtol=1e-5)


def test_bias_gelu_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(4, 8, device="cuda")
    with pytest.raises(TypeError):
        bg.bias_gelu(x.double(), torch.randn(8, device="cuda").double())
    with pytest.raises(ValueError):
        bg.bias_gelu(x, torch.randn(8))            # bias on the CPU
    with pytest.raises(ValueError):
        bg.bias_gelu(x, torch.randn(7, device="cuda"))


# ------------------------------------------------------------- fake quant
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_on_card_equals_cpu(cuda, dtype):
    """Fake-quant and the moving-average quanter give the CPU's bytes on
    the card (every division is by a tensor; the moving-average constants
    are cast to the operand's dtype first), outputs and stored scales, in
    train and eval mode; the STE gradient too."""
    x = (torch.randn(4, 1000, generator=cuda, device="cuda") * 3).to(dtype)
    x[0, :4] = torch.tensor([0.5, -1.5, 2.5, 1000.0])
    s = torch.tensor(0.0371, device="cuda")
    got = quant._fake_quant(x, s, -127.0, 127.0)
    want = quant._fake_quant(x.cpu(), s.cpu(), -127.0, 127.0)
    assert torch.equal(got.cpu(), want)
    qc, qg = quant.FakeQuanterWithAbsMaxObserver(), \
        quant.FakeQuanterWithAbsMaxObserver().cuda()
    for i, amp in enumerate((0.2, 0.5, 4.0, 6.0, 5.0)):
        xi = (torch.randn(64, 96, generator=cuda, device="cuda") * amp).to(dtype)
        if i == 4:
            qc.eval()
            qg.eval()
        xg = xi.clone().requires_grad_()
        xc = xi.cpu().requires_grad_()
        yg, yc = qg(xg), qc(xc)
        assert torch.equal(yg.detach().cpu(), yc.detach())
        assert torch.equal(qg.scale.cpu(), qc.scale)
        yg.sum().backward()
        yc.sum().backward()
        assert torch.equal(xg.grad.cpu(), xc.grad)


def test_qat_tiny_gpt_trains_on_card_like_cpu(cuda):
    """QAT-wrapped tiny GPT: 3 f32 TrainSteps on the card against the CPU,
    then convert_to_int8 and serve with int8 pools: first tokens equal,
    greedy agreement >= 0.8.  The first loss (one forward) rtol 1e-5; all
    three rtol 1e-3, since fake-quant turns last-bit GEMM differences into
    whole grid steps (the sensitivity measured in test_torch_port_qat.py)."""
    from paddle_tpu_torch.serving.quant import top1_agreement

    torch.manual_seed(0)
    cpu = quant.QAT(quant.QuantConfig()).quantize(GPTForCausalLM(
        device="cpu", vocab_size=96, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128))
    card = copy.deepcopy(cpu).to("cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(1, 96, (4, 64)))
    losses = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = jit.TrainStep(m, opt, loss_fn=None)
        x = ids.to(dev)
        losses[dev] = [float(step({"input_ids": x, "labels": x})) for _ in range(3)]
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    outs = {}
    prompts = [np.random.RandomState(i).randint(1, 96, (n,)).tolist()
               for i, n in enumerate((5, 17, 40))]
    for dev, m in (("cpu", cpu), ("cuda", card)):
        quant.convert_to_int8(m.eval())
        with ServingEngine(m, device=dev, num_slots=2, page_size=16,
                           max_model_len=128, kv_dtype="int8") as eng:
            hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            outs[dev] = [h.result(timeout=300) for h in hs]
    assert [o[0] for o in outs["cuda"]] == [o[0] for o in outs["cpu"]]
    assert top1_agreement(outs["cpu"], outs["cuda"]) >= 0.8


# ------------------------------------- generate() and speculative / chunked
def _stacked_pools(gen, dtype, L, shape):
    """Layer 1 of stacked ``[L, *shape]`` pools (a view, as generate()
    hands each layer)."""
    return [torch.randn((L,) + shape, generator=gen, device="cuda").to(dtype)[1]
            for _ in range(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,PP,pos", [(4, 20, 300), (8, 40, 639), (1, 1, 0)])
def test_paged_decode_attend_identity_table(cuda, dtype, B, PP, pos):
    """K3 over generate()'s per-sequence pools viewed as [B*PP, ...] with
    the identity table, against the plain version on the CPU."""
    kp, vp = _stacked_pools(cuda, dtype, 3, (B, PP, 16, 12, 64))
    q = torch.randn(B, 12, 64, generator=cuda, device="cuda").to(dtype)
    k3, via = pa.LAUNCHES, pa.DECODE_ATTEND_LAUNCHES
    o = pa.paged_decode_attend(q, kp, vp, pos)
    assert pa.LAUNCHES == k3 + 1 and pa.DECODE_ATTEND_LAUNCHES == via + 1
    ref = pa.paged_decode_attend(q.cpu(), kp.cpu(), vp.cpu(), pos)
    torch.testing.assert_close(o.cpu().float(), ref.float(),
                               atol=ATOL[dtype], rtol=0)


def _chunk_inputs(gen, dtype, B, C, lens, NP=64, quant=False):
    P = B * NP + 1
    table = torch.randperm(P - 1, generator=gen, device="cuda")[:B * NP] \
        .to(torch.int32).reshape(B, NP)
    q = torch.randn(B, C, 12, 64, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if quant:
        return (q, *_quant_pools(gen, P, 16, 12, 64), table, ln)
    kp = torch.randn(P, 16, 12, 64, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, 16, 12, 64, generator=gen, device="cuda").to(dtype)
    return q, kp, vp, table, ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,C,lens", [
    (8, 5, [514, 916, 354, 835, 193, 675, 113, 1021]),   # verify, one at cap
    (1, 128, [512]),                                     # one prefill chunk
    (3, 17, [0, 1000, 40]),
])
def test_chunk_attend_expanded_rows(cuda, dtype, quant, B, C, lens):
    """K3 (K4 over int8 pools) over the [B*C]-row expansion, against the
    plain version on the card, a second launch bit-equal."""
    args = _chunk_inputs(cuda, dtype, B, C, lens, quant=quant)
    if quant:
        fn, ref_fn = pa.paged_chunk_attend_quant, pa.paged_chunk_attend_quant_ref
        before = (pa.QUANT_LAUNCHES, pa.QUANT_CHUNK_LAUNCHES)
    else:
        fn, ref_fn = pa.paged_chunk_attend, pa.paged_chunk_attend_ref
        before = (pa.LAUNCHES, pa.CHUNK_LAUNCHES)
    o = fn(*args)
    after = (pa.QUANT_LAUNCHES, pa.QUANT_CHUNK_LAUNCHES) if quant \
        else (pa.LAUNCHES, pa.CHUNK_LAUNCHES)
    assert after == (before[0] + 1, before[1] + 1)
    assert torch.equal(fn(*args), o)
    torch.testing.assert_close(o.float(), ref_fn(*args).float(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_write_on_card_equals_cpu(cuda, quant):
    """The chunk write with lanes past the table (a slot at the cap, one
    wholly past it) is byte-equal on the card and on the CPU."""
    P, ps, NP = 13, 4, 3
    table = torch.randperm(P - 1, generator=cuda, device="cuda")[:9] \
        .to(torch.int32).reshape(3, NP)
    lens = torch.tensor([2, 10, 13], dtype=torch.int32, device="cuda")
    kv = torch.randn(3, 5, 2, 8, generator=cuda, device="cuda")
    pool = torch.randn(P, ps, 2, 8, generator=cuda, device="cuda")
    if quant:
        pool = pool.mul(50).to(torch.int8)
        spool = torch.rand(P, ps, 2, generator=cuda, device="cuda")
        got = pa.paged_table_chunk_write_quant(pool.clone(), spool.clone(),
                                               kv, table, lens)
        want = pa.paged_table_chunk_write_quant(
            pool.cpu(), spool.cpu(), kv.cpu(), table.cpu(), lens.cpu())
    else:
        got = (pa.paged_table_chunk_write(pool.clone(), kv, table, lens),)
        want = (pa.paged_table_chunk_write(pool.cpu(), kv.cpu(), table.cpu(),
                                           lens.cpu()),)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["additive", "bool"])
def test_masked_attention_on_card_matches_cpu(cuda, dtype, mask_kind):
    """A masked call without dropout runs the plain attention on the card
    (the dense decode cache's path), as on the CPU."""
    from paddle_tpu_torch.nn import functional as TF

    q = torch.randn(2, 5, 4, 64, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(2, 20, 4, 64, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(2, 20, 4, 64, generator=cuda, device="cuda").to(dtype)
    keep = torch.arange(20, device="cuda")[None, :] \
        <= 14 + torch.arange(5, device="cuda")[:, None]
    mask = keep[None, None] if mask_kind == "bool" else \
        torch.zeros(1, 1, 5, 20, device="cuda").masked_fill(~keep, -1e30)
    o = TF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                        training=False)
    ref = TF.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                          attn_mask=mask.cpu(), training=False)
    assert o.dtype == dtype
    torch.testing.assert_close(o.cpu().float(), ref.float(),
                               atol=ATOL[dtype], rtol=0)


def test_dropout_on_card_still_raises(cuda):
    """With dropout active, what the plain attention cannot take still
    raises on the card: unequal head counts without a mask (GQA), as in
    the TPU package."""
    from paddle_tpu_torch.nn import functional as TF

    q = torch.randn(1, 8, 4, 64, device="cuda")
    kv = torch.randn(1, 8, 2, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="dropout_p=0.1"):
        TF.scaled_dot_product_attention(q, kv, kv, dropout_p=0.1,
                                        is_causal=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_inactive_dropout_on_card_is_the_kernel(cuda, dtype):
    """Eval mode with dropout_p > 0, and dropout_p = 0, dispatch to K1 and
    equal a direct K1 call bit for bit."""
    from paddle_tpu_torch.nn import functional as TF

    q, k, v = _fwd_inputs(cuda, dtype, 2, 3, 70, 70, 64, "contiguous")
    want = fa.flash_attention_bshd(q, k, v, causal=True)
    n0 = fa.LAUNCHES
    for kw in (dict(dropout_p=0.3, training=False),
               dict(dropout_p=0.0, training=True)):
        got = TF.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)
        assert torch.equal(got, want)
    assert fa.LAUNCHES == n0 + 2


def test_dropout_on_card_keeps_1_minus_p_and_scales(cuda):
    """Training-mode dropout runs the plain attention on the card: with
    q = k = 0 every probability is 1 / Sk, and a one-hot V reads each
    dropped probability out, so every output entry is 0 or exactly
    1 / (Sk (1 - p)).  The kept share lies within 4 binomial standard
    deviations of 1 - p (N = 98,304 draws; the generator is seeded)."""
    from paddle_tpu_torch.nn import functional as TF

    B, S, H, p = 2, 64, 12, 0.3
    q = torch.zeros(B, S, H, S, device="cuda")
    v = torch.eye(S, device="cuda")[None, :, None, :].expand(B, S, H, S)
    torch.manual_seed(0)
    n0 = fa.LAUNCHES
    out = TF.scaled_dot_product_attention(q, q, v.contiguous(), dropout_p=p,
                                          training=True)
    assert fa.LAUNCHES == n0
    kept = out != 0
    torch.testing.assert_close(out[kept], torch.full_like(
        out[kept], 1 / (S * (1 - p))), atol=1e-7, rtol=1e-6)
    n = out.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5


def test_masked_dropout_on_card(cuda):
    """A masked call with dropout: masked keys get no weight, kept ones
    1 / (visible keys x (1 - p)) under q = k = 0, in training mode; in
    eval mode the masked plain attention, as without dropout."""
    from paddle_tpu_torch.nn import functional as TF

    B, S, H, p = 2, 40, 4, 0.5
    q = torch.zeros(B, S, H, S, device="cuda")
    v = torch.eye(S, device="cuda")[None, :, None, :].expand(
        B, S, H, S).contiguous()
    keep = torch.arange(S, device="cuda")[None, :] < 10 + torch.arange(
        S, device="cuda")[:, None] // 2
    mask = keep[None, None]
    torch.manual_seed(1)
    out = TF.scaled_dot_product_attention(q, q, v, attn_mask=mask,
                                          dropout_p=p, training=True)
    probs = out.permute(0, 2, 1, 3)                # [B, H, query, key]
    assert not bool(probs[..., ~keep].any())
    visible = keep.sum(-1).float()[None, None, :, None].expand_as(probs)
    kept = probs != 0
    torch.testing.assert_close(probs[kept], 1 / (visible[kept] * (1 - p)),
                               atol=1e-7, rtol=1e-6)
    assert 0.3 < kept.float().sum().item() / keep.sum().item() / (B * H) < 0.7
    ev = TF.scaled_dot_product_attention(q, q, v, attn_mask=mask,
                                         dropout_p=p, training=False)
    torch.testing.assert_close(ev, TF.scaled_dot_product_attention(
        q, q, v, attn_mask=mask, training=False), atol=0, rtol=0)


def test_gpt_tiny_trains_with_attention_dropout_on_card(cuda):
    """GPT-tiny with attention_probs_dropout_prob=0.1: TrainSteps on the
    card run the plain attention with dropout (no flash launch) with
    finite, falling losses; in eval mode its logits equal the same
    weights' at dropout 0 bit for bit, both through K1."""
    cfg = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    model = GPTForCausalLM(device="cuda", attention_probs_dropout_prob=0.1,
                           **cfg)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 96, (2, 48))
                           ).to("cuda")
    step = jit.TrainStep(model, optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters()))
    n0 = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES
    losses = [step({"input_ids": ids, "labels": ids}).item() for _ in range(6)]
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES) == n0
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    plain = GPTForCausalLM(device="cuda", **cfg)
    plain.load_state_dict(model.state_dict())
    model.eval()
    plain.eval()
    n0 = fa.LAUNCHES
    with torch.no_grad():
        assert torch.equal(model(ids), plain(ids))
    assert fa.LAUNCHES == n0 + 2 * cfg["num_hidden_layers"]


def _tiny_pair(cfg=None):
    cfg = cfg or dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    cpu = GPTForCausalLM(device="cpu", **cfg)
    return cpu, copy.deepcopy(cpu).to("cuda")


def test_generate_on_card_matches_cpu(cuda):
    """Tiny random GPT, float32: greedy generate() ids on the card equal
    the CPU's for the dense and paged caches, no cache and beam search;
    the paged prefill runs K1 once per layer, each paged decode step K3
    through paged_decode_attend once per layer."""
    cpu, card = _tiny_pair()
    ids = torch.from_numpy(np.random.RandomState(1).randint(1, 96, (3, 21)))
    for kw in (dict(cache_impl="dense"), dict(cache_impl="paged", page_size=8),
               dict(use_cache=False),
               dict(decode_strategy="beam_search", num_beams=3)):
        n = 4 if kw.get("use_cache") is False else 12
        k1, via = fa.LAUNCHES, pa.DECODE_ATTEND_LAUNCHES
        got = card.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        if kw.get("cache_impl") == "paged":
            assert fa.LAUNCHES - k1 == 2
            assert pa.DECODE_ATTEND_LAUNCHES - via == 2 * (n - 1)
        assert got.device.type == "cuda"
        want = cpu.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        assert torch.equal(got.cpu(), want), kw


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spec_and_chunked_engine_on_card_matches_cpu(cuda, kv_dtype):
    """Tiny random GPT, float32, speculative_k=3 with prefill_chunk_tokens=8
    on repetitive prompts: the card engine against the CPU engine (equal
    ids natively; with int8 pools first tokens equal and agreement >= 0.8),
    every verify step and prefill chunk through K3 (K4) via the chunk
    attend."""
    cpu, card = _tiny_pair()
    prompts = [[5, 6, 7, 8] * 3, [9, 10] * 10, [11, 12, 13] * 8, [14] * 5]

    def serve(model, device):
        with ServingEngine(model, device=device, num_slots=3, page_size=8,
                           max_model_len=64, speculative_k=3,
                           prefill_chunk_tokens=8, kv_dtype=kv_dtype) as eng:
            hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            return [h.result(timeout=120) for h in hs], eng.stats()

    want, _ = serve(cpu, "cpu")
    c0 = pa.QUANT_CHUNK_LAUNCHES if kv_dtype else pa.CHUNK_LAUNCHES
    got, st = serve(card, "cuda")
    c1 = pa.QUANT_CHUNK_LAUNCHES if kv_dtype else pa.CHUNK_LAUNCHES
    if kv_dtype:
        assert [g[0] for g in got] == [w[0] for w in want]
        assert _top1(want, got) >= 0.8
    else:
        assert got == want
    assert c1 - c0 == 2 * (st["verify_steps"] + st["prefill_chunks"])
    assert st["verify_steps"] > 0 and st["prefill_chunks"] > 0


# ------------------------------------------- robustness and prefix cache
def _held(eng, reqs, arm=None):
    """Submit while the scheduler sits in a wedge (one admission pass sees
    every request), arm a fault, release."""
    from paddle_tpu_torch.observability import faults

    site = f"serving.scheduler_wedge@{eng.replica}"
    faults.inject(site, seconds=60.0, times=1)
    while faults.trip_count(site) < 1:
        time.sleep(0.005)
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    if arm is not None:
        arm()
    faults.clear(site)
    return hs


def _engine_on(model, device, **kw):
    kw.setdefault("num_slots", 2)
    return ServingEngine(model, device=device, page_size=8,
                         max_model_len=64, **kw)


def _uninterrupted(model, reqs, **kw):
    with _engine_on(model, "cuda", **kw) as eng:
        return [eng.generate(p, max_new_tokens=n, timeout=120)
                for p, n, _ in reqs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_restart_on_card_keeps_ids(cuda, kv_dtype):
    """A TransientError at the 4th decode step with two requests in
    flight: one restart, both requeued, the rebuilt pools on the card, and
    the ids of an uninterrupted card run."""
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.resilience import TransientError

    _, card = _tiny_pair()
    reqs = [([5, 6, 7, 8, 9], 12, {}), ([11, 12, 13] * 4, 10, {})]

    def boom():
        raise TransientError("injected decode crash")

    eng = _engine_on(card, "cuda", kv_dtype=kv_dtype, replica="c-restart")
    try:
        with eng:
            eng.generate([3, 4], max_new_tokens=2, timeout=120)
            hs = _held(eng, reqs, arm=lambda: faults.inject(
                "serving.step_crash", fn=boom, at_trips={4}))
            got = [h.result(timeout=120) for h in hs]
            st = eng.stats()
    finally:
        faults.clear()
    assert st["engine_restarts"] == 1 and st["requests_requeued"] == 2
    assert all(p.device.type == "cuda" for p in eng._pools)
    assert got == _uninterrupted(card, reqs, kv_dtype=kv_dtype)


def test_restart_after_the_step_holds_one_pool_set(cuda):
    """A TransientError at the 4th decode step with two requests in
    flight: the restart zeroes the pools in place — the same tensors, so
    the card's allocated bytes never pass one pool set (pools sized to
    dominate the card's other tensors) and every captured program stays
    valid (replayed, not captured again) — and the ids are unchanged."""
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.resilience import TransientError

    _, card = _tiny_pair()
    reqs = [([5, 6, 7, 8, 9], 12, {}), ([11, 12, 13] * 4, 10, {})]
    want = _uninterrupted(card, reqs)
    eng = _engine_on(card, "cuda", num_pages=65536, replica="c-one-set")
    pools = [id(p) for p in eng._pools]
    pool_bytes = sum(p.numel() * p.element_size() for p in eng._pools)
    slack = 64 << 20
    assert pool_bytes > 8 * slack

    def boom():
        raise TransientError("crash at the step")

    try:
        with eng:
            eng.generate([3, 4], max_new_tokens=2, timeout=120)
            graphs = dict(eng._graphs)
            n0 = eng.program_traces()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            hs = _held(eng, reqs, arm=lambda: faults.inject(
                "serving.step_crash@c-one-set", fn=boom, at_trips={4}))
            got = [h.result(timeout=120) for h in hs]
            st = eng.stats()
    finally:
        faults.clear()
    assert st["engine_restarts"] == 1
    assert [id(p) for p in eng._pools] == pools
    assert torch.cuda.max_memory_allocated() <= base + slack
    # the graphs captured before the crash are the ones replayed after it;
    # the only mints are the requeued prompts' new prefill buckets
    assert all(eng._graphs[k] is g and g.captured for k, g in graphs.items())
    new = set(eng._graphs) - set(graphs)
    assert eng.program_traces() - n0 == len(new)
    assert all(k[0] == "serve_prefill" for k in new)
    assert got == want


def _greedy_inputs(eng, B, rows):
    """A table of distinct real pages per row and lengths ``rows``."""
    NP = eng.table_width
    table = np.full((B, NP), eng._scratch, np.int32)
    for b in range(B):
        table[b, :] = np.arange(b * NP, (b + 1) * NP)
    return table, np.asarray(rows, np.int32)


def _counters():
    return (fa.LAUNCHES, pa.LAUNCHES, pa.QUANT_LAUNCHES, pa.CHUNK_LAUNCHES,
            pa.QUANT_CHUNK_LAUNCHES)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_captured_programs_replay_bit_equal_to_eager(cuda, kv_dtype):
    """Tiny GPT, float32, speculative k=2: after a run, each captured
    program — the serve_step (K3 / K4), a prefill bucket (K1) and the
    verify step (K3 / K4 over the [B*(k+1)]-row expansion) — replayed on
    fresh inputs gives the greedy tokens of the eager adapter call on
    cloned pools, and leaves the pools bit-equal to that call's; each
    replay adds its kernels' launches to the counters."""
    _, card = _tiny_pair()
    eng = _engine_on(card, "cuda", num_slots=2, kv_dtype=kv_dtype,
                     speculative_k=2, replica=f"c-replay-{kv_dtype}")
    with eng:
        for p in ([5, 6, 7] * 6, [9, 10, 11, 12] * 3, [4] * 20):
            eng.generate(p, max_new_tokens=8, timeout=120)
    L = card.gpt.layers.__len__()
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    decode = 2 if kv_dtype else 1
    kinds = {}
    for key, prog in eng._graphs.items():
        assert prog.captured, key
        kinds.setdefault(key[0], key)
    assert {"serve_step", "serve_prefill", "verify"} <= set(kinds)
    rs = np.random.RandomState(7)
    temps = np.zeros((2,), np.float32)

    def run(key, host, eager):
        pools = [p.clone() for p in eng._pools]
        with torch.inference_mode():
            logits = eager(pools)
            c0 = _counters()
            prog = eng._graphs[key]
            prog.feed(*host)
            packed, _ = prog()
            torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eng._pools, pools))
        return packed.cpu(), logits.cpu(), \
            [a - b for a, b in zip(_counters(), c0)]

    # serve_step: one token per slot at lengths 21 and 9
    table, lens = _greedy_inputs(eng, 2, [21, 9])
    last = rs.randint(1, 96, (2, 1)).astype(np.int64)
    packed, logits, dc = run(
        kinds["serve_step"], (last, table, lens, temps),
        lambda pools: eng._adapter.step(t(last), *pools, t(table),
                                        t(lens))[0])
    assert torch.equal(packed[0], logits.argmax(-1))
    assert dc[decode] == L and dc[0] == 0

    # a prefill bucket: one prompt right-padded to the bucket
    s_pad = kinds["serve_prefill"][1]
    ids = np.zeros((1, s_pad), np.int64)
    ids[0, :s_pad - 3] = rs.randint(1, 96, (s_pad - 3,))
    t1, _ = _greedy_inputs(eng, 1, [0])
    l1 = np.asarray([s_pad - 3], np.int32)
    packed, logits, dc = run(
        kinds["serve_prefill"], (ids, t1, l1, temps[:1]),
        lambda pools: eng._adapter.prefill(t(ids), *pools, t(t1),
                                           t(l1))[0])
    assert torch.equal(packed[0], logits.argmax(-1))
    assert dc[0] == L and dc[decode] == 0

    # verify: the last token and 2 drafts per slot
    vids = rs.randint(1, 96, (2, 3)).astype(np.int64)
    dlen = np.asarray([2, 1], np.int32)
    packed, logits, dc = run(
        kinds["verify"], (vids, table, lens, dlen, temps),
        lambda pools: eng._adapter.verify(t(vids), *pools, t(table),
                                          t(lens))[0])
    greedy = logits.argmax(-1)
    assert torch.equal(packed[:, :3], greedy)
    real = torch.arange(2)[None, :] < torch.as_tensor(dlen)[:, None]
    assert torch.equal(packed[:, 3:5].bool(),
                       (torch.as_tensor(vids[:, 1:]) == greedy[:, :2]) & real)
    assert dc[decode] == L and dc[decode + 2] == L


def test_generate_replays_its_captured_step(cuda):
    """generate() on the card: each call captures its decode step once and
    replays it for the rest of its tokens (6 steps: 1 eager and captured,
    5 replays); a second call with the same key gives the first call's
    greedy ids and counts K1 / K3 as the first call did."""
    from paddle_tpu_torch.jit import graphs

    _, card = _tiny_pair()
    ids = np.random.RandomState(2).randint(1, 96, (2, 11))
    c0, r0 = _counters(), graphs.REPLAYS
    a = card.generate(ids, max_new_tokens=7, temperature=0.0,
                      cache_impl="paged", page_size=8)
    c1, r1 = _counters(), graphs.REPLAYS
    b = card.generate(ids, max_new_tokens=7, temperature=0.0,
                      cache_impl="paged", page_size=8)
    c2, r2 = _counters(), graphs.REPLAYS
    assert r1 - r0 == 5 and r2 - r1 == 5
    assert torch.equal(a, b)
    assert [x - y for x, y in zip(c1, c0)] == [x - y for x, y in zip(c2, c1)]
    assert c2[0] - c1[0] == 2 and c2[1] - c1[1] == 2 * 6


def test_generate_returns_the_card_memory_it_took(cuda):
    """generate() over several prompt lengths, dense and paged: after each
    call the allocated device memory is back at its baseline (the cache,
    the captured step and its pool go with the call)."""
    _, card = _tiny_pair()
    card.generate(np.ones((2, 4), np.int64), max_new_tokens=3,
                  temperature=0.0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for impl in ("dense", "paged"):
        for s0 in (5, 9, 17, 30):
            ids = np.random.RandomState(s0).randint(1, 96, (2, s0))
            card.generate(ids, max_new_tokens=6, temperature=0.7,
                          cache_impl=impl, page_size=8)
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() == base, (impl, s0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cost_count_copies_no_pool(cuda, kv_dtype):
    """The perf table's count of each captured program of a live engine
    reads its pools in place: the allocator's peak over a round of counts
    (after a first round, which sets up this thread's cuBLAS workspace)
    stays below the pools' bytes, which a copy of them would pass, and the
    pools are bit-equal across it."""
    _, card = _tiny_pair(dict(vocab_size=96, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=2,
                              max_position_embeddings=1024))
    eng = ServingEngine(card, device="cuda", page_size=8, max_model_len=1024,
                        num_slots=4, kv_dtype=kv_dtype,
                        replica=f"c-cost-{kv_dtype}")
    with eng:
        eng.generate([5, 6, 7] * 6, max_new_tokens=8, timeout=120)
        keys = list(eng._graphs)
        assert {k[0] for k in keys} >= {"serve_step", "serve_prefill"}
        costs = [eng._program_cost(k) for k in keys]
        pools = [p.clone() for p in eng._pools]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        assert [eng._program_cost(k) for k in keys] == costs
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        assert all(f > 0 for f, _ in costs)
        assert peak < sum(p.numel() * p.element_size() for p in pools)
        assert all(torch.equal(a, b) for a, b in zip(pools, eng._pools))


def test_nan_lane_on_card_fails_only_that_request(cuda):
    from paddle_tpu_torch.observability import faults, numerics
    from paddle_tpu_torch.resilience import NumericFault

    _, card = _tiny_pair()
    eng = _engine_on(card, "cuda", numeric_guard=True, replica="c-nan")
    try:
        with eng:
            eng.generate([3, 4], max_new_tokens=2, timeout=120)
            numerics.set_nan_inject_row(0)
            h0 = eng.submit([9, 10, 11], max_new_tokens=30)
            h1 = eng.submit([12, 13, 14], max_new_tokens=30)
            it0, it1 = h0.stream(), h1.stream()
            next(it0)
            next(it1)
            faults.inject("numerics.nan_inject", times=1)
            with pytest.raises(NumericFault):
                h0.result(timeout=120)
            other = h1.result(timeout=120)
    finally:
        faults.clear()
    assert h0.status == "error" and h1.status == "completed"
    assert other == _uninterrupted(card, [([12, 13, 14], 30, {})])[0]


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8"},
                                {"prefill_chunk_tokens": 8},
                                {"speculative_k": 3}],
                         ids=["plain", "int8", "chunked", "spec"])
def test_preemption_on_card_keeps_ids(cuda, kw):
    _, card = _tiny_pair()
    n = 20 if "prefill_chunk_tokens" in kw else 6
    rs = np.random.RandomState(6)
    bp1, bp2 = rs.randint(1, 96, n).tolist(), rs.randint(1, 96, n).tolist()
    rp = [7, 8, 9, 10]
    with _engine_on(card, "cuda", qos=True, **kw) as eng:
        b1 = eng.submit(bp1, max_new_tokens=30, tier="batch")
        b2 = eng.submit(bp2, max_new_tokens=30, tier="batch")
        while sum(s is not None for s in eng._slots) < 2:
            time.sleep(0.002)
        rt = eng.submit(rp, max_new_tokens=8, tier="realtime")
        got = [rt.result(timeout=120), b1.result(timeout=120),
               b2.result(timeout=120)]
    assert b1.preemptions + b2.preemptions == 1 and rt.preemptions == 0
    assert got == _uninterrupted(card, [(rp, 8, {}), (bp1, 30, {}),
                                        (bp2, 30, {})], **kw)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefix_cache_arms_on_card(cuda, kv_dtype):
    """lru, radix and radix_spill over shared-prefix traffic in an
    undersized pool: float32 ids equal across the arms and (native pools)
    equal the CPU engine's (int8: first tokens equal, agreement >= 0.8);
    every cached prefill runs the chunk attend once per layer (K3, or K4
    over int8 pools); the spill tier spills and resurrects."""
    cpu, card = _tiny_pair()
    rs = np.random.RandomState(2)
    heads = [rs.randint(1, 96, 24).tolist() for _ in range(2)]
    prompts = []
    for i in range(10):
        if i % 4 == 3:
            prompts.append(rs.randint(1, 96, 40).tolist())   # one-off
        else:
            prompts.append(heads[i % 2] + rs.randint(1, 96, 5).tolist())
    arms = {"lru": {"prefix_cache": "lru"},
            "radix": {"prefix_cache": "radix"},
            "radix_spill": {"prefix_cache": "radix", "kv_spill": True}}

    def serve(model, device, kw):
        with _engine_on(model, device, num_slots=1, num_pages=9,
                        kv_dtype=kv_dtype, **kw) as eng:
            outs = [eng.generate(p, max_new_tokens=6, timeout=120)
                    for p in prompts]
            return outs, eng.stats()

    want, _ = serve(cpu, "cpu", arms["lru"])
    got = {}
    for arm, kw in arms.items():
        c0 = pa.QUANT_CHUNK_LAUNCHES if kv_dtype else pa.CHUNK_LAUNCHES
        outs, st = serve(card, "cuda", kw)
        c1 = pa.QUANT_CHUNK_LAUNCHES if kv_dtype else pa.CHUNK_LAUNCHES
        assert c1 - c0 == 2 * st["cached_prefills"], arm
        assert (st["cached_prefills"] > 0) == (arm != "lru"), arm
        got[arm] = outs
        if arm == "radix_spill":
            pc = st["prefix_cache"]
            assert pc["spill"]["spills"] > 0 and pc["resurrections"] > 0
    assert got["lru"] == got["radix"] == got["radix_spill"]
    if kv_dtype:
        assert [g[0] for g in got["lru"]] == [w[0] for w in want]
        assert _top1(want, got["lru"]) >= 0.8
    else:
        assert got["lru"] == want


def test_guard_adds_no_host_sync_to_the_step(cuda):
    """One plain decode step of two slots, run from this thread while the
    scheduler sits in a wedge (after one uncounted step: a thread's first
    CUDA work syncs once more), under torch.cuda.set_sync_debug_mode: the
    numeric guard's flags come back in the tokens' transfer, so the step
    syncs as often with the guard as without it."""
    import warnings

    from paddle_tpu_torch.observability import faults

    _, card = _tiny_pair()
    syncs = {}
    for guard in (False, True):
        eng = _engine_on(card, "cuda", numeric_guard=guard,
                         replica=f"c-sync-{guard}")
        try:
            with eng:
                eng.generate([3, 4], max_new_tokens=2, timeout=120)
                site = f"serving.scheduler_wedge@{eng.replica}"
                faults.inject(site, seconds=60.0, times=1)
                while faults.trip_count(site) < 1:
                    time.sleep(0.005)
                hs = [eng.submit(p, max_new_tokens=4)
                      for p in ([5, 6, 7], [8, 9, 10, 11])]
                with torch.inference_mode():
                    eng._admit()
                    active = [i for i, s in enumerate(eng._slots)
                              if s is not None]
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
                    assert len(h.result(timeout=120)) == 4
        finally:
            faults.clear()
        assert active == [0, 1]
        syncs[guard] = sum("called a synchronizing CUDA operation"
                           in str(w.message) for w in rec)
    assert syncs[True] == syncs[False] >= 1


# --------------------------------------------------------- observability
def _step_sync_count(card, guard, replica):
    """Host syncs of one plain decode step of two slots (the recipe of
    test_guard_adds_no_host_sync_to_the_step)."""
    import warnings

    from paddle_tpu_torch.observability import faults

    eng = _engine_on(card, "cuda", numeric_guard=guard, replica=replica,
                     telemetry_port=0)
    try:
        with eng:
            eng.generate([3, 4], max_new_tokens=2, timeout=120)
            site = f"serving.scheduler_wedge@{eng.replica}"
            faults.inject(site, seconds=60.0, times=1)
            while faults.trip_count(site) < 1:
                time.sleep(0.005)
            hs = [eng.submit(p, max_new_tokens=4)
                  for p in ([5, 6, 7], [8, 9, 10, 11])]
            with torch.inference_mode():
                eng._admit()
                active = [i for i, s in enumerate(eng._slots)
                          if s is not None]
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
                assert len(h.result(timeout=120)) == 4
    finally:
        faults.clear()
    assert active == [0, 1]
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in rec)


@pytest.mark.parametrize("guard", [False, True])
def test_sinks_add_no_host_sync_to_the_step(cuda, guard, tmp_path):
    """With a span tracer, the flight recorder and telemetry on (and the
    guard's numerics stream), a decode step syncs as often as with every
    sink off: once, the packed tokens' transfer (the host rows go through
    pinned staging buffers, non_blocking, into the graph's inputs)."""
    from paddle_tpu_torch.observability import flight_recorder, tracing

    _, card = _tiny_pair()
    off = _step_sync_count(card, guard, f"c-obs-sync-off-{guard}")
    tr = tracing.Tracer().start()
    flight_recorder.enable(dir=str(tmp_path))
    try:
        on = _step_sync_count(card, guard, f"c-obs-sync-on-{guard}")
    finally:
        tr.stop()
        flight_recorder.disable()
    assert on == off == 1
    assert tr.find("serving.decode_step")


def test_observed_engine_on_card_matches_cpu(cuda, tmp_path):
    """Tiny random GPT, float32, every sink on: the card's greedy ids equal
    the CPU engine's; /metrics, /healthz and /statusz answer while the
    requests run; K1 once per layer per prefill, K3 per layer per step."""
    import json
    import urllib.request

    from paddle_tpu_torch.observability import flight_recorder, tracing

    cpu, card = _tiny_pair()
    prompts = [[5, 6, 7, 8] * 3, [9, 10] * 10, [11, 12, 13] * 8, [14] * 5]
    with _engine_on(cpu, "cpu", num_slots=3) as eng:
        want = [eng.generate(p, max_new_tokens=12, timeout=120)
                for p in prompts]
    tr = tracing.Tracer().start()
    flight_recorder.enable(dir=str(tmp_path))
    k1, k3 = fa.LAUNCHES, pa.LAUNCHES
    try:
        with _engine_on(card, "cuda", num_slots=3, telemetry_port=0,
                        numeric_guard=True, replica="c-obs-on") as eng:
            hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            url = eng.telemetry.url
            codes = {}
            for path in ("/metrics", "/healthz", "/statusz"):
                with urllib.request.urlopen(url + path, timeout=30) as r:
                    codes[path] = (r.status, r.read())
            got = [h.result(timeout=120) for h in hs]
            st = eng.stats()
    finally:
        tr.stop()
        flight_recorder.disable()
    assert got == want
    assert all(c == 200 for c, _ in codes.values())
    assert b"serving_ttft_seconds" in codes["/metrics"][1]
    assert "serving/c-obs-on" in json.loads(codes["/statusz"][1])
    assert fa.LAUNCHES - k1 == 2 * st["prefills"]
    assert pa.LAUNCHES - k3 == 2 * st["iteration"]
    assert tr.find("serving.prefill") and tr.find("serving.decode_step")


def test_ledger_reconciles_with_the_allocator_on_card(cuda):
    """The engine's pools in the ledger are the pools' bytes; the
    remainder against torch.cuda.memory_allocated is >= 0; an oversized
    allocation is an OOM the ledger recognizes and dumps."""
    import json

    from paddle_tpu_torch.observability import memory

    _, card = _tiny_pair()
    eng = _engine_on(card, "cuda", replica="c-obs-mem")
    rows = memory.ledger().owner_rows(replica="c-obs-mem")
    pools = sum(p.numel() * p.element_size() for p in eng._pools)
    assert sum(r["bytes"] for r in rows if r["owner"] == "kv.pages") == pools
    assert all(r["device"].startswith("cuda") for r in rows if r["arrays"])
    rep = memory.ledger().report()
    assert rep["untracked_bytes"] is not None and rep["untracked_bytes"] >= 0
    assert rep["live_bytes"] == torch.cuda.memory_allocated()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(1 << 46, dtype=torch.uint8, device="cuda")
    assert memory.is_oom_error(ei.value)
    doc = json.load(open(memory.oom_dump(ei.value, replica="c-obs-mem")))
    assert doc["reason"] == "oom"
    assert any(r["owner"] == "kv.pages"
               for r in doc["extra"]["memory"]["owners"])
    torch.ones(4, device="cuda").sum().item()      # the card still works


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_row_on_card_equals_cpu(cuda, dtype):
    """The numerics probe on the card: the CPU's row within 1e-6
    relative (NaN, inf, zeros, subnormals), and no host sync."""
    import warnings

    from paddle_tpu_torch.observability import numerics

    x = torch.randn(8, 5003, generator=torch.Generator().manual_seed(3))
    x[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    x[1, :100] = 0.0
    x[2, :4] = torch.tensor([1e-39, -1e-40, 3e-5, 2e38])
    x = x.to(dtype)
    want = numerics.stats_row(x)
    xc = x.cuda()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = numerics.stats_row(xc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in rec if "synchronizing" in str(w.message)]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def test_hbm_budget_on_card_keeps_admitted_ids(cuda, monkeypatch):
    """PADDLE_HBM_BUDGET_BYTES at the weights plus 6 pages: of four
    requests held at a wedge, the ones that fit run with the ids of an
    unbudgeted card engine; the others shed ``hbm_budget``."""
    from paddle_tpu_torch.serving import RequestRejectedError

    _, card = _tiny_pair()
    reqs = [([5, 6, 7, 8] * 3, 20, {}), ([9, 10] * 10, 20, {}),
            ([11, 12, 13], 4, {}), ([14] * 20, 30, {})]
    want = _uninterrupted(card, reqs)
    eng = _engine_on(card, "cuda", replica="c-obs-hbm")
    monkeypatch.setenv("PADDLE_HBM_BUDGET_BYTES",
                       str(eng._fixed_bytes + 6 * eng._bytes_per_page))
    out = []
    with eng:
        from paddle_tpu_torch.observability import faults

        site = f"serving.scheduler_wedge@{eng.replica}"
        faults.inject(site, seconds=60.0, times=1)
        while faults.trip_count(site) < 1:
            time.sleep(0.005)
        for p, n, _ in reqs:
            try:
                out.append(eng.submit(p, max_new_tokens=n))
            except RequestRejectedError as e:
                out.append(e.reason)
        faults.clear(site)
        got = [o if isinstance(o, str) else o.result(timeout=120)
               for o in out]
    assert got.count("hbm_budget") == 2
    assert [g for g in got if not isinstance(g, str)] \
        == [w for w, g in zip(want, got) if not isinstance(g, str)]
    assert eng._committed_pages == 0


# ------------------------------------------------------------------- Llama
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,hkv,d", [(32, 8, 128), (32, 32, 128), (8, 1, 64)])
def test_paged_kernel_f32_q_over_16bit_pools(cuda, pool_dtype, h, hkv, d):
    """K3's f32-query entry (a bf16 Llama's decode): an f32 q over bf16 /
    f16 pools, f32 out, against the plain version within the f32 tolerance
    (the pages widen exactly), at the slot-boundary lengths; a second
    launch bit-equal to the first."""
    ps, NP = 16, 12
    lens = [0, 1, ps - 1, ps, ps + 1, NP * ps, 5 * ps + 3, NP * ps + 9]
    B = len(lens)
    table = torch.randperm(B * NP, generator=cuda, device="cuda")
    table = table.to(torch.int32).reshape(B, NP)
    kp, vp = (torch.randn(B * NP, ps, hkv, d, generator=cuda, device="cuda")
              .to(pool_dtype) for _ in range(2))
    q = torch.randn(B, h, d, generator=cuda, device="cuda")
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n0 = pa.LAUNCHES
    o = pa.paged_attention(q, kp, vp, table, ln)
    again = pa.paged_attention(q, kp, vp, table, ln)
    assert pa.LAUNCHES == n0 + 2 and o.dtype == torch.float32
    ref = pa.paged_attention_ref(q, kp, vp, table, ln)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, ref, atol=ATOL[torch.float32], rtol=0)
    assert torch.equal(again, o)
    assert bool((o[0] == 0).all())


def test_paged_kernel_takes_only_its_dtype_pairings(cuda):
    """Pools in q's dtype, or bf16 / f16 under an f32 q: every other
    pairing raises before a launch."""
    table = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    ln = torch.ones(1, dtype=torch.int32, device="cuda")

    def pools(dt, dt_v=None):
        return (torch.zeros(1, 16, 2, 64, dtype=dt, device="cuda"),
                torch.zeros(1, 16, 2, 64, dtype=dt_v or dt, device="cuda"))

    for q_dt, k_dt, v_dt in ((torch.bfloat16, torch.float32, None),
                             (torch.float16, torch.bfloat16, None),
                             (torch.bfloat16, torch.float16, None),
                             (torch.float32, torch.bfloat16, torch.float16),
                             (torch.float32, torch.int8, None)):
        q = torch.zeros(1, 4, 64, dtype=q_dt, device="cuda")
        with pytest.raises(TypeError):
            pa.paged_attention(q, *pools(k_dt, v_dt), table, ln)


def test_flash_kernel_f32_at_llama_width(cuda):
    """K1's f32 body at a Llama head (H=32, D=128, S=512), causal: what a
    bf16-weight Llama's prefill runs (its rotated q / k are f32)."""
    q, k, v = (torch.randn(1, 512, 32, 128, generator=cuda, device="cuda")
               for _ in range(3))
    o, lse = fa.flash_attention_fn(q, k, v, causal=True, return_lse=True)
    o2, lse2 = fa.flash_attention_fn(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    torch.testing.assert_close(o, fa.flash_attention_ref(q, k, v, causal=True),
                               atol=ATOL[torch.float32], rtol=0)


def _tiny_llama_pair(dtype=None):
    from paddle_tpu_torch.text.models import LlamaForCausalLM

    cfg = dict(vocab_size=160, hidden_size=256, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1,
               intermediate_size=256, max_position_embeddings=128)
    cpu = LlamaForCausalLM(device="cpu", generator=torch.Generator()
                           .manual_seed(0), **cfg)
    card = copy.deepcopy(cpu).to("cuda")
    if dtype is not None:
        cpu, card = cpu.to(dtype), card.to(dtype)
    return cpu, card


def test_llama_generate_on_card_matches_cpu(cuda):
    """A small GQA Llama (head_dim 128, 2 heads over 1 kv head), float32:
    greedy ids on the card equal the CPU's for the dense and paged caches
    and beam search; the paged prefill runs K1 once per layer, each decode
    step K3 once per layer."""
    cpu, card = _tiny_llama_pair()
    ids = torch.from_numpy(np.random.RandomState(1).randint(1, 160, (3, 21)))
    for kw in (dict(cache_impl="dense"), dict(cache_impl="paged", page_size=8),
               dict(decode_strategy="beam_search", num_beams=3)):
        n = 12
        k1, via = fa.LAUNCHES, pa.DECODE_ATTEND_LAUNCHES
        got = card.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        if kw.get("cache_impl") == "paged":
            assert fa.LAUNCHES - k1 == 2
            assert pa.DECODE_ATTEND_LAUNCHES - via == 2 * (n - 1)
        want = cpu.generate(ids, max_new_tokens=n, temperature=0.0, **kw)
        assert torch.equal(got.cpu(), want), kw


def test_llama_bf16_weights_decode_through_the_f32_query_entry(cuda):
    """The same Llama with bf16 weights: its activations are f32 (jnp's
    promotion), so the paged prefill runs K1's f32 body and each decode
    step K3's f32-query entry over the bf16 pools; the logits are f32 and
    each row's first new token equals the CPU's (later tokens may part
    where a last-bit difference rounds a cached key to another bf16)."""
    cpu, card = _tiny_llama_pair(torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(1).randint(1, 160, (3, 21)))
    with torch.no_grad():
        assert card(ids.to("cuda")).dtype == torch.float32
    k1, via = fa.LAUNCHES, pa.DECODE_ATTEND_LAUNCHES
    got = card.generate(ids, max_new_tokens=8, temperature=0.0,
                        cache_impl="paged", page_size=8)
    assert (fa.LAUNCHES - k1, pa.DECODE_ATTEND_LAUNCHES - via) == (2, 2 * 7)
    want = cpu.generate(ids, max_new_tokens=8, temperature=0.0,
                        cache_impl="paged", page_size=8)
    assert torch.equal(got.cpu()[:, 21], want[:, 21])


def test_llama_o2_trainstep_runs_the_flash_kernels(cuda):
    """One AMP O2 TrainStep of the small GQA Llama: K1, K2a and K2b once
    per layer (bf16 over the repeated kv heads), a finite f32 loss."""
    _, card = _tiny_llama_pair()
    o = optimizer.AdamW(learning_rate=1e-3, parameters=card.parameters(),
                        grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    step = jit.TrainStep(card, o, loss_fn=None, amp_level="O2")
    x = torch.from_numpy(np.random.RandomState(2).randint(0, 160, (2, 64)))
    x = x.to("cuda")
    n = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    loss = step({"input_ids": x, "labels": x})
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert (fa.LAUNCHES - n[0], fa.BWD_DKDV_LAUNCHES - n[1],
            fa.BWD_DQ_LAUNCHES - n[2]) == (2, 2, 2)


# ------------------------------------------- numerics and multi-tenant serving
def _mt_on(model, store, **kw):
    from paddle_tpu_torch.serving.multitenant import MultiTenantEngine

    kw.setdefault("num_slots", 2)
    return MultiTenantEngine(model, lora_store=store, device="cuda",
                             page_size=8, max_model_len=64, **kw)


def _tiny_store(model, n=3):
    from paddle_tpu_torch.serving.multitenant import LoRAAdapter, LoRAStore

    store = LoRAStore(model, capacity=4, ranks=(4, 8),
                      targets=("qkv", "out_proj"))
    for i in range(n):
        store.register(LoRAAdapter.random(model, f"t{i}", rank=4 + 2 * i,
                                          seed=20 + i, scale=0.3))
    return store


def _digit_grammar():
    from paddle_tpu_torch.serving.multitenant import compile_regex

    vocab = ["<pad>"] + list("0123456789") + [f"<u{i}>" for i in range(84)] \
        + ["<eos>"]
    return compile_regex("[0-9]{1,4}", vocab, 95)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_mt_captured_programs_replay_bit_equal_to_eager(cuda, kv_dtype):
    """Tiny GPT, float32, multi-LoRA over two rank buckets, speculative
    k=2: each captured ``mt_*`` program — the step (K3 / K4), a prefill
    bucket (K1) and the verify step — replayed on fresh inputs gives the
    greedy tokens of the eager adapter call on cloned pools, with the
    adapter gather and the masks fed through the static buffers."""
    _, card = _tiny_pair()
    store = _tiny_store(card)
    eng = _mt_on(card, store, kv_dtype=kv_dtype, speculative_k=2,
                 replica=f"c-mt-replay-{kv_dtype}")
    with eng:
        for p, a in (([5, 6, 7] * 6, "t0"), ([9, 10, 11, 12] * 3, "t2"),
                     ([4] * 20, None)):
            eng.generate(p, max_new_tokens=8, adapter=a, timeout=120)
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    kinds = {}
    for key, prog in eng._graphs.items():
        assert prog.captured, key
        kinds.setdefault(key[0], key)
    assert {"mt_step", "mt_prefill", "mt_verify"} <= set(kinds)
    rs = np.random.RandomState(7)
    temps = np.zeros((2,), np.float32)
    lw = store.device_args()
    lease = store.acquire("t2")
    aid = np.zeros((2, 2), np.int32)
    aid[lease.bucket, 0] = lease.row             # lane 0: t2, lane 1: base

    def run(key, host, eager):
        pools = [p.clone() for p in eng._pools]
        with torch.inference_mode():
            logits = eager(pools)
            prog = eng._graphs[key]
            prog.feed(*host)
            packed, _ = prog()
            torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eng._pools, pools))
        return packed.cpu(), logits.cpu()

    table, lens = _greedy_inputs(eng, 2, [21, 9])
    last = rs.randint(1, 96, (2, 1)).astype(np.int64)
    allowed = np.ones((2, 96), np.bool_)
    packed, logits = run(
        kinds["mt_step"], (last, table, lens, temps, allowed, aid),
        lambda pools: eng._adapter.step(t(last), *pools, t(table), t(lens),
                                        t(aid), *lw)[0])
    assert torch.equal(packed[0], logits.argmax(-1))
    s_pad = kinds["mt_prefill"][1]
    ids = np.zeros((1, s_pad), np.int64)
    ids[0, :s_pad - 3] = rs.randint(1, 96, (s_pad - 3,))
    t1, _ = _greedy_inputs(eng, 1, [0])
    l1 = np.asarray([s_pad - 3], np.int32)
    a1 = aid[:, :1].copy()
    packed, logits = run(
        kinds["mt_prefill"], (ids, t1, l1, temps[:1], allowed[:1], a1),
        lambda pools: eng._adapter.prefill(t(ids), *pools, t(t1), t(l1),
                                           t(a1), *lw)[0])
    assert torch.equal(packed[0], logits.argmax(-1))
    vids = rs.randint(1, 96, (2, 3)).astype(np.int64)
    dlen = np.asarray([2, 1], np.int32)
    allowed3 = np.ones((2, 3, 96), np.bool_)
    packed, logits = run(
        kinds["mt_verify"], (vids, table, lens, dlen, temps, allowed3, aid),
        lambda pools: eng._adapter.verify(t(vids), *pools, t(table),
                                          t(lens), t(aid), *lw)[0])
    assert torch.equal(packed[:, :3], logits.argmax(-1))
    store.release(lease)


def test_mt_hot_swap_in_place_no_recapture(cuda):
    """Registering and serving a new adapter on a warm engine writes the
    pool rows in place (every pool's data_ptr unchanged), mints nothing
    and recaptures nothing; its ids equal a dedicated engine's."""
    from paddle_tpu_torch.serving.multitenant import LoRAAdapter

    _, card = _tiny_pair()
    store = _tiny_store(card)
    p = [7, 8, 9, 10, 11, 12]
    with _mt_on(card, store, replica="c-mt-hot") as eng:
        eng.generate(p, max_new_tokens=6, adapter="t0", timeout=120)
        ptrs = [x.data_ptr() for x in store.device_args()]
        graphs = {k: id(g.graph) for k, g in eng._graphs.items()}
        mints = eng.program_traces()
        eng.register_adapter(LoRAAdapter.random(card, "hot", rank=8,
                                                seed=99, scale=0.3))
        got = eng.generate(p, max_new_tokens=6, adapter="hot", timeout=120)
        assert [x.data_ptr() for x in store.device_args()] == ptrs
        assert {k: id(g.graph) for k, g in eng._graphs.items()} == graphs
        assert eng.program_traces() == mints
    with _mt_on(card, store, replica="c-mt-hot-2") as eng2:
        assert eng2.generate(p, max_new_tokens=6, adapter="hot",
                             timeout=120) == got


def test_mt_mask_buffers_reset_on_retire(cuda):
    """A constrained row feeds the step's mask buffer; once it retires
    the buffer holds all-True rows again, and later steps copy no mask."""
    from paddle_tpu_torch.jit.graphs import KEEP

    _, card = _tiny_pair()
    g = _digit_grammar()
    with _mt_on(card, None, replica="c-mt-mask") as eng:
        eng.generate([5, 6, 7], max_new_tokens=3, timeout=120)
        out = eng.generate([8, 9, 10], max_new_tokens=6, grammar=g,
                           timeout=120)
        eng.generate([5, 6, 7], max_new_tokens=3, timeout=120)
        key = eng._step_store_key()
        buf = eng._graphs[key].inputs[4]
        assert buf.dtype == torch.bool and bool(buf.all())
        assert eng._mask_arg(key, eng._h_allowed) is KEEP
    assert g.matches(out)


def test_probed_trainstep_equals_unprobed_on_card(cuda):
    """Tiny GPT f32 on the card: 3 probed TrainSteps give the unprobed
    steps' losses bit for bit (K1 / K2 per layer per step either way), and
    the probe rows hold no non-finite value."""
    from paddle_tpu_torch.observability import numerics

    cpu, _ = _tiny_pair()
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        1, 96, (2, 32))).to("cuda")
    out = {}
    try:
        for probed in (False, True):
            numerics.reset()
            if probed:
                numerics.enable_tensor_checker(level="warn")
            model = copy.deepcopy(cpu).to("cuda")
            step = jit.TrainStep(model, optimizer.AdamW(
                learning_rate=1e-3, parameters=model.parameters()))
            k1 = fa.LAUNCHES
            out[probed] = torch.stack(
                [step({"input_ids": ids, "labels": ids}) for _ in range(3)])
            assert fa.LAUNCHES - k1 == 2 * 3
            if probed:
                numerics.poll()
                ent = numerics.latest(step._perf_tag)
                assert ent["sites"][0] == "gpt.word_embeddings"
                assert not ent["table"][:, 0].any()
    finally:
        numerics.reset()
    assert torch.equal(out[True], out[False])


def test_mt_memory_returns_to_baseline_after_evict(cuda):
    """Register, serve, release and evict adapters repeatedly: the
    allocated card memory comes back to the baseline each time (page-ins
    write the fixed pools; the host copies never reach the card)."""
    from paddle_tpu_torch.serving.multitenant import LoRAAdapter

    _, card = _tiny_pair()
    store = _tiny_store(card, n=1)
    with _mt_on(card, store, replica="c-mt-mem") as eng:
        eng.generate([5, 6, 7, 8], max_new_tokens=4, adapter="t0",
                     timeout=120)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for i in range(4):
            name = f"cyc{i}"
            eng.register_adapter(LoRAAdapter.random(card, name, rank=8,
                                                    seed=40 + i, scale=0.3))
            eng.generate([5, 6, 7, 8], max_new_tokens=4, adapter=name,
                         timeout=120)
            store.evict(name)
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() == base, i
