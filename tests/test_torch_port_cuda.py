"""PyTorch port on the card: each hand-written CUDA kernel held against its
plain PyTorch version on CUDA tensors (K1 over both of its bodies, the
split-K decode also bit for bit against a second launch, and the
full-sweep K5a / K5b bit for bit against K3 / K4; K2 to head_dim 256; each
dtype's flash body by the per-body counters; paddle's public
``F.flash_attention`` through K1 / K2 with gradients), attention with dropout
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
``evict``, and a probed TrainStep against the unprobed one; a cluster
capturing a new replica's graphs while the others replay, with a
replica stopped mid-decode (f32 ids equal the CPU's, memory back at its
baseline) and one reaped after ``cluster.replica_preempt``; recompute's
bit-equal gradients with K1 launched twice; the eleven optimizers on the
card against the CPU; BERT-tiny through ``hapi.Model.fit`` against the
CPU, an unmasked ``TransformerEncoder``'s K1 / K2 launches under
``Model.fit``, a ``.pdparams`` written on the card loaded on the CPU,
``Embedding``'s padding rule on the card; ResNet-18 on the card against
the CPU and a ViT's K1 / K2 launches per block under an O2 step;
a world of one over NCCL and the mp = 2 layers in two gloo rank
processes on the one card; a stage hop of card tensors and GPT-tiny's
pp = 2 pipe in two gloo rank processes against one process; the serving
mesh (a leader and a follower process on the one card) against the
mp = 1 engine.  Marked ``cuda``; every test
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
#: K1's f32 body on the tensor cores (3xTF32, every head_dim) against its
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
    # head_dim 17 / 32 / 40 / 96 (zero-padded to 64 or 128) and 192 / 256
    # (padded to 256: the 16-bit body's 64-key tiles, Q read by ldmatrix
    # in the key loop; the f32 body's 8 warps splitting head_dim, 32-key
    # tiles)
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
    the reach of its two bodies (the f32 one, 3xTF32, also within
    F32_TC_ATOL); a second launch is bit-equal to the first."""
    q, k, v = _fwd_inputs(cuda, dtype, b, h, sq, sk, d, layout)
    n0 = fa.LAUNCHES
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    o2, lse2 = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    assert fa.LAUNCHES == n0 + 2
    assert o.dtype == dtype and o.shape == q.shape and o.is_contiguous()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
    if dtype == torch.float32:                      # the 3xTF32 body
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
    (torch.float32, 64, "3xtf32", "3xtf32"),
    (torch.float32, 128, "3xtf32", "3xtf32"),
    (torch.bfloat16, 192, "tc16", "tc16"), (torch.float16, 256, "tc16", "tc16"),
    (torch.float32, 256, "3xtf32", "3xtf32")])
def test_flash_calls_reach_their_dtypes_bodies(cuda, dtype, d, fwd_body,
                                               bwd_body):
    """The C entries' body rule, by the per-body launch counters: bf16 /
    f16 stay on the 16-bit tensor cores forward and backward, f32 takes
    3xTF32 forward and backward, at every head_dim (192 and 256 too); one
    forward and one K2a + K2b per call."""
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
    fragments, at the f32 tolerance; at DP = 128 (head_dim 96) and DP =
    256 (head_dim 256: 8 warps splitting head_dim, 32-key tiles)."""
    b, h, s = 2, 4, 200
    for d in (96, 256):
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
                 (1, 4, 512, 512, 128, False), (2, 3, 200, 256, 40, True),
                 (2, 2, 300, 300, 256, True))]

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
#: K2's f32 body (3xTF32, every head_dim) against its plain version, max
#: error over max |ref|, beside BWD_TOL: a body that dropped the split's
#: cross terms fails it, see
#: test_flash_bwd_f32_one_pass_tf32_fails_the_tight_check
K2_F32_TC_TOL = 5e-5


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
    # head_dim 129-256: the tensor cores in every dtype (head_dim padded
    # to 256, K2a's 8 warps splitting it in two), causal and not, ragged
    # lengths, sq < sk, widths 130 / 200 / 255, a misaligned base, the
    # strided qkv split, S = 1024
    (2, 2, 160, 160, 192, True, False, "contiguous"),
    (2, 2, 129, 200, 192, False, True, "contiguous"),
    (2, 2, 160, 160, 256, False, False, "contiguous"),
    (1, 3, 77, 300, 256, True, True, "contiguous"),
    (1, 2, 100, 100, 256, True, False, "unaligned"),
    (1, 2, 70, 70, 130, False, True, "contiguous"),
    (1, 3, 200, 200, 200, True, False, "contiguous"),
    (1, 2, 150, 150, 255, True, True, "contiguous"),
    (1, 2, 300, 300, 192, True, False, "qkv"),
    (2, 2, 1024, 1024, 256, True, False, "contiguous")])
def test_flash_bwd_kernels_match_plain(cuda, dtype, b, h, sq, sk, d, causal,
                                       g_lse, layout):
    """K2a (dk, dv) and K2b (dq) against flash_attention_bwd_ref on the
    same inputs and the kernel forward's lse; error over max |ref| within
    BWD_TOL, and for f32 (3xTF32) within K2_F32_TC_TOL."""
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
        if dtype == torch.float32:
            assert _rel_err(a, b) <= K2_F32_TC_TOL


def test_flash_bwd_f32_keys_are_not_symmetric(cuda):
    """K2's 3xTF32 body takes the queries (K2a) and keys (K2b) of each
    8-wide step of its second products in a permuted order (2t, 2t + 1 per
    lane): G and K that rise with the row index, and a q.k that favours
    late keys, would show any mismatch between the score fragments and
    the rows they meet, at K2_F32_TC_TOL; head_dim 96 and 256."""
    for d in (96, 256):
        b, h, s = 2, 3, 200
        ramp = torch.linspace(0, 1, s, device="cuda")[None, :, None, None]
        q = torch.randn(b, s, h, d, generator=cuda, device="cuda")
        k = torch.randn(b, s, h, d, generator=cuda, device="cuda") + ramp
        v = torch.randn(b, s, h, d, generator=cuda, device="cuda")
        g = torch.arange(s * d, dtype=torch.float32, device="cuda").reshape(
            1, s, 1, d).expand(b, s, h, d).contiguous() / (s * d)
        for causal in (True, False):
            o, lse = fa.flash_attention_fn(q, k, v, causal=causal,
                                           return_lse=True)
            r = (g * o).sum(-1).transpose(1, 2).reshape(-1, s).contiguous()
            got = fa._bwd_kernels(q, k, v, g, lse, r, d ** -0.5, causal)
            want = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, d ** -0.5,
                                              causal)
            for a, w in zip(got, want):
                assert _rel_err(a, w) <= K2_F32_TC_TOL


def test_flash_bwd_f32_one_pass_tf32_fails_the_tight_check(cuda, tmp_path,
                                                           monkeypatch):
    """The control for K2_F32_TC_TOL: K2 built from a copy of the sources
    whose TF32 product lacks the 3xTF32 split's two cross terms errs past
    K2_F32_TC_TOL on f32 cases (head_dim 40 to 256) where the committed
    body stays within it.  The copy is built into this test's own
    directory and unloaded after."""
    from paddle_tpu_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    cross = ("  mma1688_tf32(c, a.small, p0.big, p1.big);\n"
             "  mma1688_tf32(c, a.big, p0.small, p1.small);\n")
    text = (src / "mma.cuh").read_text()
    assert text.count(cross) == 1
    (src / "mma.cuh").write_text(text.replace(cross, ""))
    cases = [_bwd_inputs(cuda, torch.float32, b, h, sq, sk, d, causal, g_lse,
                         "contiguous") + (d, causal)
             for b, h, sq, sk, d, causal, g_lse in (
                 (2, 3, 300, 300, 64, True, False),
                 (2, 3, 256, 256, 128, True, False),
                 (1, 4, 512, 512, 128, False, True),
                 (2, 3, 200, 256, 40, True, True),
                 (1, 2, 300, 300, 256, True, True))]

    def errs():
        return [max(_rel_err(a, w) for a, w in zip(
                    fa._bwd_kernels(q, k, v, g, lse, r, d ** -0.5, c),
                    fa.flash_attention_bwd_ref(q, k, v, g, lse, r, d ** -0.5,
                                               c)))
                for q, k, v, g, lse, r, d, c in cases]

    three = errs()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_SECONDS", _build.BUILD_SECONDS)
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(_build._libs, "flash_attention_bwd", raising=False)
    one = errs()
    print(f"K2 f32 max err / max |ref| per case: 3xTF32 {three}; one-pass "
          f"TF32 {one} (BWD_TOL {BWD_TOL[torch.float32]}, K2_F32_TC_TOL "
          f"{K2_F32_TC_TOL})")
    assert max(three) <= K2_F32_TC_TOL < min(one)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype, layout, d):
    """Two launches of K2a + K2b on the same inputs give bit-equal dq, dk
    and dv: no atomics, every sum in a fixed order (at head_dim 256 too,
    where K2a's two warps of a group exchange partial scores)."""
    args = _bwd_inputs(cuda, dtype, 2, 4, 700, 700, d, True, True, layout)
    first = fa._bwd_kernels(*args, d ** -0.5, True)
    second = fa._bwd_kernels(*args, d ** -0.5, True)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_public_flash_attention_runs_k1_and_k2(cuda, dtype, causal):
    """paddle's ``F.flash_attention`` on card tensors launches K1 once
    forward and K2a / K2b once each backward, and holds its output (ATOL)
    and the gradients of q, k and v (BWD_TOL, error over max |ref|) to
    torch autograd through flash_attention_ref on the same inputs."""
    from paddle_tpu_torch.nn import functional as PF

    b, s, h, d = 2, 150, 3, 64
    x = [torch.randn(b, s, h, d, generator=cuda, device="cuda").to(dtype)
         for _ in range(3)]
    g = torch.randn(b, s, h, d, generator=cuda, device="cuda").to(dtype)
    mine = [t.clone().requires_grad_() for t in x]
    ref = [t.clone().requires_grad_() for t in x]
    n = fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    out, softmax = PF.flash_attention(*mine, causal=causal,
                                      return_softmax=True)
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == \
        (n[0] + 1, n[1], n[2])
    out.backward(g)
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    want = fa.flash_attention_ref(*ref, causal=causal)
    want.backward(g)
    assert softmax is None and out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)
    for a, w in zip(mine, ref):
        assert _rel_err(a.grad, w.grad) <= BWD_TOL[dtype]


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
    the captured step and its pool go with the call).  Garbage of earlier
    tests (a card model in a reference cycle) is collected before the
    baseline, so a collection inside a call cannot lower the count."""
    import gc

    _, card = _tiny_pair()
    card.generate(np.ones((2, 4), np.int64), max_new_tokens=3,
                  temperature=0.0)
    gc.collect()
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


# ------------------------------------------------------ cluster, training
def _cl_prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 96, (n,)).tolist()


def test_cluster_captures_while_others_replay(cuda):
    """A two-replica cluster on the card under load, three times over: a
    third replica is built, warmed from a manifest and captures its graphs
    while the others replay, a replica is stopped mid-decode (its requests
    rerouted, f32 ids equal the CPU cluster's), and the cluster stops.
    With no cuBLAS workspace cleared, the card's memory after the first
    cycle is the baseline and no later cycle grows it (a capture stream
    per cuBLAS handle: a new engine thread reuses its predecessor's)."""
    import gc

    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.serving import ServingCluster

    cpu, card = _tiny_pair()
    prompts = [_cl_prompt(9 + i % 5, 300 + i) for i in range(8)]

    def cluster(model, **kw):
        return ServingCluster(model, replicas=2, num_slots=2, page_size=8,
                              max_model_len=64, **kw)

    with cluster(cpu, device="cpu", replica_prefix="ccpu/") as c:
        ref = [c.generate(p, max_new_tokens=24, timeout=120)
               for p in prompts]
    with cluster(card, replica_prefix="cw/") as c:   # mints every key
        [c.generate(p, max_new_tokens=24, timeout=120) for p in prompts]
        manifest = c.engines[0].capture_manifest()
    del c
    after = []
    for cycle in range(3):
        c = cluster(card, replica_prefix=f"cc{cycle}/", warmup=manifest)
        # pace the schedulers (3 ms a step) so the stop lands mid-decode
        faults.inject("serving.step_crash", fn=lambda: time.sleep(0.003))
        with c:
            hs = [c.submit(p, max_new_tokens=24) for p in prompts]
            third = c.pool.add_replica()         # captures while 2 replay
            t0 = time.time()
            while not all(len(h.token_ids) >= 2 for h in hs[:2]):
                assert time.time() - t0 < 60
                time.sleep(0.001)
            victim = next(e for e in c.engines
                          if e.replica == hs[0].replica_history[0])
            victim.stop()                        # stop mid-decode
            outs = [h.result(timeout=120) for h in hs]
            assert outs == ref
            assert any(len(h.replica_history) == 2 for h in hs)
            assert third._warmed["warmed"] > 0 and third._started
            assert c.generate(prompts[0], max_new_tokens=24,
                              timeout=120) == ref[0]
        faults.clear()
        del c, hs, third, victim
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[1:] == [after[0]] * 2, after


def test_cluster_replica_preempt_reaped_on_card(cuda):
    """``cluster.replica_preempt@<r>`` on the card: every request finishes
    with the CPU engine's ids and the autoscaler replaces the replica."""
    from paddle_tpu_torch.observability import faults
    from paddle_tpu_torch.serving import ServingCluster

    cpu, card = _tiny_pair()
    prompts = [_cl_prompt(7 + i, 400 + i) for i in range(4)]
    eng = ServingEngine(cpu, device="cpu", num_slots=2, page_size=8,
                        max_model_len=64, replica="cpre-cpu")
    with eng:
        ref = [eng.generate(p, max_new_tokens=20, timeout=120)
               for p in prompts]
    c = ServingCluster(card, replicas=2, num_slots=2, page_size=8,
                       max_model_len=64, replica_prefix="cpre/",
                       name="cpre",
                       autoscale={"min_replicas": 2, "max_replicas": 3,
                                  "stable_s": 0.1, "cooldown_s": 0.3,
                                  "interval_s": 0.05})
    with c:
        hs = [c.submit(p, max_new_tokens=20) for p in prompts]
        faults.inject("cluster.replica_preempt@cpre/0", times=1)
        try:
            assert [h.result(timeout=120) for h in hs] == ref
        finally:
            faults.clear()
        t0 = time.time()
        while "cpre/2" not in [e.replica for e in c.engines]:
            assert time.time() - t0 < 60
            time.sleep(0.01)


def test_recompute_bit_equal_grads_on_card(cuda):
    """A recomputed bf16 Llama decoder layer: gradients bit-equal to the
    plain run's, K1 launched twice; a recomputed bf16 GPT decoder layer
    with dropout 0.1 (the plain attention): bit-equal under one seed."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models import LlamaConfig
    from paddle_tpu_torch.text.models.gpt import GPTDecoderLayer
    from paddle_tpu_torch.text.models.llama import (LlamaDecoderLayer,
                                                    _rope_cos_sin)

    def llama():
        cfg = LlamaConfig(hidden_size=256, intermediate_size=512,
                          num_attention_heads=4, num_key_value_heads=2)
        rope = _rope_cos_sin(torch.arange(128), 64, cfg.rope_theta)
        return LlamaDecoderLayer(cfg), (rope,)

    def gpt():
        return GPTDecoderLayer(256, 4, 512, dropout=0.1, attn_dropout=0.1), ()

    for make, want in ((llama, {"plain": 1, "recompute": 2}),
                       (gpt, {"plain": 0, "recompute": 0})):
        torch.manual_seed(0)
        with torch.device("cuda"):
            layer, extra = make()
            layer = layer.to(torch.bfloat16).train()
            x0 = torch.randn(2, 128, 256, dtype=torch.bfloat16)
        grads, k1 = {}, {}
        for mode in ("plain", "recompute"):
            layer.zero_grad()
            x = x0.clone().requires_grad_()
            torch.manual_seed(7)
            fa.LAUNCHES = 0
            y = layer(x, *extra) if mode == "plain" \
                else fleet.recompute(layer, x, *extra)
            y.float().square().mean().backward()
            k1[mode] = fa.LAUNCHES
            grads[mode] = [x.grad] + [p.grad for p in layer.parameters()]
        for a, b in zip(grads["plain"], grads["recompute"]):
            assert torch.equal(a, b)
        assert k1 == want


@pytest.mark.parametrize("name", ["Adamax", "Adagrad", "RMSProp", "Adadelta",
                                  "Lamb", "Rprop", "NAdam", "RAdam", "ASGD",
                                  "Lars", "LBFGS"])
def test_optimizer_on_card_matches_cpu(cuda, name):
    """Each of the eleven optimizers trains the tiny GPT on the card as it
    does on the CPU (f32, 4 steps; LBFGS through its closure): losses rtol
    1e-4; its scalar state stays on the card."""
    kw = {"Adagrad": {"learning_rate": 0.01}, "RMSProp": {"learning_rate": 1e-3},
          "Adadelta": {"learning_rate": 1.0}, "Lars": {"learning_rate": 0.1},
          "LBFGS": {"learning_rate": 0.1, "max_iter": 3},
          "ASGD": {"learning_rate": 0.01, "batch_num": 2}}.get(
        name, {"learning_rate": 1e-3})
    cpu, card = _tiny_pair()
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 96, (2, 32)))
    losses = {}
    for dev, m in (("cpu", cpu), ("cuda", card)):
        o = getattr(optimizer, name)(parameters=m.parameters(), **kw)
        x = ids.to(dev)

        def closure():
            o.clear_grad()
            loss = m(x, labels=x)
            loss.backward()
            return loss

        out = []
        for _ in range(4):
            if name == "LBFGS":
                out.append(float(o.step(closure)))
            else:
                out.append(float(closure().detach()))
                o.step()
        losses[dev] = out
        if name != "LBFGS":
            st = o._states[id(next(m.parameters()))]
            assert all(t.device.type == dev for t in st.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_replicas_capture_their_first_dispatch_concurrently(cuda, kv_dtype):
    """Two replicas take their first dispatches (eager run, then capture)
    at the same moment: neither capture is invalidated by the other
    thread (a device-wide synchronize after a first eager run once did
    that), the launch counters stay exact (a capture's launches were once
    taken as a global before / after difference, which another thread's
    launches corrupted), and the ids equal one CPU engine's."""
    from paddle_tpu_torch.serving import ServingCluster

    cpu, card = _tiny_pair()
    prompts = [_cl_prompt(5 + i % 7, 500 + i) for i in range(8)]
    eng = ServingEngine(cpu, device="cpu", num_slots=2, page_size=8,
                        max_model_len=64, kv_dtype=kv_dtype,
                        replica=f"ccc-cpu-{kv_dtype}")
    with eng:
        ref = [eng.generate(p, max_new_tokens=12, timeout=120)
               for p in prompts]
    c = ServingCluster(card, replicas=2, num_slots=2, page_size=8,
                       max_model_len=64, kv_dtype=kv_dtype,
                       replica_prefix=f"ccc-{kv_dtype}/")
    fa.LAUNCHES = pa.LAUNCHES = pa.QUANT_LAUNCHES = 0
    with c:
        hs = [c.submit(p, max_new_tokens=12) for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
        assert all(e.health != "error" for e in c.engines)
        st = [e.stats() for e in c.engines]
    # each thread's capture records its own launches: the counters are
    # the eager and replayed launches of both replicas, none lost or
    # counted twice
    decode = pa.QUANT_LAUNCHES if kv_dtype else pa.LAUNCHES
    assert fa.LAUNCHES == 2 * sum(x["prefills"] for x in st)
    assert decode == 2 * sum(x["iteration"] for x in st)
    if kv_dtype is None:
        assert outs == ref
    else:   # the int8 rule of the card tests: first tokens equal
        assert [o[0] for o in outs] == [r[0] for r in ref]


# ------------------------------------------------ slice 15: hapi and BERT
BERT_TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=32, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)


def _bert_tiny_data(n=12, s=16):
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 96, (n, s)).astype("int64")
    ids[0, 9:] = 0
    ids[5, 3:] = 0
    return ids, rs.randint(0, 3, (n,)).astype("int64")


def _hapi_losses():
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Rec(Callback):
        losses = None

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    rec = Rec()
    rec.losses = []
    return rec


def test_bert_tiny_card_matches_cpu_forward_and_fit(cuda):
    """BERT-tiny (its pad mask: the plain attention, no kernel) on the
    card against a CPU copy: the eval logits within 1e-5 and 3
    ``Model.fit`` steps' losses within rtol 1e-4, f32."""
    from paddle_tpu_torch import Model, nn as tnn, optimizer as topt
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    torch.manual_seed(0)
    cpu = BertForSequenceClassification(num_classes=3, dropout=0.0,
                                        device="cpu", **BERT_TINY)
    card = copy.deepcopy(cpu).to("cuda")
    ids, y = _bert_tiny_data()
    logits = {}
    losses = {}
    k0 = (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    for dev, net in (("cpu", cpu), ("cuda", card)):
        m = Model(net, device=dev)
        m.prepare(topt.AdamW(learning_rate=1e-3, parameters=net.parameters()),
                  tnn.CrossEntropyLoss())
        logits[dev] = m.predict_batch([ids])[0]
        rec = _hapi_losses()
        m.fit(TensorDataset([ids, y]), batch_size=4, epochs=1, shuffle=False,
              verbose=0, callbacks=[rec])
        losses[dev] = rec.losses
    assert len(losses["cuda"]) == 3
    np.testing.assert_allclose(logits["cuda"], logits["cpu"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == k0


def test_unmasked_encoder_fit_launches_k1_k2(cuda):
    """An unmasked ``TransformerEncoder`` trained by ``Model.fit`` in bf16
    O2 runs K1 forward and K2a / K2b backward once per layer per step
    (``Model`` puts the CPU-built network on the card); its bf16 eval
    forward (K1) equals the plain attention's (a zero mask) within 2e-2 of
    its max; and each layer's K1 output and K2 dq / dk / dv, on that
    layer's own inputs in the network, equal an f32 plain attention's."""
    from paddle_tpu_torch import Model, nn as tnn, optimizer as topt
    from paddle_tpu_torch.io import TensorDataset

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = tnn.Embedding(50, 64)
            self.encoder = tnn.TransformerEncoder(
                tnn.TransformerEncoderLayer(64, 4, 128, dropout=0.0), 2)
            self.head = tnn.Linear(64, 2)

        def forward(self, ids, mask=None):
            return self.head(self.encoder(self.emb(ids), mask).mean(1))

    torch.manual_seed(0)
    net = Net()
    m = Model(net)
    assert next(net.parameters()).is_cuda
    m.prepare(topt.AdamW(learning_rate=1e-3, parameters=net.parameters()),
              tnn.CrossEntropyLoss(), amp_configs="O2")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 50, (12, 40)).astype("int64")
    y = rs.randint(0, 2, (12,)).astype("int64")
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    m.fit(TensorDataset([ids, y]), batch_size=4, epochs=1, shuffle=False,
          verbose=0)
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == (6, 6, 6)
    bf = copy.deepcopy(net).to(torch.bfloat16).eval()
    x = torch.from_numpy(ids[:4]).cuda()
    with torch.no_grad():
        flash = bf(x).float()
        assert fa.LAUNCHES == 8
        plain = bf(x, torch.zeros(4, 1, 1, 40, dtype=torch.bfloat16,
                                  device="cuda")).float()
    assert fa.LAUNCHES == 8
    assert float((flash - plain).abs().max()) <= 2e-2 * float(
        plain.abs().max())
    # per layer, on the attention core's own inputs and upstream gradient
    # in the network: K1's output within ATOL and K2's dq / dk / dv within
    # 2e-2 of their max, against an f32 autograd through the plain attention
    from paddle_tpu_torch.nn import functional as NF

    sdpa, cores = NF.scaled_dot_product_attention, []

    def recording_sdpa(q, k, v, *args, **kwargs):
        for t in (q, k, v):
            t.retain_grad()
        o = sdpa(q, k, v, *args, **kwargs)
        o.retain_grad()
        cores.append((q, k, v, o))
        return o

    h = bf.emb(x).detach().requires_grad_()
    bf.train()
    NF.scaled_dot_product_attention = recording_sdpa
    try:
        y = bf.encoder(h)
    finally:
        NF.scaled_dot_product_attention = sdpa
    y.backward(torch.randn(y.shape, generator=cuda, device="cuda").to(
        torch.bfloat16))
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == \
        (10, 8, 8) and len(cores) == 2
    for q, k, v, o in cores:
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention_ref(*leaves)
        ref.backward(o.grad.float())
        assert float((o.detach().float() - ref.detach()).abs().max()) <= 2e-2
        for t, leaf in zip((q, k, v), leaves):
            assert float((t.grad.float() - leaf.grad).abs().max()) <= \
                2e-2 * float(leaf.grad.abs().max())


def test_pdparams_written_on_card_loads_on_cpu(cuda, tmp_path):
    """``Model.save`` of a card model (f32 and bf16) writes the
    reference's schema; a CPU model loads it and gives the same logits."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.text.models import BertForSequenceClassification

    ids, _ = _bert_tiny_data()
    for dtype in (torch.float32, torch.bfloat16):
        torch.manual_seed(0)
        card = BertForSequenceClassification(num_classes=3, device="cuda",
                                             dtype=dtype, **BERT_TINY)
        Model(card).save(str(tmp_path / f"{dtype}"))
        torch.manual_seed(1)
        cpu = BertForSequenceClassification(num_classes=3, device="cpu",
                                            dtype=dtype, **BERT_TINY)
        Model(cpu, device="cpu").load(str(tmp_path / f"{dtype}"))
        for a, b in zip(card.parameters(), cpu.parameters()):
            assert torch.equal(a.cpu(), b)
        got = Model(cpu, device="cpu").predict_batch([ids])[0]
        want = Model(card).predict_batch([ids])[0]
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_embedding_pad_row_on_card(cuda):
    """The reference's padding rule on the card: zero output at the pad
    id whatever the row holds, and no gradient into the row."""
    from paddle_tpu_torch import nn as tnn

    e = tnn.Embedding(10, 8, padding_idx=2).to("cuda")
    with torch.no_grad():
        e.weight.normal_(generator=cuda)          # a nonzero pad row
    ids = torch.tensor([[2, 1, 2, 7]], device="cuda")
    out = e(ids)
    assert not out[ids == 2].any() and out[ids != 2].abs().sum() > 0
    out.square().sum().backward()
    assert not e.weight.grad[2].any() and e.weight.grad[7].any()


def test_resnet18_card_matches_cpu(cuda):
    """ResNet-18 in f32 with TF32 off for cuBLAS and cuDNN: eval logits on
    the card within 1e-4 of a CPU copy's max; then at seeds 0-4 one
    Momentum ``TrainStep`` each on the card, on the CPU in f32 and on the
    CPU in float64: the loss rtol 1e-4 against the f32 CPU's, and the
    card's update within 0.1 (parameters) and 1e-4 (BN running
    statistics) of the float64 update, over its norm.  Rounding moves
    the parameters' update in discrete jumps, where a pre-activation
    within rounding of 0 flips its ReLU: the f32 CPU reads 4e-6 at seeds
    1-3 and 1.9e-3 / 6.3e-3 at seeds 0 / 4 (one flip each), an H100
    5.6e-6 to 2.5e-2; the faults planted by
    ``test_torch_port_vision.py::test_resnet18_card_gate_separates_faults``
    read 1 and over (8 for the running statistics)."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.vision.models import resnet18

    torch.backends.cudnn.allow_tf32 = False
    for seed in range(5):
        torch.manual_seed(seed)
        cpu = resnet18(num_classes=10, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        exact = copy.deepcopy(cpu).double()
        init = {k: v.double() for k, v in cpu.state_dict().items()}
        rs = np.random.RandomState(seed)
        x = torch.from_numpy(rs.randn(4, 3, 64, 64).astype("float32"))
        y = torch.from_numpy(rs.randint(0, 10, (4,)))
        if seed == 0:
            cpu.eval()
            card.eval()
            with torch.no_grad():
                want = cpu(x)
                got = card(x.cuda()).cpu()
            assert float((got - want).abs().max()) \
                <= 1e-4 * float(want.abs().max())
        losses, states = [], []
        for m, dev, dt in ((cpu, "cpu", torch.float32),
                           (card, "cuda", torch.float32),
                           (exact, "cpu", torch.float64)):
            m.train()
            step = jit.TrainStep(m, optimizer.Momentum(
                learning_rate=0.1, momentum=0.9, parameters=m.parameters(),
                weight_decay=1e-4), loss_fn=tnn.CrossEntropyLoss())
            losses.append(float(step(x.to(device=dev, dtype=dt), y.to(dev))))
            states.append({k: v.detach().cpu().double()
                           for k, v in m.state_dict().items()})
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
        stats = [k for k in init if k.endswith(("_mean", "_variance"))]
        for keys, limit in (([k for k in init if k not in stats], 0.1),
                            (stats, 1e-4)):
            def dist(a, b):
                return sum(float(((a[k] - b[k]) ** 2).sum())
                           for k in keys) ** 0.5
            card_gap = dist(states[1], states[2]) / dist(states[2], init)
            assert card_gap <= limit, (seed, card_gap)


def test_vit_o2_step_runs_k1_k2_per_block(cuda):
    """A ViT-S/16 (img 32, depth 2) trained one bf16 O2 ``TrainStep``
    launches K1, K2a and K2b once per block on the 16-bit tensor-core
    bodies; its bf16 eval forward runs K1 once per block and agrees with
    the f32 model's within 5e-2 of the max."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.vision.models import vit_s_16

    torch.manual_seed(0)
    m = vit_s_16(img_size=32, depth=2, class_num=10, device="cuda")
    step = jit.TrainStep(m, optimizer.AdamW(
        learning_rate=1e-3, parameters=list(m.named_parameters())),
        loss_fn=tnn.CrossEntropyLoss(), amp_level="O2")
    x = torch.randn(4, 3, 32, 32, generator=cuda, device="cuda")
    y = torch.randint(0, 10, (4,), device="cuda")
    fa.LAUNCHES = fa.BWD_DKDV_LAUNCHES = fa.BWD_DQ_LAUNCHES = 0
    for d in (fa.FWD_BODY_LAUNCHES, fa.BWD_BODY_LAUNCHES):
        d.update(dict.fromkeys(d, 0))
    assert torch.isfinite(step(x, y))
    assert (fa.LAUNCHES, fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == (2, 2, 2)
    assert fa.FWD_BODY_LAUNCHES["tc16"] == 2
    assert fa.BWD_BODY_LAUNCHES["tc16"] == 4
    m.eval()
    bf = copy.deepcopy(m).to(torch.bfloat16)
    with torch.no_grad():
        want = m(x)
        got = bf(x.to(torch.bfloat16)).float()
    assert fa.LAUNCHES == 6
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


def _tensor_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensor_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return {prefix: tree}
    return {}


def test_async_snapshot_of_card_state_restores_pre_update_bytes(cuda,
                                                                tmp_path):
    """``save(block=False)`` of a card TrainStep's live state (bf16 O2:
    f32 masters and AdamW moments updated in place), then the next step
    before the write: the committed arrays equal a CPU copy taken at the
    save, byte for byte, and differ from the live state."""
    from paddle_tpu_torch.resilience import AsyncCheckpointManager

    torch.manual_seed(0)
    model = GPTForCausalLM(vocab_size=96, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           max_position_embeddings=64, device="cuda")
    step = jit.TrainStep(model, optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters()), loss_fn=None,
        amp_level="O2")
    ids = torch.randint(0, 96, (4, 48), generator=cuda, device="cuda")
    batch = {"input_ids": ids, "labels": ids}
    step(batch)
    sd = step.state_dict()
    mgr = AsyncCheckpointManager(tmp_path)
    mgr._write_lock.acquire()           # the write lands after the step
    try:
        mgr.save(1, sd)
        ref = {k: v.detach().cpu().numpy().copy()
               for k, v in _tensor_leaves(sd).items()}
        step(batch)
        torch.cuda.synchronize()
    finally:
        mgr._write_lock.release()
    mgr.wait_until_finished()
    got = _tensor_leaves(mgr.restore(1, to_tensors=False))
    live = {k: v.detach().cpu().numpy()
            for k, v in _tensor_leaves(step.state_dict()).items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        assert got[k].tobytes() == ref[k].tobytes(), k
    assert any(got[k].tobytes() != live[k].tobytes() for k in ref)
    mgr.close()


def test_restore_to_device_none_lands_on_cuda(cuda, tmp_path):
    """``restore``, ``restore_latest_valid`` and ``RecoverySupervisor``
    with no ``device`` put tensors on the card; ``device="cpu"`` on the
    CPU; a bf16 leaf survives as ``|V2`` bytes without tensors."""
    from paddle_tpu_torch.resilience import (AsyncCheckpointManager,
                                             RecoverySupervisor)

    w = torch.randn(5, 3, generator=cuda, device="cuda")
    h = w.to(torch.bfloat16)
    mgr = AsyncCheckpointManager(tmp_path)
    mgr.save(3, {"w": w, "n": 3}, block=True)
    out = mgr.restore(3)
    assert out["w"].device.type == "cuda" and torch.equal(out["w"], w)
    step, out = mgr.restore_latest_valid()
    assert step == 3 and out["w"].device.type == "cuda"
    assert mgr.restore(3, device="cpu")["w"].device.type == "cpu"
    seen = []
    RecoverySupervisor(mgr).run(lambda s, st: seen.append(st["w"].device))
    assert seen[0].type == "cuda"
    mgr.save(4, {"h": h}, block=True)
    raw = mgr.restore(4, to_tensors=False)["h"]
    assert raw.dtype.str == "|V2"
    assert raw.tobytes() == h.cpu().view(torch.int16).numpy().tobytes()
    mgr.close()


# ----------------------------------------------------- distributed part one
def test_nccl_world_of_one_collectives_on_card(cuda):
    """No env contract on the card: a world of one over NCCL; every eager
    op returns the identity (or the one-element list) on the card."""
    import os

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp

    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("PADDLE_TRAINER") or k == "PADDLE_DISTRI_BACKEND"}
    try:
        dist.init_parallel_env()
        assert dist.get_backend() == "nccl"
        t = torch.rand(1000, device="cuda", generator=cuda) + 0.5
        for op in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.AVG):
            got = dist.all_reduce(t.clone(), op=op)
            assert got.is_cuda and torch.equal(got, t)
        torch.testing.assert_close(dist.all_reduce(t.clone(), op=ReduceOp.PROD),
                                   t, rtol=1e-6, atol=0)
        assert torch.equal(dist.reduce(t.clone(), dst=0), t)
        assert torch.equal(dist.all_gather([], t)[0], t)
        assert torch.equal(dist.broadcast(t.clone(), src=0), t)
        assert torch.equal(dist.reduce_scatter(torch.empty_like(t), [t]), t)
        assert torch.equal(dist.scatter(torch.empty_like(t), [t], src=0), t)
        assert torch.equal(dist.alltoall([], [t])[0], t)
        assert torch.equal(dist.alltoall_single(None, t), t)
        assert dist.all_gather_object([], (1, "a")) == [(1, "a")]
        dist.barrier()
    finally:
        dist.destroy_process_group()
        os.environ.update(saved)


def test_tensor_parallel_layers_two_ranks_on_card(cuda, tmp_path):
    """Two rank processes on the one card over gloo (``spawn``): the
    mp = 2 column / row / vocab layers and the parallel cross-entropy on
    card tensors match the plain math on the full weights on the card,
    and gloo's all_gather on a card tensor raises instead of staging it
    on the host."""
    import json

    import paddle_tpu_torch.distributed as dist
    from _torch_port_dist_workers import card_tp_check

    dist.spawn(card_tp_check, args=(str(tmp_path),), nprocs=2,
               backend="gloo")
    for r in range(2):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        assert got["backend"] == "gloo" and got["on_card"]
        assert max(got["err"].values()) <= 1e-4, got["err"]
        assert "gloo backend cannot run it on a CUDA tensor" in \
            got["gloo_card_all_gather"]


def test_pipeline_two_stages_on_card(cuda, tmp_path):
    """Two pp ranks on the one card over gloo (``spawn``): a stage hop
    carries card tensors (with and without the shape header, counted as
    broadcasts), and GPT-tiny's pp = 2 pipe (1f1b) trained 2 SGD steps on
    the card gives the one-process run's losses (rtol 1e-5), K1 / K2
    launched on each stage (each its 1 block: 2 micro-batches a step, K1
    also in the recompute)."""
    import json

    import paddle_tpu_torch.distributed as dist
    from _torch_port_dist_workers import card_pp_check
    from paddle_tpu_torch.text.models import export_paddle_tpu_state_dict

    cfg = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64)
    torch.manual_seed(0)
    one = GPTForCausalLM(device="cuda", **cfg)
    np.savez(tmp_path / "gpt.npz", **export_paddle_tpu_state_dict(one))
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    ids = np.random.RandomState(0).randint(0, 96, (4, 64)).astype("int64")
    np.save(tmp_path / "ids.npy", ids)
    dist.spawn(card_pp_check, args=(str(tmp_path),), nprocs=2,
               backend="gloo")
    step = jit.TrainStep(one, optimizer.SGD(learning_rate=0.5,
                                            parameters=one.parameters()))
    x = torch.from_numpy(ids).to("cuda")
    want = [float(step({"input_ids": x, "labels": x})) for _ in range(2)]
    for r in range(2):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        assert got["hop_ok"] and got["hop_bytes"] > 4096 * 4
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        k1 = 2 * 2 * (3 if got["stage"] == 0 else 2)
        assert got["launches"] == [k1, 4, 4], got["launches"]



@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_mesh_engine_two_ranks_on_card(cuda, kv_dtype):
    """``ServingEngine(mesh=["cuda:0"] * 2)``: a leader and a follower
    process on the one card over gloo.  A tiny GPT's greedy ids equal the
    mp = 1 card engine's and the CPU's; both ranks launch K1 and the
    pools' decode kernel (K3, or K4 over int8 pools) alike, each over its
    one head; no follower outlives the engine."""
    import multiprocessing

    torch.manual_seed(0)
    model = GPTForCausalLM(device="cpu", vocab_size=96, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=2,
                           max_position_embeddings=64).eval()
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 96, (n,)).tolist() for n in (3, 8, 13, 16)]

    def serve(**kw):
        m = model if "mesh" in kw else copy.deepcopy(model)
        with ServingEngine(m, num_slots=3, page_size=8, max_model_len=64,
                           kv_dtype=kv_dtype, **kw) as eng:
            rows = eng.mesh_stats(reset=True)
            hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            out = [h.result(timeout=300) for h in hs]
            if rows is not None:
                rows = eng.mesh_stats()
                pids = [p.pid for p in eng._mesh.procs]
        if rows is not None:
            live = {p.pid for p in multiprocessing.active_children()}
            assert not set(pids) & live
        return out, rows

    cpu, _ = serve(device="cpu")
    card, _ = serve(device="cuda")
    mesh, rows = serve(mesh=["cuda:0", "cuda:0"])
    assert mesh == card == cpu
    decode = "k4" if kv_dtype else "k3"
    assert rows[0]["launches"] == rows[1]["launches"]
    assert rows[0]["launches"]["k1"] > 0 and rows[0]["launches"][decode] > 0
    assert all(s[3] == 1 for r in rows for s in r["pool_shapes"])
    assert rows[1]["mesh"]["calls"] == rows[0]["mesh"]["calls"] > 0


def test_init_parallel_env_takes_cuda_without_an_index(cuda):
    """``init_parallel_env(device="cuda")`` (what the examples pass on the
    card) joins a world of one on the rank's card, as ``device=None``
    does, instead of handing ``set_device`` a device without an index."""
    import paddle_tpu_torch.distributed as dist

    made = not torch.distributed.is_initialized()
    dist.init_parallel_env(device="cuda")
    try:
        assert dist.env.device() == torch.device("cuda", 0)
        x = torch.ones(4, device="cuda")
        assert dist.all_reduce(x).tolist() == [1.0] * 4
    finally:
        if made:
            dist.destroy_process_group()
