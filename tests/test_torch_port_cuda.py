"""PyTorch port on the card: each hand-written CUDA kernel held against its
plain PyTorch version on CUDA tensors (the full-sweep K5a / K5b also bit
for bit against K3 / K4), Int8Linear's torch._int_mm against the CPU, the
tiny-GPT serving engine on the card (native and int8 pools) against the
same engine on the CPU, tiny-GPT training through the flash kernels
forward and backward, the fused bias + GELU kernel (K6) and fake-quant on
the card against the CPU.  Marked ``cuda``; every test
skips (from the ``cuda`` fixture) where no card is present.  Run on a
machine with an NVIDIA Hopper card (``--noconftest``: these tests need no
JAX, and that machine may have none):

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q
"""

import copy

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
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,d,causal", [
    (17, 17, 64, True), (300, 300, 64, True), (64, 320, 64, True),
    (300, 300, 64, False), (256, 256, 128, True), (33, 33, 256, False)])
def test_flash_kernel_matches_plain(cuda, dtype, sq, sk, d, causal):
    q = torch.randn(2, sq, 3, d, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(2, sk, 3, d, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(2, sk, 3, d, generator=cuda, device="cuda").to(dtype)
    n0 = fa.LAUNCHES
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    assert fa.LAUNCHES == n0 + 1
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ref.float(), atol=ATOL[dtype], rtol=0)
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
    a gradient it cannot take (head_dim > 128).  Under no_grad both run."""
    q = torch.randn(1, 8, 2, 64, device="cuda", requires_grad=True)
    wide = torch.randn(1, 8, 2, 256, device="cuda", requires_grad=True)
    n0 = fa.LAUNCHES
    with pytest.raises(NotImplementedError, match="needs_grad=True"):
        fa.flash_attention_fn(wide, wide, wide, causal=True)
    assert fa.LAUNCHES == n0
    pool = torch.randn(4, 8, 2, 64, device="cuda")
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    ln = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    qd = q[0, :2]                                  # [B=2, H=2, D=64]
    with pytest.raises(NotImplementedError, match="inference-only"):
        pa.paged_attention(qd, pool, pool, table, ln)
    with torch.no_grad():
        fa.flash_attention_fn(wide, wide, wide, causal=True)
        pa.paged_attention(qd, pool, pool, table, ln)


def _rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,d,causal,g_lse", [
    (17, 17, 64, True, False), (300, 300, 64, True, False),
    (64, 320, 64, True, True), (300, 300, 64, False, True),
    (256, 256, 128, True, False), (33, 70, 128, False, False)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, sq, sk, d, causal, g_lse):
    """K2a (dk, dv) and K2b (dq) against flash_attention_bwd_ref on the
    same inputs and the kernel forward's lse; error over max |ref|."""
    def t(s):
        return torch.randn(2, s, 3, d, generator=cuda, device="cuda").to(dtype)

    q, k, v, g = t(sq), t(sk), t(sk), t(sq)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fn(q, k, v, causal=causal, return_lse=True)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(-1, sq)
    r = delta - (torch.randn(delta.shape, generator=cuda, device="cuda")
                 if g_lse else 0.0)
    n = fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES
    got = fa._bwd_kernels(q, k, v, g, lse, r.contiguous(), scale, causal)
    assert (fa.BWD_DKDV_LAUNCHES, fa.BWD_DQ_LAUNCHES) == (n[0] + 1, n[1] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, g, lse, r, scale, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and a.is_contiguous()
        assert _rel_err(a, b) <= BWD_TOL[dtype]


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
