"""PyTorch port, kernels' modules: the CPU paths of paddle_tpu_torch's flash
attention (K1) and paged flash decode (K3) wrappers, and the pool writes,
held against the JAX package on the same numpy inputs.

K1 is compared with the Pallas kernel itself run in interpret mode (the
``pl.pallas_call`` patch of test_ops_kernels.py) and with ``_ref_attention``;
K3 with the jnp oracle ``paged_attention_ref`` (the paged Pallas path
cannot run on this jax).  float32, atol = rtol = 2e-5 as test_ops_kernels.
Also: the dispatch rules (a non-CPU tensor the kernels do not take raises,
never falls back) and import hygiene (the port imports no JAX)."""

import ast
import functools
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jpa = importlib.import_module("paddle_tpu.ops.paged_attention")

TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = Path(__file__).resolve().parent.parent


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _bh(x):
    """[B, S, H, D] numpy -> [B*H, S, D]"""
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _pallas_interpret(fn, *args):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 256)])
def test_flash_cpu_matches_pallas_kernel(causal, sq, sk):
    """Port CPU path == the TPU kernel in interpret mode == _ref_attention,
    for sq == sk and for sq < sk with the bottom-right causal offset."""
    B, H, D = 1, 2, 64
    q, k, v = _rand(0, B, sq, H, D), _rand(1, B, sk, H, D), _rand(2, B, sk, H, D)
    scale = 1.0 / math.sqrt(D)
    o_kernel, lse_kernel = _pallas_interpret(
        functools.partial(jfa._flash_fwd, causal_offset=sk - sq, with_lse=True),
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k)), jnp.asarray(_bh(v)), scale,
        causal, 128, 128)
    o_ref = jfa._ref_attention(jnp.asarray(_bh(q)), jnp.asarray(_bh(k)),
                               jnp.asarray(_bh(v)), scale, causal)
    o, lse = tfa.flash_attention_fn(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal,
                                    return_lse=True)
    o_bh = _bh(o.numpy())
    np.testing.assert_allclose(o_bh, np.asarray(o_kernel), **TOL)
    np.testing.assert_allclose(o_bh, np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_kernel)[..., 0], **TOL)


def test_flash_bshd_matches_jax_front_end():
    """Public [B, S, H, D] entry vs the JAX one (off-TPU it takes the
    reference einsum path) at a ragged length the TPU path would pad."""
    q, k, v = (_rand(s, 2, 37, 3, 64) for s in (3, 4, 5))
    want = jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
    got = tfa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["causal", "full", "bool_mask", "add_mask",
                                  "sq_lt_sk"])
def test_sdpa_matches_jax(case):
    B, S, H, D = 2, 24, 3, 16
    sk = 40 if case == "sq_lt_sk" else S
    q, k, v = _rand(6, B, S, H, D), _rand(7, B, sk, H, D), _rand(8, B, sk, H, D)
    mask_np = None
    if case == "bool_mask":
        mask_np = np.random.RandomState(9).rand(B, H, S, sk) > 0.3
        mask_np[..., 0] = True
    elif case == "add_mask":
        mask_np = _rand(9, B, H, S, sk)
    causal = case in ("causal", "sq_lt_sk")
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=None if mask_np is None else paddle.to_tensor(mask_np),
        is_causal=causal, training=False).numpy()
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask_np is None else torch.from_numpy(mask_np),
        is_causal=causal, training=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sdpa_dropout_is_inverted_and_train_only():
    """Dropout on the probabilities, scaled by 1/(1-p): with V all ones a
    row's output is (kept mass) / (1-p), whose mean over many rows is 1
    (bound 0.02, about 3 standard errors here; the seed is fixed); eval
    mode applies none."""
    B, S, H, D = 4, 64, 4, 8
    q, k = (torch.from_numpy(_rand(s, B, S, H, D)) for s in (11, 12))
    v = torch.ones(B, S, H, D)
    torch.manual_seed(0)
    out = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                          is_causal=False, training=True)
    assert abs(out.mean().item() - 1.0) < 0.02
    assert not torch.allclose(out, torch.ones_like(out))
    ev = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                         is_causal=False, training=False)
    torch.testing.assert_close(ev, torch.ones_like(ev))


def test_supported_has_no_length_floor():
    assert tfa.supported((1, 17, 12, 64), (1, 17, 12, 64), True)
    assert tfa.supported((1, 64, 12, 64), (1, 320, 12, 64), True)
    assert not tfa.supported((1, 320, 12, 64), (1, 64, 12, 64), True)
    assert not tfa.supported((1, 64, 12, 64), (1, 64, 4, 64), False)   # GQA
    assert not tfa.supported((1, 64, 2, 512), (1, 64, 2, 512), False)
    assert not tfa.supported((64, 12, 64), (64, 12, 64), False)


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to a kernel or raises: here (meta tensors)
    it raises, from the kernel wrappers and from sdpa's dispatch."""
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_fn(q, q, q, causal=True)
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(q, q, q, is_causal=True, training=False)
    with pytest.raises(NotImplementedError):
        TF.scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(
            1, 2, 8, 8, dtype=torch.bool, device="meta"), training=False)
    qd = torch.empty(2, 2, 16, device="meta")
    pool = torch.empty(4, 8, 2, 16, device="meta")
    table = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        tpa.paged_attention(qd, pool, pool, table,
                            torch.zeros(2, dtype=torch.int32, device="meta"))


# ------------------------------------------------------------------ K3
def _paged_inputs(seed, lens, h, hkv, ps=8, np_=4, d=16, extra_pages=3):
    B = len(lens)
    P = B * np_ + extra_pages
    rs = np.random.RandomState(seed)
    q = rs.randn(B, h, d).astype("float32")
    kp = rs.randn(P, ps, hkv, d).astype("float32")
    vp = rs.randn(P, ps, hkv, d).astype("float32")
    table = rs.permutation(P)[:B * np_].reshape(B, np_).astype("int32")
    return q, kp, vp, table, np.asarray(lens, "int32")


@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_cpu_matches_oracle(g):
    """Ragged lengths (1, ps-1, ps, ps+1, full table) over shuffled page
    ids, GQA group g; empty rows are zeros (the oracle gives mean(V))."""
    ps, np_ = 8, 4
    lens = [1, ps - 1, ps, ps + 1, np_ * ps, 0, 2 * ps + 3]
    q, kp, vp, table, ln = _paged_inputs(10 + g, lens, 2 * g, 2, ps, np_)
    want = np.asarray(jpa.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(ln)))
    got = tpa.paged_attention(*(torch.from_numpy(x) for x in
                                (q, kp, vp, table, ln))).numpy()
    live = ln > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.all(got[~live] == 0.0)


def test_paged_lengths_past_table_clamp():
    ps, np_ = 8, 4
    q, kp, vp, table, ln = _paged_inputs(3, [np_ * ps + 5, 100], 4, 2, ps, np_)
    want = np.asarray(jpa.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(np.minimum(ln, np_ * ps))))
    got = tpa.paged_attention(*(torch.from_numpy(x) for x in
                                (q, kp, vp, table, ln))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_rejects_bad_group():
    q, kp, vp, table, ln = _paged_inputs(4, [3, 5], 3, 2)
    with pytest.raises(ValueError):
        tpa.paged_attention(*(torch.from_numpy(x) for x in
                              (q, kp, vp, table, ln)))


@pytest.mark.parametrize("S", [8, 13, 24])
def test_prefill_write_byte_equal(S):
    B, ps, h, d, P = 3, 8, 2, 4, 16
    rs = np.random.RandomState(S)
    pool = rs.randn(P, ps, h, d).astype("float32")
    kv = rs.randn(B, S, h, d).astype("float32")
    table = rs.permutation(P)[:B * 4].reshape(B, 4).astype("int32")
    want = np.asarray(jpa.paged_table_prefill_write(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(table)))
    tp = torch.from_numpy(pool.copy())
    out = tpa.paged_table_prefill_write(tp, torch.from_numpy(kv),
                                        torch.from_numpy(table))
    assert out is tp                         # updated in place
    np.testing.assert_array_equal(tp.numpy(), want)


def test_token_write_byte_equal():
    B, ps, h, d, P = 4, 8, 2, 4, 20
    rs = np.random.RandomState(7)
    pool = rs.randn(P, ps, h, d).astype("float32")
    tok = rs.randn(B, h, d).astype("float32")
    table = rs.permutation(P)[:B * 4].reshape(B, 4).astype("int32")
    lens = np.asarray([0, 7, 8, 31], "int32")
    want = np.asarray(jpa.paged_table_token_write(
        jnp.asarray(pool), jnp.asarray(tok), jnp.asarray(table),
        jnp.asarray(lens)))
    tp = torch.from_numpy(pool.copy())
    tpa.paged_table_token_write(tp, torch.from_numpy(tok),
                                torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_array_equal(tp.numpy(), want)


def test_last_page():
    got = tpa._last_page(torch.tensor([0, 1, 8, 9, 16]), 8)
    want = np.asarray(jpa._last_page(jnp.asarray([0, 1, 8, 9, 16]), 8))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,HKV,NP", [(8, 12, 64), (1, 12, 64), (1, 1, 1),
                                      (3, 4, 256), (64, 12, 64), (2, 1, 7)])
def test_decode_splits_cover_the_table(B, HKV, NP):
    """The split-K decode's partition: every split owns at least one table
    slot, the splits cover all NP slots, and the grid reaches the target
    block count unless each split already holds one slot."""
    n = tpa._splits(B, HKV, NP)
    chunk = -(-NP // n)
    assert 1 <= n <= NP and (n - 1) * chunk < NP <= n * chunk
    assert B * HKV * n >= min(tpa._TARGET_BLOCKS, B * HKV * NP)


# ------------------------------------------------------------ build / hygiene
def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    """The kernels build on first use; with no nvcc (as here) the build
    fails with a clear error, and nothing is built at import."""
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc: the build would succeed")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("paged_flash_decode")
    assert _build.build_dir() == tmp_path
    assert not any(tmp_path.glob("*.so"))


def test_build_target_is_content_hashed():
    a = _build._target("flash_attention_fwd")
    b = _build._target("paged_flash_decode")
    assert a.parent == b.parent == _build.build_dir()
    assert a.name.startswith("flash_attention_fwd-") and a.suffix == ".so"
    assert _build._target("flash_attention_fwd") == a


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{f.relative_to(ROOT)} imports {mod}"
