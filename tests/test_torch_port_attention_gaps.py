"""PyTorch port, two attention gaps closed: the flash backward at head_dim
129-256 and the dropout rule of ``scaled_dot_product_attention``, held
against the JAX package on the same numpy inputs.

K2's plain version (``flash_attention_bwd_ref``, what the CUDA backward
is held to on the card) is compared with the Pallas backward kernels in
interpret mode at head_dim 192 and 256 (small S: interpret mode is slow),
and autograd through ``flash_attention_fn`` on the CPU with ``jax.grad``
of the reference's ``_ref_attention`` at ragged lengths.  Dropout: a call
with ``training=False`` and ``dropout_p > 0`` equals the ``dropout_p = 0``
call bit for bit on the CPU, in both packages, and the two packages agree.
The CUDA dispatch (K1 when dropout is inactive, the plain attention with
dropout when it is active) is held on the card by
``tests/test_torch_port_cuda.py``; here the non-CUDA devices that still
raise.  The per-body launch counters name only the two tensor-core
bodies, numbered as the C entries number them."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

# the float32 tolerance of the K2 comparisons in test_torch_port_train.py
# and test_ops_kernels.py (the same math summed in another order)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _pallas_interpret(fn, *args):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return fn(*args)
    finally:
        pl.pallas_call = orig


def _bshd(x):
    """[BH, S, D] numpy -> [B=BH, S, H=1, D] torch (the port's layout)."""
    return torch.from_numpy(np.ascontiguousarray(x))[:, :, None]


# ------------------------------------------------- K2 at head_dim 129-256
@pytest.mark.parametrize("d,sq,sk,causal,with_g_lse", [
    (192, 128, 128, True, False), (192, 128, 160, False, True),
    (256, 128, 128, False, False), (256, 96, 160, True, True)])
def test_bwd_ref_matches_pallas_backward_wide(d, sq, sk, causal, with_g_lse):
    """flash_attention_bwd_ref == _flash_bwd_pallas (interpret mode) at
    head_dim 192 / 256, both from the Pallas forward's lse, BH=2; sq < sk
    uses the bottom-right causal offset; r = delta (- g_lse)."""
    BH = 2
    q, k, v = _rand(20, BH, sq, d), _rand(21, BH, sk, d), _rand(22, BH, sk, d)
    g = _rand(23, BH, sq, d)
    scale = 1.0 / np.sqrt(d)
    off = sk - sq
    o, lse = _pallas_interpret(
        functools.partial(jfa._flash_fwd, causal_offset=off, with_lse=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, sq, sk)
    r = jnp.sum(jnp.asarray(g) * o, axis=-1, keepdims=True)
    if with_g_lse:
        r = r - jnp.asarray(_rand(24, BH, sq, 1))
    want = _pallas_interpret(jfa._flash_bwd_pallas, jnp.asarray(q),
                             jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
                             lse, r, scale, causal, off)
    got = tfa.flash_attention_bwd_ref(
        _bshd(q), _bshd(k), _bshd(v), _bshd(g),
        torch.tensor(np.asarray(lse)[..., 0]),
        torch.tensor(np.asarray(r)[..., 0]), scale, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, :, 0].numpy(), np.asarray(b),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal,sq,sk", [(True, 160, 160), (False, 160, 160),
                                          (True, 97, 160)])
def test_autograd_matches_jax_grad_wide(d, causal, sq, sk):
    """The port's autograd Function on the CPU (plain forward, K2's plain
    backward) against jax.grad of _ref_attention at head_dim 192 / 256,
    [B=1, S, H=2, D], ragged lengths, float32 (1e-4: the same math in
    another order, over up to 160 keys of width 256)."""
    B, H = 1, 2
    q, k, v = (_rand(s, B, n, H, d) for s, n in ((30, sq), (31, sk), (32, sk)))
    g = _rand(33, B, sq, H, d)
    scale = 1.0 / np.sqrt(d)

    def to_bh(x):
        return jnp.moveaxis(x, 2, 1).reshape(-1, x.shape[1], d)

    def loss(q, k, v):
        o = jfa._ref_attention(to_bh(q), to_bh(k), to_bh(v), scale, causal)
        return jnp.sum(o * to_bh(jnp.asarray(g)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention_fn(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(g))
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_wide_head_gradient_is_refused_only_past_256():
    """Off the CPU the forward checks the backward's rule before any
    compute: head_dim 256 passes the check (meta tensors then raise for
    the device), 257 is refused by the rule, naming it."""
    ok = torch.empty(1, 8, 2, 256, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="runs on cuda or cpu"):
        tfa.flash_attention_fn(ok, ok, ok, causal=True)
    wide = torch.empty(1, 8, 2, 257, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="head_dim <= 256"):
        tfa.flash_attention_fn(wide, wide, wide, causal=True)


def test_flash_bodies_are_the_tensor_core_bodies_only():
    """Every head_dim runs on the tensor cores forward and backward: the
    two per-body launch counters have the same keys, the 16-bit and the
    3xTF32 body, and the wrapper's numbering of them is the C entries'
    (enums FwdBody and BwdBody, read from the sources)."""
    import re

    from paddle_tpu_torch.ops import _build

    assert set(tfa.FWD_BODY_LAUNCHES) == set(tfa.BWD_BODY_LAUNCHES) == \
        {"tc16", "3xtf32"}
    for src, enum in (("flash_attention_fwd.cu", "FwdBody"),
                      ("flash_attention_bwd.cu", "BwdBody")):
        text = (_build.CSRC / src).read_text()
        body = re.search(r"enum %s : int \{([^}]*)\}" % enum, text).group(1)
        numbers = sorted(int(n) for n in re.findall(r"= (\d+)", body))
        assert {n: tfa._BODIES[n] for n in numbers} == tfa._BODIES


# ------------------------------------------------------------ dropout rule
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_eval_mode_dropout_equals_no_dropout_in_both_packages(causal, masked):
    """training=False with dropout_p > 0 is the dropout_p = 0 call, bit for
    bit, in the port and in the JAX package (both on the CPU); the two
    packages agree within 1e-5 (float32 softmax in another order)."""
    B, S, H, D = 2, 24, 3, 16
    q, k, v = (_rand(s, B, S, H, D) for s in (40, 41, 42))
    mask = np.tril(np.ones((S, S), bool))[None, None] if masked else None
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    jq, jk, jv = (paddle.to_tensor(x) for x in (q, k, v))
    jm = None if mask is None else paddle.to_tensor(mask)
    outs = {}
    for p in (0.0, 0.4):
        t = TF.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm,
                                            dropout_p=p, is_causal=causal,
                                            training=False)
        j = JF.scaled_dot_product_attention(jq, jk, jv, attn_mask=jm,
                                            dropout_p=p, is_causal=causal,
                                            training=False)
        outs[p] = (t.numpy(), np.asarray(j.numpy()))
    np.testing.assert_array_equal(outs[0.4][0], outs[0.0][0])
    np.testing.assert_array_equal(outs[0.4][1], outs[0.0][1])
    np.testing.assert_allclose(outs[0.0][0], outs[0.0][1], rtol=1e-5,
                               atol=1e-5)


def test_dropout_on_meta_tensors_still_raises():
    """A tensor that is neither on the CPU nor on a CUDA card raises, with
    dropout active or not: there is no quiet fallback."""
    q = torch.empty(1, 8, 2, 16, device="meta")
    for kw in (dict(dropout_p=0.1, training=True),
               dict(dropout_p=0.1, training=False)):
        with pytest.raises(NotImplementedError, match="meta"):
            TF.scaled_dot_product_attention(q, q, q, is_causal=True, **kw)
