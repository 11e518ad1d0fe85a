"""PyTorch port, slice 15's model side: ``nn.functional.common`` (dropout,
embedding with the reference's padding rule, one_hot), ``nn.initializer``,
the ``nn.Transformer*`` layers, BERT / ERNIE, the tokenizer and the
weight converter, on the CPU against the JAX package.  Weights are carried
across with ``load_paddle_tpu_state_dict``; inputs come from numpy seeds.

Tolerances: forwards and gradients in f32 within 1e-5 (rtol and atol);
bf16 O2 logits within 2e-2 of the JAX O2 logits (relative to their max);
initializer moments within the sampling error of 40,000 draws (stated per
test); the tokenizer's ids exactly."""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu.text import BertTokenizer as JBertTokenizer
from paddle_tpu.text import SimpleTokenizer as JSimpleTokenizer
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.nn.layers.common import is_transposed
from paddle_tpu_torch.text import BertTokenizer, SimpleTokenizer
from paddle_tpu_torch.text.models import (BertForPretraining,
                                          BertForSequenceClassification,
                                          BertModel, BertPretrainingCriterion,
                                          ErnieForSequenceClassification,
                                          ErnieModel,
                                          export_paddle_tpu_state_dict,
                                          export_paddle_tpu_tensors,
                                          load_paddle_tpu_state_dict)
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t._value)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


# ============================================================ functional
def test_embedding_pad_row_output_is_zero_whatever_the_row_holds():
    """A loaded table with a NONZERO pad row: the reference zeroes the
    output at the pad id (torch's own padding_idx returned the row), and
    the row gets no gradient."""
    table = _rand(0, 10, 6)                      # row 0 is not zero
    ids = np.array([[0, 3, 0, 9], [5, 0, 1, 2]], dtype="int64")
    paddle.seed(0)
    je = jnn.Embedding(10, 6, padding_idx=0)
    je.set_state_dict({"weight": table})
    want = _np(je(paddle.to_tensor(ids)))
    te = tnn.Embedding(10, 6, padding_idx=0)
    load_paddle_tpu_state_dict(te, {"weight": table})
    got = te(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert not got[ids == 0].any()
    got.square().sum().backward()
    assert not te.weight.grad[0].any()
    assert te.weight.grad[3].any()
    # the functional form, both packages
    fj = _np(JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(table),
                          padding_idx=0))
    ft = TF.embedding(torch.from_numpy(ids), torch.from_numpy(table),
                      padding_idx=0)
    np.testing.assert_allclose(ft.numpy(), fj, **TOL)
    # a fresh layer starts with a zero pad row, as the reference's
    assert not tnn.Embedding(10, 6, padding_idx=0).weight[0].any()


def test_dropout_keep_rate_scale_axis_and_modes():
    """Masks come from torch's generator, not JAX's keys: hold the keep
    rate (within 4 sigma of 1 - p over 40,000 draws), the 1 / (1 - p)
    scale, the ``axis`` sharing and the modes, all against JAX's rule."""
    x = torch.ones(200, 200)
    y = TF.dropout(x, 0.3, training=True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 4 * np.sqrt(0.7 * 0.3 / 40000)
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
    ya = TF.dropout(torch.ones(8, 50, 4), 0.5, axis=[0, 2])
    assert (ya == ya[:, :1, :]).all()            # shared along dim 1
    xj = _rand(1, 4, 5)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        want = _np(JF.dropout(paddle.to_tensor(xj), 0.4, training=False,
                              mode=mode))
        got = TF.dropout(torch.from_numpy(xj), 0.4, training=False, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    yd = TF.dropout(x, 0.3, training=True, mode="downscale_in_infer")
    assert set(torch.unique(yd).tolist()) <= {0.0, 1.0}
    assert TF.dropout(x, 0.0, training=True) is x
    layer = tnn.Dropout(0.5).eval()
    assert torch.equal(layer(x), x)


def test_dropout_plain_form_is_torch_dropout():
    """No ``axis``, upscale_in_train: one call of torch's fused dropout
    (the same draws under one seed), through the functional and the
    layer; p >= 1 drops everything."""
    x = torch.from_numpy(_rand(4, 6, 50))
    for fn in (lambda: TF.dropout(x, 0.3, training=True),
               lambda: tnn.Dropout(0.3).train()(x)):
        torch.manual_seed(7)
        got = fn()
        torch.manual_seed(7)
        assert torch.equal(got, torch.nn.functional.dropout(x, 0.3))
    assert not TF.dropout(x, 1.0, training=True).any()


def test_one_hot_relu_tanh():
    ids = np.array([[0, 2], [3, 1]], dtype="int64")
    np.testing.assert_array_equal(
        TF.one_hot(torch.from_numpy(ids), 4).numpy(),
        _np(JF.one_hot(paddle.to_tensor(ids), 4)))
    x = _rand(2, 3, 7)
    for name in ("relu", "tanh"):
        np.testing.assert_allclose(
            getattr(TF, name)(torch.from_numpy(x)).numpy(),
            _np(getattr(JF, name)(paddle.to_tensor(x))), **TOL)


# ============================================================ initializers
SHAPES = [(200, 200), (64, 32, 3, 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name,args", [
    ("Normal", (0.5, 2.0)), ("TruncatedNormal", (0.1, 0.5)),
    ("Uniform", (-0.3, 0.7)), ("XavierNormal", ()), ("XavierUniform", ()),
    ("KaimingNormal", ()), ("KaimingUniform", ()),
])
def test_initializer_moments_match_reference(name, args, shape):
    """Moments, not bits: the mean and the std of a port draw within 4
    standard errors of the difference from the JAX draw's (n draws each:
    the mean's error std / sqrt(n), the std's std * sqrt(1 / (2 n)), each
    times sqrt(2) for the difference of two draws); the supports equal."""
    paddle.seed(0)
    j = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
    g = torch.Generator().manual_seed(0)
    t = getattr(TI, name)(*args)(shape, generator=g).numpy()
    assert t.shape == j.shape and t.dtype == np.float32
    n = t.size
    se_mean = j.std() / np.sqrt(n)
    assert abs(t.mean() - j.mean()) < 4 * np.sqrt(2) * se_mean + 1e-7
    assert abs(t.std() - j.std()) < 4 * np.sqrt(2) * j.std() * np.sqrt(1 / (2 * n))
    if name in ("Uniform", "XavierUniform", "KaimingUniform"):
        assert t.min() >= j.min() - 1e-3 * abs(j.min()) - 1e-6
        assert t.max() <= j.max() + 1e-3 * abs(j.max()) + 1e-6
    if name == "TruncatedNormal":
        mean, std = args
        assert t.min() >= mean - 2 * std - 1e-6
        assert t.max() <= mean + 2 * std + 1e-6


def test_deterministic_initializers_equal_reference():
    paddle.seed(0)
    for ji, ti, shape in [
            (JI.Constant(0.25), TI.Constant(0.25), (3, 4)),
            (JI.Dirac(), TI.Dirac(), (4, 4, 3, 3)),
            (JI.Dirac(groups=2), TI.Dirac(groups=2), (4, 2, 3)),
            (JI.Bilinear(), TI.Bilinear(), (2, 2, 4, 4)),
            (JI.Assign(np.arange(12.0).reshape(3, 4)),
             TI.Assign(np.arange(12.0).reshape(3, 4)), (3, 4))]:
        np.testing.assert_array_equal(ti(shape).numpy(),
                                      np.asarray(ji(shape, "float32")))
    for nl, param in [("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                      ("selu", None), ("linear", None)]:
        assert TI.calculate_gain(nl, param) == JI.calculate_gain(nl, param)
    assert TI._fans((5, 7)) == JI._fans((5, 7))
    assert TI._fans((64, 32, 3, 3)) == JI._fans((64, 32, 3, 3))


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 5)])
def test_orthogonal_initializer(shape):
    """Orthogonal over the last axis with ``gain``, as JAX's: Q^T Q (or
    Q Q^T for wide) equals gain^2 I in both packages."""
    gain = 1.5
    paddle.seed(0)
    j = np.asarray(JI.Orthogonal(gain)(shape, "float32")).reshape(-1, shape[-1])
    t = TI.Orthogonal(gain)(shape, generator=torch.Generator().manual_seed(0))
    t = t.numpy().reshape(-1, shape[-1])
    for m in (j, t):
        gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)),
                                   atol=1e-5)


def test_set_global_initializer_reaches_linear():
    TI.set_global_initializer(TI.Constant(0.5), TI.Constant(-1.0))
    try:
        lin = tnn.Linear(3, 4)
    finally:
        TI.set_global_initializer(None)
    assert (lin.weight == 0.5).all() and (lin.bias == -1.0).all()
    fresh = tnn.Linear(3, 4)
    assert not (fresh.weight == 0.5).all() and not fresh.bias.any()


# ============================================================ transformer
def _mha_pair(kdim=None, need_weights=False):
    paddle.seed(0)
    j = jnn.MultiHeadAttention(16, 4, kdim=kdim, vdim=kdim,
                               need_weights=need_weights)
    t = tnn.MultiHeadAttention(16, 4, kdim=kdim, vdim=kdim,
                               need_weights=need_weights)
    load_paddle_tpu_state_dict(t, _state(j))
    return j.eval(), t.eval()


def _masks(b, sq, sk):
    add = np.where(np.random.RandomState(3).rand(b, 1, sq, sk) < 0.3,
                   -1e4, 0.0).astype("float32")
    keep = np.random.RandomState(4).rand(b, 1, sq, sk) > 0.3
    keep[..., 0] = True
    return {"none": None, "additive": add, "bool": keep}


@pytest.mark.parametrize("mask", ["none", "additive", "bool"])
@pytest.mark.parametrize("need_weights", [False, True])
def test_mha_forward_and_grads(mask, need_weights):
    j, t = _mha_pair(need_weights=need_weights)
    q, kv = _rand(5, 2, 6, 16), _rand(6, 2, 9, 16)
    m = _masks(2, 6, 9)[mask]
    jq = paddle.to_tensor(q, stop_gradient=False)
    jkv = paddle.to_tensor(kv, stop_gradient=False)
    jm = None if m is None else paddle.to_tensor(m)
    jo = j(jq, jkv, jkv, jm)
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    tm = None if m is None else torch.from_numpy(m)
    to = t(tq, tkv, tkv, tm)
    if need_weights:
        (jo, jw), (to, tw) = jo, to
        np.testing.assert_allclose(tw.detach().numpy(), _np(jw), **TOL)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), _np(jq.grad), **TOL)
    np.testing.assert_allclose(tkv.grad.numpy(), _np(jkv.grad), **TOL)
    np.testing.assert_allclose(t.q_proj.weight.grad.numpy().T,
                               _np(j.q_proj.weight.grad), **TOL)


def test_mha_cache_and_static_cache():
    """Incremental decoding with ``Cache`` (k / v concatenated step by
    step) and cross attention over a ``StaticCache``, both packages."""
    j, t = _mha_pair()
    x, mem = _rand(7, 2, 4, 16), _rand(8, 2, 5, 16)
    jc = j.gen_cache(paddle.to_tensor(x))
    tc = t.gen_cache(torch.from_numpy(x))
    assert tuple(tc.k.shape) == (2, 0, 4, 4)
    for i in range(4):
        xi = x[:, i:i + 1]
        jo, jc = j(paddle.to_tensor(xi), cache=jc)
        to, tc = t(torch.from_numpy(xi), cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    assert tuple(tc.k.shape) == (2, 4, 4, 4)
    np.testing.assert_allclose(tc.v.detach().numpy(), _np(jc.v), **TOL)
    js = j.gen_cache(paddle.to_tensor(mem), type=jnn.MultiHeadAttention.StaticCache)
    ts = t.gen_cache(torch.from_numpy(mem), type=tnn.MultiHeadAttention.StaticCache)
    jo = j(paddle.to_tensor(x), paddle.to_tensor(mem), paddle.to_tensor(mem),
           cache=js)
    to = t(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem),
           cache=ts)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)


def _encdec_pair(kind, normalize_before, layers=2):
    paddle.seed(0)
    if kind == "encoder":
        jl = jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                         normalize_before=normalize_before)
        tl = tnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                         normalize_before=normalize_before)
        jn = jnn.LayerNorm(16) if normalize_before else None
        tn = tnn.LayerNorm(16) if normalize_before else None
        j, t = jnn.TransformerEncoder(jl, layers, jn), \
            tnn.TransformerEncoder(tl, layers, tn)
    else:
        jl = jnn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before)
        tl = tnn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                         activation="gelu",
                                         normalize_before=normalize_before)
        j, t = jnn.TransformerDecoder(jl, layers), \
            tnn.TransformerDecoder(tl, layers)
    load_paddle_tpu_state_dict(t, _state(j))
    return j, t


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_decoder_forward_and_grads(kind, normalize_before):
    j, t = _encdec_pair(kind, normalize_before)
    x, mem = _rand(9, 2, 6, 16), _rand(10, 2, 5, 16)
    causal = np.triu(np.full((6, 6), -1e9, "float32"), 1)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    if kind == "encoder":
        jo = j(jx, paddle.to_tensor(causal))
        to = t(tx, torch.from_numpy(causal))
    else:
        jo = j(jx, paddle.to_tensor(mem), paddle.to_tensor(causal))
        to = t(tx, torch.from_numpy(mem), torch.from_numpy(causal))
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    (jo * jo).mean().backward()
    (to * to).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)
    jg = {k: _np(p.grad) for k, p in j.named_parameters()}
    for k, p in t.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if is_transposed(p) else g, jg[k],
                                   **TOL, err_msg=k)


def test_param_attr_initializer_and_no_bias():
    """``weight_attr`` / ``bias_attr`` as paddle's ``ParamAttr``: the
    initializer draws in the ``[in, out]`` layout; ``bias_attr=False``
    drops every bias, as in the reference."""
    from types import SimpleNamespace

    from paddle_tpu.nn.param_attr import ParamAttr

    j = jnn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, bias_attr=False,
        weight_attr=ParamAttr(initializer=JI.Constant(0.05)))
    t = tnn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, bias_attr=False,
        weight_attr=SimpleNamespace(initializer=TI.Constant(0.05)))
    assert set(t.state_dict()) == set(j.state_dict())
    assert t.linear1.bias is None and t.self_attn.q_proj.bias is None
    x = _rand(14, 2, 5, 16)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               _np(j(paddle.to_tensor(x))), **TOL)
    # the layout: an [in, out] array assigned to a Linear of 8 -> 4
    from paddle_tpu_torch.nn.layers.transformer import _linear

    w = np.arange(32, dtype="float32").reshape(8, 4)
    jl = jnn.Linear(8, 4, weight_attr=ParamAttr(initializer=JI.Assign(w)))
    tl = _linear(8, 4, SimpleNamespace(initializer=TI.Assign(w)))
    np.testing.assert_array_equal(tl.weight.detach().numpy().T,
                                  _np(jl.weight))


def test_encoder_layers_start_equal_and_caches_match():
    """``TransformerEncoder`` deep-copies its first layer: every layer
    starts from the same weights, as the reference's; the encoder's
    incremental cache path equals the JAX one."""
    paddle.seed(0)
    t = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(16, 4, 32), 3)
    w = [layer.linear1.weight for layer in t.layers]
    assert all(torch.equal(w[0], x) for x in w[1:])
    assert len({id(x) for x in w}) == 3
    j, t = _encdec_pair("encoder", False)
    x = _rand(11, 2, 3, 16)
    jc, tc = j.gen_cache(paddle.to_tensor(x)), t.gen_cache(torch.from_numpy(x))
    jo, jc = j(paddle.to_tensor(x), None, jc)
    to, tc = t(torch.from_numpy(x), None, tc)
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    np.testing.assert_allclose(tc[1].k.detach().numpy(), _np(jc[1].k), **TOL)


def test_transformer_builds_on_the_card_unless_cpu_is_asked(monkeypatch):
    """``nn.Transformer`` is a whole model: the card by default (no card
    raises, nothing falls back to the CPU), or the ``device`` / ``dtype``
    asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.Transformer(16, 4, 1, 1, 32)
    t = tnn.Transformer(16, 4, 1, 1, 32, device="cpu", dtype=torch.float64)
    assert {(p.device.type, p.dtype) for p in t.parameters()} == \
        {("cpu", torch.float64)}


def test_transformer_and_square_mask():
    paddle.seed(0)
    j = jnn.Transformer(16, 4, 2, 2, 32, dropout=0.0, normalize_before=True)
    t = tnn.Transformer(16, 4, 2, 2, 32, dropout=0.0, normalize_before=True,
                        device="cpu")
    load_paddle_tpu_state_dict(t, _state(j))
    np.testing.assert_array_equal(
        t.generate_square_subsequent_mask(5, device="cpu").numpy(),
        _np(jnn.Transformer.generate_square_subsequent_mask(5)))
    src, tgt = _rand(12, 2, 6, 16), _rand(13, 2, 5, 16)
    jo = j(paddle.to_tensor(src), paddle.to_tensor(tgt),
           tgt_mask=jnn.Transformer.generate_square_subsequent_mask(5))
    to = t(torch.from_numpy(src), torch.from_numpy(tgt),
           tgt_mask=t.generate_square_subsequent_mask(5, device="cpu"))
    np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)
    # decoder incremental cache (self Cache + cross StaticCache)
    jd, td = j.decoder, t.decoder
    mem_j = j.encoder(paddle.to_tensor(src))
    mem_t = t.encoder(torch.from_numpy(src))
    jc, tc = jd.gen_cache(mem_j), td.gen_cache(mem_t)
    for i in range(3):
        jo, jc = jd(paddle.to_tensor(tgt[:, i:i + 1]), mem_j, cache=jc)
        to, tc = td(torch.from_numpy(tgt[:, i:i + 1]), mem_t, cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), _np(jo), **TOL)


# ============================================================ BERT / ERNIE
def _ids(seed, b=3, s=16, vocab=96, pad_rows=True):
    ids = np.random.RandomState(seed).randint(1, vocab, (b, s)).astype("int64")
    if pad_rows:
        ids[0, 10:] = 0          # a padded row
        ids[2, 5:] = 0
    return ids


def _bert_pair(jcls, tcls, **kw):
    paddle.seed(0)
    j = jcls(**kw)
    t = tcls(device="cpu", **kw)
    st = _state(j)
    word = next(k for k in st if k.endswith("word_embeddings.weight"))
    st[word] = st[word].copy()
    st[word][0] = _rand(9, st[word].shape[1])   # a NONZERO pad row in both
    j.set_state_dict(st)          # (not a constant: LayerNorm removes one)
    load_paddle_tpu_state_dict(t, st)
    return j.eval(), t.eval()


@pytest.mark.parametrize("jcls,tcls", [(jbert.BertModel, BertModel),
                                       (jbert.ErnieModel, ErnieModel)])
def test_bert_ernie_seq_out_and_pooled(jcls, tcls):
    j, t = _bert_pair(jcls, tcls, **TINY)
    ids = _ids(0)
    tt = np.random.RandomState(1).randint(0, 2, ids.shape).astype("int64")
    js, jp = j(paddle.to_tensor(ids), paddle.to_tensor(tt))
    with torch.no_grad():
        ts, tp = t(torch.from_numpy(ids), torch.from_numpy(tt))
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    np.testing.assert_allclose(tp.numpy(), _np(jp), **TOL)
    # an explicit attention_mask and position_ids
    am = (ids != 0).astype("int64")
    pos = np.tile(np.arange(16)[None], (3, 1)).astype("int64")
    js, _ = j(paddle.to_tensor(ids), None, paddle.to_tensor(pos),
              paddle.to_tensor(am))
    with torch.no_grad():
        ts, _ = t(torch.from_numpy(ids), None, torch.from_numpy(pos),
                  torch.from_numpy(am))
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)


def test_ernie_defaults():
    assert ErnieModel.__init__.__defaults__[:11] == \
        jbert.ErnieModel.__init__.__defaults__[:11]
    assert BertModel.__init__.__defaults__[:13] == \
        jbert.BertModel.__init__.__defaults__[:13]


@pytest.mark.parametrize("jcls,tcls", [
    (jbert.BertForSequenceClassification, BertForSequenceClassification),
    (jbert.ErnieForSequenceClassification, ErnieForSequenceClassification)])
def test_classifier_logits_and_grads(jcls, tcls):
    paddle.seed(0)
    j = jcls(num_classes=3, dropout=0.0, **TINY)
    t = tcls(num_classes=3, dropout=0.0, device="cpu", **TINY)
    load_paddle_tpu_state_dict(t, _state(j))
    ids = _ids(2)
    labels = np.array([0, 2, 1], dtype="int64")
    jl = j(paddle.to_tensor(ids))
    tl = t(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.detach().numpy(), _np(jl), **TOL)
    JF.cross_entropy(jl, paddle.to_tensor(labels)).backward()
    TF.cross_entropy(tl, torch.from_numpy(labels)).backward()
    jg = {k: _np(p.grad) for k, p in j.named_parameters()}
    for k, p in t.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if is_transposed(p) else g, jg[k],
                                   **TOL, err_msg=k)
    # the pad row's gradient is zero in both
    assert not t.bert.embeddings.word_embeddings.weight.grad[0].any()


def test_bert_pretraining_tied_head_and_criterion():
    """The tied MLM head registers no second parameter: the parameter
    count, the state keys and the criterion (``ignore_index=-100``)
    equal the reference's."""
    paddle.seed(0)
    j = jbert.BertForPretraining(**TINY)
    t = BertForPretraining(device="cpu", **TINY)
    assert sum(p.numel() for p in t.parameters()) == \
        sum(int(np.prod(p.shape)) for p in j.parameters())
    assert set(t.state_dict()) == set(j.state_dict())
    assert "cls.decoder_weight" not in t.state_dict()
    load_paddle_tpu_state_dict(t, _state(j))
    j.eval(), t.eval()
    ids = _ids(3)
    mlm = np.full(ids.shape, -100, "int64")
    mlm[:, 2] = ids[:, 2]
    mlm[1, 7] = 5
    nsp = np.array([[0], [1], [1]], dtype="int64")
    jp, jn = j(paddle.to_tensor(ids))
    tp, tn = t(torch.from_numpy(ids))
    np.testing.assert_allclose(tp.detach().numpy(), _np(jp), **TOL)
    np.testing.assert_allclose(tn.detach().numpy(), _np(jn), **TOL)
    jc = jbert.BertPretrainingCriterion(96)(jp, jn, paddle.to_tensor(mlm),
                                            paddle.to_tensor(nsp))
    tc = BertPretrainingCriterion(96)(tp, tn, torch.from_numpy(mlm),
                                      torch.from_numpy(nsp))
    np.testing.assert_allclose(float(tc), float(_np(jc)), **TOL)
    tc.backward()
    word = t.bert.embeddings.word_embeddings.weight
    assert word.grad is not None and word.grad[ids[0, 2]].any()
    # the untied head owns a [vocab, hidden] XavierNormal weight
    head = jbert.BertLMPredictionHead(32, 96)
    from paddle_tpu_torch.text.models.bert import BertLMPredictionHead
    th = BertLMPredictionHead(32, 96)
    assert tuple(th.decoder_weight.shape) == tuple(head.decoder_weight.shape)
    assert set(th.state_dict()) == set(head.state_dict())


def test_bert_pretraining_tie_survives_deepcopy_and_o2_rebinding():
    t = BertForPretraining(device="cpu", **TINY)
    c = copy.deepcopy(t)
    assert c.cls._weight is c.bert.embeddings.word_embeddings.weight
    assert c.cls._weight is not t.cls._weight


def test_bert_amp_o2_logits_match_reference_o2():
    """Under O2 both packages cast the additive f32 pad mask with q / k /
    v (-1e4 becomes bf16's -9984) and run the encoder in bf16: the port's
    O2 logits are held to the reference's O2 logits (2e-2 of their
    max), not to f32."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp

    paddle.seed(0)
    j = jbert.BertForSequenceClassification(num_classes=4, dropout=0.0, **TINY)
    t = BertForSequenceClassification(num_classes=4, dropout=0.0,
                                      device="cpu", **TINY)
    load_paddle_tpu_state_dict(t, _state(j))
    j.eval(), t.eval()
    ids = _ids(4)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jl = _np(j(paddle.to_tensor(ids)))
    with tamp.auto_cast(level="O2", dtype="bfloat16"), torch.no_grad():
        tl = t(torch.from_numpy(ids)).float().numpy()
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()


# ============================================================ convert
def test_convert_round_trip_bert():
    """JAX -> port -> JAX: the exported state (paddle layout, no
    duplicate tied key) loads into the reference, and its logits return."""
    paddle.seed(0)
    j = jbert.BertForPretraining(**TINY)
    t = BertForPretraining(device="cpu", **TINY)
    st = _state(j)
    load_paddle_tpu_state_dict(t, st)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.01)
    out = export_paddle_tpu_state_dict(t, expected=st)
    assert set(out) == set(st)
    j.set_state_dict(out)
    j.eval(), t.eval()
    ids = _ids(5)
    jp, _ = j(paddle.to_tensor(ids))
    with torch.no_grad():
        tp, _ = t(torch.from_numpy(ids))
    np.testing.assert_allclose(tp.numpy(), _np(jp), **TOL)
    tens = export_paddle_tpu_tensors(t)
    for k, v in tens.items():
        np.testing.assert_array_equal(v.numpy(), out[k])
    assert isinstance(tens["cls.transform.weight"], torch.nn.Parameter)
    # the exported tensors are copies, not the live weights
    tens["nsp.bias"].data.add_(1.0)
    assert not torch.equal(tens["nsp.bias"], t.nsp.bias.detach())


# ============================================================ tokenizer
CORPUS = [
    "a triumph of wit and craft", "gorgeous, moving, expertly acted",
    "one of the year's best films", "sharp writing and a brilliant cast",
    "dull, lifeless, and painfully long",
    "a waste of everyone's talent and time",
    "the plot collapses into nonsense", "clumsy pacing and wooden dialogue",
] * 8
SAMPLES = ["a brilliant, moving triumph!", "Crème brûlée à la café",
           "北京大学的学生 read wit", "ＦＵＬＬ-width and naïve résumé",
           "unknownword collapses", ""]


@pytest.mark.parametrize("kind", ["bert", "simple"])
def test_tokenizer_ids_equal(kind):
    jt = (JBertTokenizer if kind == "bert" else JSimpleTokenizer).from_corpus(
        CORPUS + SAMPLES[:4], **({"min_freq": 1} if kind == "bert" else {}))
    tt = (BertTokenizer if kind == "bert" else SimpleTokenizer).from_corpus(
        CORPUS + SAMPLES[:4], **({"min_freq": 1} if kind == "bert" else {}))
    assert tt.vocab == jt.vocab
    for text in CORPUS[:8] + SAMPLES:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt(text, max_length=12) == jt(text, max_length=12)
        assert tt(text, "a pair here", max_length=20) == \
            jt(text, "a pair here", max_length=20)
    assert tt.convert_ids_to_tokens(range(12)) == \
        jt.convert_ids_to_tokens(range(12))
    assert (tt.pad_token_id, tt.cls_token_id, tt.sep_token_id,
            tt.mask_token_id, tt.unk_token_id) == \
        (jt.pad_token_id, jt.cls_token_id, jt.sep_token_id,
         jt.mask_token_id, jt.unk_token_id)


def test_tokenizer_from_vocab_file(tmp_path):
    f = tmp_path / "vocab.txt"
    f.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                            "cr", "##è", "##me", "wit"]) + "\n")
    jt, tt = JBertTokenizer.from_vocab_file(str(f)), \
        BertTokenizer.from_vocab_file(str(f))
    for text in ("crème wit", "witty crme"):
        assert tt(text, max_length=8) == jt(text, max_length=8)
