"""PyTorch port, distributed part one: the tensor-parallel layers,
``DataParallel``, GPT trained dp x mp through ``fleet`` and the two
collective examples, on four gloo rank processes
(``_torch_port_dist_workers.RankPool``, one torch thread each).

Each rank holds its shard, so the layers are held to the JAX plain math
on the full weights (the reference's TP layers hold the full logical
weight), and the hybrid GPT run to the reference's unsharded GPT on the
same weights, as ``tests/test_gpt_hybrid.py`` holds the reference's own
hybrid run (rtol 2e-4, atol 2e-5).  The reference's ``fleet.init`` is
never called here: its topology is process-wide."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                          load_paddle_tpu_state_dict)
from _torch_port_dist_workers import RankPool
from _torch_port_jax_isolation import no_jax_hybrid_topology  # noqa: F401

RS = np.random.RandomState(0)
TOL = dict(rtol=0, atol=1e-5)
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=32)
GPT_STEPS, GPT_LR = 4, 1e-3


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f(*s):
    return RS.randn(*s).astype("float32")


# ------------------------------------------------------------ the TP layers
TP = dict(x=_f(3, 8), w1=_f(8, 16), b1=_f(16), dy1=_f(3, 16), w2=_f(16, 8),
          b2=_f(8), dy2=_f(3, 8), h=_f(3, 16), emb=_f(32, 6),
          ids=RS.randint(0, 32, (2, 5)).astype("int64"), de=_f(2, 5, 6),
          logits=_f(7, 32), labels=np.array([0, 5, 31, -100, 8, 16, 24]),
          dl=_f(7))


@pytest.fixture(scope="module")
def tp(pool):
    return pool.run("tp_layers", TP)


def _vjp(fn, *args, cot):
    out, back = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in back(jnp.asarray(cot))]


def _cat(tp, key, axis):
    return np.concatenate([r[key] for r in sorted(tp, key=lambda r:
                                                  r["mp_rank"])], axis=axis)


def test_column_parallel_linear_gathered(tp):
    y, (dx, dw, db) = _vjp(lambda x, w, b: x @ w + b, TP["x"], TP["w1"],
                           TP["b1"], cot=TP["dy1"])
    for r in tp:
        np.testing.assert_allclose(r["col_y"], y, **TOL)
        np.testing.assert_allclose(r["col_dx"], dx, **TOL)
    # a shard is [out/mp, in] in the port's layout: paddle's [in, out/mp]
    np.testing.assert_allclose(_cat(tp, "col_dw", 0).T, dw, **TOL)
    np.testing.assert_allclose(_cat(tp, "col_db", 0), db, **TOL)


def test_column_then_row_parallel_linear(tp):
    y, (dx, dw1, db1, dw2, db2) = _vjp(
        lambda x, w1, b1, w2, b2: (x @ w1 + b1) @ w2 + b2, TP["x"], TP["w1"],
        TP["b1"], TP["w2"], TP["b2"], cot=TP["dy2"])
    for r in tp:
        np.testing.assert_allclose(r["mlp_y"], y, **TOL)
        np.testing.assert_allclose(r["mlp_dx"], dx, **TOL)
        np.testing.assert_allclose(r["mlp_db2"], db2, **TOL)
    np.testing.assert_allclose(_cat(tp, "mlp_dw1", 0).T, dw1, **TOL)
    np.testing.assert_allclose(_cat(tp, "mlp_db1", 0), db1, **TOL)
    np.testing.assert_allclose(_cat(tp, "mlp_dw2", 1).T, dw2, **TOL)


def test_row_parallel_linear_scatters_a_full_input(tp):
    y, (dh, dw, db) = _vjp(lambda h, w, b: h @ w + b, TP["h"], TP["w2"],
                           TP["b2"], cot=TP["dy2"])
    for r in tp:
        np.testing.assert_allclose(r["row_y"], y, **TOL)
        np.testing.assert_allclose(r["row_dh"], dh, **TOL)
        np.testing.assert_allclose(r["row_db"], db, **TOL)
    np.testing.assert_allclose(_cat(tp, "row_dw", 1).T, dw, **TOL)


def test_vocab_parallel_embedding(tp):
    ids = jnp.asarray(TP["ids"])
    y, (dw,) = _vjp(lambda w: jnp.take(w, ids, axis=0), TP["emb"],
                    cot=TP["de"])
    for r in tp:
        np.testing.assert_allclose(r["emb_y"], y, **TOL)
    np.testing.assert_allclose(_cat(tp, "emb_dw", 0), dw, **TOL)


def test_parallel_cross_entropy(tp):
    lab = jnp.asarray(TP["labels"])

    def ce(logits):
        lse = jax.nn.logsumexp(logits, axis=-1)
        y = jnp.take_along_axis(logits, jnp.clip(lab, 0)[:, None], -1)[:, 0]
        return jnp.where(lab != -100, lse - y, 0.0)

    loss, (dl,) = _vjp(ce, TP["logits"], cot=TP["dl"])
    for r in tp:
        np.testing.assert_allclose(r["ce_loss"], loss, **TOL)
    np.testing.assert_allclose(_cat(tp, "ce_dlogits", -1), dl, **TOL)


def test_shards_are_marked_and_replicas_are_not(tp):
    assert tp[0]["sharded"] == ["col.bias", "col.weight", "emb.weight",
                                "row.weight"]


# ------------------------------------------------------------ DataParallel
def _jax_mlp():
    paddle.seed(11)
    m = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    return m, {k: np.array(np.asarray(v._value), copy=True)
               for k, v in m.state_dict().items()}


DP_X = np.random.RandomState(0).randn(16, 8).astype("float32")
DP_Y = np.random.RandomState(1).randint(0, 4, (16,)).astype("int64")


def test_data_parallel_matches_the_reference_single_device_run(pool):
    """dp = 4 (ranks 1-3 start from other weights: the wrap broadcasts
    rank 0's): the ranks' mean loss is the reference's single-device loss
    on the whole batch, step by step, and every rank ends on the
    reference's weights (as ``tests/test_distributed.py`` holds the
    reference's own DataParallel)."""
    m, state = _jax_mlp()
    o = jopt.Momentum(learning_rate=0.05, momentum=0.9,
                      parameters=m.parameters())
    step = paddle.jit.TrainStep(m, o, loss_fn=jnn.CrossEntropyLoss())
    x, y = paddle.to_tensor(DP_X), paddle.to_tensor(DP_Y)
    ref = [float(step(x, y)) for _ in range(4)]
    res = pool.run("dp_train", state, DP_X, DP_Y, 4)
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], 0), ref,
                               rtol=1e-5, atol=1e-6)
    want = {k: np.asarray(v._value) for k, v in m.state_dict().items()}
    for r in res:
        assert r["reductions"] == 4
        for k in want:
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k])
            np.testing.assert_allclose(r["state"][k], want[k], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_one_gradient_reduction_per_backward(pool):
    """Eager ``backward()`` and ``TrainStep`` alike: one reduction (one
    flat all_reduce for the one dtype) per backward, none in the step."""
    _, state = _jax_mlp()
    for r in pool.run("dp_counts", state, DP_X, DP_Y):
        assert r["counts"] == [1, 1, 2, 3]
        assert r["all_reduce_calls"] == 3


def test_reduction_after_a_backward_that_raised(pool):
    """A backward that raises after a gradient has landed (on every rank,
    as a transient collective fault or an OOM would) drops its queued
    reduction; the next backward still reduces once on every rank, to the
    gradient of the whole batch."""
    _, state = _jax_mlp()
    m = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(),
                       tnn.Linear(32, 4))
    load_paddle_tpu_state_dict(m, state)
    tnn.CrossEntropyLoss()(m(torch.from_numpy(DP_X)),
                           torch.from_numpy(DP_Y)).backward()
    for r in pool.run("dp_after_failed_backward", state, DP_X, DP_Y):
        assert r["raised"] and r["landed"]
        assert r["reductions"] == 1 and r["all_reduce_calls"] == 1
        for n, p in m.named_parameters():
            np.testing.assert_allclose(r["grads"][n], p.grad.numpy(),
                                       rtol=0, atol=1e-6, err_msg=n)


# ------------------------------------------------------------- GPT dp x mp
@pytest.fixture(scope="module")
def gpt_ref():
    paddle.seed(7)
    j = JGPT(**GPT_CFG)
    state = {k: np.array(np.asarray(v._value), copy=True)
             for k, v in j.state_dict().items()}
    ids = np.random.RandomState(3).randint(0, 128, (8, 16)).astype("int64")
    o = jopt.AdamW(learning_rate=GPT_LR, weight_decay=0.01,
                   parameters=j.parameters(),
                   grad_clip=jopt.ClipGradByGlobalNorm(1.0))
    step = paddle.jit.TrainStep(j, o, loss_fn=None)
    t = paddle.to_tensor(ids)
    losses = [float(step({"input_ids": t, "labels": t}))
              for _ in range(GPT_STEPS)]
    return state, ids, losses


@pytest.fixture(scope="module")
def gpt_hybrid(pool, gpt_ref):
    state, ids, _ = gpt_ref
    return pool.run("gpt_hybrid", state, ids, GPT_CFG, GPT_STEPS, GPT_LR)


def test_gpt_dp2_mp2_matches_the_unsharded_reference(gpt_ref, gpt_hybrid):
    """4 TrainSteps (AdamW, ClipGradByGlobalNorm(1.0)) at dp2 x mp2: the
    dp-mean of the ranks' losses is the reference's unsharded GPT's."""
    _, _, ref = gpt_ref
    by_dp = {}
    for r in gpt_hybrid:
        by_dp.setdefault(r["dp_rank"], []).append(r["losses"])
    for losses in by_dp.values():           # the mp ranks agree exactly
        assert losses[0] == losses[1]
    got = np.mean([v[0] for v in by_dp.values()], 0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]


def test_gpt_hybrid_layout_and_collectives(gpt_hybrid):
    """Each rank's attention runs its 2 of the 4 heads; the dp replicas
    end on the same shards; one reduction per step; the training path's
    collectives are all_reduce (and the wrap's one broadcast)."""
    by_mp = {}
    for r in gpt_hybrid:
        assert r["heads"] == 2 and r["reductions"] == GPT_STEPS
        assert set(r["calls"]) == {"all_reduce", "broadcast"}, r["calls"]
        assert r["calls"]["broadcast"] == 1
        by_mp.setdefault(r["mp_rank"], []).append(r["final"])
    for a, b in by_mp.values():
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_weights_carried_by_shard_and_back(gpt_hybrid):
    """Each rank loads its shard of the reference's full arrays, and the
    export gathers them back byte for byte."""
    assert all(r["carried"] for r in gpt_hybrid)


def test_global_norm_under_mp_is_the_unsharded_models(pool, gpt_ref):
    """ClipGradByGlobalNorm's norm at dp2 x mp2 and at mp 4 (the sharded
    squares summed over mp, the replicated ones once) equals the
    unsharded model's over the full parameters."""
    state, ids, _ = gpt_ref
    t = GPTForCausalLM(device="cpu", **GPT_CFG)
    load_paddle_tpu_state_dict(t, state)
    x = torch.from_numpy(ids)
    loss = t(x, labels=x)
    loss.backward()
    want = float(topt.ClipGradByGlobalNorm(1.0)._global_norm(
        [(p, p.grad) for p in t.parameters()]))
    for dp, mp in ((2, 2), (1, 4)):
        for r_loss, norm in pool.run("gpt_norm", state, ids, GPT_CFG, dp, mp):
            np.testing.assert_allclose(norm, want, rtol=1e-5)
            if dp == 1:
                np.testing.assert_allclose(r_loss, loss.item(), rtol=1e-6)


# ------------------------------------------------------------ the examples
def test_train_resnet_dp_example_matches_one_process(pool):
    """``examples/train_resnet_dp.py`` at dp = 4 (SyncBatchNorm over the
    ranks), 5 steps at the example's 64 x 64: the ranks' mean loss is a
    single-process run's on the global batch at every step."""
    argv = ["--device", "cpu", "--steps", "4", "--batch-size", "8"]
    res = pool.run("example", "train_resnet_dp", argv, timeout=300)
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.examples import train_resnet_dp

    try:
        one = train_resnet_dp.main(argv, log=lambda *a: None)
    finally:
        topology.set_hybrid_communicate_group(None)
        dist.destroy_process_group()
    got = np.mean([r["losses"] for r in res], 0)
    assert len(got) == 5
    np.testing.assert_allclose(got, one["losses"], rtol=1e-4)


def test_resilient_training_example_resumes_at_4_ranks(pool, tmp_path):
    """``examples/resilient_training.py``: the injected collective failure
    and the corrupt checkpoint are survived on every rank (one transient
    restart, one quarantined checkpoint), and the losses equal a clean
    run's."""
    faulted = pool.run("example", "resilient_training",
                       ["--device", "cpu", "--dir", str(tmp_path / "f")])
    clean = pool.run("example", "resilient_training",
                     ["--device", "cpu", "--dir", str(tmp_path / "c"),
                      "--clean"])
    for f, c in zip(faulted, clean):
        assert f["restarts"] == 1 and f["quarantined"] == 1
        assert c["restarts"] == 0 and c["quarantined"] == 0
        assert f["losses"] == c["losses"] == faulted[0]["losses"]
        assert 8 in f["valid"]
